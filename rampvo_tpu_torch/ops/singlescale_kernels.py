"""The SingleScale encoder's recurrent chain through the Hopper kernel
(csrc/lstm_carry_fold.cu). Port of the SingleScale part of
rampvo_tpu/ops/encoder_pallas.py (lstm_carry_fold_cm, the weight packing,
the channel-major state and the encode function).

One fused pass per frame computes both modality LSTMs as a carried step
(recurrent h @ W_hh, forget gate) and the two presence-gated shared folds,
channel-major: x [8, HW] + hc [4hp, HW] + ss [hp, HW] -> (ss', hc'). The
hidden size h = 15 is padded to hp = 16 per gate; the padded rows stay
exactly zero (zero weights and biases, zero initial carry). The presence
flags are a device int32[2]: no host sync per frame. The two BasicEncoder4
heads stay torch.nn convolutions (models/encoders.py).

`lstm_carry_fold_cm` launches the kernel for CUDA tensors and runs
`lstm_carry_fold_ref` for CPU tensors; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .encoder_kernels import refuse_autograd
from ..models.encoders import SS_LSTM_DIM, SingleScaleEncoder


def lstm_carry_fold_ref(x_cm, hc_cm, ss_cm, wg, wh, bg, wf, bf, pres):
    """Plain version: x_cm [Cp, HW]; hc_cm [4hp, HW] rows [h_ev | h_im |
    c_ev | c_im]; ss_cm [hp, HW]; wg [Cp, 8hp], wh [2hp, 8hp] (gate g in
    columns [g*2hp, (g+1)*2hp), event half first); bg [8hp]; wf [2hp, hp]
    over rows [ss | data]; bf [hp]; pres [2] int (event, image present).
    Returns (ss' [hp, HW], hc' [4hp, HW]) in the inputs' dtypes; arithmetic
    in float32."""
    hp = ss_cm.shape[0]
    hcat = hc_cm[:2 * hp].float()
    ccat = hc_cm[2 * hp:].float()
    gates = (wg.float().t() @ x_cm.float() + wh.float().t() @ hcat
             + bg.float()[:, None])
    i, f, g, o = gates.split(2 * hp)
    c = torch.sigmoid(f) * ccat + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    wft, bfc = wf.float().t(), bf.float()[:, None]
    p = pres.reshape(2) > 0
    ss = ss_cm.float()
    ss = torch.where(p[0], wft @ torch.cat([ss, h[:hp]]) + bfc, ss)
    ss = torch.where(p[1], wft @ torch.cat([ss, h[hp:]]) + bfc, ss)
    return ss.to(ss_cm.dtype), torch.cat([h, c]).to(hc_cm.dtype)


_SIG = {"lstm_carry_fold_launch": [ctypes.c_void_p] * 11
        + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        "lstm_carry_fold_blocks_per_sm": []}


def lstm_carry_fold_cuda(x_cm, hc_cm, ss_cm, wg, wh, bg, wf, bf, pres,
                         defines=()):
    """Launch the Hopper kernel (same contract as `lstm_carry_fold_ref`).
    `defines` selects a build variant of the source (see its head). It has
    no backward (the VO runtime calls it under no_grad)."""
    refuse_autograd("lstm_carry_fold", x_cm, hc_cm, ss_cm, wg, wh, bg, wf,
                    bf, pres)
    Cp, HW = x_cm.shape
    hp = ss_cm.shape[0]
    dt = ss_cm.dtype
    if Cp != 8 or hp != 16:
        raise ValueError(f"lstm_carry_fold: needs Cp == 8, hp == 16 "
                         f"({Cp}, {hp})")
    if dt not in (torch.float32, torch.bfloat16) or x_cm.dtype != dt \
            or hc_cm.dtype != dt:
        raise TypeError("lstm_carry_fold: x, hc and ss must share a f32/bf16 "
                        "dtype")
    w = [t.float().contiguous() for t in (wg, wh, bg, wf, bf)]
    pres = pres.to(torch.int32).contiguous()
    if w[0].shape != (8, 8 * hp) or w[1].shape != (2 * hp, 8 * hp) \
            or w[2].numel() != 8 * hp or w[3].shape != (2 * hp, hp) \
            or w[4].numel() != hp or pres.numel() != 2 \
            or hc_cm.shape != (4 * hp, HW) or ss_cm.shape[1] != HW:
        raise ValueError("lstm_carry_fold: weight or state shape")
    for t in (x_cm, hc_cm, ss_cm, *w, pres):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("lstm_carry_fold: inputs must be contiguous CUDA")
    oss = torch.empty_like(ss_cm)
    ohc = torch.empty_like(hc_cm)
    dev = x_cm.device
    lib = build.load("lstm_carry_fold", _SIG, defines)
    # one wave of the 256-thread blocks the build keeps on each SM
    grid = min(-(-HW // 256), lib.lstm_carry_fold_blocks_per_sm()
               * torch.cuda.get_device_properties(dev).multi_processor_count)
    err = lib.lstm_carry_fold_launch(
        x_cm.data_ptr(), hc_cm.data_ptr(), ss_cm.data_ptr(),
        *(t.data_ptr() for t in w), pres.data_ptr(), oss.data_ptr(),
        ohc.data_ptr(), HW, hp, int(dt == torch.bfloat16), grid,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "lstm_carry_fold_launch")
    lstm_carry_fold_cm.launches += 1
    return oss, ohc


def lstm_carry_fold_cm(x_cm, hc_cm, ss_cm, wg, wh, bg, wf, bf, pres):
    """Channel-major carried LSTM + shared-fold step (see
    `lstm_carry_fold_ref`)."""
    if x_cm.is_cuda:
        return lstm_carry_fold_cuda(x_cm.contiguous(), hc_cm.contiguous(),
                                    ss_cm.contiguous(), wg, wh, bg, wf, bf,
                                    pres)
    return lstm_carry_fold_ref(x_cm, hc_cm, ss_cm, wg, wh, bg, wf, bf, pres)


lstm_carry_fold_cm.launches = 0


# ---------------------------------------------------------------------------
# weight packing (float32 algebra on the module's parameters)
# ---------------------------------------------------------------------------

def padded_dim(h: int) -> int:
    """Hidden size padded to a multiple of 8 (15 -> 16)."""
    return h + (-h) % 8


def _pad_gates(w4, hp):
    """[..., 4, h] -> [..., 4, hp] zero-padded per gate."""
    return F.pad(w4, (0, hp - w4.shape[-1]))


def _interleave(we4, wi4):
    """Block-diagonal [event; image] rows, gate-interleaved columns
    [g: event | image]."""
    z = torch.zeros_like
    return torch.cat([torch.cat([we4, z(we4)], dim=-1),
                      torch.cat([z(wi4), wi4], dim=-1)], dim=0)


def singlescale_gate_weights(enc: SingleScaleEncoder, hp: int):
    """Interleaved, padded gate weights of the carried kernel: wg
    [Ce+Ci, 8hp], wh [2hp, 8hp], bg [8hp]; gate g occupies columns
    [g*2hp, (g+1)*2hp) with the event half first."""
    pe, pi = enc.events_convlstm, enc.image_convlstm
    h = pe.hidden_size
    we = pe.weight_ih_l0.float().t()                   # [Ce, 4h]
    wi = pi.weight_ih_l0.float().t()
    wg = _interleave(_pad_gates(we.reshape(-1, 4, h), hp),
                     _pad_gates(wi.reshape(-1, 4, h), hp))

    def pad_hh(lstm):
        w4 = _pad_gates(lstm.weight_hh_l0.float().t().reshape(h, 4, h), hp)
        return F.pad(w4, (0, 0, 0, 0, 0, hp - h))      # [hp, 4, hp]

    wh = _interleave(pad_hh(pe), pad_hh(pi))
    # the bias sum in the parameters' dtype, as the reference's autocast
    be = _pad_gates((pe.bias_ih_l0 + pe.bias_hh_l0).float().reshape(4, h), hp)
    bi = _pad_gates((pi.bias_ih_l0 + pi.bias_hh_l0).float().reshape(4, h), hp)
    bg = torch.cat([be, bi], dim=-1).reshape(8 * hp)
    return wg.reshape(-1, 8 * hp), wh.reshape(2 * hp, 8 * hp), bg


def singlescale_fold_weights(enc: SingleScaleEncoder, hp: int):
    """Shared fold (concat(ss, data) @ W + b) padded to hp per half:
    wf [2hp, hp], bf [hp]."""
    conv = enc.superstate_encoder
    Wt = conv.weight.float()[:, :, 0, 0].t()           # [2h, h]
    h = Wt.shape[-1]
    Wc = F.pad(Wt, (0, hp - h))
    wf = torch.cat([F.pad(Wc[:h], (0, 0, 0, hp - h)),
                    F.pad(Wc[h:], (0, 0, 0, hp - h))], dim=0)
    return wf, F.pad(conv.bias.float(), (0, hp - h))


@torch.no_grad()
def singlescale_weights(enc: SingleScaleEncoder):
    """The kernel's packed weights (wg, wh, bg, wf, bf) of an encoder. They
    are constant for a frozen network, so a caller that encodes many
    frames packs them once."""
    hp = padded_dim(enc.events_convlstm.hidden_size)
    return (*singlescale_gate_weights(enc, hp),
            *singlescale_fold_weights(enc, hp))


# ---------------------------------------------------------------------------
# channel-major state
# ---------------------------------------------------------------------------

def singlescale_init_state(H: int, W: int, lstm_dim: int = SS_LSTM_DIM,
                           dtype=torch.float32, device="cpu"):
    """Channel-major persistent state {"hc": [4hp, HW], "ss": [hp, HW]}."""
    hp = padded_dim(lstm_dim)
    return {"hc": torch.zeros((4 * hp, H * W), dtype=dtype, device=device),
            "ss": torch.zeros((hp, H * W), dtype=dtype, device=device)}


def singlescale_state_to_cm(state, lstm_dim: int = SS_LSTM_DIM):
    """Channels-last `SingleScaleEncoder` state -> channel-major, padded."""
    hp = padded_dim(lstm_dim)

    def cm(x):
        return F.pad(x.reshape(-1, x.shape[-1]).t(), (0, 0, 0, hp - x.shape[-1]))

    return {"hc": torch.cat([cm(state["ev"][0]), cm(state["im"][0]),
                             cm(state["ev"][1]), cm(state["im"][1])]),
            "ss": cm(state["ss"])}


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def singlescale_encode(enc: SingleScaleEncoder, events, images, state,
                       heads: bool = True, weights=None):
    """SingleScaleEncoder forward (T == 1) with the carried chain through
    `lstm_carry_fold_cm`: events [1, H, W, Ce], images [1, H, W, Ci]
    channels-last, state from `singlescale_init_state`, `weights` from
    `singlescale_weights(enc)` (packed here when None). Returns (fmap
    [1, H/4, W/4, 128], imap [1, H/4, W/4, 384], new state); the
    Patchifier's /4 is the caller's. `heads=False` advances the carry only
    and returns (None, None, new state)."""
    if events.shape[0] != 1:
        raise ValueError("the SingleScale encoder port takes T == 1")
    if weights is None:
        weights = singlescale_weights(enc)
    ev, im = events[0], images[0]
    pres = torch.stack([ev.ne(0).any(), im.ne(0).any()]).to(torch.int32)
    x = torch.cat([ev, im], dim=-1)
    x_cm = x.reshape(-1, x.shape[-1]).t().to(state["ss"].dtype)
    ss, hc = lstm_carry_fold_cm(x_cm, state["hc"], state["ss"], *weights,
                                pres)
    new_state = {"hc": hc, "ss": ss}
    if not heads:
        return None, None, new_state
    h = enc.events_convlstm.hidden_size
    dt = next(enc.fmap_encoder.parameters()).dtype
    fmap, imap = enc.heads(ss[:h].reshape(1, h, ev.shape[0], ev.shape[1])
                           .to(dt))
    return fmap, imap, new_state
