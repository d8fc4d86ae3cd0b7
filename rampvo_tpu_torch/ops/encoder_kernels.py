"""The MultiScale encoder's recurrent chain through the Hopper kernel
(csrc/lstm_fold.cu). Port of rampvo_tpu/ops/encoder_pallas.py (the
MultiScale part: lstm_fold_cm, the weight composition and the encode
driver).

Per scale, one fused pass computes both modality LSTMs (zero-carry single
step) and the two super-state folds composed into one matmul, channel-major
([C, Hs*Ws]): x [8, HW] + ss [h, HW] -> ss' [h, HW]. The weight
composition is plain tensor algebra in float32; the two pyramid heads stay
torch.nn convolutions (models/encoders.py).

`lstm_fold_cm` launches the kernel for CUDA tensors and runs
`lstm_fold_ref` for CPU tensors; nothing falls back. The bf16 kernel runs
the gate product and the fold on the tensor cores and reads its weights
as bf16 B fragments (`pack_fold_weights`); `multiscale_weights` packs a
network's weights once for every scale and both mask values, and
`lstm_fold_bf16_ref` is the plain mirror that rounds where that kernel
rounds.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build
from ..models.encoders import SCALES, MultiScaleEncoder


def lstm_fold_ref(x_cm, ss_cm, wg, bg, wf, bf):
    """Plain version: x_cm [Cp, HW], ss_cm [h, HW], wg [Cp, 8h] (gate
    columns [g*2h, (g+1)*2h) = [event | image] for gate g in i, f, g, o),
    bg [8h], wf [3h, h] over rows [ss | h_ev | h_im], bf [h]. Returns
    ss' [h, HW] in ss's dtype; arithmetic in float32."""
    h = ss_cm.shape[0]
    gates = wg.float().t() @ x_cm.float() + bg.float()[:, None]   # [8h, HW]
    i = gates[0:2 * h]
    g = gates[4 * h:6 * h]
    o = gates[6 * h:8 * h]
    c = torch.sigmoid(i) * torch.tanh(g)
    hcat = torch.sigmoid(o) * torch.tanh(c)
    cat3 = torch.cat([ss_cm.float(), hcat], dim=0)
    out = wf.float().t() @ cat3 + bf.float()[:, None]
    return out.to(ss_cm.dtype)


def lstm_fold_bf16_ref(x_cm, ss_cm, wg, bg, wf, bf):
    """`lstm_fold_ref` rounded where the bf16 kernel rounds: x, ss and the
    weights to bf16, the LSTM output h to bf16 before the fold; products,
    sums, biases and the LSTM's functions in float32 (the kernel's are the
    SFU approximations). Returns ss' [h, HW] float32 before the kernel's
    last rounding (to bf16)."""
    h = ss_cm.shape[0]
    r = lambda t: t.to(torch.bfloat16).float()
    gates = r(wg).t() @ r(x_cm) + bg.float()[:, None]
    c = torch.sigmoid(gates[0:2 * h]) * torch.tanh(gates[4 * h:6 * h])
    hcat = r(torch.sigmoid(gates[6 * h:8 * h]) * torch.tanh(c))
    return r(wf).t() @ torch.cat([r(ss_cm), hcat], dim=0) + bf.float()[:, None]


GATE_BLOCKS = (0, 4, 6)  # gates i, g, o: columns [o * h, o * h + 2h) of wg


class FoldWeights(NamedTuple):
    """One scale's K2 weights (for one mask value): the composed float32
    weights, which the plain version and the f32 kernel read, and what
    the bf16 kernel reads -- `frag`, bf16 pairs in mma fragment order (the
    gate B fragments [2h/8 chunks][i, g, o][32 lanes][2], then the fold's
    [3h/16 k-steps][h/8 n-tiles][32 lanes][4]), and `bias`, float32 (the
    gate biases [2h/8][3][8], then bf)."""
    wg: torch.Tensor    # [8, 8h]
    bg: torch.Tensor    # [8h]
    wf: torch.Tensor    # [3h, h] over rows [ss | h_ev | h_im]
    bf: torch.Tensor    # [h]
    frag: torch.Tensor
    bias: torch.Tensor


@torch.no_grad()
def pack_fold_weights(wg, bg, wf, bf) -> FoldWeights:
    """The kernel's weights from `lstm_fold_ref`'s (csrc/lstm_fold.cu).
    Lane l = 4 g + t of an m16n8k8 gate chunk c holds B[2t + i][g] =
    wg[2t + i, o h + 8c + g] for i = 0, 1; of an m16n8k16 fold k-step ks
    and n-tile nt, B[2t + i (+ 8)][g] = wf[16 ks + 2t + i (+ 8), 8 nt + g].
    Constant for a frozen network: pack once (`multiscale_weights`)."""
    wg, bg, wf, bf = (t.float().contiguous() for t in (wg, bg, wf, bf))
    h = wf.shape[1]
    nch = 2 * h // 8
    gate = torch.stack([wg[:, o * h:(o + 2) * h] for o in GATE_BLOCKS])
    gate = gate.reshape(3, 8, nch, 8).permute(2, 0, 3, 1)  # [c, G, g, k]
    fold = wf.reshape(3 * h // 16, 2, 4, 2, h // 8, 8).permute(
        0, 4, 5, 2, 1, 3)                                # [ks, nt, g, t, k8, i]
    frag = torch.cat([gate.reshape(-1), fold.reshape(-1)]).to(
        torch.bfloat16).contiguous()
    b3 = torch.stack([bg[o * h:(o + 2) * h] for o in GATE_BLOCKS])
    bias = torch.cat([b3.reshape(3, nch, 8).permute(1, 0, 2).reshape(-1),
                      bf]).contiguous()
    return FoldWeights(wg, bg, wf, bf, frag, bias)


_SIG = {"lstm_fold_launch": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]}


def refuse_autograd(what: str, *tensors):
    """The encoder kernels have no backward: raise, instead of returning a
    tensor cut from the autograd graph, when grad is enabled and an input
    requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel has no backward; an input requires grad "
            "under autograd (run it under torch.no_grad())")


_SMS: dict = {}


def _sm_count(dev) -> int:
    """The card's SM count (the kernel sizes its persistent grid by it)."""
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def lstm_fold_cuda(x_cm, ss_cm, wg, bg, wf, bf, packed=None, defines=()):
    """Launch the Hopper kernel (same contract as `lstm_fold_ref`). It has
    no backward (the VO runtime calls it under no_grad). `packed` is
    `pack_fold_weights(wg, bg, wf, bf)`, packed here when None; `defines`
    picks a build variant."""
    refuse_autograd("lstm_fold", x_cm, ss_cm, wg, bg, wf, bf)
    Cp, HW = x_cm.shape
    h = ss_cm.shape[0]
    dt = ss_cm.dtype
    if Cp != 8 or h not in (16, 32, 64):
        raise ValueError(f"lstm_fold: needs Cp == 8, h in 16/32/64 ({Cp}, {h})")
    if dt not in (torch.float32, torch.bfloat16) or x_cm.dtype != dt:
        raise TypeError("lstm_fold: x and ss must share a f32/bf16 dtype")
    if not (x_cm.is_cuda and ss_cm.is_cuda):
        raise ValueError("lstm_fold: inputs must be contiguous CUDA")
    w = pack_fold_weights(wg, bg, wf, bf) if packed is None else packed
    if w.wg.shape != (8, 8 * h) or w.wf.shape != (3 * h, h) \
            or w.bg.numel() != 8 * h or w.bf.numel() != h \
            or w.frag.numel() != 48 * h + 3 * h * h \
            or w.bias.numel() != 7 * h or ss_cm.shape[1] != HW:
        raise ValueError("lstm_fold: weight or state shape")
    for t in (x_cm, ss_cm, *w):
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("lstm_fold: inputs must be contiguous CUDA, "
                             "16-byte aligned")
    out = torch.empty_like(ss_cm)
    dev = x_cm.device
    lib = build.load("lstm_fold", _SIG, defines)
    err = lib.lstm_fold_launch(
        x_cm.data_ptr(), ss_cm.data_ptr(), *(t.data_ptr() for t in w),
        out.data_ptr(), HW, h, int(dt == torch.bfloat16), _sm_count(dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "lstm_fold_launch")
    lstm_fold_cm.launches += 1
    return out


def lstm_fold_cm(x_cm, ss_cm, wg, bg, wf, bf, packed=None):
    """Channel-major fused LSTM + fold step (see `lstm_fold_ref`);
    `packed` (`pack_fold_weights` of the same weights) spares the CUDA
    path packing them."""
    if x_cm.is_cuda:
        return lstm_fold_cuda(x_cm.contiguous(), ss_cm.contiguous(), wg, bg,
                              wf, bf, packed)
    return lstm_fold_ref(x_cm, ss_cm, wg, bg, wf, bf)


lstm_fold_cm.launches = 0


# ---------------------------------------------------------------------------
# weight composition (float32 algebra on the module's parameters)
# ---------------------------------------------------------------------------

def _lstm_wb(enc):
    """(W_ih^T [C, 4h], b_ih + b_hh [4h]) of an LSTMEncoder, float32."""
    lstm = enc.convlstm
    return (lstm.weight_ih_l0.float().t(),
            (lstm.bias_ih_l0 + lstm.bias_hh_l0).float())


def gate_weights(pe, pi):
    """Gate-interleaved block-diagonal input weights of the event and image
    LSTMs: (wg [Ce+Ci, 8h], bg [8h], h)."""
    we, be = _lstm_wb(pe)
    wi, bi = _lstm_wb(pi)
    Ce, Ci = we.shape[0], wi.shape[0]
    h = we.shape[1] // 4
    we4 = we.reshape(Ce, 4, h)
    wi4 = wi.reshape(Ci, 4, h)
    top = torch.cat([we4, torch.zeros_like(we4)], dim=-1)
    bot = torch.cat([torch.zeros_like(wi4), wi4], dim=-1)
    wg = torch.cat([top, bot], dim=0).reshape(Ce + Ci, 8 * h)
    bg = torch.cat([be.reshape(4, h), bi.reshape(4, h)], dim=-1).reshape(8 * h)
    return wg, bg, h


def gate_weights_scale1(pe, pi):
    """Scale-1 gate weights with the 1x1 conv_1 folded in."""
    wg, bg, h = gate_weights(pe, pi)
    Ke = pe.conv_1.weight.float()[:, :, 0, 0].t()      # [Ce_in, Ce_out]
    Ki = pi.conv_1.weight.float()[:, :, 0, 0].t()
    Ce, Ci = Ke.shape[0], Ki.shape[0]
    K = torch.zeros((Ce + Ci, Ce + Ci), dtype=torch.float32, device=wg.device)
    K[:Ce, :Ce] = Ke
    K[Ce:, Ce:] = Ki
    bc = torch.cat([pe.conv_1.bias.float(), pi.conv_1.bias.float()])
    return K @ wg, bc @ wg + bg, h


def fold_weights(enc: MultiScaleEncoder, si: int, m: bool):
    """Composed super-state fold over rows [ss | h_ev | h_im]: (wf [3h, h],
    bf [h]). With the mask set the image fold is applied after the event
    fold, which composes into one affine map."""
    fe = enc.super_state_ev_encoder[si].encoder
    fi = enc.super_state_im_encoders[si].encoder
    We = fe.weight.float()[:, :, 0, 0].t()             # [2h, h]
    Wi = fi.weight.float()[:, :, 0, 0].t()
    be, bi = fe.bias.float(), fi.bias.float()
    h = We.shape[-1]
    We1, We2 = We[:h], We[h:]
    Wi1, Wi2 = Wi[:h], Wi[h:]
    if m:
        return (torch.cat([We1 @ Wi1, We2 @ Wi1, Wi2], dim=0), be @ Wi1 + bi)
    return torch.cat([We1, We2, torch.zeros_like(Wi2)], dim=0), be


def scale_weights(enc: MultiScaleEncoder, si: int, m: bool) -> FoldWeights:
    """Scale si's composed and packed K2 weights for mask value m."""
    pe, pi = enc.ev_encoders[si], enc.im_encoders[si]
    gate = gate_weights_scale1 if SCALES[si] <= 1 else gate_weights
    wg, bg, _ = gate(pe, pi)
    return pack_fold_weights(wg, bg, *fold_weights(enc, si, m))


@torch.no_grad()
def multiscale_weights(enc: MultiScaleEncoder):
    """K2's weights of every scale for both mask values, [{False:
    FoldWeights, True: FoldWeights}] per scale. Constant for a frozen
    network, so a caller that encodes many frames packs them once."""
    return [{m: scale_weights(enc, si, m) for m in (False, True)}
            for si in range(len(SCALES))]


# ---------------------------------------------------------------------------
# encode driver
# ---------------------------------------------------------------------------

def multiscale_chain(enc: MultiScaleEncoder, events, images, mask, state,
                     packed=None):
    """Per-scale LSTM + fold chains through `lstm_fold_cm`.

    events [1, H, W, Ce], images [1, H, W, Ci] (channels-last), mask [1]
    host bool, state {"ss": [[h_s, Hs*Ws]]} channel-major, `packed` from
    `multiscale_weights(enc)` (composed here when None). Returns
    (super-states NCHW list, new state)."""
    m = bool(mask.reshape(-1)[0])
    dt = state["ss"][0].dtype
    ev = events[0].permute(2, 0, 1)[None]
    im = images[0].permute(2, 0, 1)[None]
    new_ss, ss_nchw = [], []
    for si, s in enumerate(SCALES):
        pe, pi = enc.ev_encoders[si], enc.im_encoders[si]
        w = scale_weights(enc, si, m) if packed is None else packed[si][m]
        if s <= 1:
            x = torch.cat([ev, im], dim=1)
        else:
            ce = F.conv2d(ev, pe.conv_1.weight, pe.conv_1.bias, stride=s,
                          padding=1)
            ci = F.conv2d(im, pi.conv_1.weight, pi.conv_1.bias, stride=s,
                          padding=1)
            x = torch.cat([ce, ci], dim=1)
        _, Cx, Hs, Ws = x.shape
        h = w.wf.shape[1]
        ss = lstm_fold_cm(x.reshape(Cx, Hs * Ws).to(dt), state["ss"][si],
                          *w[:4], packed=w)
        new_ss.append(ss)
        ss_nchw.append(ss.reshape(1, h, Hs, Ws))
    return ss_nchw, {"ss": new_ss}


def multiscale_heads(enc: MultiScaleEncoder, ss_nchw):
    """The two pyramid heads; returns channels-last fmap, imap."""
    dt = next(enc.fmap_encoder.parameters()).dtype
    fmap, imap = enc.heads([s.to(dt) for s in ss_nchw])
    return fmap.permute(0, 2, 3, 1), imap.permute(0, 2, 3, 1)


def multiscale_encode(enc: MultiScaleEncoder, events, images, mask, state,
                      heads: bool = True, packed=None):
    """MultiScaleEncoder forward (T == 1) with the fused chain; `packed`
    from `multiscale_weights(enc)` (composed per call when None). Returns
    (fmap [1, H/4, W/4, 128], imap [1, H/4, W/4, 384], new state); the
    Patchifier's /4 is the caller's. `heads=False` advances the state
    only and returns (None, None, new state)."""
    if events.shape[0] != 1:
        raise ValueError("the MultiScale encoder port takes T == 1")
    ss_nchw, new_state = multiscale_chain(enc, events, images, mask, state,
                                          packed)
    if not heads:
        return None, None, new_state
    fmap, imap = multiscale_heads(enc, ss_nchw)
    return fmap, imap, new_state
