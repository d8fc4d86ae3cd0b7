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
`lstm_fold_ref` for CPU tensors; nothing falls back.
"""

from __future__ import annotations

import ctypes

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


_SIG = {"lstm_fold_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]}


def lstm_fold_cuda(x_cm, ss_cm, wg, bg, wf, bf):
    """Launch the Hopper kernel (same contract as `lstm_fold_ref`)."""
    Cp, HW = x_cm.shape
    h = ss_cm.shape[0]
    dt = ss_cm.dtype
    if Cp != 8 or h not in (16, 32, 64):
        raise ValueError(f"lstm_fold: needs Cp == 8, h in 16/32/64 ({Cp}, {h})")
    if dt not in (torch.float32, torch.bfloat16) or x_cm.dtype != dt:
        raise TypeError("lstm_fold: x and ss must share a f32/bf16 dtype")
    w = [t.float().contiguous() for t in (wg, bg, wf, bf)]
    if w[0].shape != (8, 8 * h) or w[2].shape != (3 * h, h) \
            or w[1].numel() != 8 * h or w[3].numel() != h \
            or ss_cm.shape[1] != HW:
        raise ValueError("lstm_fold: weight or state shape")
    for t in (x_cm, ss_cm, *w):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("lstm_fold: inputs must be contiguous CUDA")
    out = torch.empty_like(ss_cm)
    dev = x_cm.device
    grid = min(-(-HW // 256),
               2 * torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = build.load("lstm_fold", _SIG)
    err = lib.lstm_fold_launch(
        x_cm.data_ptr(), ss_cm.data_ptr(), *(t.data_ptr() for t in w),
        out.data_ptr(), HW, h, int(dt == torch.bfloat16), grid,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "lstm_fold_launch")
    lstm_fold_cm.launches += 1
    return out


def lstm_fold_cm(x_cm, ss_cm, wg, bg, wf, bf):
    """Channel-major fused LSTM + fold step (see `lstm_fold_ref`)."""
    if x_cm.is_cuda:
        return lstm_fold_cuda(x_cm.contiguous(), ss_cm.contiguous(), wg, bg,
                              wf, bf)
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


# ---------------------------------------------------------------------------
# encode driver
# ---------------------------------------------------------------------------

def multiscale_chain(enc: MultiScaleEncoder, events, images, mask, state):
    """Per-scale LSTM + fold chains through `lstm_fold_cm`.

    events [1, H, W, Ce], images [1, H, W, Ci] (channels-last), mask [1]
    host bool, state {"ss": [[h_s, Hs*Ws]]} channel-major. Returns
    (super-states NCHW list, new state)."""
    m = bool(mask.reshape(-1)[0])
    dt = state["ss"][0].dtype
    ev = events[0].permute(2, 0, 1)[None]
    im = images[0].permute(2, 0, 1)[None]
    new_ss, ss_nchw = [], []
    for si, s in enumerate(SCALES):
        pe, pi = enc.ev_encoders[si], enc.im_encoders[si]
        if s <= 1:
            wg, bg, h = gate_weights_scale1(pe, pi)
            x = torch.cat([ev, im], dim=1)
        else:
            ce = F.conv2d(ev, pe.conv_1.weight, pe.conv_1.bias, stride=s,
                          padding=1)
            ci = F.conv2d(im, pi.conv_1.weight, pi.conv_1.bias, stride=s,
                          padding=1)
            x = torch.cat([ce, ci], dim=1)
            wg, bg, h = gate_weights(pe, pi)
        wf, bf = fold_weights(enc, si, m)
        _, Cx, Hs, Ws = x.shape
        ss = lstm_fold_cm(x.reshape(Cx, Hs * Ws).to(dt), state["ss"][si],
                          wg, bg, wf, bf)
        new_ss.append(ss)
        ss_nchw.append(ss.reshape(1, h, Hs, Ws))
    return ss_nchw, {"ss": new_ss}


def multiscale_heads(enc: MultiScaleEncoder, ss_nchw):
    """The two pyramid heads; returns channels-last fmap, imap."""
    dt = next(enc.fmap_encoder.parameters()).dtype
    fmap, imap = enc.heads([s.to(dt) for s in ss_nchw])
    return fmap.permute(0, 2, 3, 1), imap.permute(0, 2, 3, 1)


def multiscale_encode(enc: MultiScaleEncoder, events, images, mask, state):
    """MultiScaleEncoder forward (T == 1) with the fused chain. Returns
    (fmap [1, H/4, W/4, 128], imap [1, H/4, W/4, 384], new state); the
    Patchifier's /4 is the caller's."""
    if events.shape[0] != 1:
        raise ValueError("the MultiScale encoder port takes T == 1")
    ss_nchw, new_state = multiscale_chain(enc, events, images, mask, state)
    fmap, imap = multiscale_heads(enc, ss_nchw)
    return fmap, imap, new_state
