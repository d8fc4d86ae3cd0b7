"""Training correlation: the Hopper kernels K7 (forward) and K8 (backward)
of csrc/corr_train.cu and their plain version. Port of
rampvo_tpu/ops/corr_pallas.py::corr_train_fused (corr_sched_fused and
corr_sched_bwd), computed as its exact XLA counterpart is: `corr_train` at
both pyramid levels, stacked by `corr_stack`.

The function: for every edge e of a flat edge list, the two-level
correlation of gmap row kk[e] (3x3 patch features) with exact 8x8 windows
of frame jj[e]'s feature maps (level 1 at the coords, level 2 at coords /
4), blended to 7x7, in the reference layout [E, 882] that corr_fc1 reads.
Its gradient reaches gmap and both feature maps; the coords get zero, as
in the reference.

K7 runs K1's per-edge routine (csrc/corr_window.cuh) on the flat edge
list. `corr_train_box_ref` mirrors its box decomposition (K1's
ops/corr_kernels.py::box_corr) and `corr_train_bwd_box_ref` K8's (gather
form over each edge's window union, ops/corr_kernels.py::window_boxes),
in plain PyTorch for the tests and chip_smoke.py; no wrapper calls them.

`corr_train_fused` is one autograd Function on CUDA tensors (K7 going
forward, K8 in the backward) and the plain version on CPU tensors; nothing
falls back. The autograd Function saves its inputs, not the windows, so
the backward recomputes nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .corr import _unblend, corr_bwd_from_gv, corr_stack, corr_train
from .corr_kernels import CAP, D, box_corr, box_passes, box_taps, \
    window_boxes, window_pick

RADIUS = 3
C = 128
NCOL = 2 * (2 * RADIUS + 1) ** 2 * 9


def corr_train_ref(gmap, fmap1, fmap2, coords, kk, jj):
    """Plain version: `corr_train` at level 1 (fmap1, coords) and level 2
    (fmap2, coords / 4), stacked level-fastest. gmap [NG, 3, 3, 128];
    fmap1 [NF, H, W, 128]; fmap2 [NF, H/4, W/4, 128]; coords [E, 3, 3, 2];
    kk, jj [E]. Returns [E, 882] float32."""
    c1 = corr_train(gmap, fmap1, coords, kk, jj, RADIUS)
    c2 = corr_train(gmap, fmap2, coords / 4.0, kk, jj, RADIUS)
    return corr_stack(c1, c2)


def corr_train_box_ref(gmap, fmap1, fmap2, coords, kk, jj, cap: int = CAP,
                       chunk: int = 1024):
    """`corr_train_ref`'s function computed the way K7 computes it
    (csrc/corr_train.cu on corr_window.cuh::edge, ops/corr_kernels.py::
    box_corr): per level the 9 pixel features dotted with the edge's
    whole box, each pixel's window picked out by its offset, then the
    blend; an edge whose kk or jj is out of range gets zeros, as in the
    kernel (the plain version indexes with them). Returns (out [E, 882]
    float32, the in-range edges that did not fit at either level: those
    the kernel counts on its slow path)."""
    E = coords.shape[0]
    NG, NF = gmap.shape[0], fmap1.shape[0]
    kk, jj = kk.long(), jj.long()
    live = (kk >= 0) & (kk < NG) & (jj >= 0) & (jj < NF)
    g = gmap.reshape(NG, 9, C)[kk.clamp(0, NG - 1)].float()
    co = coords.reshape(E, 9, 2).float()
    st, slow = box_corr(g, fmap1, fmap2, jj.clamp(0, NF - 1), co[..., 0],
                        co[..., 1], cap, chunk)
    return torch.where(live[:, None], st, torch.zeros_like(st)), slow & live


def corr_train_bwd_ref(ct, gmap, fmap1, fmap2, coords, kk, jj):
    """Plain backward of `corr_train_ref` for the output gradient ct
    [E, 882]: (grad gmap, grad fmap1, grad fmap2), float32. Each level's
    gradient is the level-l columns of ct unblended onto the raw taps."""
    E = ct.shape[0]
    P = coords.shape[1]
    ctl = ct.float().reshape(E, P, P, (2 * RADIUS + 1) ** 2, 2)
    grads = []
    for l, (fmap, co) in enumerate(((fmap1, coords), (fmap2, coords / 4.0))):
        gv = _unblend(ctl[..., l], co[..., 0], co[..., 1], RADIUS)
        grads.append(corr_bwd_from_gv(gv, gmap, fmap, co, kk, jj, RADIUS))
    return grads[0][0] + grads[1][0], grads[0][1], grads[1][1]


def corr_train_bwd_box_ref(ct, gmap, fmap1, fmap2, coords, kk, jj,
                           cap: int = CAP, chunk: int = 1024):
    """`corr_train_bwd_ref`'s function computed the way K8 computes it
    (csrc/corr_train.cu): per level, the output gradient unblended onto
    the raw taps and scattered into the edge's box, gv [9, box] (zero where
    a pixel's window does not cover a tap); then, per box tap, grad fmap
    gets sum_q gv[q, tap] * g[q] once and grad gmap[q] gets gv[q, tap] *
    f(tap). Edges whose spread exceeds `cap` go pixel by pixel. Returns
    ((grad gmap, grad fmap1, grad fmap2) float32, edges that did not fit
    at a level whose output gradient is not all zero: those the kernel
    sends down its slow path)."""
    E = ct.shape[0]
    P = coords.shape[1]
    dev = ct.device
    ctl = ct.float().reshape(E, P, P, (2 * RADIUS + 1) ** 2, 2)
    g = gmap.reshape(-1, P * P, C).float()
    kk, jj = kk.long(), jj.long()
    grad_g = torch.zeros_like(g)
    grads_f, slow = [], torch.zeros(E, dtype=torch.bool, device=dev)
    for l, (fmap, co) in enumerate(((fmap1, coords), (fmap2, coords * 0.25))):
        Nf, H, W, _ = fmap.shape
        x, y = co[..., 0].float(), co[..., 1].float()
        gv = _unblend(ctl[..., l], x, y, RADIUS).reshape(E, P * P, D * D)
        b = window_boxes(x.reshape(E, -1), y.reshape(E, -1), H, W, cap)
        slow |= ~b.fits & (ctl[..., l] != 0).flatten(1).any(1)
        grad_f = torch.zeros((Nf * H * W, C), dtype=torch.float32, device=dev)
        for idx, qs, bx, by, bw, bh, ox, oy, side in box_passes(b, cap):
            for s in range(0, idx.numel(), chunk):
                c = slice(s, s + chunk)
                e = idx[c]
                f, lin, inb = box_taps(fmap, jj[e], bx[c], by[c], bw[c],
                                       bh[c], side)
                gvb = torch.zeros((e.numel(), len(qs), side * side),
                                  dtype=torch.float32, device=dev)
                gvb.scatter_(2, window_pick(ox[c], oy[c], bw[c]).flatten(2),
                             gv[e][:, qs])
                qi = torch.tensor(qs, device=dev)
                upd = torch.zeros((e.numel(), P * P, C), device=dev)
                upd[:, qi] = torch.einsum("nqt,ntc->nqc", gvb, f)
                grad_g.index_add_(0, kk[e], upd)
                gf = torch.einsum("nqt,nqc->ntc", gvb, g[kk[e]][:, qs])
                grad_f.index_add_(0, lin[inb], gf[inb])
        grads_f.append(grad_f.reshape(Nf, H, W, C))
    return (grad_g.reshape(gmap.shape), grads_f[0], grads_f[1]), slow


_SIG = {
    "corr_train_fwd_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "corr_train_bwd_launch": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "corr_train_slow_edges": [ctypes.POINTER(ctypes.c_uint), ctypes.c_int],
}


def _checked(gmap, fmap1, fmap2, coords, kk, jj):
    """Validate the kernel's inputs; returns (NG, NF, H1, W1, H2, W2, E,
    coords, kk, jj) with coords float32 and the indices int32, all
    contiguous."""
    NG, P, P2, Cg = gmap.shape
    NF, H1, W1, C1 = fmap1.shape
    NF2, H2, W2, C2 = fmap2.shape
    E = coords.shape[0]
    dt = gmap.dtype
    if not (P == P2 == 3 and Cg == C1 == C2 == C and NF2 == NF):
        raise ValueError("corr_train: needs 3x3 patches of 128 channels")
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corr_train: unsupported dtype {dt}")
    if fmap1.dtype != dt or fmap2.dtype != dt:
        raise TypeError("corr_train: gmap and feature maps differ in dtype")
    if coords.shape != (E, 3, 3, 2) or kk.shape != (E,) or jj.shape != (E,):
        raise ValueError("corr_train: coords [E, 3, 3, 2], kk and jj [E]")
    coords = coords.float().contiguous()
    kk = kk.to(torch.int32).contiguous()
    jj = jj.to(torch.int32).contiguous()
    for t in (gmap, fmap1, fmap2, coords, kk, jj):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("corr_train: inputs must be contiguous CUDA")
        if t.data_ptr() % 16:
            raise ValueError("corr_train: inputs must be 16-byte aligned")
    return NG, NF, H1, W1, H2, W2, E, coords, kk, jj


def corr_train_cuda(gmap, fmap1, fmap2, coords, kk, jj, defines=()):
    """Launch K7 (same contract as `corr_train_ref`; the output has the
    inputs' dtype; an edge whose kk or jj is out of range gets zeros).
    `defines` picks a build variant."""
    NG, NF, H1, W1, H2, W2, E, coords, kk, jj = _checked(
        gmap, fmap1, fmap2, coords, kk, jj)
    out = torch.empty((E, NCOL), dtype=gmap.dtype, device=gmap.device)
    lib = build.load("corr_train", _SIG, defines)
    err = lib.corr_train_fwd_launch(
        gmap.data_ptr(), fmap1.data_ptr(), fmap2.data_ptr(), coords.data_ptr(),
        kk.data_ptr(), jj.data_ptr(), out.data_ptr(), E, NG, NF, H1, W1, H2,
        W2, int(gmap.dtype == torch.bfloat16),
        torch.cuda.current_stream(gmap.device).cuda_stream)
    build.check(err, "corr_train_fwd_launch")
    corr_train_cuda.launches += 1
    return out


def corr_train_bwd_cuda(ct, gmap, fmap1, fmap2, coords, kk, jj, slow=None,
                        defines=()):
    """Launch K8 (same contract as `corr_train_bwd_ref`): float32 gradients
    of gmap, fmap1 and fmap2, summed with atomics. `slow`, a CUDA int32
    tensor of one element, is increased by the number of edges whose pixel
    spread exceeded the kernel's box cap (its exact slow path); `defines`
    picks a build variant."""
    NG, NF, H1, W1, H2, W2, E, coords, kk, jj = _checked(
        gmap, fmap1, fmap2, coords, kk, jj)
    ct = ct.float().contiguous()
    if ct.shape != (E, NCOL) or not ct.is_cuda:
        raise ValueError("corr_train: output gradient must be CUDA [E, 882]")
    if slow is not None and not (slow.is_cuda and slow.dtype == torch.int32
                                 and slow.numel() == 1):
        raise ValueError("corr_train: slow must be one CUDA int32")
    f32 = dict(dtype=torch.float32, device=gmap.device)
    gg = torch.zeros(gmap.shape, **f32)
    g1 = torch.zeros(fmap1.shape, **f32)
    g2 = torch.zeros(fmap2.shape, **f32)
    lib = build.load("corr_train", _SIG, defines)
    err = lib.corr_train_bwd_launch(
        ct.data_ptr(), gmap.data_ptr(), fmap1.data_ptr(), fmap2.data_ptr(),
        coords.data_ptr(), kk.data_ptr(), jj.data_ptr(), gg.data_ptr(),
        g1.data_ptr(), g2.data_ptr(),
        None if slow is None else slow.data_ptr(), E, NG, NF, H1, W1, H2, W2,
        int(gmap.dtype == torch.bfloat16),
        torch.cuda.current_stream(gmap.device).cuda_stream)
    build.check(err, "corr_train_bwd_launch")
    corr_train_bwd_cuda.launches += 1
    return gg, g1, g2


corr_train_cuda.launches = 0
corr_train_bwd_cuda.launches = 0


def corr_train_slow_edges(reset: bool = True, defines=()) -> int:
    """How many edges of K7's launches took the kernel's slow path (pixel
    spread beyond CAP at either level) since the last reset; waits for
    the device. K8 counts into the `slow` tensor its caller passes."""
    lib = build.load("corr_train", _SIG, defines)
    n = ctypes.c_uint(0)
    build.check(lib.corr_train_slow_edges(ctypes.byref(n), int(reset)),
                "corr_train_slow_edges")
    return n.value


class CorrTrainFused(torch.autograd.Function):
    """K7 forward, K8 backward; the coords gradient is zero."""

    @staticmethod
    def forward(ctx, gmap, fmap1, fmap2, coords, kk, jj):
        ctx.save_for_backward(gmap, fmap1, fmap2, coords, kk, jj)
        return corr_train_cuda(gmap, fmap1, fmap2, coords, kk, jj)

    @staticmethod
    def backward(ctx, ct):
        gmap, fmap1, fmap2, coords, kk, jj = ctx.saved_tensors
        gg, g1, g2 = corr_train_bwd_cuda(ct, gmap, fmap1, fmap2, coords, kk,
                                         jj)
        return (gg.to(gmap.dtype), g1.to(fmap1.dtype), g2.to(fmap2.dtype),
                torch.zeros_like(coords), None, None)


def corr_train_fused(gmap, fmap1, fmap2, coords, kk, jj):
    """Differentiable two-level training correlation, [E, 882].

    gmap [NG, 3, 3, 128]; fmap1 [NF, H, W, 128]; fmap2 [NF, H/4, W/4, 128]
    (fmap1's 4x pool); coords [E, 3, 3, 2] level-1 patch pixels; kk [E]
    into gmap, jj [E] into the maps. CUDA tensors go through K7/K8, CPU
    tensors through the plain version."""
    if gmap.is_cuda:
        return CorrTrainFused.apply(gmap.contiguous(), fmap1.contiguous(),
                                    fmap2.contiguous(), coords, kk, jj)
    return corr_train_ref(gmap, fmap1, fmap2, coords, kk, jj)
