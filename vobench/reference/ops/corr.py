"""Patch correlation and patch extraction, plain PyTorch (port of
rampvo_tpu/ops/corr.py; reference altcorr correlation_kernel.cu).

Semantics are exact, including the D = 2R+2 window followed by a 2x2
bilinear blend down to (2R+1)^2. Feature maps are channels-last
[N, H, W, C]; out-of-bounds window taps contribute 0.
"""

from __future__ import annotations

import torch


def _gather_2d(fmap, n_idx, y_idx, x_idx):
    """fmap[n, y, x, :] with zeros for out-of-bounds (y, x). Index tensors
    share one shape S; returns [*S, C]."""
    N, H, W, C = fmap.shape
    inb = (y_idx >= 0) & (y_idx < H) & (x_idx >= 0) & (x_idx < W)
    lin = (n_idx * H + y_idx.clamp(0, H - 1)) * W + x_idx.clamp(0, W - 1)
    vals = fmap.reshape(N * H * W, C)[lin]
    return torch.where(inb[..., None], vals, torch.zeros_like(vals))


def patchify(net, coords, radius: int, mode: str = "bilinear"):
    """(2R+1)^2 bilinear (or (2R+2)^2 raw) windows at float coords.
    net [N, H, W, C], coords [N, M, 2] (x, y) -> [N, M, d, d, C]
    (ref altcorr/correlation.py:51-68)."""
    N, M, _ = coords.shape
    R = radius
    D = 2 * R + 2
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    dd = torch.arange(D, device=coords.device) - R
    yy = (y0[:, :, None, None] + dd[None, None, :, None]).expand(N, M, D, D)
    xx = (x0[:, :, None, None] + dd[None, None, None, :]).expand(N, M, D, D)
    nn_ = torch.arange(N, device=coords.device)[:, None, None, None].expand(
        N, M, D, D)
    patches = _gather_2d(net, nn_, yy, xx)
    if mode != "bilinear":
        return patches
    fx = (x - x0.to(x.dtype))[..., None, None, None]
    fy = (y - y0.to(y.dtype))[..., None, None, None]
    d = 2 * R + 1
    return ((1 - fy) * (1 - fx) * patches[:, :, :d, :d]
            + (1 - fy) * fx * patches[:, :, :d, 1:]
            + fy * (1 - fx) * patches[:, :, 1:, :d]
            + fy * fx * patches[:, :, 1:, 1:])


def corr_raw(gmap, fmap, coords, ii, jj, radius: int = 3):
    """The unblended (2R+2)^2 correlation windows of `corr`: [E, P, P, D, D]
    float32, window dims (y, x), taps at floor(coords) - R + (dy, dx)."""
    _, H, W, _ = fmap.shape
    R = radius
    D = 2 * R + 2
    f1 = gmap[ii.long()].float()                             # [E, P, P, C]
    x0 = torch.floor(coords[..., 0]).long()
    y0 = torch.floor(coords[..., 1]).long()
    # fully-out-of-bounds windows clamp into the zero region
    y0c = y0.clamp(-D, H + D)
    x0c = x0.clamp(-D, W + D)
    dd = torch.arange(D, device=coords.device) - R
    yy = y0c[..., None, None] + dd[:, None]                  # [E, P, P, D, 1]
    xx = x0c[..., None, None] + dd[None, :]                  # [E, P, P, 1, D]
    nn_ = jj.long()[:, None, None, None, None]
    f2 = _gather_2d(fmap, nn_, yy, xx).float()               # [E,P,P,D,D,C]
    return torch.einsum("epqc,epqyxc->epqyx", f1, f2)


def corr(gmap, fmap, coords, ii, jj, radius: int = 3):
    """Local correlation volume (corr_cuda_forward,
    correlation_kernel.cu:83-136,221-232).

    gmap [Mg, P, P, C]; fmap [Nf, H, W, C]; coords [E, P, P, 2] in fmap
    resolution; ii [E] into gmap; jj [E] into fmap.
    Returns [E, P, P, (2R+1)^2] float32, window dims ordered (x, y) as in
    the reference's final permute."""
    E, P, _, _ = coords.shape
    R = radius
    vol = corr_raw(gmap, fmap, coords, ii, jj, radius)
    x = coords[..., 0]
    y = coords[..., 1]
    fx = (x - torch.floor(x))[..., None, None]
    fy = (y - torch.floor(y))[..., None, None]
    d = 2 * R + 1
    out = ((1 - fy) * (1 - fx) * vol[..., :d, :d]
           + (1 - fy) * fx * vol[..., :d, 1:]
           + fy * (1 - fx) * vol[..., 1:, :d]
           + fy * fx * vol[..., 1:, 1:])
    return out.transpose(-1, -2).reshape(E, P, P, d * d)


def _chunks(E: int) -> int:
    """Edge chunks of the training correlation (corr_bwd_from_gv's rule)."""
    return 8 if E % 8 == 0 else (4 if E % 4 == 0 else 1)


def _unblend(grad_out, x, y, R: int):
    """Backward of the bilinear 2x2 blend and the window transpose: the
    (2R+1)^2 output gradient [E, P, P, d*d] onto the (2R+2)^2 raw taps
    [E, P, P, D, D] (ref ops/corr.py::_unblend)."""
    E, P, _, _ = grad_out.shape
    d, D = 2 * R + 1, 2 * R + 2
    g = grad_out.reshape(E, P, P, d, d).transpose(-1, -2)   # undo (x, y)
    fx = (x - torch.floor(x))[..., None, None]
    fy = (y - torch.floor(y))[..., None, None]
    gv = grad_out.new_zeros((E, P, P, D, D))
    gv[..., :d, :d] += (1 - fy) * (1 - fx) * g
    gv[..., :d, 1:] += (1 - fy) * fx * g
    gv[..., 1:, :d] += fy * (1 - fx) * g
    gv[..., 1:, 1:] += fy * fx * g
    return gv


def corr_bwd_from_gv(gv, gmap, fmap, coords, ii, jj, radius: int):
    """(grad_gmap, grad_fmap) of `corr` from the raw-tap gradient gv
    [E, P, P, D, D]: the taps are gathered again chunk by chunk, so the
    [E, P, P, D, D, C] window tensor never exists whole (ref
    ops/corr.py::corr_bwd_from_gv). Taps outside the map get no gradient.
    Both results are float32."""
    E, P, _, _ = coords.shape
    Nf, H, W, C = fmap.shape
    R = radius
    D = 2 * R + 2
    dev = fmap.device
    x0 = torch.floor(coords[..., 0]).long().clamp(-D, W + D)
    y0 = torch.floor(coords[..., 1]).long().clamp(-D, H + D)
    dd = torch.arange(D, device=dev) - R
    grad_g = torch.zeros((gmap.shape[0], P, P, C), dtype=torch.float32,
                         device=dev)
    grad_f = torch.zeros((Nf * H * W, C), dtype=torch.float32, device=dev)
    c = max(E // _chunks(E), 1)
    for s in range(0, E, c):
        sl = slice(s, s + c)
        yy = y0[sl][..., None, None] + dd[:, None]            # [c,P,P,D,1]
        xx = x0[sl][..., None, None] + dd[None, :]            # [c,P,P,1,D]
        nn_ = jj[sl].long()[:, None, None, None, None]
        f2 = _gather_2d(fmap, nn_, yy, xx).float()            # [c,P,P,D,D,C]
        g_c = gv[sl]
        grad_g.index_add_(0, ii[sl].long(),
                          torch.einsum("epqyx,epqyxc->epqc", g_c, f2))
        del f2
        f1 = gmap[ii[sl].long()].float()
        contrib = torch.einsum("epqyx,epqc->epqyxc", g_c, f1)
        yb, xb = yy.expand_as(g_c), xx.expand_as(g_c)
        inb = (yb >= 0) & (yb < H) & (xb >= 0) & (xb < W)
        lin = (nn_ * H + yb.clamp(0, H - 1)) * W + xb.clamp(0, W - 1)
        grad_f.index_add_(0, lin[inb], contrib[inb])
    return grad_g, grad_f.reshape(Nf, H, W, C)


class CorrTrain(torch.autograd.Function):
    """`corr` with the reference's memory-bounded backward
    (altcorr/correlation.py:32-45, ref ops/corr.py::corr_train): gradients
    reach gmap and fmap only; the coords gradient is zero. Forward and
    backward run in edge chunks."""

    @staticmethod
    def forward(ctx, gmap, fmap, coords, ii, jj, radius):
        ctx.save_for_backward(gmap, fmap, coords, ii, jj)
        ctx.radius = radius
        E = coords.shape[0]
        c = max(E // _chunks(E), 1)
        return torch.cat([corr(gmap, fmap, coords[s:s + c], ii[s:s + c],
                               jj[s:s + c], radius)
                          for s in range(0, max(E, 1), c)])

    @staticmethod
    def backward(ctx, grad_out):
        gmap, fmap, coords, ii, jj = ctx.saved_tensors
        gv = _unblend(grad_out.float(), coords[..., 0], coords[..., 1],
                      ctx.radius)
        gg, gf = corr_bwd_from_gv(gv, gmap, fmap, coords, ii, jj, ctx.radius)
        return (gg.to(gmap.dtype), gf.to(fmap.dtype), torch.zeros_like(coords),
                None, None, None)


def corr_train(gmap, fmap, coords, ii, jj, radius: int = 3):
    """Differentiable `corr` (same contract) for the training forward."""
    return CorrTrain.apply(gmap, fmap, coords, ii, jj, radius)


def avg_pool2d(x, k: int):
    """Non-overlapping average pool on NHWC (stride == kernel)."""
    if k == 1:
        return x
    n, h, w, c = x.shape
    x = x[:, : h - h % k, : w - w % k]
    return x.reshape(n, h // k, k, w // k, k, c).mean(dim=(2, 4))


def pyramidify(fmap, lvls=(1, 4)):
    """Feature pyramid by average pooling (ref ramp/utils.py:81-90), NHWC."""
    return [avg_pool2d(fmap, lvl) for lvl in lvls]


def corr_stack(c1, c2):
    """Stack two pyramid levels into the update operator's input layout,
    level fastest-varying (Ramp_vo.py:182): [E, P, P, d*d] x 2 ->
    [E, 2*d*d*P*P]."""
    return torch.stack([c1, c2], dim=-1).reshape(c1.shape[0], -1)
