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


def corr(gmap, fmap, coords, ii, jj, radius: int = 3):
    """Local correlation volume (corr_cuda_forward,
    correlation_kernel.cu:83-136,221-232).

    gmap [Mg, P, P, C]; fmap [Nf, H, W, C]; coords [E, P, P, 2] in fmap
    resolution; ii [E] into gmap; jj [E] into fmap.
    Returns [E, P, P, (2R+1)^2] float32, window dims ordered (x, y) as in
    the reference's final permute."""
    E, P, _, _ = coords.shape
    Nf, H, W, C = fmap.shape
    R = radius
    D = 2 * R + 2
    f1 = gmap[ii.long()].float()                             # [E, P, P, C]
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    # fully-out-of-bounds windows clamp into the zero region
    y0c = y0.clamp(-D, H + D)
    x0c = x0.clamp(-D, W + D)
    dd = torch.arange(D, device=coords.device) - R
    yy = y0c[..., None, None] + dd[:, None]                  # [E, P, P, D, 1]
    xx = x0c[..., None, None] + dd[None, :]                  # [E, P, P, 1, D]
    nn_ = jj.long()[:, None, None, None, None]
    f2 = _gather_2d(fmap, nn_, yy, xx).float()               # [E,P,P,D,D,C]
    vol = torch.einsum("epqc,epqyxc->epqyx", f1, f2)
    fx = (x - x0.float())[..., None, None]
    fy = (y - y0.float())[..., None, None]
    d = 2 * R + 1
    out = ((1 - fy) * (1 - fx) * vol[..., :d, :d]
           + (1 - fy) * fx * vol[..., :d, 1:]
           + fy * (1 - fx) * vol[..., 1:, :d]
           + fy * fx * vol[..., 1:, 1:])
    return out.transpose(-1, -2).reshape(E, P, P, d * d)


def avg_pool2d(x, k: int):
    """Non-overlapping average pool on NHWC (stride == kernel)."""
    if k == 1:
        return x
    n, h, w, c = x.shape
    x = x[:, : h - h % k, : w - w % k]
    return x.reshape(n, h // k, k, w // k, k, c).mean(dim=(2, 4))


def corr_stack(c1, c2):
    """Stack two pyramid levels into the update operator's input layout,
    level fastest-varying (Ramp_vo.py:182): [E, P, P, d*d] x 2 ->
    [E, 2*d*d*P*P]."""
    return torch.stack([c1, c2], dim=-1).reshape(c1.shape[0], -1)
