"""Flow and pose losses (port of rampvo_tpu/train/loss.py; ref
train.py:29-65, ramp/utils.py:389-399)."""

from __future__ import annotations

import torch

from ..lie import ops as lops


def masked_norm(x, mask):
    """L2 norm over the last axis that stays NaN-free under masking: the
    norm's gradient is NaN at x = 0 (identity pose pairs), and NaN * 0
    would reach every parameter, so masked rows see 1.0 before the norm
    (the double where of loss.py:68-78)."""
    mask_e = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
    safe = torch.where(mask_e, x, torch.ones_like(x))
    n = torch.linalg.norm(safe, dim=-1)
    return torch.where(mask, n, torch.zeros_like(n))


def kabsch_umeyama_scale(A, B):
    """Umeyama scale c with c R B ~ A (ref ramp/utils.py:389-399).
    A, B [N, 3]."""
    EA, EB = A.mean(0), B.mean(0)
    varA = ((A - EA) ** 2).sum(-1).mean()
    H = (A - EA).t() @ (B - EB) / A.shape[0]
    return varA / torch.clamp(torch.linalg.svdvals(H).sum(), min=1e-12)


def pose_loss_terms(Gs, Ps, n_valid: int):
    """Relative-pose translation and rotation errors over all pairs of the
    first n_valid frames, after the Umeyama scale correction (ref
    train.py:36-62). Gs, Ps [N, 7] world-to-camera (predicted, ground
    truth). Returns (tr_mean, ro_mean)."""
    N = Gs.shape[0]
    P1 = lops.se3_inv(Gs)
    P2 = lops.se3_inv(Ps)
    fmask = (torch.arange(N, device=Gs.device) < n_valid).to(Gs.dtype)[:, None]
    cnt = torch.clamp(fmask.sum(), min=1.0)

    def masked_scale(A, B):
        Ac = (A - (A * fmask).sum(0) / cnt) * fmask
        Bc = (B - (B * fmask).sum(0) / cnt) * fmask
        varA = (Ac ** 2).sum() / cnt
        H = Ac.t() @ Bc / cnt
        return varA / torch.clamp(torch.linalg.svdvals(H).sum(), min=1e-12)

    with torch.no_grad():   # the scale is a constant (loss.py:49)
        s = torch.clamp(masked_scale(P2[:, :3], P1[:, :3]), max=10.0)
    P1 = torch.cat([P1[:, :3] * s, P1[:, 3:]], dim=-1)

    idx = torch.arange(N, device=Gs.device)
    ii = idx.repeat_interleave(N)
    jj = idx.repeat(N)
    pmask = (ii != jj) & (ii < n_valid) & (jj < n_valid)
    dP = lops.se3_mul(lops.se3_inv(P1[ii]), P1[jj])
    dG = lops.se3_mul(lops.se3_inv(P2[ii]), P2[jj])
    e1 = lops.se3_log(lops.se3_mul(dP, lops.se3_inv(dG)))
    w = pmask.to(e1.dtype)
    wsum = torch.clamp(w.sum(), min=1.0)
    tr = (masked_norm(e1[:, 0:3], pmask) * w).sum() / wsum
    ro = (masked_norm(e1[:, 3:6], pmask) * w).sum() / wsum
    return tr, ro
