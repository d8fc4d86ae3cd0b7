"""Gauss-Newton bundle adjustment for inference over the edge lattice
(port of the lattice path of rampvo_tpu/ba/core.py::ba_infer; reference
fastba ba_cuda.cu:232-376,430-576).

Gates ||r|| < 128 px, Z > 0.2, center within 64 px of the image; damping
S_kk += 1e-4 S_kk + 1; depth retraction with reset d > 20 -> 1 and floor
1e-4; poses t0..t1 free. Only patch centers enter the normal equations.
All edges of a lattice cell share a pose pair, so linearization and
assembly run per cell. A failed Cholesky zeroes the update
(the reference skips it, Ramp_vo.py:302-306) without leaving the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..lie import ops as lops


def _center_jacobians(X1, tij, fx, fy):
    """Analytic Jacobians at transformed homogeneous points X1 [E, 4] with
    relative translations tij [E, 3]: Jj [E, 2, 6], Jz [E, 2] and the
    projection without the principal point [E, 2] (ba_cuda.cu:316-338)."""
    X, Y, Z, W = X1.unbind(-1)
    o = torch.zeros_like(Z)
    d = 1.0 / torch.clamp(Z, min=0.1)
    d2 = d * d
    Jj = torch.stack(
        [
            fx * W * d, o, -fx * X * W * d2, -fx * X * Y * d2,
            fx * (1 + X * X * d2), -fx * Y * d,
            o, fy * W * d, -fy * Y * W * d2, -fy * (1 + Y * Y * d2),
            fy * X * Y * d2, fy * X * d,
        ],
        dim=-1,
    ).reshape(Z.shape + (2, 6))
    Jz = torch.stack(
        [fx * (tij[..., 0] * d - tij[..., 2] * X * d2),
         fy * (tij[..., 1] * d - tij[..., 2] * Y * d2)], dim=-1)
    return Jj, Jz, torch.stack([fx * (X * d), fy * (Y * d)], dim=-1)


def linearize_center_cells(poses, centers, intrinsics, ii_c, jj_c, Mp: int):
    """Linearize lattice-ordered patch centers with one shared camera.

    poses [Np, 7]; centers [E, 3] (x, y, inverse depth); intrinsics [4];
    ii_c/jj_c [NC] cell frame indices (clamped into poses). Returns coords
    [E, 2], Z [E], Ji, Jj [E, 2, 6], Jz [E, 2]."""
    E = centers.shape[0]
    NC = E // Mp
    Np = poses.shape[0]
    Gi = poses[ii_c.clamp(0, Np - 1)]
    Gj = poses[jj_c.clamp(0, Np - 1)]
    Gij = lops.se3_mul(Gj, lops.se3_inv(Gi))                  # [NC, 7]
    fx, fy, cx, cy = intrinsics.unbind(-1)
    X0 = torch.stack(
        [(centers[:, 0] - cx) / fx, (centers[:, 1] - cy) / fy,
         torch.ones_like(centers[:, 2]), centers[:, 2]], dim=-1)
    X1 = lops.se3_act4(Gij[:, None, :], X0.reshape(NC, Mp, 4)).reshape(E, 4)
    tij = Gij[:, None, :3].expand(NC, Mp, 3).reshape(E, 3)
    Jj, Jz, xy = _center_jacobians(X1, tij, fx, fy)
    coords = xy + torch.stack([cx, cy])[None]
    # Ji = -AdjT(Gij) Jj-rows, AdjT = [[R^T, 0], [-R^T [t]x, R^T]] per cell
    Rt = lops.quat_to_matrix(Gij[:, 3:7]).transpose(-1, -2)
    tx = lops.hat_so3(Gij[:, :3])
    Z3 = torch.zeros_like(Rt)
    adjT = torch.cat([torch.cat([Rt, Z3], -1),
                      torch.cat([-(Rt @ tx), Rt], -1)], -2)   # [NC, 6, 6]
    Ji = -torch.einsum("cab,cmb->cma", adjT,
                       Jj.reshape(NC, Mp * 2, 6)).reshape(E, 2, 6)
    return coords, X1[:, 2], Ji, Jj, Jz


def _solve_schur(B, E, C, v, u, lmbda, ep, lm, n_dyn: int):
    """Damped Schur-complement solve. B [6N, 6N], E [6N, M], C [M], v [6N],
    u [M]; slots >= n_dyn are inert. Returns dX [N, 6], dZ [M]."""
    N = E.shape[0] // 6
    Q = 1.0 / (C + lmbda)
    EQ = E * Q[None, :]
    S = B - EQ @ E.t()
    y = v - EQ @ u
    diag = torch.diagonal(S)
    S = S + torch.diag(lm * diag + ep)
    live6 = (torch.arange(6 * N, device=B.device) < 6 * n_dyn)
    mask2d = live6[:, None] & live6[None, :]
    eye = torch.eye(6 * N, dtype=S.dtype, device=S.device)
    S = torch.where(mask2d, S, eye)
    y = torch.where(live6, y, torch.zeros_like(y))
    L, info = torch.linalg.cholesky_ex(S)
    ok = (info == 0) & torch.isfinite(L).all()
    L_safe = torch.where(ok, L, eye)
    dX = torch.cholesky_solve(y[:, None], L_safe)[:, 0]
    dX = torch.where(ok, dX, torch.zeros_like(dX))
    dZ = torch.where(ok, Q * (u - E.t() @ dX), torch.zeros_like(u))
    return dX.reshape(N, 6), dZ


def _assemble_cellwise(r, w, Ji, Jj, Jz, i_slot, j_slot, N: int, M: int,
                       lattice, win_rows):
    """Normal equations from lattice-ordered edges: per-cell pose-pair
    blocks placed by one-hots (dump slot N for fixed/inert poses), per-patch
    sums along the lattice t axis gathered through the window rows.
    Returns B [6N, 6N], E [6N, M], C [M], v [6N], u [M], touched [M]."""
    NI, T, Mp = lattice
    NC = NI * T
    Np1 = N + 1
    Jc = torch.cat([Ji, Jj], dim=-1).reshape(NC, Mp * 2, 12)
    wc = w.reshape(NC, Mp * 2, 1)
    rc = r.reshape(NC, Mp * 2)
    wJ = wc * Jc
    Bc = torch.einsum("cka,ckb->cab", wJ, Jc)                 # [NC, 12, 12]
    vc = torch.einsum("ck,cka->ca", wc[..., 0] * rc, Jc)      # [NC, 12]

    def onehot(s):
        s = torch.where((s >= 0) & (s < N), s, torch.full_like(s, N))
        return F.one_hot(s.long(), Np1).to(r.dtype)

    si = i_slot.reshape(NC, Mp)[:, 0]
    sj = j_slot.reshape(NC, Mp)[:, 0]
    oh_i, oh_j = onehot(si), onehot(sj)
    ohP = torch.stack([oh_i, oh_j], dim=1)                    # [NC, 2, Np1]
    B_full = torch.einsum("cup,cuxvy,cvq->pxqy", ohP,
                          Bc.reshape(NC, 2, 6, 2, 6), ohP).reshape(
                              Np1 * 6, Np1 * 6)
    v_full = torch.einsum("cup,cux->px", ohP,
                          vc.reshape(NC, 2, 6)).reshape(Np1 * 6)

    wJz = w * Jz
    Ck = (wJz * Jz).sum(-1).reshape(NI, T, Mp).sum(1)
    uk = (wJz * r).sum(-1).reshape(NI, T, Mp).sum(1)
    tk = w.sum(-1).reshape(NI, T, Mp).sum(1)
    Erow = (wJ * Jz.reshape(NC, Mp * 2, 1)).reshape(NI, T, Mp, 2, 12).sum(3)
    Ei_row = Erow[..., :6].sum(1)                             # [NI, Mp, 6]
    Ejp = torch.einsum("rtmx,rtp->prmx", Erow[..., 6:],
                       oh_j.reshape(NI, T, Np1))
    # a row's host slot is t-constant; sanitized-invalid cells carry
    # si = -t0, so the max over t recovers it (all-invalid rows -> dump)
    si_row = si.reshape(NI, T).amax(dim=1)
    Efull = Ejp + torch.einsum("rmx,rp->prmx", Ei_row, onehot(si_row))

    ok = win_rows >= 0
    rows = win_rows.clamp(0, NI - 1)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    Emat4 = torch.where(ok[None, :, None, None], Efull[:, rows], zero)
    Emat = Emat4.permute(0, 3, 1, 2).reshape(Np1 * 6, M)[: 6 * N]
    C = torch.where(ok[:, None], Ck[rows], zero).reshape(M)
    u = torch.where(ok[:, None], uk[rows], zero).reshape(M)
    touched = torch.where(ok[:, None], tk[rows], zero).reshape(M) > 0
    return B_full[: 6 * N, : 6 * N], Emat, C, v_full[: 6 * N], u, touched


def ba_infer(poses, cwin, intrinsics, targets, weights, lmbda, ii, jj, kk,
             t0: int, t1: int, *, N: int, M: int, lattice, win_rows,
             iterations: int = 2, valid=None):
    """Inference GN BA over lattice-ordered edges.

    poses [Np, 7] (window); cwin [M, 3] patch centers (x, y, inverse depth);
    intrinsics [4]; targets, weights [E, 2]; ii/jj [E] window frame indices;
    kk [E] patch slots (clamped into [0, M)); t0/t1 host ints, poses
    [t0, t1) free; lattice (NI, T, Mp); win_rows [M // Mp] lattice row of
    each window frame (-1). Returns (poses', inverse depths [M])."""
    fx, fy, cx, cy = intrinsics.unbind(-1)
    n_dyn = t1 - t0
    Mp = lattice[2]
    ii_c = ii.reshape(-1, Mp)[:, 0]
    jj_c = jj.reshape(-1, Mp)[:, 0]
    kk = kk.long().clamp(0, M - 1)
    i_slot = ii - t0
    j_slot = jj - t0
    nup = max(0, min(n_dyn, N, poses.shape[0] - t0))  # retracted slots
    for _ in range(iterations):
        centers = cwin[kk]
        coords, Z, Ji, Jj, Jz = linearize_center_cells(
            poses, centers, intrinsics, ii_c, jj_c, Mp)
        r = targets - coords
        gate = ((torch.linalg.norm(r, dim=-1) < 128.0) & (Z > 0.2)
                & (coords[:, 0] > -64.0) & (coords[:, 1] > -64.0)
                & (coords[:, 0] < 2 * cx + 64.0)
                & (coords[:, 1] < 2 * cy + 64.0))
        if valid is not None:
            gate = gate & valid
        w = torch.where(gate[:, None], weights, torch.zeros_like(weights))
        rg = torch.where(gate[:, None], r, torch.zeros_like(r))
        Bm, Em, C, v, u, touched = _assemble_cellwise(
            rg, w, Ji, Jj, Jz, i_slot, j_slot, N, M, lattice, win_rows)
        dX, dZ = _solve_schur(Bm, Em, C, v, u, lmbda, 1.0, 1e-4, n_dyn)
        if nup > 0:
            poses = poses.clone()
            poses[t0:t0 + nup] = lops.se3_retr(poses[t0:t0 + nup], dX[:nup])
        d = cwin[:, 2] + dZ
        d = torch.where(d > 20.0, torch.ones_like(d), d)
        d = torch.clamp(d, min=1e-4)
        d = torch.where(touched, d, cwin[:, 2])
        cwin = torch.cat([cwin[:, :2], d[:, None]], dim=1)
    return poses, cwin[:, 2]
