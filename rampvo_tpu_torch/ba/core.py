"""Gauss-Newton bundle adjustment (port of rampvo_tpu/ba/core.py): the
lattice path of `ba_infer` for inference and the differentiable `ba_train`
for training.

`ba_infer` (reference fastba ba_cuda.cu:232-376,430-576):
Gates ||r|| < 128 px, Z > 0.2, center within 64 px of the image; damping
S_kk += 1e-4 S_kk + 1; depth retraction with reset d > 20 -> 1 and floor
1e-4; poses t0..t1 free. Only patch centers enter the normal equations.
All edges of a lattice cell share a pose pair, so linearization and
assembly run per cell. A failed Cholesky zeroes the update
(the reference skips it, Ramp_vo.py:302-306) without leaving the device.

`ba_train` (reference ramp/ba.py:86-182): one differentiable GN step over
a flat edge list; gates ||r|| < 250 px, Z > 0.2 and the bounds; damping
S_kk += 1e-4 S_kk + ep; depth clamp [1e-3, 10]; poses from `fixedp` on
free, or none with `structure_only`.
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


def linearize_center(poses, centers, intr_i, intr_j, ii, jj):
    """Linearize the reprojection of patch centers over a flat edge list.
    poses [Np, 7]; centers [E, 3] (x, y, inverse depth) in frame ii;
    intr_i/intr_j [E, 4]. Returns coords [E, 2], Z [E], Ji, Jj [E, 2, 6],
    Jz [E, 2]. Frame indices are clamped into poses (inert edges must not
    read garbage)."""
    Np = poses.shape[0]
    Gi = poses[ii.long().clamp(0, Np - 1)]
    Gj = poses[jj.long().clamp(0, Np - 1)]
    Gij = lops.se3_mul(Gj, lops.se3_inv(Gi))
    fx_i, fy_i, cx_i, cy_i = intr_i.unbind(-1)
    fx_j, fy_j, cx_j, cy_j = intr_j.unbind(-1)
    X0 = torch.stack(
        [(centers[:, 0] - cx_i) / fx_i, (centers[:, 1] - cy_i) / fy_i,
         torch.ones_like(centers[:, 2]), centers[:, 2]], dim=-1)
    X1 = lops.se3_act4(Gij, X0)
    Jj, Jz, xy = _center_jacobians(X1, Gij[:, :3], fx_j, fy_j)
    coords = xy + torch.stack([cx_j, cy_j], dim=-1)
    Ji = -lops.se3_adjT(Gij[:, None, :], Jj)   # -Adj^T_{Gij} Jj
    return coords, X1[:, 2], Ji, Jj, Jz


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


def _solve_schur(B, E, C, v, u, lmbda, ep, lm, n_dyn: int,
                 structure_only: bool = False):
    """Damped Schur-complement solve. B [6N, 6N], E [6N, M], C [M], v [6N],
    u [M]; slots >= n_dyn are inert. With `structure_only` (or no pose)
    only the depths move. Returns dX [N, 6], dZ [M]."""
    N = E.shape[0] // 6
    Q = 1.0 / (C + lmbda)
    if structure_only or N == 0:
        return u.new_zeros((N, 6)), Q * u
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


def _assemble(r, w, Ji, Jj, Jz, i_slot, j_slot, k_slot, N: int, M: int):
    """Dense normal equations of a flat edge list: each edge's Jacobians
    expanded onto the pose-slot axis by one-hots (slot N is the explicit
    dump for fixed and out-of-window poses), the pose Hessian one matmul,
    the per-patch sums one index_add over k_slot (out-of-range patches
    dropped). Returns B [6N, 6N], E [6N, M], C [M], v [6N], u [M],
    touched [M] (ref ba/core.py::_assemble)."""
    E_ = r.shape[0]
    Np1 = N + 1

    def onehot(s):
        s = torch.where((s >= 0) & (s < N), s, torch.full_like(s, N))
        return F.one_hot(s.long(), Np1).to(r.dtype)

    U = (torch.einsum("ea,erx->erax", onehot(i_slot), Ji)
         + torch.einsum("ea,erx->erax", onehot(j_slot), Jj)).reshape(
             E_, 2, Np1 * 6)
    Uw = U * w[..., None]
    U2 = U.reshape(E_ * 2, Np1 * 6)
    Uw2 = Uw.reshape(E_ * 2, Np1 * 6)
    B_full = Uw2.t() @ U2
    v_full = Uw2.t() @ r.reshape(E_ * 2)
    Erow = torch.einsum("erm,er->em", Uw, Jz)
    Ck = (w * Jz * Jz).sum(-1)
    uk = (w * Jz * r).sum(-1)
    feats = torch.cat([Erow, Ck[:, None], uk[:, None],
                       w.sum(-1, keepdim=True)], dim=-1)
    k_ok = (k_slot >= 0) & (k_slot < M)
    feats = torch.where(k_ok[:, None], feats, torch.zeros_like(feats))
    seg = torch.where(k_ok, k_slot, torch.full_like(k_slot, M)).long()
    agg = feats.new_zeros((M + 1, feats.shape[1])).index_add(0, seg, feats)[:M]
    Emat = agg[:, : Np1 * 6].t()[: 6 * N]
    C, u, touched = agg[:, -3], agg[:, -2], agg[:, -1] > 0
    return B_full[: 6 * N, : 6 * N], Emat, C, v_full[: 6 * N], u, touched


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


def ba_train(poses, patches, intrinsics, targets, weights, lmbda, ii, jj, kk,
             bounds, ep: float = 100.0, fixedp: int = 1,
             structure_only: bool = False, valid=None):
    """One differentiable Gauss-Newton step (ref ba/core.py::ba_train,
    ramp/ba.py:86-182), unbatched.

    poses [Nf, 7] (world-to-camera); patches [Np, 3, P, P]; intrinsics
    [Nf, 4]; targets, weights [E, 2]; lmbda scalar; ii/jj [E] frames, kk
    [E] patches; bounds (x0, y0, x1, y1) of the reprojected centers; poses
    [fixedp, Nf) free. Returns (poses', patches')."""
    Nf = poses.shape[0]
    Npatch, P = patches.shape[0], patches.shape[-1]
    N = Nf - fixedp
    iil, jjl, kkl = ii.long(), jj.long(), kk.long()
    centers = patches[kkl, :, P // 2, P // 2]
    coords, Z, Ji, Jj, Jz = linearize_center(
        poses, centers, intrinsics[iil.clamp(0, Nf - 1)],
        intrinsics[jjl.clamp(0, Nf - 1)], iil, jjl)
    r = targets - coords
    gate = ((torch.linalg.norm(r, dim=-1) < 250.0) & (Z > 0.2)
            & (coords[:, 0] > bounds[0]) & (coords[:, 1] > bounds[1])
            & (coords[:, 0] < bounds[2]) & (coords[:, 1] < bounds[3]))
    if valid is not None:
        gate = gate & valid
    w = torch.where(gate[:, None], weights, torch.zeros_like(weights))
    r = torch.where(gate[:, None], r, torch.zeros_like(r))
    Bm, Em, C, v, u, _ = _assemble(r, w, Ji, Jj, Jz, iil - fixedp,
                                   jjl - fixedp, kkl, N, Npatch)
    dX, dZ = _solve_schur(Bm, Em, C, v, u, lmbda, ep, 1e-4, N,
                          structure_only)
    if not structure_only and N > 0:
        poses = torch.cat([poses[:fixedp],
                           lops.se3_retr(poses[fixedp:], dX)], dim=0)
    d = torch.clamp(patches[:, 2] + dZ[:, None, None], 1e-3, 10.0)
    patches = torch.cat([patches[:, :2], d[:, None]], dim=1)
    return poses, patches
