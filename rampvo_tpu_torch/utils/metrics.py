"""Trajectory metrics: ATE (evo-style APE, translation, Umeyama-aligned,
scale-corrected) and per-axis rotation error.

Native implementation of what the reference outsources to `evo`
(ref: evaluate.py:294-307, utils/rotation_error_with_euler.py:107-127);
port of rampvo_tpu/utils/metrics.py.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(
    x: np.ndarray, y: np.ndarray, with_scale: bool = True
):
    """Least-squares similarity transform aligning x -> y.

    x, y: [N, 3] point sets. Returns (R [3,3], t [3], s scalar) such that
    y ≈ s * R @ x + t. (Umeyama, TPAMI 1991 — same algorithm evo uses.)
    """
    mu_x = x.mean(axis=0)
    mu_y = y.mean(axis=0)
    xc = x - mu_x
    yc = y - mu_y
    n = x.shape[0]

    cov = yc.T @ xc / n
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt

    if with_scale:
        var_x = (xc**2).sum() / n
        s = float(np.trace(np.diag(D) @ S) / var_x) if var_x > 0 else 1.0
    else:
        s = 1.0
    t = mu_y - s * R @ mu_x
    return R, t, s


def associate_trajectories(
    ts_ref: np.ndarray, ts_est: np.ndarray, max_diff: float = 0.01
):
    """Nearest-timestamp association (evo sync.associate_trajectories
    semantics). Returns (idx_ref, idx_est)."""
    idx_ref, idx_est = [], []
    j = 0
    order = np.argsort(ts_ref)
    ts_ref_sorted = ts_ref[order]
    for i, t in enumerate(ts_est):
        k = np.searchsorted(ts_ref_sorted, t)
        best, bestd = None, np.inf
        for c in (k - 1, k):
            if 0 <= c < len(ts_ref_sorted):
                d = abs(ts_ref_sorted[c] - t)
                if d < bestd:
                    best, bestd = c, d
        if best is not None and bestd <= max_diff:
            idx_ref.append(order[best])
            idx_est.append(i)
    # drop duplicate ref matches, keep first
    seen = set()
    ir, ie = [], []
    for r, e in zip(idx_ref, idx_est):
        if r not in seen:
            seen.add(r)
            ir.append(r)
            ie.append(e)
    return np.asarray(ir, int), np.asarray(ie, int)


def ate_rmse(
    est_xyz: np.ndarray,
    ref_xyz: np.ndarray,
    align: bool = True,
    correct_scale: bool = True,
) -> float:
    """ATE RMSE over the translation part after (scaled) Umeyama alignment
    (ref metric: evaluate.py:296-304)."""
    if align:
        R, t, s = umeyama_alignment(est_xyz, ref_xyz, with_scale=correct_scale)
        est_xyz = (s * (R @ est_xyz.T)).T + t
    err = np.linalg.norm(est_xyz - ref_xyz, axis=1)
    return float(np.sqrt((err**2).mean()))


def _quat_to_euler_xyz(q_xyzw: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation as R

    return R.from_quat(q_xyzw).as_euler("xyz")


def rot_error_per_axis(
    est_q_xyzw: np.ndarray, ref_q_xyzw: np.ndarray, correct_scale: bool = True
) -> np.ndarray:
    """Per-axis rotation error in degrees after Umeyama alignment of the
    Euler-angle point sets (mirrors the reference's unusual construction,
    utils/rotation_error_with_euler.py:107-127)."""
    ang_est = _quat_to_euler_xyz(est_q_xyzw)
    ang_ref = _quat_to_euler_xyz(ref_q_xyzw)

    R, t, s = umeyama_alignment(ang_est, ang_ref, with_scale=correct_scale)
    ang_est = (s * (R @ ang_est.T)).T + t

    err = (ang_est - ang_ref + np.pi) % (2 * np.pi) - np.pi
    return np.rad2deg(np.mean(np.abs(err), axis=0))

