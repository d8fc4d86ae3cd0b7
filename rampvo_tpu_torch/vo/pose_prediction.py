"""Future-pose extrapolation by per-patch-track splines (port of
rampvo_tpu/vo/pose_prediction.py; ref ramp/pose_prediction/
pose_pred_utils.py, Ramp_vo.py:446-525).

The optional mode `use_pose_pred` of config_net (evaluate.py:266-279): a
virtual keyframe is appended, every live patch gets an edge to it, its
patch positions there are extrapolated by per-track UnivariateSplines over
the last 5 observations, and one flat BA solve on the extended graph gives
the future pose. The tracks and splines are host numpy and scipy, as in
the reference; the reprojection (`transform_edges`) and the BA run on the
state's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ba.core import ba_infer
from ..geometry.projective import transform_edges
from ..lie import ops as lops
from .config import VOConfig
from .runtime import _patches_rows
from .state import VOState, edge_table

PAST_PATCH_NUM = 5  # ref: pose_pred_utils.py:236


def motion_bootstrap(poses_n1, poses_n2, damping=0.5):
    """Damped-linear extrapolation from the last two poses [7] (numpy,
    float32; ref pose_pred_utils.py:189-198)."""
    P1 = torch.tensor(np.asarray(poses_n1, np.float32))[None]
    P2 = torch.tensor(np.asarray(poses_n2, np.float32))[None]
    xi = damping * lops.se3_log(lops.se3_mul(P1, lops.se3_inv(P2)))
    return lops.se3_mul(lops.se3_exp(xi), P1)[0].numpy()


def add_forward_elements(cfg: VOConfig, n, ii, jj, kk, weights):
    """Edges from every live patch to the virtual frame `n`
    (ref: pose_pred_utils.py:201-214). Inputs are numpy arrays of the VALID
    edges only."""
    M, r = cfg.M, cfg.PATCH_LIFETIME
    t0 = M * max(n - r, 0)
    t1 = M * max(n - 1, 0)
    kk_add = np.arange(t0, t1, dtype=np.int32)
    jj_add = np.full_like(kk_add, n - 1)
    ii_add = kk_add // M

    ii2 = np.concatenate([ii, ii_add])
    jj2 = np.concatenate([jj, jj_add])
    kk2 = np.concatenate([kk, kk_add])
    w2 = np.concatenate([weights, np.zeros((len(kk_add), 2), np.float32)])
    return ii2, jj2, kk2, w2


def compute_patch_tracks(coords, ii, jj, kk, image_to_proj):
    """(start_frame, patch_id) -> [n_obs, 2] track of center-pixel coords
    (ref: pose_pred_utils.py:168-186)."""
    tracks = {}
    sel = jj == image_to_proj
    for s, p in zip(ii[sel], kk[sel]):
        key = (int(s), int(p))
        if key in tracks:
            continue
        mask = (ii == key[0]) & (kk == key[1])
        if not mask.any():
            continue
        tracks[key] = coords[mask][:, 0, 0, :]
    return tracks


def fit_track_models(tracks, tstamps, next_frame_index, ii, jj, data_shape,
                     frequency=30.0, deg=4):
    """Per-track spline models (ref: pose_pred_utils.py:278-317)."""
    from scipy.interpolate import UnivariateSpline

    height, width = data_shape
    models = {}
    for (start_image, patch_id), track in tracks.items():
        first = int(jj[ii == start_image].min())
        xy = track[:-1]  # drop the virtual-frame reprojection
        t = np.asarray(tstamps[first:next_frame_index], float) / frequency
        m = min(len(xy), len(t))
        if m < 2:
            continue
        x, y = xy[:m, 0], xy[:m, 1]
        t = t[:m]

        inb = (x >= 0) & (x < width) & (y >= 0) & (y < height)
        masked_weight = 0.0 if np.all(~inb[-PAST_PATCH_NUM:]) else 1e-9

        x_, y_, t_ = (a[-PAST_PATCH_NUM:] for a in (x, y, t))
        if len(t_) < 2 or t_[-1] == t_[0]:
            continue
        w = (t_ - t_[0]) / (t_[-1] - t_[0]) + 1e-7
        k = min(deg, len(t_) - 1)
        spl_x = UnivariateSpline(t_, x_, w=w, k=k, ext=0, check_finite=False)
        spl_y = UnivariateSpline(t_, y_, w=w, k=k, ext=0, check_finite=False)
        models[(start_image, patch_id)] = (spl_x, spl_y, masked_weight, t_[-1])
    return models


def predict_patch_targets(models, step_to_pred_future, frequency,
                          next_frame_index, coords, weights, ii, jj, kk):
    """Rewrite virtual-frame targets/weights from the spline predictions
    (ref: pose_pred_utils.py:320-346). In-place on numpy copies."""
    for (start_image, patch_id), (sx, sy, mw, t_last) in models.items():
        t_new = t_last + step_to_pred_future / frequency
        nx, ny = float(sx(t_new)), float(sy(t_new))
        gx = np.arange(nx - 1, nx + 2)[:3]
        gy = np.arange(ny - 1, ny + 2)[:3]
        cols, rows = np.meshgrid(gx, gy, indexing="ij")

        edge_mask = (ii == start_image) & (kk == patch_id) & \
            (jj == next_frame_index)
        coords[edge_mask] = np.stack([rows, cols], axis=-1)[None]
        weights[edge_mask] = mw
    return coords, weights


def predict_future_pose(slam, sec_to_pred_future, abs_time,
                        last_keyframe_number, deg=4, frequency=30.0):
    """Extend the graph with a virtual frame, spline-predict its patch
    targets, BA, and append the pose (ref: Ramp_vo.py:446-525).

    `slam` is a flushed vo.RampVO; its trajectory state is updated in
    place: the virtual pose takes global row `counter` and logical frame
    `n`, and n and counter (read once on the host, whether host ints or
    0-d tensors) advance as host ints, so `terminate()` returns it. Returns
    the pose [7] (world-to-camera, numpy).
    """
    cfg = slam.cfg
    st: VOState = slam.state
    M = cfg.M
    dev = st.poses.device
    n = int(st.n)
    counter = int(st.counter)
    next_frame_index = n  # the virtual frame's logical index

    # ---- host copies of the live graph (flat view of the edge lattice) ----
    ii_a, jj_a, kk_a, valid_a = edge_table(cfg, n, st.cell_valid)
    valid = valid_a.cpu().numpy()
    ii = ii_a.cpu().numpy()[valid]
    jj = jj_a.cpu().numpy()[valid]
    kk = kk_a.cpu().numpy()[valid]
    weights = st.last_weight.reshape(-1, 2).cpu().numpy()[valid]
    l2g = st.l2g.cpu().numpy()
    poses = st.poses.cpu().numpy().copy()  # writable host copy
    FM = st.pat_d.numel()

    # virtual pose: damped-linear bootstrap; virtual frame global row = counter
    g_virtual = counter
    g1, g2 = l2g[n - 1], l2g[max(n - 2, 0)]
    poses[g_virtual] = motion_bootstrap(
        poses[g1], poses[g2], cfg.MOTION_DAMPING
    )
    l2g_ext = l2g.copy()
    l2g_ext[n] = g_virtual

    ii, jj, kk, weights = add_forward_elements(
        cfg, n + 1, ii, jj, kk, weights
    )

    # ---- reproject the extended graph (on the state's device) ----
    def logical_pose(idx):
        return poses[l2g_ext[np.clip(idx, 0, len(l2g_ext) - 1)]]

    def on_dev(a):
        return torch.as_tensor(a, device=dev)

    prow = np.clip(l2g_ext[kk // M] * M + kk % M, 0, FM - 1)
    coords = transform_edges(
        on_dev(logical_pose(ii)), on_dev(logical_pose(jj)),
        _patches_rows(st, on_dev(prow)), st.intrinsics,
    ).cpu().numpy()

    tstamps = l2g_ext  # tstamp id of logical frame == its global id
    if slam._pp_tracks is None:
        slam._pp_tracks = compute_patch_tracks(coords, ii, jj, kk,
                                               next_frame_index)
    if slam._pp_models is None:
        h4, w4 = (4 * int(x) for x in st.hw4)
        slam._pp_models = fit_track_models(
            slam._pp_tracks, tstamps, next_frame_index, ii, jj,
            (h4, w4), frequency, deg,
        )

    target_pp, weights = predict_patch_targets(
        slam._pp_models, sec_to_pred_future, frequency, next_frame_index,
        coords.copy(), weights, ii, jj, kk,
    )
    target = target_pp[:, 1, 1, :]

    # ---- flat BA on the extended window ----
    t1 = n + 1
    t0 = max(t1 - cfg.OPTIMIZATION_WINDOW if st.initialized else 1, 1)
    PW = cfg.POSE_WINDOW
    base = max(t1 - PW, 0)
    win_g = l2g_ext[base:base + PW]
    win_g = np.pad(win_g, (0, PW - len(win_g)), constant_values=0)
    posew = poses[np.clip(win_g, 0, len(poses) - 1)]
    q = np.arange(PW * M)
    prow_w = l2g_ext[np.clip(base + q // M, 0, len(l2g_ext) - 1)] * M + q % M
    cwin = _patches_rows(st, on_dev(np.clip(prow_w, 0, FM - 1)))[:, :, 1, 1]

    posew2, _ = ba_infer(
        on_dev(posew), cwin, st.intrinsics, on_dev(target), on_dev(weights),
        1e-4, on_dev(ii - base), on_dev(jj - base), on_dev(kk - base * M),
        t0 - base, t1 - base, N=cfg.OPTIMIZATION_WINDOW, M=PW * M,
        iterations=2,
    )
    new_pose = posew2[min(n - base, PW - 1)]

    # ---- append the virtual pose to the trajectory (ref: :517-525) ----
    st.poses[g_virtual] = new_pose
    st.l2g[n] = g_virtual
    st.n = n + 1
    st.counter = counter + 1
    slam.tlist.append(abs_time)
    return new_pose.cpu().numpy()
