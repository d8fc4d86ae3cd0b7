"""Pose prediction of rampvo_tpu_torch (vo/pose_prediction.py, the flat
`ba_infer`, the oracle hook, `cli.evaluate.run_pose_pred`) against
rampvo_tpu on the CPU at 64x96, M=8, float32.

Tolerances: the track bookkeeping (forward edges, tracks, spline keys and
masks) exact; spline outputs and the motion bootstrap 1e-6; the flat BA
1e-4 (float32 sums in another order); VO poses 1e-4, as the slice tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import synthetic
from rampvo_tpu.ba import ba_infer as j_ba_infer
from rampvo_tpu.cli import eval_utils as jeu
from rampvo_tpu.cli import evaluate as jev
from rampvo_tpu.lie import ops as jl
from rampvo_tpu.vo import RampVO as JRampVO
from rampvo_tpu.vo import VOConfig as JVOConfig
from rampvo_tpu.vo import pose_prediction as jpp
from rampvo_tpu.vo.runtime import make_vo_frame as j_make_vo_frame
from rampvo_tpu_torch.ba.core import ba_infer as p_ba_infer
from rampvo_tpu_torch.cli import eval_utils as peu
from rampvo_tpu_torch.cli import evaluate as pev
from rampvo_tpu_torch.lie import ops as pl
from rampvo_tpu_torch.vo import RampVO, VOConfig
from rampvo_tpu_torch.vo import pose_prediction as ppp
from rampvo_tpu_torch.vo.runtime import make_vo_frame
from test_pose_pred import _make_oracle
from test_torch_slice import (  # noqa: F401  (fixtures)
    KW,
    _torch_threads,
    assert_same_bookkeeping,
    max_diff,
    rand_d,
    weights,
)

H, W = 64, 96
M = KW["PATCHES_PER_FRAME"]
ONE = np.ones(1, dtype=bool)


def _poses(rng, n, scale=0.1):
    return np.asarray(jl.se3_exp(jnp.asarray(scale * rng.randn(n, 6),
                                             jnp.float32)))


def test_motion_bootstrap():
    """Damped-linear extrapolation within 1e-6 of the JAX one."""
    p = _poses(np.random.RandomState(0), 8)
    for a, b in ((0, 1), (2, 3), (4, 4), (6, 7)):
        np.testing.assert_allclose(ppp.motion_bootstrap(p[a], p[b], 0.5),
                                   jpp.motion_bootstrap(p[a], p[b], 0.5),
                                   atol=1e-6)


def track_graph(seed=0, n=7, Mp=3, r=3, H=60, W=80):
    """A lattice-like edge set of n frames with Mp patches each (patch k of
    host i = k // Mp sees frames i-r+1 .. i+r-1) and the patches' smooth
    pixel tracks [E, 3, 3, 2], some leaving the image."""
    rng = np.random.RandomState(seed)
    start = rng.rand(n * Mp, 2) * [W, H]
    vel = rng.randn(n * Mp, 2) * 6.0
    start[::4] = [-40.0, -30.0]          # these tracks stay out of view
    vel[::4] = 1.0
    ii, jj, kk = [], [], []
    for k in range(n * Mp):
        i = k // Mp
        for j in range(max(i - r + 1, 0), min(i + r, n)):
            ii.append(i), jj.append(j), kk.append(k)
    ii, jj, kk = (np.asarray(a, np.int64) for a in (ii, jj, kk))
    c = start[kk] + vel[kk] * (jj - ii)[:, None] + rng.randn(len(kk), 2)
    grid = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], indexing="ij"), -1)
    coords = (c[:, None, None, :] + grid[None]).astype(np.float32)
    weights = rng.rand(len(kk), 2).astype(np.float32)
    return ii, jj, kk, coords, weights


def test_track_bookkeeping_and_splines():
    """add_forward_elements, compute_patch_tracks, fit_track_models and
    predict_patch_targets on the same graph: edges and tracks exact,
    spline models with the same keys, masks and last times, and their
    predictions and the rewritten targets within 1e-6."""
    cfg = VOConfig(PATCHES_PER_FRAME=3, PATCH_LIFETIME=3)
    jcfg = JVOConfig(PATCHES_PER_FRAME=3, PATCH_LIFETIME=3)
    ii, jj, kk, coords, w = track_graph()
    n = 7
    out_p = ppp.add_forward_elements(cfg, n + 1, ii, jj, kk, w)
    out_j = jpp.add_forward_elements(jcfg, n + 1, ii, jj, kk, w)
    for a, b in zip(out_p, out_j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ii2, jj2, kk2, w2 = out_p
    rng = np.random.RandomState(1)
    extra = len(ii2) - len(ii)
    coords2 = np.concatenate(
        [coords, (rng.rand(extra, 3, 3, 2) * 60).astype(np.float32)])
    tp = ppp.compute_patch_tracks(coords2, ii2, jj2, kk2, n)
    tj = jpp.compute_patch_tracks(coords2, ii2, jj2, kk2, n)
    assert tp.keys() == tj.keys() and len(tp) == extra
    for k in tj:
        np.testing.assert_array_equal(tp[k], tj[k])
    tstamps = np.arange(64) * 2
    for deg in (2, 4):
        mp = ppp.fit_track_models(tp, tstamps, n, ii2, jj2, (60, 80), 30.0,
                                  deg)
        mj = jpp.fit_track_models(tj, tstamps, n, ii2, jj2, (60, 80), 30.0,
                                  deg)
        assert mp.keys() == mj.keys() and len(mp) > 0
        masks = {mj[k][2] for k in mj}
        assert masks == {0.0, 1e-9}, masks      # some tracks left the image
        ts = np.linspace(0.0, 1.0, 7)
        for k in mj:
            assert mp[k][2:] == mj[k][2:]
            for a, b in zip(mp[k][:2], mj[k][:2]):
                np.testing.assert_allclose(a(ts), b(ts), atol=1e-6)
        cp, wp = ppp.predict_patch_targets(mp, 2, 30.0, n, coords2.copy(),
                                           w2.copy(), ii2, jj2, kk2)
        cj, wj = jpp.predict_patch_targets(mj, 2, 30.0, n, coords2.copy(),
                                           w2.copy(), ii2, jj2, kk2)
        np.testing.assert_allclose(cp, cj, atol=1e-6)
        np.testing.assert_array_equal(wp, wj)


def test_flat_ba_infer_vs_jax():
    """ba_infer(lattice=None) against the JAX flat ba_infer on a seeded
    graph of 8 poses (0 fixed, then 1..7 free), 20 patches and 90 edges,
    two of them with patch slots past the window (dropped by the
    assembly): poses and inverse depths within 1e-4."""
    rng = np.random.RandomState(3)
    Np, Mw, E = 8, 20, 90
    poses = _poses(rng, Np, 0.02)
    intr = np.array([50.0, 50.0, 48.0, 32.0], np.float32)
    cwin = np.stack([rng.rand(Mw) * 90 + 3, rng.rand(Mw) * 60 + 2,
                     0.3 + 0.7 * rng.rand(Mw)], -1).astype(np.float32)
    ii = rng.randint(0, Np, E)
    jj = (ii + rng.randint(1, Np, E)) % Np
    kk = rng.randint(0, Mw, E)
    kk[:2] = Mw + 1
    targets = (cwin[np.minimum(kk, Mw - 1), :2]
               + rng.randn(E, 2) * 2).astype(np.float32)
    wts = rng.rand(E, 2).astype(np.float32)
    for t0, t1, N in ((1, 8, 8), (3, 8, 5), (1, 5, 6)):
        want = j_ba_infer(jnp.asarray(poses), jnp.asarray(cwin),
                          jnp.asarray(intr), jnp.asarray(targets),
                          jnp.asarray(wts), jnp.float32(1e-4),
                          jnp.asarray(ii, jnp.int32),
                          jnp.asarray(jj, jnp.int32),
                          jnp.asarray(kk, jnp.int32), jnp.int32(t0),
                          jnp.int32(t1), N=N, M=Mw, iterations=2)
        got = p_ba_infer(torch.tensor(poses), torch.tensor(cwin),
                         torch.tensor(intr), torch.tensor(targets),
                         torch.tensor(wts), 1e-4, torch.tensor(ii),
                         torch.tensor(jj), torch.tensor(kk), t0, t1, N=N,
                         M=Mw, iterations=2)
        moved = np.abs(np.asarray(want[0]) - poses).max()
        assert moved > 1e-3, (t0, t1)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def _port_oracle(gt_w2c):
    """The JAX test's ground-truth oracle (tests/test_pose_pred.py) on the
    port's state: exact targets of each edge's patch center from the true
    poses and disparity field."""
    gt = torch.tensor(gt_w2c, dtype=torch.float32)

    def oracle(state, ii, jj, kk, coords):
        L, F = state.l2g.shape[0], state.poses.shape[0]
        gi = state.l2g[ii.clamp(0, L - 1)]
        gj = state.l2g[jj.clamp(0, L - 1)]
        rows = (state.l2g[torch.div(kk, M, rounding_mode="floor").clamp(
            0, L - 1)] * M + kk % M).clamp(0, F * M - 1)
        x = state.pat_cx.reshape(-1)[rows]
        y = state.pat_cy.reshape(-1)[rows]
        fx, fy, cx, cy = state.intrinsics.unbind(-1)
        d = 0.35 + 0.2 * torch.sin(x / 6.0) * torch.cos(y / 5.0)
        X0 = torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(x),
                          d], -1)
        gmax = gt.shape[0] - 1
        Gij = pl.se3_mul(gt[gj.clamp(0, gmax)],
                         pl.se3_inv(gt[gi.clamp(0, gmax)]))
        X1 = pl.se3_act4(Gij, X0)
        Z = torch.clamp(X1[:, 2], min=0.1)
        target = torch.stack([fx * X1[:, 0] / Z + cx, fy * X1[:, 1] / Z + cy],
                             -1)
        return target - coords[:, 1, 1, :], torch.ones_like(target)

    return oracle


def test_pose_prediction_slice_vs_jax(weights):
    """Both VOs driven by the same ground-truth oracle over 12 frames of
    the synthetic curved trajectory (same weights, events and depth
    draws; never evicting), then predict_future_pose for a 3-step horizon
    (deg 2, 1 Hz as the JAX test): bookkeeping identical at every frame
    and after each prediction, poses within 1e-4, the predicted poses and
    terminate()'s trajectories within 1e-4."""
    params, net = weights
    n_frames, horizon = 12, 3
    images, poses_c2w, intr = synthetic.render_sequence(
        n_frames + horizon, H, W, motion="curve")
    gt_w2c = np.asarray(jl.se3_inv(jnp.asarray(poses_c2w, jnp.float32)))
    kw = dict(KW, KEYFRAME_THRESH=0.0)
    jcfg = JVOConfig(**kw)
    jvo = JRampVO(jcfg, params, ht=H, wd=W)
    jvo._vo_frame = j_make_vo_frame(jcfg, jvo.vonet,
                                    oracle=_make_oracle(jnp.asarray(gt_w2c),
                                                        M))
    pvo = RampVO(VOConfig(**kw), net, ht=H, wd=W, device="cpu")
    pvo._vo_frame = make_vo_frame(pvo.cfg, pvo.vonet, "cpu",
                                  oracle=_port_oracle(gt_w2c))
    rng = np.random.RandomState(0)
    for t in range(n_frames):
        ev = rng.rand(1, H, W, 5).astype(np.float32)
        im = (images[t][None, :, :, None].repeat(3, -1) / 255.0).astype(
            np.float32)
        rd = rand_d(jvo.state, M)
        jvo(t, jnp.asarray(ev), jnp.asarray(im), ONE, intr)
        pvo(t, ev, im, ONE, intr, rand_d=rd)
        assert_same_bookkeeping(jvo.state, pvo.state, t)
        assert max_diff(jvo.state, pvo.state, "poses") < 1e-4, t
    assert pvo.state.initialized and pvo.state.n == n_frames
    for k in range(1, horizon + 1):
        kw_pp = dict(sec_to_pred_future=k, abs_time=n_frames - 1 + k,
                     last_keyframe_number=n_frames, deg=2, frequency=1.0)
        pj = jvo.predict_future_pose(**kw_pp)
        pp = pvo.predict_future_pose(**kw_pp)
        np.testing.assert_allclose(pp, pj, atol=1e-4)
        assert_same_bookkeeping(jvo.state, pvo.state, f"predict {k}")
        assert max_diff(jvo.state, pvo.state, "poses") < 1e-4, k
    assert pvo._pp_models and pvo._pp_models.keys() == jvo._pp_models.keys()
    (ta, sa), (tb, sb) = jvo.terminate(), pvo.terminate()
    assert tb.shape == ta.shape == (n_frames + horizon, 7)
    np.testing.assert_array_equal(sb, sa)
    np.testing.assert_allclose(tb, ta, atol=1e-4)


def scene(n=24, seed=0):
    """An in-memory scene in the loader's format at 64x96 (the synthetic
    line trajectory's images, random events) and its reference
    trajectories for both packages."""
    images, poses_c2w, intr = synthetic.render_sequence(n, H, W, seed=seed)
    rng = np.random.RandomState(seed)
    data = [{"events": rng.rand(1, H, W, 5).astype(np.float32),
             "image": (2 * images[t][None, :, :, None].repeat(3, -1) / 255.0
                       - 0.5).astype(np.float32),
             "mask": ONE, "intrinsics": intr} for t in range(n)]
    stamps = 0.1 * np.arange(n)
    refs = [m.traj_from_xyzw(poses_c2w[:, :3], poses_c2w[:, 3:], stamps)
            for m in (jeu, peu)]
    return data, refs, stamps


EVAL = {"data_loader": {"train": {"args": {
    "input_mode": "MultiScale", "event_bias": True, "num_event_bins": 5}}}}


class DrawsRampVO(RampVO):
    """The port's RampVO fed the JAX driver's pre-initialization depths
    (its state key PRNGKey(0) split once per committed frame)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        rng, self.draws = jax.random.PRNGKey(0), []
        for _ in range(64):
            rng, k1 = jax.random.split(rng)
            self.draws.append(torch.tensor(np.asarray(
                jax.random.uniform(k1, (M,)))))

    def __call__(self, tstamp, events, image, mask, intrinsics):
        super().__call__(tstamp, events, image, mask, intrinsics,
                         rand_d=self.draws.pop(0))


def test_run_pose_pred_vs_jax(weights, monkeypatch):
    """evaluate_sequence(use_pose_pred=True) on a 24-frame scene in both
    packages: the VO runs 12 frames, is refined, predicts 12 more frames,
    is refined again; the trajectory holds 24 poses; ATE, rotation errors
    and the trajectory within 1e-4 of the JAX run (same weights and depth
    draws)."""
    params, net = weights
    cfg_kw = dict(KW, KEYFRAME_THRESH=0.0)
    data, (jref, pref), stamps = scene()
    ja, jr, jt, _, _ = jev.evaluate_sequence(
        JVOConfig(**cfg_kw), params, EVAL, data, jref, stamps,
        use_pose_pred=True)
    monkeypatch.setattr(pev, "RampVO", DrawsRampVO)
    pa, pr, pt, _, (pts, _) = pev.evaluate_sequence(
        VOConfig(**cfg_kw), net, EVAL, data, pref, stamps,
        use_pose_pred=True, device="cpu")
    assert pt.positions_xyz.shape == jt.positions_xyz.shape == (24, 3)
    assert pts.shape == (24, 3)
    assert np.isfinite(pa) and pa != 1000.0
    np.testing.assert_allclose(pa, ja, atol=1e-4)
    np.testing.assert_allclose(pr, jr, atol=1e-4)
    np.testing.assert_allclose(pt.positions_xyz, jt.positions_xyz, atol=1e-4)
    np.testing.assert_array_equal(pt.timestamps, jt.timestamps)
