"""Ground-truth tracking of rampvo_tpu_torch's VO runtime, the port's twin
of tests/test_vo_tracking.py: with ground-truth update targets (an oracle
in place of the correlation and the update network) the whole loop --
edge lattice, BA, keyframing, the terminal updates, terminate() -- must
recover the camera trajectory up to the monocular gauge. Also fault F3:
`make_final_updates(oracle=)` against the JAX builder.

`port_oracle` and `track` need no JAX; chip_smoke.py's tracking phase
runs `track` on the card.
"""

import numpy as np
import pytest
import torch

from rampvo_tpu_torch.data import synthetic
from rampvo_tpu_torch.lie import ops as pl
from rampvo_tpu_torch.models.vonet import VONet, init_weights
from rampvo_tpu_torch.utils import ate_rmse
from rampvo_tpu_torch.vo import RampVO, VOConfig, make_final_updates, \
    make_vo_frame
from rampvo_tpu_torch.vo import runtime

H, W = 60, 80
N_FRAMES = 18
ONE = np.ones(1, dtype=bool)

# (OPTIMIZATION_WINDOW, PATCH_LIFETIME, REMOVAL_WINDOW, terminal updates,
#  KEYFRAME_THRESH, ATE bound as a share of the trajectory's extent)
CASES = {
    # full windows: the solver must recover the trajectory exactly
    "full": (20, 17, 20, 30, 0.0, 1e-3),
    # toy sliding window: early poses freeze before enough evidence
    # arrives; bounded drift is the expected SLAM behaviour
    "sliding": (6, 5, 8, 12, 0.0, 0.2),
    # the toy window with evictions: the keyframe path the JAX test
    # leaves out (removed frames placed through terminate()'s chain)
    "evicting": (6, 5, 8, 12, 1.0, 0.2),
}


def true_disp(x, y):
    """Non-planar synthetic inverse depth: a single plane is degenerate
    (a pose/depth homography family fits any planar target set)."""
    return 0.35 + 0.2 * torch.sin(x / 6.0) * torch.cos(y / 5.0)


def port_oracle(gt_w2c, M):
    """tests/test_vo_tracking.py's oracle on the port's state: the exact
    target of each edge's patch center, reprojected through the true
    world-to-camera poses `gt_w2c` [N, 7] with `true_disp`; weight 1."""
    gt = torch.tensor(np.array(gt_w2c), dtype=torch.float32)

    def oracle(state, ii, jj, kk, coords):
        g = gt.to(coords.device)
        L, F = state.l2g.shape[0], state.poses.shape[0]
        gi = state.l2g[ii.clamp(0, L - 1)]
        gj = state.l2g[jj.clamp(0, L - 1)]
        rows = (state.l2g[torch.div(kk, M, rounding_mode="floor").clamp(
            0, L - 1)] * M + kk % M).clamp(0, F * M - 1)
        x = state.pat_cx.reshape(-1)[rows]
        y = state.pat_cy.reshape(-1)[rows]
        fx, fy, cx, cy = state.intrinsics.unbind(-1)
        X0 = torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(x),
                          true_disp(x, y)], -1)
        gmax = g.shape[0] - 1
        Gij = pl.se3_mul(g[gj.clamp(0, gmax)],
                         pl.se3_inv(g[gi.clamp(0, gmax)]))
        X1 = pl.se3_act4(Gij, X0)
        Z = torch.clamp(X1[:, 2], min=0.1)
        target = torch.stack([fx * X1[:, 0] / Z + cx, fy * X1[:, 1] / Z + cy],
                             -1)
        return target - coords[:, 1, 1, :], torch.ones_like(target)

    return oracle


def tracking_kw(ow, plife, rw, thresh):
    """tests/test_vo_tracking.py's VOConfig fields, with KEYFRAME_THRESH."""
    return dict(
        BUFFER_SIZE=64, MAX_FRAMES=64, PATCHES_PER_FRAME=16,
        REMOVAL_WINDOW=rw, OPTIMIZATION_WINDOW=ow, PATCH_LIFETIME=plife,
        KEYFRAME_INDEX=2, KEYFRAME_THRESH=thresh, MIXED_PRECISION=False,
        PROBE_THRESH=-1.0, MEM=32)


def track(case, device="cpu"):
    """Drive RampVO on `device` with the oracle over the 18 frames of the
    synthetic curved trajectory (random events, images / 255, as the JAX
    test), then the terminal updates with the oracle. Returns a dict:
    the ATE of terminate()'s camera-to-world trajectory over all 18
    frames against the ground truth (scaled Umeyama alignment), the
    trajectory's extent, the bound, n, the evicted frame count and
    whether the state initialized."""
    ow, plife, rw, finals, thresh, tol = CASES[case]
    images, poses_c2w, intr = synthetic.render_sequence(N_FRAMES, H, W,
                                                        motion="curve")
    gt_w2c = pl.se3_inv(torch.tensor(poses_c2w, dtype=torch.float32))
    cfg = VOConfig(**tracking_kw(ow, plife, rw, thresh))
    oracle = port_oracle(gt_w2c, cfg.M)
    net = init_weights(VONet("MultiScale"), torch.Generator().manual_seed(0))
    vo = RampVO(cfg, net, ht=H, wd=W, device=device)
    vo._vo_frame = make_vo_frame(cfg, vo.vonet, device, oracle=oracle)
    rng = np.random.RandomState(0)
    for t in range(N_FRAMES):
        ev = rng.rand(1, H, W, 5).astype(np.float32)
        im = (images[t][None, :, :, None].repeat(3, -1) / 255.0).astype(
            np.float32)
        vo(t, ev, im, ONE, intr)
    make_final_updates(cfg, vo.vonet, iters=finals, oracle=oracle)(vo.state)
    est_c2w, _ = vo.terminate()
    ref = poses_c2w[:, :3].astype(np.float32)
    extent = float(np.linalg.norm(ref.max(0) - ref.min(0)))
    return {"ate": ate_rmse(est_c2w[:, :3], ref), "extent": extent,
            "bound": tol * extent, "n": vo.state.n,
            "evicted": N_FRAMES - vo.state.n,
            "initialized": vo.state.initialized,
            "frames": len(est_c2w)}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", list(CASES))
def test_oracle_targets_recover_trajectory(case):
    """The JAX test's assertions: initialized, every frame kept where
    nothing may be evicted (and at least one evicted where the threshold
    says so), ATE below its share of the trajectory's extent."""
    r = track(case)
    print(f"{case}: oracle-target ATE {r['ate']:.6g} (extent "
          f"{r['extent']:.4f}, bound {r['bound']:.6g}), "
          f"{r['evicted']} evicted")
    assert r["initialized"]
    assert r["frames"] == N_FRAMES
    if CASES[case][4] == 0.0:
        assert r["n"] == N_FRAMES
    else:
        assert 0 < r["evicted"], r
    assert r["ate"] < r["bound"], r


def test_final_updates_oracle_matches_jax(monkeypatch):
    """F3: both packages' VOs driven by the same ground-truth oracle over
    10 frames at 60x80, M=16 (the sliding-window config, never evicting;
    same weights, events and pre-initialization depths), then 6 terminal
    updates `make_final_updates(..., oracle=)` in each: bookkeeping
    identical, poses within 1e-4 (tests/test_torch_pose_pred.py's
    tolerance) before and after, and the terminal updates moved the
    poses. The port's terminal updates run no correlation and no update
    network: both raise here."""
    import jax
    import jax.numpy as jnp

    from rampvo_tpu.lie import ops as jl
    from rampvo_tpu.models import VONet as JVONet
    from rampvo_tpu.vo import RampVO as JRampVO
    from rampvo_tpu.vo import VOConfig as JVOConfig
    from rampvo_tpu.vo.runtime import make_final_updates as j_final
    from rampvo_tpu.vo.runtime import make_vo_frame as j_make_vo_frame
    from rampvo_tpu_torch.ckpt.weights import from_flax_params
    from test_pose_pred import _make_oracle
    from test_torch_slice import assert_same_bookkeeping, max_diff, rand_d

    n_frames, finals = 10, 6
    kw = tracking_kw(*CASES["sliding"][:3], thresh=0.0)
    jcfg, pcfg = JVOConfig(**kw), VOConfig(**kw)
    M = pcfg.M
    images, poses_c2w, intr = synthetic.render_sequence(n_frames, H, W,
                                                        motion="curve")
    gt_w2c = np.asarray(jl.se3_inv(jnp.asarray(poses_c2w, jnp.float32)))
    params = jax.jit(JVONet().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 5)),
        jnp.zeros((1, 16, 16, 3)), jnp.asarray([True]))
    params = jax.tree_util.tree_map(np.asarray, params)
    net = VONet()
    net.load_state_dict(from_flax_params(params))

    j_oracle = _make_oracle(jnp.asarray(gt_w2c), M)
    p_oracle = port_oracle(gt_w2c, M)
    jvo = JRampVO(jcfg, params, ht=H, wd=W)
    jvo._vo_frame = j_make_vo_frame(jcfg, jvo.vonet, oracle=j_oracle)
    pvo = RampVO(pcfg, net, ht=H, wd=W, device="cpu")
    pvo._vo_frame = make_vo_frame(pcfg, pvo.vonet, "cpu", oracle=p_oracle)
    rng = np.random.RandomState(0)
    for t in range(n_frames):
        ev = rng.rand(1, H, W, 5).astype(np.float32)
        im = (images[t][None, :, :, None].repeat(3, -1) / 255.0).astype(
            np.float32)
        rd = rand_d(jvo.state, M)
        jvo(t, jnp.asarray(ev), jnp.asarray(im), ONE, intr)
        pvo(t, ev, im, ONE, intr, rand_d=rd)
    assert pvo.state.initialized and pvo.state.n == n_frames
    assert_same_bookkeeping(jvo.state, pvo.state, "frames")
    assert max_diff(jvo.state, pvo.state, "poses") < 1e-4
    before = pvo.state.poses.clone()

    def refuse(*a, **k):
        raise AssertionError("a terminal update ran the correlation or the "
                             "update network")

    monkeypatch.setattr(runtime, "_edge_corr_ctx_lattice", refuse)
    monkeypatch.setattr(runtime, "make_update_fn", lambda *a, **k: refuse)
    jvo.state = j_final(jcfg, jvo.vonet, iters=finals, oracle=j_oracle)(
        jvo.params, jvo.state)
    make_final_updates(pcfg, pvo.vonet, iters=finals, oracle=p_oracle)(
        pvo.state)
    assert_same_bookkeeping(jvo.state, pvo.state, "finals")
    assert max_diff(jvo.state, pvo.state, "poses") < 1e-4
    assert float((pvo.state.poses - before).abs().max()) > 1e-4
