"""The evaluation CLI of rampvo_tpu_torch against rampvo_tpu on the CPU:
the scene loader (exact), the metrics and pose-format readers, the .pth
loader (exact, against import_pth + from_flax_params), and the CLI end to
end on the synthetic scene in both input modes, through `evaluate()` and
once through `python -m rampvo_tpu_torch.cli.evaluate --device cpu`.
The network is random, so the end-to-end runs check the wiring (scene ->
loader -> VO -> trajectory -> metrics -> result files), not accuracy.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import synthetic
from rampvo_tpu.ckpt.torch_import import import_pth
from rampvo_tpu.cli import eval_utils as jeu
from rampvo_tpu.data.loader import data_loader_all_events as j_loader
from rampvo_tpu_torch.ckpt.weights import from_flax_params, load_pth
from rampvo_tpu_torch.cli import eval_utils as peu
from rampvo_tpu_torch.cli import evaluate as pev
from rampvo_tpu_torch.data.loader import data_loader_all_events as p_loader
from rampvo_tpu_torch.models.vonet import VONet, init_weights
from rampvo_tpu_torch.vo import VOConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["MultiScale", "SingleScale"]
SMALL_VO = dict(BUFFER_SIZE=64, MAX_FRAMES=64, PATCHES_PER_FRAME=8,
                REMOVAL_WINDOW=5, OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3,
                KEYFRAME_INDEX=2, MIXED_PRECISION=False, PROBE_THRESH=-1.0,
                MEM=16)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and torch's default (one thread per core, spinning) oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes") / "P000"
    synthetic.write_scene(str(root), n_frames=10, H=60, W=80)
    return str(root)


def eval_cfg(scene_dir, input_mode="MultiScale"):
    cfg = json.loads(json.dumps(synthetic.EVAL_CFG))
    cfg["data_loader"]["train"]["args"]["input_mode"] = input_mode
    cfg["data_loader"]["test"] = {"test_split": [scene_dir],
                                  "dataset_name": "Synthetic",
                                  "use_pose_pred": False}
    return cfg


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("downsample_fact", [1, 2])
def test_loader_matches_jax(scene, downsample_fact):
    """data_loader_all_events == the JAX loader exactly: event stacks
    (int8), images (float16), masks, intrinsics, frame indices."""
    cfg = eval_cfg(scene)
    intr = (60.0, 60.0, 40.0, 30.0)
    a, fa = j_loader(cfg, scene, downsample_fact, intrinsics=intr)
    b, fb = p_loader(cfg, scene, downsample_fact, intrinsics=intr)
    assert fb == fa and len(b) == len(a) > 0
    assert any(d["mask"][0] for d in b) and not all(d["mask"][0] for d in b)
    for x, y in zip(a, b):
        assert set(y) == set(x)
        for k in ("events", "image", "intrinsics", "mask"):
            assert y[k].dtype == x[k].dtype, k
            np.testing.assert_array_equal(y[k], x[k], err_msg=k)
        assert y["frame_index"] == x["frame_index"]
    assert b[0]["events"].shape == (1, 480, 640, 5)


# ---------------------------------------------------------------------------
# metrics and pose-format readers
# ---------------------------------------------------------------------------

def _poses(rng, n):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([np.cumsum(rng.randn(n, 3) * 0.1, 0), q], 1)


def _traj_equal(a, b):
    for f in ("positions_xyz", "quat_wxyz", "timestamps"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def test_score_matches_jax():
    """est_trajectory + score (association, scaled Umeyama ATE, per-axis
    rotation error) == the JAX package to 1e-6, including the sentinel on
    a trajectory that cannot be associated."""
    rng = np.random.RandomState(0)
    ref_p, est_p = _poses(rng, 30), _poses(rng, 25)
    ts_ref = np.arange(30) * 0.1
    ts_est = np.sort(rng.choice(ts_ref, 25, replace=False)) + 1e-4
    ref_j = jeu.est_trajectory(ref_p, ts_ref)
    ref_p_ = peu.est_trajectory(ref_p, ts_ref)
    _traj_equal(ref_j, ref_p_)
    for ts in (ts_est, ts_est + 5.0):            # the second never matches
        a = jeu.score(ref_j, jeu.est_trajectory(est_p, ts))
        b = peu.score(ref_p_, peu.est_trajectory(est_p, ts))
        np.testing.assert_allclose(b[0], a[0], atol=1e-6)
        np.testing.assert_allclose(b[1], a[1], atol=1e-6)
    assert b == (1000.0, [1000.0] * 3)


def test_pose_readers_match_jax(tmp_path):
    """The four pose-format readers, select_scene_cut and both writers
    give what the JAX package gives on the same files."""
    rng = np.random.RandomState(1)
    p = _poses(rng, 12)
    stamps = np.arange(12) * 1e5
    np.savetxt(tmp_path / "eds.txt", np.concatenate([stamps[:, None], p], 1))
    np.savetxt(tmp_path / "sd.txt", p)
    np.savetxt(tmp_path / "sd_ts.txt", stamps)
    np.savetxt(tmp_path / "tartan.txt", p, delimiter=" ")
    np.savetxt(tmp_path / "tartan_ts.txt", stamps)
    cases = [
        ("read_eds_format_poses", (tmp_path / "eds.txt",)),
        ("read_stereodavis_format_poses",
         (tmp_path / "sd.txt", tmp_path / "sd_ts.txt")),
        ("read_tartan_format_poses",
         (tmp_path / "tartan.txt", tmp_path / "tartan_ts.txt")),
        ("read_moonlanding_format_poses",
         (tmp_path / "tartan.txt", tmp_path / "tartan_ts.txt")),
    ]
    for name, args in cases:
        _traj_equal(getattr(jeu, name)(*args), getattr(peu, name)(*args))
    tj = jeu.read_eds_format_poses(tmp_path / "eds.txt")
    tp = peu.read_eds_format_poses(tmp_path / "eds.txt")
    dl = list(range(300))
    for scene_path in ("x/indoor_flying2", "x/other"):
        (la, ta), (lb, tb) = (jeu.select_scene_cut(dl, tj, scene_path),
                              peu.select_scene_cut(dl, tp, scene_path))
        assert la == lb
        _traj_equal(ta, tb)
    jeu.save_stamped_trajectories(str(tmp_path / "j"), tj, tj)
    peu.save_stamped_trajectories(str(tmp_path / "p"), tp, tp)
    pts, clr = rng.randn(20, 3), rng.rand(20, 3)
    jeu.save_output_for_colmap(str(tmp_path / "jc"), tj, pts, clr, 1, 2, 3, 4)
    peu.save_output_for_colmap(str(tmp_path / "pc"), tp, pts, clr, 1, 2, 3, 4)
    for d, names in (("", ("stamped_groundtruth.txt",
                           "stamped_traj_estimate.txt")),
                     ("c", ("images.txt", "points3D.txt", "cameras.txt"))):
        for f in names:
            assert ((tmp_path / f"p{d}" / f).read_text()
                    == (tmp_path / f"j{d}" / f).read_text()), f


# ---------------------------------------------------------------------------
# .pth loader
# ---------------------------------------------------------------------------

def _write_pth(path, input_mode, seed, wrap=False):
    """A reference-style checkpoint of a seeded port VONet: "module."
    prefixes, an update.lmbda entry and, in MultiScale mode, the heads'
    unused layer2/conv2 keys."""
    net = init_weights(VONet(input_mode), torch.Generator().manual_seed(seed))
    sd = {f"module.{k}": v for k, v in net.state_dict().items()}
    sd["module.update.lmbda"] = torch.tensor([1e-4])
    if input_mode == "MultiScale":
        g = torch.Generator().manual_seed(seed + 1)
        for head in ("fmap_encoder", "imap_encoder"):
            for k, shape in (("layer2.0.conv1.weight", (64, 32, 3, 3)),
                             ("layer2.1.conv2.bias", (64,)),
                             ("conv2.weight", (128, 64, 1, 1))):
                sd[f"module.patchify.encoder.{head}.{k}"] = torch.randn(
                    shape, generator=g)
    torch.save({"model_state_dict": sd, "steps": 7} if wrap else sd, path)
    return net


@pytest.mark.parametrize("input_mode", MODES)
def test_load_pth_matches_jax(tmp_path, input_mode):
    """load_pth == import_pth followed by from_flax_params, key for key and
    bit for bit, on a .pth written from a seeded port VONet (raw and
    wrapped in model_state_dict); it loads strictly into VONet and gives
    back the seeded weights; an unknown key raises."""
    for wrap in (False, True):
        path = str(tmp_path / f"{input_mode}_{wrap}.pth")
        net = _write_pth(path, input_mode, seed=3 + wrap, wrap=wrap)
        got = load_pth(path, input_mode)
        variables, _ = import_pth(path, input_mode)
        want = from_flax_params(variables, input_mode)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
        fresh = VONet(input_mode)
        fresh.load_state_dict(got, strict=True)
        for k, v in net.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), k
        heads_l2 = any(".layer2." in k for k in got)
        assert heads_l2 == (input_mode == "SingleScale")
    bad = dict(torch.load(path, weights_only=True)["model_state_dict"])
    bad["module.patchify.encoder.nonsense.weight"] = torch.zeros(1)
    with pytest.raises(KeyError):
        load_pth(bad, input_mode)


# ---------------------------------------------------------------------------
# the CLI end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("input_mode", MODES)
def test_evaluate_end_to_end(scene, tmp_path, input_mode, monkeypatch):
    """evaluate() on the synthetic scene: the VO initializes, finite ATE,
    stamped trajectory files, results JSON with test_info."""
    made = []

    class Recorded(pev.RampVO):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(pev, "RampVO", Recorded)
    net = init_weights(VONet(input_mode), torch.Generator().manual_seed(0))
    results_path = str(tmp_path / "results.json")
    results = pev.evaluate(
        net, trials=1, config_VO=VOConfig(**SMALL_VO),
        eval_cfg=eval_cfg(scene, input_mode), results_path=results_path,
        save_dir=str(tmp_path / "trajs"), device="cpu")
    trial = results[scene]["trial_0"]
    assert len(made) == 1 and made[0].state.initialized
    assert np.isfinite(trial["ate"]) and trial["ate"] != 1000.0
    assert len(trial["rot_err"]) == 3
    saved = json.load(open(results_path))
    assert "test_info" in saved and scene in saved
    tdir = tmp_path / "trajs" / "full_data" / "trial_0" / "P000"
    est = np.loadtxt(tdir / "stamped_traj_estimate.txt")
    gt = np.loadtxt(tdir / "stamped_groundtruth.txt")
    assert est.shape[1] == gt.shape[1] == 8 and est.shape[0] >= 5


def test_trial_crash_degrades_to_sentinel(scene, tmp_path, monkeypatch):
    """A crash inside one trial scores ate=1000 instead of aborting the
    run (ref evaluate.py:308-310)."""

    def boom(*a, **kw):
        raise RuntimeError("simulated per-trial failure")

    monkeypatch.setattr(pev, "evaluate_sequence", boom)
    net = VONet("MultiScale")
    results = pev.evaluate(net, trials=2, config_VO=VOConfig(**SMALL_VO),
                           eval_cfg=eval_cfg(scene),
                           save_dir=str(tmp_path / "t"), device="cpu")
    for j in range(2):
        assert results[scene][f"trial_{j}"] == {"ate": 1000.0,
                                                "rot_err": [1000.0] * 3}


def test_unported_options_raise(scene):
    """Options that are not ported raise NotImplementedError up front, and
    the default device is the card."""
    net = VONet("MultiScale")
    cfg = eval_cfg(scene)
    cfg["data_loader"]["test"]["use_pose_pred"] = True
    with pytest.raises(NotImplementedError, match="item 12"):
        pev.evaluate(net, eval_cfg=cfg, device="cpu")
    for argv, item in ((["--fleet", "2"], "item 16"),
                       (["--chunk", "4"], "item 15")):
        with pytest.raises(NotImplementedError, match=item):
            pev.main(argv)
    assert pev.parse_shard("1:3", list("abcdefg")) == ["b", "e"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pev.evaluate(net, eval_cfg=eval_cfg(scene))


def test_cli_module_runs(tmp_path):
    """python -m rampvo_tpu_torch.cli.evaluate --device cpu on a scene, a
    .pth and configs written to tmp_path: exits 0, writes the results JSON
    with a finite ATE and the stamped trajectories."""
    scene_dir = str(tmp_path / "P001")
    synthetic.write_scene(scene_dir, n_frames=6, H=60, W=80, seed=1)
    weights = str(tmp_path / "w.pth")
    _write_pth(weights, "SingleScale", seed=5)
    cfg = eval_cfg(scene_dir, "SingleScale")
    (tmp_path / "eval.json").write_text(json.dumps(cfg))
    (tmp_path / "vo.yaml").write_text(
        "".join(f"{k}: {v}\n" for k, v in SMALL_VO.items()))
    results = tmp_path / "out.json"
    res = subprocess.run(
        [sys.executable, "-m", "rampvo_tpu_torch.cli.evaluate",
         "--weights", weights, "--config_VO", str(tmp_path / "vo.yaml"),
         "--config_eval", str(tmp_path / "eval.json"),
         "--results_path", str(results), "--device", "cpu"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(results.read_text())
    assert np.isfinite(out[scene_dir]["trial_0"]["ate"])
    assert out[scene_dir]["trial_0"]["ate"] != 1000.0
    assert (tmp_path / "trajectory_evaluation" / "full_data" / "trial_0"
            / "P001" / "stamped_traj_estimate.txt").exists()
