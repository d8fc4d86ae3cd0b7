"""The training data path and CLI of rampvo_tpu_torch on the CPU: the
TartanEvent dataset, its frame graph and the augmentor against rampvo_tpu on
a `tests/synthetic.py::write_scene` scene with the same seeds, the training
checkpoints, and the training CLI (`--device cpu`) end to end."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import synthetic
from rampvo_tpu.data import augmentation as jaug
from rampvo_tpu.data import frame_graph as jfg
from rampvo_tpu.data import tartan as jtartan
from rampvo_tpu_torch.ckpt.train_state import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from rampvo_tpu_torch.cli import train as ptrain
from rampvo_tpu_torch.data import augmentation as paug
from rampvo_tpu_torch.data import frame_graph as pfg
from rampvo_tpu_torch.data import tartan as ptartan
from rampvo_tpu_torch.utils.logger import Logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 48


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_scene") / "P000"
    synthetic.write_scene(str(root), n_frames=24, H=H, W=W)
    return str(root)


def make_cfg(n_frames=6, **over):
    cfg = json.loads(json.dumps(synthetic.EVAL_CFG))
    a = cfg["data_loader"]["train"]["args"]
    a.update(type="train", load_sampled_frames=True, data_drop="no",
             augment_data=False, n_events_in_between=1,
             num_events_selected=400, n_frames=n_frames, image_height=H,
             image_width=W, lr=1e-4, steps=2, steps_to_save_ckpt=2, clip=10.0,
             pose_weight=10.0, flow_weight=0.1, weight_decay=1e-6,
             pct_start=0.01)
    a.update(over)
    return cfg


# ---------------------------------------------------------------------------
# dataset, frame graph, augmentation
# ---------------------------------------------------------------------------

def test_frame_graph(scene):
    """build_frame_graph == the JAX frame graph on the scene: the same
    neighbours of every frame, flow distances within 1e-4 relative (the
    SE3 action runs in float32 in both)."""
    info = jtartan.TartanEventDataset(make_cfg(), scene, fmin=0.01,
                                      fmax=1000.0).scene_info[scene]
    args = (info["poses"], info["depths"], info["intrinsics"],
            jtartan.depth_read)
    a = jfg.build_frame_graph(*args)
    b = pfg.build_frame_graph(*args)
    assert a.keys() == b.keys()
    for i in a:
        np.testing.assert_array_equal(b[i][0], a[i][0])
        np.testing.assert_allclose(b[i][1], a[i][1], rtol=1e-4, atol=1e-4)


def test_event_indices(scene, tmp_path):
    """precompute_event_indices writes the same indices.txt as the JAX
    package's (which wrote the scene's)."""
    out = str(tmp_path / "indices.txt")
    ptartan.precompute_event_indices(
        os.path.join(scene, "events.h5"),
        os.path.join(scene, "timestamps.txt"), num_events=600,
        indices_file=out)
    np.testing.assert_array_equal(
        np.loadtxt(out, delimiter=","),
        np.loadtxt(os.path.join(scene, "indices.txt"), delimiter=","))


@pytest.mark.parametrize("mode,drop", [(None, "sample_drop"),
                                       ("all_events_all_images",
                                        "sequence_drop")])
def test_dataset_windows(scene, mode, drop):
    """TartanEventDataset == the JAX dataset from the same seed, item by
    item, in both event importing modes and both data-drop modes: equal
    masks, events, images and intrinsics, poses and disparities within
    1e-6 relative. The windows are padded to T_cap = n_frames * 2."""
    cfg = make_cfg(events_importing_mode=mode, data_drop=drop,
                   steps_until_finetune=0)
    kw = dict(seed=3, fmin=0.01, fmax=1000.0)
    a = jtartan.TartanEventDataset(cfg, scene, **kw)
    b = ptartan.TartanEventDataset(cfg, scene, **kw)
    assert len(a) == len(b) > 0
    for idx in (1, 4, 7):
        x, y = a[idx], b[idx]
        assert x.keys() == y.keys()
        assert y["events"].shape == (12, H, W, 5) and y["mask"].sum() == 6
        for k in ("mask", "events", "images", "intrinsics"):
            np.testing.assert_array_equal(y[k], x[k], err_msg=k)
        for k in ("poses", "disps"):
            np.testing.assert_allclose(y[k], x[k], rtol=1e-6, err_msg=k)


def test_augmentor():
    """EventRGBDAugmentor == the JAX augmentor from the same seed over five
    calls (color jitter, scale and crop draws), outputs equal; and the two
    modality-dropout functions draw alike."""
    rng = np.random.RandomState(0)
    T, N = 4, 4
    ev = rng.rand(T, 64, 96, 5).astype(np.float32)
    im = (rng.rand(N, 64, 96, 3) * 255).astype(np.float32)
    po = rng.randn(N, 7).astype(np.float32)
    di = (0.5 + rng.rand(N, 64, 96)).astype(np.float32)
    K = np.tile(np.array([50.0, 50.0, 48.0, 32.0], np.float32), (N, 1))
    ja = jaug.EventRGBDAugmentor(crop_size=(48, 64), seed=1)
    pa = paug.EventRGBDAugmentor(crop_size=(48, 64), seed=1)
    for _ in range(5):
        for x, y in zip(ja(ev, im, po, di, K), pa(ev, im, po, di, K)):
            np.testing.assert_array_equal(y, x)
    ev0 = ev.copy()
    ev0[1] = 0
    for seed in range(4):
        for fj, fp in ((jaug.set_random_sample_to_zero,
                        paug.set_random_sample_to_zero),
                       (jaug.set_random_sequence_to_zero,
                        paug.set_random_sequence_to_zero)):
            for e in (ev, ev0):
                x = fj(e, im, np.random.RandomState(seed))
                y = fp(e, im, np.random.RandomState(seed))
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(v, u)


# ---------------------------------------------------------------------------
# checkpoints, logger, CLI
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    """save_checkpoint / restore_checkpoint: the newest step of a directory
    comes back with its parameters and optimizer state; a file path works
    too."""
    net = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(net.parameters(), lr=1e-3)
    net(torch.ones(1, 3)).sum().backward()
    opt.step()
    d = str(tmp_path / "ck")
    save_checkpoint(d, 5, net.state_dict(), opt.state_dict())
    p10 = save_checkpoint(d, 10, net.state_dict(), opt.state_dict())
    assert latest_checkpoint(d) == p10
    for src in (d, p10):
        r = restore_checkpoint(src)
        assert r["step"] == 10
        for k, v in net.state_dict().items():
            assert torch.equal(r["params"][k], v)
        opt2 = torch.optim.AdamW(net.parameters(), lr=1e-3)
        opt2.load_state_dict(r["opt"])
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty_dir_absent"))


def test_logger(tmp_path, capsys):
    """Running means are printed every 100 pushes (stdout when TensorBoard
    is absent) and the writer closes."""
    lg = Logger("t", log_dir=str(tmp_path))
    for i in range(100):
        lg.push({"loss": 1.0, "px1": 0.5})
    lg.close()
    out = capsys.readouterr().out
    assert "loss=0.99000" in out and "px1=0.49500" in out


def _run_cli(scene, tmp_path, monkeypatch, capsys, M):
    """The training CLI with --device cpu: 8 frames, 10 unrolled steps, M
    patches, 2 optimizer steps with the loader thread on. Checks the
    finite losses printed, the checkpoint of step 2, and its restore by a
    second loop from `--ckpt` (step count, parameters, optimizer state)."""
    cfg = make_cfg(n_frames=8)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    monkeypatch.chdir(tmp_path)
    argv = ["--config_path", cfg_path, "--data_path", scene, "--workers", "1",
            "--print_every", "1", "--unroll_steps", "10", "--name", "clitest",
            "--fmin", "0.001", "--fmax", "1000.0", "--device", "cpu"]
    if M == 80:
        ptrain.main(argv)
    else:          # train(args) builds this dataset and runs this loop
        ds = ptartan.TartanEventDataset(cfg, scene, fmin=0.001, fmax=1000.0)
        ptrain.TrainLoop(ptrain.parse_args(argv), cfg, ds, M=M).run()
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "'loss':" in ln]
    assert len(lines) == 2, out
    losses = [eval(ln)["loss"] for ln in lines]
    assert all(np.isfinite(losses)), losses
    ckpt_dir = os.path.join(str(tmp_path), "checkpoints", "clitest")
    restored = restore_checkpoint(ckpt_dir)
    assert restored["step"] == 2 and restored["opt"]["count"] == 2
    args = ptrain.parse_args(argv + ["--ckpt", ckpt_dir])
    ds = ptartan.TartanEventDataset(cfg, scene, fmin=0.001, fmax=1000.0)
    loop = ptrain.TrainLoop(args, cfg, ds, M=M)
    assert loop.step_count == 2 and loop.trainer.count == 2
    assert not loop.structure_only()
    for k, v in loop.net.state_dict().items():
        assert torch.equal(v, restored["params"][k]), k
    assert len(loop.trainer.opt.state) == len(loop.trainer.params)


def test_train_cli_cpu(scene, tmp_path, monkeypatch, capsys):
    """The training CLI's argument parsing, dataset and loop on the CPU at
    8 patches per frame (see `_run_cli`)."""
    _run_cli(scene, tmp_path, monkeypatch, capsys, M=8)


@pytest.mark.slow
def test_train_cli_cpu_recipe_patches(scene, tmp_path, monkeypatch, capsys):
    """`main(argv)` at the recipe's 80 patches per frame, the JAX CLI
    test's run (about 200 s on the CPU)."""
    _run_cli(scene, tmp_path, monkeypatch, capsys, M=80)


def test_train_loop_from_pth(scene, tmp_path):
    """`--ckpt X.pth` starts from a reference-format state_dict through
    `load_pth` (weights only: step 0, the warmup is off as in the
    reference, since a checkpoint was given)."""
    from rampvo_tpu_torch.models.vonet import VONet, init_weights

    net = init_weights(VONet(), torch.Generator().manual_seed(3))
    pth = str(tmp_path / "w.pth")
    torch.save({"model_state_dict": net.state_dict()}, pth)
    cfg = make_cfg(n_frames=8)
    args = ptrain.parse_args(["--config_path", "x", "--device", "cpu",
                              "--ckpt", pth])
    ds = ptartan.TartanEventDataset(cfg, scene, fmin=0.001, fmax=1000.0)
    loop = ptrain.TrainLoop(args, cfg, ds, M=8)
    assert loop.step_count == 0 and not loop.structure_only()
    for k, v in net.state_dict().items():
        assert torch.equal(loop.net.state_dict()[k], v), k


@pytest.mark.parametrize("gradient", [False, True],
                         ids=["random", "gradient"])
def test_train_loop_selection_from_config(scene, gradient):
    """`event_bias: false` in the config trains without event bias, and
    `gradient_bias` picks the gradient-ranked selection over the random
    one (as the JAX CLI reads them): one optimizer step at M=8 with
    finite metrics."""
    cfg = make_cfg(n_frames=8, event_bias=False, gradient_bias=gradient)
    args = ptrain.parse_args(["--config_path", "x", "--device", "cpu",
                              "--unroll_steps", "10"])
    ds = ptartan.TartanEventDataset(cfg, scene, fmin=0.001, fmax=1000.0)
    loop = ptrain.TrainLoop(args, cfg, ds, M=8)
    assert (loop.fwd.event_bias, loop.fwd.gradient_bias) == (False, gradient)
    loop.run(n_steps=1)
    (hist,) = loop.history
    assert all(np.isfinite(v) for v in hist.values()), hist


def test_train_cli_module_entry():
    """`python -m rampvo_tpu_torch.cli.train` has the JAX CLI's flags plus
    --device (cuda by default)."""
    res = subprocess.run([sys.executable, "-m", "rampvo_tpu_torch.cli.train",
                          "--help"], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ("--data_path", "--name", "--ckpt", "--config_path",
                 "--log_results", "--tensorboard", "--workers", "--fmin",
                 "--fmax", "--seed", "--unroll_steps",
                 "--structure_only_steps", "--print_every", "--validate",
                 "--device"):
        assert flag in res.stdout, flag
    assert ptrain.parse_args(["--config_path", "x"]).device == "cuda"
