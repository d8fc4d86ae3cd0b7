"""The port's CLIs load the checkpoints that the port's training loop
writes, on the CPU: a `cli.train.TrainLoop` trains 2 steps of the tiny
config and saves checkpoints/<name>/step_2.pth ({"params", "opt",
"step"}); `cli.evaluate.load_params` takes it as a file, as its directory
and as a loaded dict, `cli.evaluate.evaluate` runs from the directory,
and `cli.train --ckpt step_2.pth` resumes step count, parameters and
optimizer state. Reference-format .pth files still go through `load_pth`
(tests/test_torch_cli.py::test_load_pth_matches_jax holds that loader to
the JAX importer)."""

import os

import numpy as np
import pytest
import torch

import synthetic
from test_torch_cli import SMALL_VO, eval_cfg
from test_torch_train_data import make_cfg
from rampvo_tpu_torch.ckpt.train_state import latest_checkpoint
from rampvo_tpu_torch.ckpt.weights import load_pth
from rampvo_tpu_torch.cli import evaluate as pev
from rampvo_tpu_torch.cli import train as ptrain
from rampvo_tpu_torch.data import tartan as ptartan
from rampvo_tpu_torch.models.vonet import VONet, init_weights
from rampvo_tpu_torch.vo import VOConfig


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def same_tree(a, b) -> bool:
    """Nested dicts, lists and tuples of tensors and numbers, equal leaf by
    leaf (tensors bit for bit)."""
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in b)
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    if isinstance(b, torch.Tensor):
        return isinstance(a, torch.Tensor) and torch.equal(a, b)
    return a == b


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(loop, checkpoint path, argv, config, dataset) after 2 optimizer
    steps of the tiny config on a 32x48 scene (8 frames, 8 patches, 10
    unrolled steps), saved by the loop itself at step 2."""
    root = tmp_path_factory.mktemp("ckpt_load")
    scene = str(root / "P000")
    synthetic.write_scene(scene, n_frames=24, H=32, W=48)
    cfg = make_cfg(n_frames=8)
    argv = ["--config_path", "unused.json", "--name", "f1", "--device", "cpu",
            "--unroll_steps", "10", "--print_every", "100"]
    ds = ptartan.TartanEventDataset(cfg, scene, fmin=0.001, fmax=1000.0)
    cwd = os.getcwd()
    os.chdir(root)                  # checkpoints/<name>/ lands here
    try:
        loop = ptrain.TrainLoop(ptrain.parse_args(argv), cfg, ds, M=8)
        loop.run()                  # the config's 2 steps; saves at step 2
    finally:
        os.chdir(cwd)
    path = latest_checkpoint(str(root / "checkpoints" / "f1"))
    assert path is not None and path.endswith("step_2.pth")
    return loop, path, argv, cfg, ds


@pytest.mark.parametrize("source", ["file", "directory", "dict"])
def test_evaluate_loads_train_checkpoint(trained, source):
    """load_params gives the trained network's parameters bit for bit from
    the step file, its directory, or the loaded dict."""
    loop, path, _, _, _ = trained
    weights = {"file": path, "directory": os.path.dirname(path),
               "dict": torch.load(path, weights_only=True)}[source]
    net = pev.load_params(weights, "MultiScale")
    want = loop.net.state_dict()
    assert net.state_dict().keys() == want.keys()
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_evaluate_runs_from_train_checkpoint(trained, tmp_path):
    """evaluate() with the checkpoint directory as its weights (the CLI's
    --weights) tracks a 60x80 scene to a finite ATE."""
    _, path, _, _, _ = trained
    scene = str(tmp_path / "P000")
    synthetic.write_scene(scene, n_frames=10, H=60, W=80)
    results = pev.evaluate(
        os.path.dirname(path), trials=1, config_VO=VOConfig(**SMALL_VO),
        eval_cfg=eval_cfg(scene), save_dir=str(tmp_path / "trajs"),
        device="cpu")
    ate = results[scene]["trial_0"]["ate"]
    assert np.isfinite(ate) and ate != 1000.0


@pytest.mark.parametrize("source", ["file", "directory"])
def test_train_resumes_from_checkpoint(trained, source):
    """--ckpt step_2.pth (or its directory) resumes the step count, the
    parameters and the optimizer state; the structure-only warmup stays
    off, as for any --ckpt."""
    loop, path, argv, cfg, ds = trained
    ckpt = path if source == "file" else os.path.dirname(path)
    again = ptrain.TrainLoop(ptrain.parse_args(argv + ["--ckpt", ckpt]), cfg,
                             ds, M=8)
    assert again.step_count == loop.step_count == 2
    assert again.trainer.count == loop.trainer.count == 2
    assert not again.structure_only()
    for k, v in loop.net.state_dict().items():
        assert torch.equal(again.net.state_dict()[k], v), k
    assert same_tree(again.trainer.state_dict(), loop.trainer.state_dict())


def test_reference_pth_still_goes_through_load_pth(tmp_path):
    """A reference-format .pth ("module." prefixes, model_state_dict, the
    update.lmbda entry) loads through load_params as load_pth maps it, and
    load_pth keeps raising on a key it cannot map, such as a training
    checkpoint's top level."""
    net = init_weights(VONet(), torch.Generator().manual_seed(4))
    sd = {f"module.{k}": v for k, v in net.state_dict().items()}
    sd["module.update.lmbda"] = torch.tensor([1e-4])
    path = str(tmp_path / "ref.pth")
    torch.save({"model_state_dict": sd}, path)
    got = pev.load_params(path, "MultiScale").state_dict()
    want = load_pth(path, "MultiScale")
    for k, v in net.state_dict().items():
        assert torch.equal(got[k], v) and torch.equal(want[k], v), k
    with pytest.raises(KeyError, match="params"):
        load_pth({"params": {}, "opt": {}, "step": 1}, "MultiScale")
