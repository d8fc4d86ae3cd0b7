"""The hardware training run and the synthetic overfit CLI of
rampvo_tpu_torch (cli/train_hw_run.py and cli/overfit_synthetic.py, the
ports of scripts/train_hw_run.py and scripts/overfit_synthetic.py) on the
CPU at small sizes.

The configuration is held against the JAX script itself, run with its
training, checkpoint, network initialization and evaluation replaced by
recorders (no JAX computation). The port's run goes end to end on the
scene's files and on the scene in memory, which must agree; its
evaluations use a smaller VOConfig than the script's (M = 96 in bf16
takes minutes a frame on the CPU). The scene is 120x160: the run's
12000 events a voxel need about that many pixels for a voxel a frame.
The overfit CLI's evaluations are recorded, not run (a 480x640
evaluation of its 40-frame scene takes minutes on the CPU; the card's
overfit phase and the slow twin in tests/test_torch_overfit.py run
them).
"""

import contextlib
import dataclasses
import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import test_torch_overfit as to
from rampvo_tpu_torch.ckpt.train_state import restore_checkpoint
from rampvo_tpu_torch.cli import overfit_synthetic as of
from rampvo_tpu_torch.cli import train_hw_run as hw
from rampvo_tpu_torch.data import synthetic
from rampvo_tpu_torch.vo import VOConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the namespace keys rampvo_tpu/cli/train.py reads
JAX_CLI_KEYS = ("data_path", "name", "ckpt", "config_path", "log_results",
                "tensorboard", "workers", "fmin", "fmax", "seed",
                "unroll_steps", "print_every", "validate",
                "structure_only_steps")
SMALL_VO = VOConfig(BUFFER_SIZE=16, MAX_FRAMES=16, PATCHES_PER_FRAME=4,
                    REMOVAL_WINDOW=5, OPTIMIZATION_WINDOW=4,
                    PATCH_LIFETIME=3, KEYFRAME_INDEX=2, MEM=8,
                    MIXED_PRECISION=False, PROBE_THRESH=-1.0)
HW_ARGV = ["--hw", "120x160", "--scene_frames", "12", "--n_frames", "8",
           "--unroll", "2", "--steps", "2", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_config_parity_with_jax_script(tmp_path, monkeypatch):
    """scripts/train_hw_run.py at --hw 48x64 --scene_frames 12 --steps 3,
    its training CLI, checkpoint, VONet and evaluation replaced by
    recorders: the port writes the same cfg.json, its training namespace
    (built by cli.train.parse_args) agrees on every key the JAX CLI
    reads, and its evaluations match the script's (evaluation config,
    every VOConfig field of the port, one trial, chunk 8, trajectory
    directories), as do the checkpoint directory and the summary's
    keys."""
    import rampvo_tpu.ckpt as jckpt
    import rampvo_tpu.cli.evaluate as jevaluate
    import rampvo_tpu.cli.train as jtrain
    import rampvo_tpu.models as jmodels

    out = str(tmp_path / "run")
    argv = ["--hw", "48x64", "--scene_frames", "12", "--steps", "3",
            "--out", out]
    seen = {"evals": []}

    class Net:
        def __init__(self, input_mode):
            seen["input_mode"] = input_mode

        def init(self, *args):
            return {"params": "random"}

    def restore(path):
        seen["ckpt_dir"] = path
        return {"step": 3, "params": {"params": "trained"}}

    def evaluate(net, **kw):
        seen["evals"].append((net["params"], kw))
        scene = kw["eval_cfg"]["data_loader"]["test"]["test_split"][0]
        return {scene: {"trial_0": {
            "ate": 0.5 if net["params"] == "random" else 0.25}}}

    monkeypatch.setattr(jtrain, "train",
                        lambda targs: seen.setdefault("targs", targs))
    monkeypatch.setattr(jckpt, "restore_checkpoint", restore)
    monkeypatch.setattr(jmodels, "VONet", Net)
    monkeypatch.setattr(jevaluate, "evaluate", evaluate)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", ["train_hw_run.py"] + argv)
    monkeypatch.chdir(tmp_path)
    spec = importlib.util.spec_from_file_location(
        "_jax_train_hw_run", os.path.join(REPO, "scripts", "train_hw_run.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.main()

    args = hw.parse_args(argv + ["--device", "cpu"])
    scene = os.path.join(out, "scene", "P000")
    cfg = hw.hw_config(args)
    with open(os.path.join(out, "cfg.json")) as f:
        assert cfg == json.load(f)
    targs = hw.train_args(args, scene, os.path.join(out, "cfg.json"))
    for k in JAX_CLI_KEYS:
        assert getattr(targs, k) == getattr(seen["targs"], k), k
    assert seen["ckpt_dir"] == os.path.join(out, "checkpoints", hw.RUN_NAME)
    assert seen["input_mode"] == "MultiScale"
    assert [p for p, _ in seen["evals"]] == ["random", "trained"]
    port_vo = dataclasses.asdict(hw.eval_vo_config())
    for tag, (_, kw) in zip(("random", "trained"), seen["evals"]):
        assert kw["eval_cfg"] == hw.hw_eval_cfg(cfg, scene)
        assert (kw["trials"], kw["chunk"]) == (1, 8)
        assert kw["save_dir"] == os.path.join(out, f"trajs_{tag}")
        jax_vo = dataclasses.asdict(kw["config_VO"])
        assert port_vo == {k: jax_vo[k] for k in port_vo}
    with open(os.path.join(out, "summary.json")) as f:
        assert list(json.load(f)) == list(hw.SUMMARY_KEYS)


@pytest.fixture(scope="module")
def hw_runs(tmp_path_factory):
    """The port's run on the scene's files and in memory: 120x160, a
    12-frame scene, 8 frames a window, 2 unrolled steps, 2 optimizer
    steps, M = 8, evaluated with SMALL_VO."""
    cwd = os.getcwd()
    runs = {}
    for mode, extra in (("files", []), ("memory", ["--memory_scene"])):
        out = str(tmp_path_factory.mktemp(mode))
        spans = []

        @contextlib.contextmanager
        def span(name):
            spans.append(name)
            yield

        args = hw.parse_args(HW_ARGV + extra + ["--out", out])
        r = hw.run(args, M=8, config_VO=SMALL_VO, span=span)
        runs[mode] = dict(r, args=args, out=out, spans=spans)
        assert os.getcwd() == cwd
    return runs


@pytest.mark.parametrize("mode", ["files", "memory"])
def test_hw_run_end_to_end(hw_runs, mode):
    """Each run: its spans, the summary's keys (also on disk), finite
    losses (also in losses.json), the checkpoint at step 2 holding the
    trained weights tensor for tensor, both evaluations tracking enough
    frames for the VO to initialize (8) to a finite ATE, cfg.json the
    run's config."""
    r = hw_runs[mode]
    out, summary = r["out"], r["summary"]
    assert r["spans"] == ["train", "evaluate random", "evaluate trained"]
    assert list(summary) == list(hw.SUMMARY_KEYS) and summary["steps"] == 2
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == summary
    losses = [h["loss"] for h in r["history"]]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    with open(os.path.join(out, "losses.json")) as f:
        assert json.load(f) == r["history"]
    restored = restore_checkpoint(os.path.join(out, "checkpoints",
                                               hw.RUN_NAME))
    assert restored["step"] == 2
    state = r["net"].state_dict()
    assert sorted(restored["params"]) == sorted(state)
    for k, v in state.items():
        assert torch.equal(restored["params"][k], v), k
    for tag in ("random", "trained"):
        voxels, frames = r["evaluations"][tag]
        assert voxels >= frames >= 8
        assert np.isfinite(summary[f"ate_{tag}"])
        assert 0 <= summary[f"ate_{tag}"] < 1000.0
    with open(os.path.join(out, "cfg.json")) as f:
        assert json.load(f) == hw.hw_config(r["args"])


def test_hw_run_memory_equals_files(hw_runs):
    """The run on the scene in memory trains on the same windows and
    evaluates the same voxels as the run on the files: the same losses,
    weights and ATEs."""
    a, b = hw_runs["files"], hw_runs["memory"]
    assert [h["loss"] for h in a["history"]] == \
        [h["loss"] for h in b["history"]]
    for x, y in zip(a["net"].state_dict().values(),
                    b["net"].state_dict().values()):
        assert torch.equal(x, y)
    assert a["evaluations"] == b["evaluations"]
    for k in ("ate_random", "ate_trained"):
        assert a["summary"][k] == b["summary"][k]


@pytest.mark.parametrize("ates", [(0.1, 0.2), (0.2, 0.1), (0.2, 0.2)])
def test_hw_run_exit_status(hw_runs, monkeypatch, capsys, ates):
    """main() exits 0 and prints HW TRAIN RUN OK only when the trained ATE
    is below the random one (the script's assertion), for forced ATEs and
    for the runs' own."""
    trained, random = ates
    summary = {"ate_trained": trained, "ate_random": random}
    monkeypatch.setattr(hw, "run", lambda args: {"summary": summary})
    code = hw.main(HW_ARGV)
    assert code == (0 if trained < random else 1)
    assert ("HW TRAIN RUN OK" in capsys.readouterr().out) == (code == 0)
    for r in hw_runs.values():
        s = r["summary"]
        assert hw.check(s) == (0 if s["ate_trained"] < s["ate_random"]
                               else 1)


OVERFIT_ARGV = ["--steps", "2", "--cpu", "--unroll", "2", "--patches", "8"]
OVERFIT_LINES = [
    r"dataset windows: \d+",
    r"step 0: loss=\d+\.\d{4} flow=\d+\.\d{3} px1=\d+\.\d{3} \(\d+s\)",
    r"step 1: loss=\d+\.\d{4} flow=\d+\.\d{3} px1=\d+\.\d{3} \(\d+s\)",
    r"random-init net: ATE = 0\.4000",
    r"overfit net    : ATE = 0\.1000",
    r"improvement: 4\.00x",
]


@pytest.fixture(scope="module")
def recipe_losses(tmp_path_factory):
    """tests/test_torch_overfit.py's recipe (its dataset over the scene's
    files, its train_steps) from the JAX test's network, at OVERFIT_ARGV's
    sizes."""
    root = str(tmp_path_factory.mktemp("overfit") / "scene")
    synthetic.write_scene(root, n_frames=of.SCENE_FRAMES, H=of.H, W=of.W,
                          motion="curve")
    ds = to.dataset(root)
    losses, _ = to.train_steps(to.overfit_init(),
                               lambda s: ds[1 + s % max(len(ds) - 1, 1)],
                               "cpu", steps=2, M=8, unroll=2)
    return losses


@pytest.mark.parametrize("mode", ["files", "memory"])
def test_overfit_synthetic_cli(recipe_losses, tmp_path, monkeypatch, capsys,
                               mode):
    """`overfit_synthetic --steps 2 --cpu` (2 unrolled steps, 8 patches)
    from the JAX test's network, on files and with --memory_scene: it
    prints the script's lines (step lines, both ATEs, the improvement)
    and returns them; its losses are the learned-weights tests' recipe's;
    it evaluates the initial network and the checkpoint's weights (the
    trained ones) with the recipe's VOConfig and evaluation config. With
    the initial ATE handed in (the memory case) it evaluates only the
    trained weights and prints the same lines."""
    calls = []
    ates = [0.4, 0.1] if mode == "files" else [0.1]

    def evaluate(net, **kw):
        calls.append((net, kw))
        path = kw["eval_cfg"]["data_loader"]["test"]["test_split"][0]
        return {path: {"trial_0": {"ate": ates[len(calls) - 1]}}}

    monkeypatch.setattr(of, "evaluate", evaluate)
    argv = OVERFIT_ARGV + ["--out", str(tmp_path)] + (
        ["--memory_scene"] if mode == "memory" else [])
    net0 = to.overfit_init()
    r = of.run(of.parse_args(argv), net=net0,
               ate_initial=None if mode == "files" else 0.4)
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if any(re.fullmatch(p, ln) for p in OVERFIT_LINES)]
    assert printed == r["lines"] and len(printed) == len(OVERFIT_LINES)
    for line, pattern in zip(printed, OVERFIT_LINES):
        assert re.fullmatch(pattern, line), line
    assert r["losses"] == recipe_losses
    assert r["ate_initial"] == 0.4 and r["ate_trained"] == 0.1
    assert [c[0] for c in calls] == [net0, r["trained"]][-len(ates):]
    assert r["trained"] is not net0
    root = os.path.join(str(tmp_path), "scene")
    for _, kw in calls:
        assert kw["config_VO"] == of.eval_config(8)
        assert kw["eval_cfg"] == of.eval_cfg(root)
        assert kw["device"] == "cpu" and kw["trials"] == 1
