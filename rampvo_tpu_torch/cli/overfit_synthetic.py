"""Overfit the synthetic scene, then show that the evaluation ATE improves
over the starting network (port of scripts/overfit_synthetic.py).

The learned-weights recipe as a script: the tiny MultiScale model
trained on a 40-frame 60x80 curved scene (TrainForward with n_frames 8,
16 patches, 10 unrolled steps; AdamW at 1e-4 behind a global-norm clip
of 0.1), its weights saved as a training checkpoint and loaded back, then
the starting and the trained network evaluated through
`cli.evaluate.evaluate`:

  python -m rampvo_tpu_torch.cli.overfit_synthetic [--steps 200]
      [--n_frames 8] [--patches 16] [--unroll 10] [--cpu]
      [--memory_scene] [--out DIR]

Runs on the card unless `--cpu` is given. The scene
is written as files under --out (a new temporary directory by default),
or held in memory with `--memory_scene` (data/synthetic.py; a machine
without h5py needs it). The starting network is
`init_weights(VONet("MultiScale"), torch.Generator().manual_seed(0))`;
`run(args, net=)` takes another (the JAX script starts from flax's
PRNGKey(0), which only JAX can draw).

The recipe's pieces (`overfit_trainer`, `to_batch`, `train_steps`,
`eval_config`, `train_config`, `eval_cfg`) are what the learned-weights
tests and the card's overfit phase run.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import os.path as osp
import tempfile
import time

import numpy as np
import torch

from ..ckpt import save_checkpoint
from ..data import synthetic
from ..data.tartan import TartanEventDataset
from ..lie import ops as lops
from ..models.vonet import VONet, init_weights
from ..train import TrainForward
from ..train.step import Trainer
from ..vo import VOConfig
from .evaluate import evaluate, load_params
from .evaluate import read_scene as read_scene_files

H, W = 60, 80              # the scene's size
SCENE_FRAMES = 40
STEPS = 40                 # the learned-weights tests' optimizer steps
N_FRAMES, M, UNROLL = 8, 16, 10
BATCH_KEYS = ("events", "images", "poses", "disps", "intrinsics", "mask")


def overfit_trainer(net):
    """The JAX recipe's optimizer, AdamW at 1e-4 (optax's default weight
    decay 1e-4) behind a global-norm clip of 0.1, as the port's Trainer:
    its one-cycle rate over 10**6 steps with no warm-up phase stays within
    4e-5 of the peak for the first 40 steps, the JAX recipe's constant
    rate."""
    return Trainer(net, {"steps": 10 ** 6, "lr": 1e-4, "clip": 0.1,
                         "weight_decay": 1e-4, "pct_start": 0.0})


def to_batch(item, device):
    """A dataset item as the forward's inputs on `device`, its
    camera-to-world poses inverted to world-to-camera as the JAX recipe
    does."""
    b = {k: torch.as_tensor(np.asarray(item[k])) for k in BATCH_KEYS}
    b["poses"] = lops.se3_inv(b["poses"].float())
    return {k: (v if k == "mask" else v.to(device)) for k, v in b.items()}


def train_steps(net, item_at, device, steps=STEPS, seed=1,
                n_frames=N_FRAMES, M=M, unroll=UNROLL, H=H, W=W,
                on_step=None):
    """`steps` optimizer steps of TrainForward(n_frames, M, unroll) on
    `net` (on `device`) over the items `item_at(step)` of H x W, draws
    from a CPU generator seeded with `seed`; `on_step(step, loss,
    metrics)` after each. Returns (losses, seconds of each step, host
    clock; reading the loss waits for the device)."""
    fwd = TrainForward(net, n_frames=n_frames, M=M, steps=unroll)
    tr = overfit_trainer(net)
    g = torch.Generator().manual_seed(seed)
    losses, seconds = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        b = to_batch(item_at(step), device)
        draws = fwd.draw(g, device, H, W)
        loss, metrics, _ = tr.step(lambda: fwd(
            b["events"], b["images"], b["poses"], b["disps"],
            b["intrinsics"], b["mask"], draws=draws))
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
        if on_step is not None:
            on_step(step, losses[-1], metrics)
    return losses, seconds


def eval_config(patches=M):
    """The JAX recipe's VOConfig for both evaluations."""
    return VOConfig(
        BUFFER_SIZE=64, MAX_FRAMES=64, PATCHES_PER_FRAME=patches,
        REMOVAL_WINDOW=8, OPTIMIZATION_WINDOW=6, PATCH_LIFETIME=5,
        KEYFRAME_INDEX=2, MIXED_PRECISION=False, PROBE_THRESH=-1.0, MEM=16)


def train_config(n_frames=N_FRAMES):
    cfg = json.loads(json.dumps(synthetic.EVAL_CFG))
    cfg["data_loader"]["train"]["args"]["n_frames"] = n_frames
    return cfg


def eval_cfg(scene_path):
    cfg = json.loads(json.dumps(synthetic.EVAL_CFG))
    cfg["data_loader"]["test"] = {
        "test_split": [scene_path], "dataset_name": "Synthetic",
        "use_pose_pred": False}
    return cfg


def run(args, net=None, scene=None, span=None, ate_initial=None):
    """The script's run for the parsed `args`: the scene (files under
    args.out, or `scene`, a `synthetic.memory_scene`, or a new one with
    --memory_scene), args.steps optimizer steps from `net` (the seeded
    initialization when None) over ds[1 + step % (len(ds) - 1)], the
    weights saved and loaded back (equal, tensor for tensor), and both
    networks evaluated; a caller that trains the same `net` again passes
    its ATE from an earlier run as `ate_initial` (the evaluation is
    deterministic on one device) and it is not evaluated again.
    `span(name)`, a context manager, wraps "train", "evaluate initial"
    and "evaluate trained". Prints the script's lines and returns {lines,
    losses, seconds, ate_initial, ate_trained, initial, trained (the
    loaded network)}."""
    span = span or (lambda name: contextlib.nullcontext())
    device = "cpu" if args.cpu else "cuda"
    out = args.out or tempfile.mkdtemp()
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    root = osp.join(out, "scene")
    if scene is None and args.memory_scene:
        scene = synthetic.memory_scene(SCENE_FRAMES, H, W)
    if scene is None:
        synthetic.write_scene(root, n_frames=SCENE_FRAMES, H=H, W=W,
                              motion="curve")
        ds = TartanEventDataset(train_config(args.n_frames), root,
                                fmin=0.001, fmax=1000.0)
        read_scene = read_scene_files
    else:
        os.makedirs(root, exist_ok=True)      # evaluate() checks the path
        ds = synthetic.MemoryDataset(scene, train_config(args.n_frames),
                                     fmin=0.001, fmax=1000.0)
        read_scene = synthetic.memory_reader(scene)
    say(f"dataset windows: {len(ds)}")

    net0 = net if net is not None else init_weights(
        VONet("MultiScale"), torch.Generator().manual_seed(0))
    trained = copy.deepcopy(net0).to(device)
    t0 = time.time()

    def log(step, loss, metrics):
        if step % 20 == 0 or step == args.steps - 1:
            say(f"step {step}: loss={loss:.4f} "
                f"flow={float(metrics['flow_e']):.3f} "
                f"px1={float(metrics['px1']):.3f} ({time.time() - t0:.0f}s)")

    h, w = (H, W) if scene is None else scene["images"].shape[1:3]
    with span("train"):
        losses, seconds = train_steps(
            trained, lambda s: ds[1 + s % max(len(ds) - 1, 1)], device,
            steps=args.steps, n_frames=args.n_frames, M=args.patches,
            unroll=args.unroll, H=h, W=w, on_step=log)
    path = save_checkpoint(osp.join(out, "checkpoints"), args.steps,
                           trained.state_dict(), {})
    loaded = load_params(path, "MultiScale")
    for a, b in zip(loaded.state_dict().values(),
                    trained.state_dict().values()):
        if not torch.equal(a, b.cpu()):
            raise RuntimeError("the checkpoint's weights differ from the "
                               "trained ones")

    vocfg = eval_config(args.patches)

    def ate_of(network, tag, name):
        with span(name):
            res = evaluate(network, trials=1, config_VO=vocfg,
                           eval_cfg=eval_cfg(root), save_dir=tempfile.mkdtemp(
                               dir=out), device=device, read_scene=read_scene)
        ate = res[root]["trial_0"]["ate"]
        say(f"{tag}: ATE = {ate:.4f}")
        return ate

    if ate_initial is None:
        ate_initial = ate_of(net0, "random-init net", "evaluate initial")
    else:
        say(f"random-init net: ATE = {ate_initial:.4f}")
    ate_trained = ate_of(loaded, "overfit net    ", "evaluate trained")
    say(f"improvement: {ate_initial / max(ate_trained, 1e-9):.2f}x")
    return {"lines": lines, "losses": losses, "seconds": seconds,
            "ate_initial": ate_initial, "ate_trained": ate_trained,
            "initial": net0, "trained": loaded}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain versions); the default "
                    "is the card")
    ap.add_argument("--n_frames", type=int, default=N_FRAMES)
    ap.add_argument("--patches", type=int, default=M)
    ap.add_argument("--unroll", type=int, default=UNROLL)
    ap.add_argument("--memory_scene", action="store_true",
                    help="hold the scene in memory instead of writing files")
    ap.add_argument("--out", type=str, default=None,
                    help="directory of the scene, checkpoint and "
                    "trajectories (default: a new temporary directory)")
    return ap.parse_args(argv)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
