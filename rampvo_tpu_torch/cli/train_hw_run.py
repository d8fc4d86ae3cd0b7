"""Hardware training run (port of scripts/train_hw_run.py): the training
CLI at the recipe's shapes until the loss falls, the checkpoint restored,
then the trained weights against a random network through the
evaluation CLI.

The synthetic curved scene (data/synthetic.py) at 480x640; the training
CLI's loop (`cli.train`) with 15 frames, 80 patches and 18 unrolled
steps, so K7 and K8 run once per unrolled step; the checkpoint under
<out>/checkpoints/hw_run/; `cli.evaluate.evaluate` with chunk 8 for the
restored weights and for `init_weights(..., manual_seed(999))`:

  python -m rampvo_tpu_torch.cli.train_hw_run [--steps 120] [--hw 480x640]
      [--n_frames 15] [--unroll 18] [--scene_frames 60] [--out DIR]
      [--lr 1e-4] [--device cuda|cpu] [--memory_scene]

Runs on the card unless `--device cpu` is given. --out defaults to
hw_train_run in the temporary directory. The scene is written as files
under <out>/scene/P000 (once; a later run reuses them), or held in memory
with `--memory_scene` (a machine without h5py needs it), where the loop
trains on `synthetic.MemoryDataset` and the evaluation reads
`synthetic.memory_reader`: the same windows and voxels. Writes
<out>/cfg.json, <out>/losses.json (the loop's per-step metrics) and
<out>/summary.json, and exits non-zero unless the trained weights track
the scene better than the random ones (then prints HW TRAIN RUN OK).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import sys
import tempfile
import time

import torch

from ..ckpt.train_state import restore_checkpoint
from ..data import synthetic
from ..models.vonet import VONet, init_weights
from ..vo import VOConfig
from . import train as tcli
from .evaluate import evaluate, load_params
from .evaluate import read_scene as read_scene_files

RUN_NAME = "hw_run"
SUMMARY_KEYS = ("steps", "wall_s", "s_per_step_incl_compile", "ate_random",
                "ate_trained")


def hw_config(args) -> dict:
    """The network config of the run: the synthetic scene's, with the
    script's training keys."""
    H, W = (int(x) for x in args.hw.split("x"))
    cfg = json.loads(json.dumps(synthetic.EVAL_CFG))
    cfg["data_loader"]["train"]["args"].update(
        n_frames=args.n_frames, steps=args.steps,
        steps_to_save_ckpt=args.steps, lr=args.lr, clip=10.0,
        pose_weight=10.0, flow_weight=0.1, weight_decay=1e-6,
        image_height=H, image_width=W, num_events_selected=12000)
    cfg["data_loader"]["test"]["test_split"] = []
    return cfg


def train_args(args, scene: str, cfg_path: str):
    """The training CLI's arguments for the run, through its own parser."""
    return tcli.parse_args([
        "--data_path", scene, "--name", RUN_NAME, "--config_path", cfg_path,
        "--workers", "1", "--fmin", "0.001", "--fmax", "1000.0",
        "--seed", "1234", "--unroll_steps", str(args.unroll),
        "--print_every", "1", "--structure_only_steps", "0",
        "--device", args.device])


def hw_eval_cfg(cfg: dict, scene: str) -> dict:
    """The evaluation config of the run: `cfg` scoring `scene`."""
    eval_cfg = json.loads(json.dumps(cfg))
    eval_cfg["data_loader"]["test"] = {
        "test_split": [scene], "dataset_name": "Synthetic",
        "use_pose_pred": False}
    return eval_cfg


def eval_vo_config() -> VOConfig:
    """The script's VOConfig for both evaluations."""
    return VOConfig(BUFFER_SIZE=128, MAX_FRAMES=128, MIXED_PRECISION=True,
                    PROBE_THRESH=-1.0)


def run(args, M: int = 80, config_VO: VOConfig | None = None,
        span=None) -> dict:
    """The run for the parsed `args` with M patches per frame (the
    training CLI's 80), evaluated with `config_VO` (`eval_vo_config()`
    when None; a test on the CPU shrinks both). `span(name)`, a context
    manager, wraps "train", "evaluate random" and "evaluate trained".
    Returns {summary, history (the loop's per-step metrics), net (the
    trained network), restored (the checkpoint), evaluations ({tag:
    (voxels, frames tracked)})}."""
    span = span or (lambda name: contextlib.nullcontext())
    H, W = (int(x) for x in args.hw.split("x"))
    out = osp.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    scene = osp.join(out, "scene", "P000")
    mem = None
    t0 = time.time()
    if args.memory_scene:
        mem = synthetic.memory_scene(args.scene_frames, H, W, motion="curve")
        os.makedirs(scene, exist_ok=True)     # evaluate() checks the path
        print(f"scene rendered in memory in {time.time() - t0:.1f}s",
              flush=True)
    elif not osp.isdir(scene):
        synthetic.write_scene(scene, n_frames=args.scene_frames, H=H, W=W,
                              motion="curve")
        print(f"scene rendered in {time.time() - t0:.1f}s -> {scene}",
              flush=True)

    cfg = hw_config(args)
    cfg_path = osp.join(out, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    targs = train_args(args, scene, cfg_path)

    cwd = os.getcwd()
    os.chdir(out)                   # checkpoints/ lands under the run dir
    try:
        with span("train"):
            t0 = time.time()
            if mem is None:
                loop = tcli.train(targs, M=M)
            else:
                data = synthetic.MemoryDataset(mem, cfg, seed=targs.seed,
                                               fmin=targs.fmin,
                                               fmax=targs.fmax)
                loop = tcli.TrainLoop(targs, cfg, data, M=M)
                loop.run()
            wall = time.time() - t0
    finally:
        os.chdir(cwd)
    history = list(loop.history)
    with open(osp.join(out, "losses.json"), "w") as f:
        json.dump(history, f)

    restored = restore_checkpoint(osp.join(out, "checkpoints", RUN_NAME))
    if int(restored["step"]) != args.steps:
        raise RuntimeError(f"restored step {restored['step']}, want "
                           f"{args.steps}")
    for k, v in loop.net.state_dict().items():
        if not torch.equal(restored["params"][k], v.cpu()):
            raise RuntimeError(f"restored weights differ from the trained "
                               f"ones at {k}")
    print(f"\ntrained {args.steps} steps in {wall:.0f}s "
          f"({wall / args.steps:.2f} s/step incl. compile)", flush=True)

    mode = cfg["data_loader"]["train"]["args"]["input_mode"]
    net0 = init_weights(VONet(mode), torch.Generator().manual_seed(999))
    eval_cfg = hw_eval_cfg(cfg, scene)
    vocfg = config_VO or eval_vo_config()
    read_scene = read_scene_files if mem is None \
        else synthetic.memory_reader(mem)
    evaluations = {}

    def ate_of(net, tag):
        def read(path, ecfg, downsample_fact):
            got = read_scene(path, ecfg, downsample_fact)
            evaluations[tag] = (len(got[0]), int(sum(
                bool(d["mask"][0]) for d in got[0])))
            return got

        with span(f"evaluate {tag}"):
            res = evaluate(net, trials=1, config_VO=vocfg, eval_cfg=eval_cfg,
                           save_dir=osp.join(out, f"trajs_{tag}"), chunk=8,
                           device=args.device, read_scene=read)
        return res[scene]["trial_0"]["ate"]

    ate_random = ate_of(net0, "random")
    ate_trained = ate_of(load_params(restored, mode), "trained")
    summary = dict(zip(SUMMARY_KEYS, (
        args.steps, wall, wall / args.steps, float(ate_random),
        float(ate_trained))))
    with open(osp.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2), flush=True)
    return {"summary": summary, "history": history, "net": loop.net,
            "restored": restored, "evaluations": evaluations}


def check(summary: dict) -> int:
    """The script's verdict on a run's summary: 0 (and HW TRAIN RUN OK)
    when the trained weights beat the random ones, else 1."""
    if not summary["ate_trained"] < summary["ate_random"]:
        print(f"FAIL: trained weights must beat random init "
              f"(ATE {summary['ate_trained']} against "
              f"{summary['ate_random']})", file=sys.stderr, flush=True)
        return 1
    print("HW TRAIN RUN OK", flush=True)
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--hw", type=str, default="480x640")
    ap.add_argument("--n_frames", type=int, default=15)
    ap.add_argument("--unroll", type=int, default=18)
    ap.add_argument("--scene_frames", type=int, default=60)
    ap.add_argument("--out", type=str,
                    default=osp.join(tempfile.gettempdir(), "hw_train_run"))
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--memory_scene", action="store_true",
                    help="hold the scene in memory instead of writing files")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    return check(run(parse_args(argv))["summary"])


if __name__ == "__main__":
    sys.exit(main())
