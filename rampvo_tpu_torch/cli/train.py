"""Training CLI (port of rampvo_tpu/cli/train.py; ref train.py:67-232).

Flag-compatible with the JAX CLI, plus `--device`:
  python -m rampvo_tpu_torch.cli.train --config_path config_net/X.json
      --data_path D [--name N] [--ckpt C] [--log_results] [--workers W]
      [--device cuda|cpu]

AdamW behind global-norm clipping with the one-cycle learning rate
(`train/step.py`), checkpoints every steps_to_save_ckpt under
checkpoints/<name>/ (`ckpt/train_state.py`), optional validation through
`cli.evaluate.evaluate`, TensorBoard and wandb. Runs on the card unless
`--device cpu` is given. `train(args)` builds the TartanEvent dataset and
hands it to `TrainLoop`, which takes any dataset object (len and
getitem giving the window dict); `cli/train_hw_run.py` drives it at the
recipe's shapes.

As the reference's train.py:154 does, the loop turns the dataset's
camera-to-world poses into world-to-camera before the forward (the JAX
CLI passes them as they are; ROADMAP section 3).

Data parallel over N GPUs of a node, one process each:
  torchrun --nproc_per_node N -m rampvo_tpu_torch.cli.train ...
With WORLD_SIZE > 1 the loop joins the process group (NCCL on the card,
gloo with `--device cpu`) unless its caller already has, takes
cuda:LOCAL_RANK, samples its own windows (RandomState(seed + rank), draws
from a generator seeded seed + 1 + rank) and steps through
`parallel.make_train_step`, which sums the ranks' shares of the global
batch's gradient: the global batch is the config's batch_size x world
size, as the JAX CLI's over its local devices. Only rank 0 prints, logs,
saves checkpoints and validates.
"""

from __future__ import annotations

import argparse
import json
from collections import deque
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..ckpt.train_state import restore_checkpoint, save_checkpoint
from ..ckpt.weights import load_pth
from ..lie import ops as lops
from ..models.vonet import VONet, init_weights
from ..parallel.mesh import (BATCH_KEYS, assert_replicated, make_mesh,
                             make_train_step)
from ..train.forward import TrainForward
from ..train.step import Trainer
from ..utils.timing import span


def collate(samples):
    """The samples' arrays stacked by key (span `data.collate`)."""
    with span("data.collate"):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def join_mesh(device: str):
    """This process's mesh: with WORLD_SIZE > 1 (torchrun's environment)
    and no process group yet, join one (NCCL for "cuda", gloo for "cpu");
    a failed join raises. One process without a group: a one-member mesh
    on `device`."""
    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    if ranks > 1 and not dist.is_initialized():
        dev = resolve_device(device)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return make_mesh(device)


class TrainLoop:
    """The training loop over `dataset` for the parsed `args` and the
    network config `config` (a config_net/*.json dict), with M patches per
    frame (the recipe's 80)."""

    def __init__(self, args, config, dataset, M: int = 80):
        train_cfg = config["data_loader"]["train"]["args"]
        if len(dataset) == 0:
            raise RuntimeError("the training dataset is empty")
        self.args, self.config, self.train_cfg = args, config, train_cfg
        self.dataset = dataset
        self.mesh = join_mesh(args.device)
        self.device = self.mesh.device
        self.lead = self.mesh.rank == 0
        self.run_name = args.name or config.get("experiment_name",
                                                "rampvo_tpu")
        mode = train_cfg["input_mode"]
        self.net = init_weights(
            VONet(mode, evs_ch=train_cfg["num_event_bins"]),
            torch.Generator().manual_seed(args.seed)).to(self.device)
        self.fwd = TrainForward(
            self.net, n_frames=train_cfg["n_frames"], M=M,
            steps=args.unroll_steps, flow_weight=train_cfg["flow_weight"],
            pose_weight=train_cfg["pose_weight"],
            event_bias=train_cfg.get("event_bias", True),
            gradient_bias=train_cfg.get("gradient_bias", False))
        self.trainer = Trainer(self.net, train_cfg)
        self.step_count = 0
        if args.ckpt is not None:
            # a training checkpoint (file or directory) resumes; a reference
            # .pth (no "params" key) gives the weights only
            restored = restore_checkpoint(args.ckpt)
            if "params" in restored:
                self.net.load_state_dict(restored["params"])
                self.trainer.load_state_dict(restored["opt"])
                self.step_count = int(restored["step"])
            else:
                self.net.load_state_dict(load_pth(restored, mode))
        assert_replicated(self.mesh, self.net.parameters())
        # per rank; the global batch is batch_size x world size
        self.batch_size = max(int(train_cfg.get("batch_size", 1)), 1)
        rank = self.mesh.rank
        self.rng = np.random.RandomState(args.seed + rank)
        self.gen = torch.Generator(device=self.device).manual_seed(
            args.seed + 1 + rank)
        self._steps = {}
        self.history = deque(maxlen=1000)   # the latest steps' metrics

    def structure_only(self) -> bool:
        """Frozen-pose warmup steps (ref train.py:156), only when training
        starts without a checkpoint."""
        return (self.step_count < self.args.structure_only_steps
                and self.args.ckpt is None)

    def make_batch(self):
        n = len(self.dataset)
        return collate([self.dataset[int(self.rng.randint(1, max(n, 2)))]
                        for _ in range(self.batch_size)])

    def step(self, batch):
        """One optimizer step on this rank's `batch`; returns the float
        metrics (averaged over the ranks). The batch's conversion and copy
        to the device open the span `train.h2d`."""
        so = self.structure_only()
        if so not in self._steps:
            self._steps[so] = make_train_step(self.fwd, self.trainer,
                                              self.mesh, structure_only=so)
        with span("train.h2d"):
            t = {k: torch.as_tensor(batch[k]) for k in BATCH_KEYS}
            t = {k: v if k == "mask" else v.to(self.device,
                                               non_blocking=True).float()
                 for k, v in t.items()}
            t["poses"] = lops.se3_inv(t["poses"])      # world-to-camera
        _, m = self._steps[so](t, generator=self.gen)
        self.step_count += 1
        return {k: float(v) for k, v in m.items()}

    def save(self) -> str:
        ckpt_dir = os.path.join("checkpoints", self.run_name)
        return save_checkpoint(ckpt_dir, self.step_count,
                               self.net.state_dict(),
                               self.trainer.state_dict())

    def run(self, n_steps=None):
        """Train until the config's step count, or `n_steps` more steps."""
        args, cfg = self.args, self.train_cfg
        stop = cfg["steps"] if n_steps is None else min(
            cfg["steps"], self.step_count + n_steps)
        wandb = None
        if args.log_results and self.lead:
            try:
                import wandb
            except ImportError:
                print("WARNING: wandb is not installed, cannot log results")
        logger = None
        if args.tensorboard and self.lead:
            from ..utils.logger import Logger

            logger = Logger(self.run_name, log_dir=args.tensorboard)
        pool = ThreadPoolExecutor(max_workers=1) if args.workers > 0 else None
        try:
            fut = pool.submit(self.make_batch) if pool else None
            t_start = time.time()
            while self.step_count < stop:
                if pool is not None:
                    batch = fut.result()
                    fut = pool.submit(self.make_batch)
                else:
                    batch = self.make_batch()
                t0 = time.perf_counter()
                m = self.step(batch)
                m["step"] = self.step_count
                m["seconds"] = time.perf_counter() - t0
                self.history.append(m)
                if logger is not None:
                    logger.push({k: m[k] for k in
                                 ("loss", "px1", "flow_e", "ro", "tr")})
                if self.lead and self.step_count % args.print_every == 0:
                    out = {k: v for k, v in m.items() if k != "seconds"}
                    out["sps"] = self.step_count / (time.time() - t_start)
                    print(out, flush=True)
                    if wandb is not None:
                        wandb.log(out, step=self.step_count)
                if self.lead and \
                        self.step_count % cfg["steps_to_save_ckpt"] == 0:
                    self.save()
                    if args.validate:
                        self._validate(logger)
            if fut is not None:
                fut.result()
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
            if logger is not None:
                logger.close()
        return self.net

    def _validate(self, logger):
        from .evaluate import evaluate

        try:
            results = evaluate(self.net, eval_cfg=self.config,
                               device=self.device)
        except Exception as e:  # the reference logs and continues
            print(f"VALIDATION FAILED: {e}", flush=True)
            return
        print("validation:", results, flush=True)
        if logger is not None:
            logger.write_dict({
                f"val/{os.path.basename(s)}": t["trial_0"]["ate"]
                for s, t in results.items()
                if isinstance(t, dict) and "trial_0" in t})


def train(args, M: int = 80):
    """Build the TartanEvent dataset named by the flags and train on it
    with M patches per frame; returns the TrainLoop (its `net` trained,
    its `history` the steps' metrics)."""
    from ..data.tartan import TartanEventDataset

    with open(args.config_path) as f:
        config = json.load(f)
    dataset = TartanEventDataset(config, args.data_path, step=0,
                                 seed=args.seed, fmin=args.fmin,
                                 fmax=args.fmax)
    if len(dataset) == 0:
        raise RuntimeError(f"no training scenes found under {args.data_path}")
    loop = TrainLoop(args, config, dataset, M=M)
    loop.run()
    return loop


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str, help="Dataset path")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--log_results", action="store_true", default=False)
    parser.add_argument("--tensorboard", type=str, default=None,
                        help="TensorBoard log dir (running means every 100 "
                        "steps; stdout when TensorBoard is absent)")
    parser.add_argument("--workers", type=int, default=0)
    parser.add_argument("--fmin", type=float, default=10.0,
                        help="frame-graph min mean flow (px) for sampling")
    parser.add_argument("--fmax", type=float, default=75.0)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--unroll_steps", type=int, default=18)
    parser.add_argument("--structure_only_steps", type=int, default=1000,
                        help="structure-only warmup steps (ref "
                        "train.py:156; 0 = train poses from step one)")
    parser.add_argument("--print_every", type=int, default=10)
    parser.add_argument("--validate", action="store_true", default=False)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    return parser.parse_args(argv)


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
