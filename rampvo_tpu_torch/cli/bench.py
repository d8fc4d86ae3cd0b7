"""Benchmark: steady-state VO frame rate of the port (the counterpart of
the JAX package's bench.py), with --breakdown the VO frame split by stage
(the counterpart of scripts/breakdown.py and the VO probes), or with
--train the time of one training step (the counterpart of
scripts/bench_train_step.py and, with --ablate, of
scripts/probe_train_ablate.py).

    python -m rampvo_tpu_torch.cli.bench [--frames 40] [--height 480]
        [--width 640] [--patches 96] [--input_mode MultiScale|SingleScale]
        [--chunk 8] [--layout fused3] [--device cuda|cpu]

bench.py's VOConfig (BUFFER_SIZE = MAX_FRAMES = 512, bf16, motion probe
off, never evicting, so the edge lattice fills as a tracking run's does)
and seeded random weights (`init_weights`, seed 0) drive
`RampVO(chunk=K)`: 40 warm frames eagerly (initialization and a full
lattice), one chunk that captures the CUDA graph, then the best of two
passes over `--frames` frames (cut to a multiple of K), each pass ending
in a synchronize. The frames are made on the device before any timing.
On the card a line before the last gives the card, the device-busy
ms/frame and the kernels a frame (torch.profiler over one chunk). The last line is one JSON object
{"metric", "value", "unit", "device"}: frames/s, named by input mode and
size.

    python -m rampvo_tpu_torch.cli.bench --breakdown [--variants a,b,...]
        [--turns 5] [--warm 40] [--chunk 8] [--input_mode ...]
        [--layout fused3] [--height 480] [--width 640] [--patches 96]
        [--small] [--device cuda|cpu]

`probes.breakdown.run_breakdown` on bench.py's VOConfig (never
evicting), seeded weights and np.random.RandomState(0) frames: --warm
eager frames, then each variant of `probes.frame.VARIANTS` (every one by
default) as a CUDA graph of --chunk frames, replayed from the warmed
state in --turns interleaved turns; the stage table, each stage alone and
a profiled replay. One line per variant and stage; the last line is one
JSON object {"metric": "vo_frame_breakdown_<mode>_HxW", "value" (all's
median graph ms/frame), "unit": "ms/frame", "stages", "variants",
"alone", "checks", "top15", "device"}. --small runs 64x96, M=8, float32
on a small lattice (the CPU tests' size; with --device cpu the plain
versions, host-clock times).

    python -m rampvo_tpu_torch.cli.bench --train [--iters 3] [--small]
        [--ablate full,no_corr,no_encoder,no_ba,no_update,pose_only | all]
        [--steps 18] [--n_frames 15] [--patches 96] [--device cuda|cpu]

One full-recipe training step (bench_train_step.py's: MultiScale,
480x640 or 240x320 with --small, 15 frames, M = 96, 18 unrolled steps,
B = 1, f32, inputs from np.random.RandomState(0), clip_by_global_norm(10)
and AdamW(1e-4, weight decay 1e-6) at a flat rate) through
`parallel.make_train_step` with no mesh. Prints the first step's seconds
and loss, then the best of --iters steps, each ending in a synchronize;
each --ablate variant (`TrainForward(ablate=)`, ABLATE_VARIANTS) is timed
in turn in this process, one line each. The last line is one JSON object
{"metric": "train_step_s_MultiScale_HxW", "value", "unit": "s/step",
"device"} for the first variant (with "variants", s/step of each, under
--ablate). The JAX script's --impls (its fused or XLA correlation, with or
without the remat save) picks TPU paths the port does not have, so it is
left out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from .. import resolve_device
from ..lie import ops as lops
from ..models.vonet import VONet, init_weights
from ..parallel.mesh import make_train_step
from ..train.forward import TrainForward
from ..train.step import Trainer
from ..vo import RampVO, VOConfig

WARM = 40     # eager frames before timing, as bench.py's
ABLATE_VARIANTS = {               # scripts/probe_train_ablate.py's
    "full": frozenset(),
    "no_corr": frozenset({"corr"}),
    "no_encoder": frozenset({"encoder"}),
    "no_ba": frozenset({"ba"}),
    "no_update": frozenset({"update"}),
    "pose_only": frozenset({"corr", "encoder", "update"}),
}


SMALL = dict(BUFFER_SIZE=64, MAX_FRAMES=64, REMOVAL_WINDOW=5,
             OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
             MIXED_PRECISION=False, MEM=16, PATCHES_PER_FRAME=8)


def bench_config(patches: int, layout: str) -> VOConfig:
    """bench.py:57-69, with `patches` patches a frame and CORR_LAYOUT
    `layout`."""
    return VOConfig(BUFFER_SIZE=512, MAX_FRAMES=512, MIXED_PRECISION=True,
                    PROBE_THRESH=-1.0, KEYFRAME_THRESH=0.0,
                    PATCHES_PER_FRAME=patches, CORR_LAYOUT=layout)


def breakdown(args, dev) -> dict:
    """--breakdown: `probes.breakdown.run_breakdown` on bench_config (the
    probe scripts' config: KEYFRAME_THRESH=0.0, PROBE_THRESH=-1.0), or at
    the CPU tests' size with --small."""
    from ..probes.breakdown import run_breakdown

    cfg = bench_config(args.patches, args.layout)
    H, W = args.height, args.width
    if args.small:
        cfg, H, W = dataclasses.replace(cfg, **SMALL), 64, 96
    net = init_weights(VONet(args.input_mode),
                       torch.Generator().manual_seed(0))
    return run_breakdown(cfg, net, args.input_mode, H, W, dev,
                         args.variants.split(",") if args.variants else None,
                         turns=args.turns, K=max(args.chunk, 1),
                         warm=args.warm)


def device_busy(vo, frames, intr):
    """(device ms/frame, kernels/frame) of `frames` through `vo`, from
    torch.profiler's CUDA kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for f, (ev, im) in enumerate(frames):
            vo(f, ev, im, [True], intr)
        vo.flush()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    n = len(frames)
    return (sum(e.self_device_time_total for e in dev) / 1e3 / n,
            sum(e.count for e in dev) / n)


def train_batch(n_frames: int, ht: int, wd: int, device):
    """bench_train_step.py's batch of one window from RandomState(0)."""
    rng = np.random.RandomState(0)
    B, NF = 1, n_frames
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    batch = {"events": t(rng.rand(B, NF, ht, wd, 5)),
             "images": t(rng.rand(B, NF, ht, wd, 3))}
    xi = t(0.05 * rng.randn(B * NF, 6))
    batch["poses"] = lops.se3_exp(xi).reshape(B, NF, 7)
    batch["disps"] = t(0.5 + 0.1 * rng.rand(B, NF, ht, wd))
    batch["intrinsics"] = t([320.0, 320.0, wd / 2, ht / 2]).expand(B, NF, 4)
    batch["mask"] = torch.ones((B, NF), dtype=torch.bool)
    return batch


def bench_train(args, dev, name: str) -> dict:
    """Time one training step of each --ablate variant; returns the last
    line's dict (with "variants", {variant: best s/step}, under
    --ablate)."""
    ht, wd = (240, 320) if args.small else (args.height, args.width)
    variants = (list(ABLATE_VARIANTS) if args.ablate == "all"
                else (args.ablate or "full").split(","))
    unknown = [v for v in variants if v not in ABLATE_VARIANTS]
    if unknown:
        raise ValueError(f"--ablate: unknown variants {unknown}")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    batch = train_batch(args.n_frames, ht, wd, dev)
    out = {}
    for v in variants:
        net = init_weights(VONet("MultiScale"),
                           torch.Generator().manual_seed(0)).to(dev)
        fwd = TrainForward(net, n_frames=args.n_frames, M=args.patches,
                           steps=args.steps, ablate=ABLATE_VARIANTS[v])
        trainer = Trainer(net, {"steps": 1, "lr": 1e-4, "clip": 10.0,
                                "weight_decay": 1e-6},
                          schedule=lambda k: 1e-4)
        step = make_train_step(fwd, trainer)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        g = torch.Generator(device=dev)
        t = time.perf_counter()
        loss, _ = step(batch, generator=g.manual_seed(1))
        loss = float(loss)
        print(f"[{v}] first step {time.perf_counter() - t:.3f} s "
              f"loss={loss:.6g}", flush=True)
        best = float("inf")
        for _ in range(args.iters):
            t = time.perf_counter()
            step(batch, generator=g.manual_seed(2))
            sync()
            best = min(best, time.perf_counter() - t)
        peak = (f", peak {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f}"
                " GiB" if dev.type == "cuda" else "")
        print(f"[{v}] {name}: train step {best:.4f} s (best of {args.iters}; "
              f"MultiScale {ht}x{wd}, {args.n_frames} frames, M="
              f"{args.patches}, {args.steps}-step unroll, E={fwd.E}{peak})",
              flush=True)
        out[v] = best
        del net, fwd, trainer, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    first = variants[0]
    res = {"metric": f"train_step_s_MultiScale_{ht}x{wd}"
           + ("" if first == "full" else f"_{first}"),
           "value": out[first], "unit": "s/step", "device": name}
    if args.ablate:
        res["variants"] = out
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--chunk", type=int, default=8,
                    help="frames per CUDA-graph replay (1 = every frame "
                    "eagerly)")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--patches", type=int, default=96)
    ap.add_argument("--input_mode", type=str, default="MultiScale",
                    choices=["MultiScale", "SingleScale"])
    ap.add_argument("--layout", type=str, default="fused3",
                    help="CORR_LAYOUT: fused3, fused4, fused2 or folded")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--train", action="store_true",
                    help="time one training step instead of VO frames")
    ap.add_argument("--iters", type=int, default=3,
                    help="--train: timed steps after the first (best of)")
    ap.add_argument("--small", action="store_true",
                    help="--train at 240x320; --breakdown at 64x96, M=8, "
                    "float32, a small lattice")
    ap.add_argument("--breakdown", action="store_true",
                    help="split the VO frame by stage instead")
    ap.add_argument("--variants", type=str, default=None,
                    help="--breakdown: comma list of probes.frame.VARIANTS "
                    "(default: every one)")
    ap.add_argument("--turns", type=int, default=5,
                    help="--breakdown: interleaved turns of replays")
    ap.add_argument("--warm", type=int, default=WARM,
                    help="--breakdown: eager frames before the graphs")
    ap.add_argument("--ablate", type=str, default=None,
                    help="--train: comma list of " + ", ".join(
                        ABLATE_VARIANTS) + ", or all")
    ap.add_argument("--steps", type=int, default=18,
                    help="--train: unrolled steps")
    ap.add_argument("--n_frames", type=int, default=15,
                    help="--train: frames of the window")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.train:
        res = bench_train(args, dev, torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")
        print(json.dumps(res))
        return res
    if args.breakdown:
        res = breakdown(args, dev)
        print(json.dumps(res))
        return res
    H, W, K = args.height, args.width, max(args.chunk, 1)
    cfg = bench_config(args.patches, args.layout)
    n_frames = args.frames - args.frames % K
    if n_frames < K or WARM + 3 * n_frames + 2 * K > cfg.MAX_FRAMES:
        raise ValueError("needs --frames >= --chunk and every frame within "
                         f"MAX_FRAMES {cfg.MAX_FRAMES}")
    net = init_weights(VONet(args.input_mode), torch.Generator().manual_seed(0))
    vo = RampVO(cfg, net, input_mode=args.input_mode, ht=H, wd=W, device=dev,
                seed=0, chunk=K)
    g = torch.Generator(device=dev).manual_seed(0)
    frames = [(torch.rand(1, H, W, 5, generator=g, device=dev),
               torch.rand(1, H, W, 3, generator=g, device=dev))
              for _ in range(WARM + K + n_frames)]
    intr = torch.tensor([320.0, 320.0, W / 2, H / 2], device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    # warm-up: initialize and fill the lattice frame by frame (a partial
    # buffer runs eagerly), then one chunk, which captures the graph
    for i in range(WARM):
        vo(i, *frames[i], [True], intr)
        vo.flush()
    for i in range(WARM, WARM + K):
        vo(i, *frames[i], [True], intr)
    vo.flush()
    sync()
    if not vo.state.initialized:
        raise RuntimeError("the VO did not initialize during the warm-up")

    timed = frames[WARM + K:]
    dt = float("inf")
    for p in range(2):
        t = time.perf_counter()
        for i, (ev, im) in enumerate(timed):
            vo(p * n_frames + i, ev, im, [True], intr)
        vo.flush()
        sync()
        dt = min(dt, time.perf_counter() - t)

    mode = args.input_mode.lower()
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        busy, calls = device_busy(vo, timed[:K] if K > 1 else timed[:4], intr)
        print(f"{name}: {args.input_mode} {H}x{W} M={args.patches} "
              f"{args.layout} chunk={K}: device busy {busy:.3f} ms/frame, "
              f"{calls:.0f} kernels/frame, {1e3 * dt / n_frames:.3f} ms/frame")
    else:
        name = "cpu"
        print(f"cpu: {args.input_mode} {H}x{W} M={args.patches} {args.layout} "
              f"chunk={K}: {1e3 * dt / n_frames:.3f} ms/frame; device busy "
              "not measured (no card)")
    print(json.dumps({"metric": f"vo_fps_{mode}_{H}x{W}",
                      "value": n_frames / dt, "unit": "frames/s",
                      "device": name}))


if __name__ == "__main__":
    main()
