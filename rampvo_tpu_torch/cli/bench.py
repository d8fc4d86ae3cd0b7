"""Benchmark: steady-state VO frame rate of the port (the counterpart of
the JAX package's bench.py).

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
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import resolve_device
from ..models.vonet import VONet, init_weights
from ..vo import RampVO, VOConfig

WARM = 40     # eager frames before timing, as bench.py's


def bench_config(patches: int, layout: str) -> VOConfig:
    """bench.py:57-69, with `patches` patches a frame and CORR_LAYOUT
    `layout`."""
    return VOConfig(BUFFER_SIZE=512, MAX_FRAMES=512, MIXED_PRECISION=True,
                    PROBE_THRESH=-1.0, KEYFRAME_THRESH=0.0,
                    PATCHES_PER_FRAME=patches, CORR_LAYOUT=layout)


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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
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
