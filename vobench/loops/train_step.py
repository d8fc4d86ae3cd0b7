"""The training loop users run, `cli/train.py::TrainLoop`, on the
benchmark's own scene: its loader (window sampling over the frame graph,
event stacks, augmentation, normalization) and its optimizer step, one
after the other as the CLI runs them without loader workers.

Set-up: the kernel library, the scene (rendered on the card from the
seed, its events copied to the host where the loader reads them), the
loop with the benchmark's weights, and its first `check.steps` steps,
which the reference follows afterwards (losses, the optimizer's first
gradient, the parameters before and after). The window runs further
steps until the first that ends at or after its length:

- train_s_per_step: the window's time over the optimizer steps completed
  in it (each step's loader call included).

With --trace 1 the profiler records `trace.steps` steps (the slice) after
`trace.start_step` steps of the window.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import check_train
from ..scene import make_texture, render
from ..trace import SLICE, profiled
from ..weights import make_weights


def train_config(cfg: dict, traffic: dict) -> dict:
    """The network config the loop takes (config_net/*.json's layout)."""
    args = dict(traffic["recipe"], input_mode=cfg["input_mode"],
                num_event_bins=cfg["num_event_bins"])
    return {"experiment_name": "vobench", "event_representation":
            cfg["event_representation"],
            "data_loader": {"train": {"args": args},
                            "test": {"test_split": []}}}


def loop_args(traffic: dict, seed: int, device) -> argparse.Namespace:
    """The CLI's flags for the loop (cli/train.py::parse_args)."""
    return argparse.Namespace(
        device=device, seed=seed, name="vobench", ckpt=None,
        unroll_steps=traffic["unroll_steps"],
        structure_only_steps=traffic["structure_only_steps"],
        log_results=False, tensorboard=None, workers=0, print_every=10 ** 9,
        validate=False, fmin=traffic["fmin"], fmax=traffic["fmax"])


def memory_scene(p: dict, H: int, W: int, seed: int, device):
    """data/synthetic.py's `memory_scene` made on the card: the frames
    rendered from a texture drawn from `seed`, the events of each frame
    step (row-major, times spread linearly over the step, polarity 1 or
    0) copied to the host, the 8-bit images, camera-to-world poses,
    intrinsics and the per-frame event index ranges."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    tex = make_texture(H, W, g, device)
    n, fx, z = int(p["pool_frames"]), float(p["fx"]), float(p["plane_z"])
    frames = [render(tex, H, W, fx, z, i, p["motion"]) for i in range(n)]
    xs, ys, ts, ps = [], [], [], []
    for i in range(1, n):
        d = frames[i] - frames[i - 1]
        y, x = torch.nonzero(d.abs() > p["event_thresh"], as_tuple=True)
        k = x.numel()
        t = (i * 1000 + torch.linspace(0, 999, k, dtype=torch.float64,
                                       device=device).to(torch.int64)
             - 1000) if k else torch.zeros(0, dtype=torch.int64,
                                                       device=device)
        xs.append(x), ys.append(y), ts.append(t)
        ps.append((d[y, x] > 0).to(torch.int8))
    cat = lambda a, dt: torch.cat(a).cpu().numpy().astype(dt)
    x, y, t, pol = (cat(xs, np.uint16), cat(ys, np.uint16),
                    cat(ts, np.int64), cat(ps, np.int8))
    images = torch.stack([f.clamp(0, 255).to(torch.uint8) for f in frames])
    images = images[..., None].expand(n, H, W, 3).cpu().numpy()
    from rampvo_tpu_torch.data.synthetic import MemoryEvents
    from ..scene import camera_xy

    poses = np.asarray([[*camera_xy(i, p["motion"]), 0, 0, 0, 0, 1]
                        for i in range(n)], np.float64)
    stamps = np.arange(n) * 1000.0
    i1 = np.searchsorted(t, stamps, side="right")
    return {"images": images, "poses": poses,
            "intrinsics": np.array([fx, fx, W / 2.0, H / 2.0], np.float32),
            "stamps": stamps, "events": MemoryEvents(x, y, t, pol, H, W),
            "i0": np.clip(i1 - 600, 0, len(t) - 1), "i1": i1}


def run(ctx) -> dict:
    cfg_j, tr = ctx.config, ctx.traffic
    dev = ctx.device
    H, W = tr["height"], tr["width"]
    # the recipe is float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with ctx.part("imports"):
        from rampvo_tpu_torch.cli.train import TrainLoop
        from rampvo_tpu_torch.data.synthetic import MemoryDataset
    ctx.init_device()
    ctx.build_kernels(["corr_train"])
    seed = ctx.seed % 2 ** 32
    config = train_config(cfg_j, tr)
    args = loop_args(tr, seed, dev.type)
    with ctx.part("scene"):
        scene = memory_scene(tr["scene"], H, W, ctx.seed + 1, dev)
    with ctx.part("dataset"):
        data = MemoryDataset(scene, config, step=0, seed=seed,
                             fmin=tr["fmin"], fmax=tr["fmax"])
    with ctx.part("loop"):
        loop = TrainLoop(args, config, data, M=tr["patches"])
        sd = make_weights(loop.net, ctx.seed, loop.device)
        loop.net.load_state_dict(sd)

    def one_step():
        with torch.profiler.record_function("loader.next"):
            batch = loop.make_batch()
        with torch.profiler.record_function("train.step"):
            m = loop.step(batch)
        return batch, m

    apply = loop.trainer.apply

    def traced_apply():
        with torch.profiler.record_function("optimizer"):
            return apply()

    loop.trainer.apply = traced_apply
    kept = {"params0": {k: v.detach().clone() for k, v in
                        loop.net.named_parameters()}}
    with ctx.part("first steps"):
        batches, losses = [], []
        for s in range(tr["check"]["steps"]):
            batch, m = one_step()
            batches.append(batch)
            losses.append(m["loss"])
            if s == 0:
                # the first moment after one step: (1 - beta1) g; an
                # optimizer that kept none took no gradient
                st, b1 = loop.trainer.opt.state, \
                    loop.trainer.opt.defaults["betas"][0]
                kept["grad1"] = {
                    k: st[p].get("exp_avg", torch.zeros_like(p)).detach()
                    .clone() / (1 - b1)
                    for k, p in loop.net.named_parameters()}
        kept["params3"] = {k: v.detach().clone() for k, v in
                           loop.net.named_parameters()}
        for _ in range(tr["warm_steps"]):
            one_step()
        ctx.sync()

    tc = tr["trace"]
    traced = range(tc["start_step"], tc["start_step"] + tc["steps"])
    done_at, prof = [], None
    t0 = ctx.open_window()
    deadline = t0 + ctx.seconds
    step = 0
    while True:
        if ctx.trace and step == traced.start:
            prof = profiled(True)
            holder = prof.__enter__()
            sl = torch.profiler.record_function(SLICE)
            sl.__enter__()
        one_step()
        t = ctx.now()
        done_at.append(t)
        if prof is not None and step == traced[-1]:
            sl.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            prof = None
        step += 1
        if t >= deadline and (not ctx.trace or step > traced[-1]):
            break
    window = done_at[-1] - t0
    ctx.close_window()
    steps = len(done_at)
    gaps = np.diff([t0] + done_at)
    print(f"train: {steps} steps in {window:.4f} s; s/step median "
          f"{float(np.median(gaps)):.4f}, min {gaps.min():.4f}, max "
          f"{gaps.max():.4f}", flush=True)
    out = {"metrics": {"train_s_per_step": window / steps},
           "attempted": steps, "failed": 0,
           "memory_peak_bytes": ctx.memory_peak()}
    if ctx.trace:
        t = holder.trace
        fwd = loop.fwd
        t.work = {"kind": "train", "steps": tc["steps"], "H": H, "W": W,
                  "M": fwd.M, "n_frames": fwd.n_frames, "E": fwd.E,
                  "unroll": fwd.steps, "bins": cfg_j["num_event_bins"],
                  "voxels": int(tr["recipe"]["n_frames"]
                                * (tr["recipe"]["n_events_in_between"] + 1)),
                  "created_at": fwd.sched.created_at.tolist(),
                  "dtype_bytes": 4}
        t.counters = {"peak_bytes": out["memory_peak_bytes"]}
        out["trace"] = t
    del loop, data
    ctx.free()
    out["checks"] = check_train.check(ctx, config, args, scene, sd, batches,
                                      losses, kept)
    return out
