"""Offline VO evaluation, the way `cli/evaluate.py --chunk K` runs a scene:
one stream, frames handed to `RampVO.__call__` back to back (a closed
loop), K frames to a CUDA-graph replay.

Set-up: the kernel libraries, weights and the scene pool made on the
device from the seed, the eager warm frames (initialization, a full edge
lattice), then one chunk that captures the graph and `warm_chunks` more.
The window hands frames over until the first chunk that completes at or
after its length; after each chunk the loop copies the chunk's K poses
to the host, as a user reading poses does. Metrics:

- vo_frames_per_s: frames of the chunks completed in the window over the
  window's whole time (the window closes when its last chunk's poses are
  on the host);
- pose_latency_ms_p95: the 95th percentile, over every chunk of the
  window, of the time from handing over the frame that completes the
  chunk to its K poses being on the host.

With --trace 1 the profiler records `trace.chunks` chunks from chunk
`trace.start_chunk` of the window (the slice), and the loop counts the
live edges and feature slots each traced chunk held, for the work counts.

Correctness: `check_vo` follows sampled chunks of the window from the
program's state, and the start of the run from the empty state, with the
plain reference.
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np
import torch

from .. import check_vo
from ..scene import make_pool
from ..trace import SLICE, profiled
from ..weights import make_weights


def vo_config(traffic: dict):
    """The VOConfig the cell runs: the traffic's preset, with the
    capacities and overrides that the run asks for (the traffic's too)."""
    from rampvo_tpu_torch.vo import VOConfig

    kw = {k: v for k, v in traffic["vo_preset"].items() if k != "source"}
    kw.update(traffic["vo_capacity"])
    kw.update(traffic.get("vo_overrides", {}))
    return VOConfig(**kw)


def copy_state(state):
    """A snapshot of a VOState: every tensor cloned (the encoder carry's
    too), the host scalars as they are."""
    def clone(x):
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(clone(v) for v in x)
        return x.clone() if isinstance(x, torch.Tensor) else x

    return {f.name: clone(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def lattice_of(state) -> tuple:
    """What `lattice_counts` reads of a state, copied on the device (no
    wait for the host inside the traced slice)."""
    return int(state.n), state.cell_valid.clone(), state.slotmap.clone()


def lattice_counts(lattice, cfg) -> tuple:
    """(live edges, distinct target slots, distinct host slots) of a
    lattice from `lattice_of`: the cells with host and target inside
    [0, n) and the target inside the last NI + r - 2 frames, as the
    update's correlation computes them."""
    NI, T, M, r = cfg.NI, cfg.T, cfg.M, cfg.PATCH_LIFETIME
    n, valid, slotmap = lattice
    valid = valid.cpu().numpy()
    lo = max(0, n - NI - T)
    slots = slotmap[lo:n].cpu().numpy()
    i_row = np.arange(NI)[:, None]
    i = n - 1 - np.mod(n - 1 - i_row, NI) + 0 * np.arange(T)[None, :]
    j = i + np.arange(T)[None, :] - (r - 1)
    live = valid & (i >= 0) & (j >= 0) & (j <= n - 1) & (j >= n - (NI + r - 2))
    slot = lambda x: slots[x - lo]
    return (int(live.sum()) * M, len(set(slot(j[live]).tolist())),
            len(set(slot(i[live]).tolist())))


def run(ctx) -> dict:
    cfg_j, tr = ctx.config, ctx.traffic
    dev = ctx.device
    H, W, K = tr["height"], tr["width"], tr["chunk"]
    mode, bins = cfg_j["input_mode"], cfg_j["num_event_bins"]
    with ctx.part("imports"):
        from rampvo_tpu_torch.models.vonet import VONet
        from rampvo_tpu_torch.vo import RampVO
    ctx.init_device()
    ctx.build_kernels(["corr_lattice", "lstm_fold" if mode == "MultiScale"
                       else "lstm_carry_fold"])
    cfg = vo_config(tr)
    with ctx.part("weights"):
        with torch.device("meta"):
            net = VONet(mode, evs_ch=bins)
        sd = make_weights(net, ctx.seed, dev)
        net = net.to_empty(device=dev)
        net.load_state_dict(sd)
    with ctx.part("scene"):
        events, images, intr = make_pool(tr["scene"], H, W, ctx.seed + 1,
                                         dev)
        ctx.sync()
    ncyc = events.shape[0]
    mask = np.ones(1, dtype=bool)
    with ctx.part("RampVO"):
        vo = RampVO(cfg, net, input_mode=mode, num_event_bins=bins, ht=H,
                    wd=W, seed=ctx.seed, device=dev, chunk=K)
    del net
    frame = 0

    def hand(i):
        f = i % ncyc
        vo(i, events[f], images[f], mask, intr)

    snaps = {}
    eager = set(tr["check"]["warm_frames"])
    with ctx.part("warm frames"):
        for i in range(tr["warm_frames"]):
            if frame in eager:
                snaps[f"fpre{frame}"] = (frame, copy_state(vo.state))
            hand(frame)
            vo.flush()
            if frame in eager:
                snaps[f"fpost{frame}"] = copy_state(vo.state)
            frame += 1
            if frame == tr["check"]["start_frames"]:
                snaps["start"] = copy_state(vo.state)
        ctx.sync()
        if not vo.state.initialized:
            raise RuntimeError("the VO did not initialize in the warm-up")
    with ctx.part("capture"):
        for _ in range(1 + tr["warm_chunks"]):
            t_chunk = ctx.now()
            for _ in range(K):
                hand(frame)
                frame += 1
            c = vo.state.counter
            vo.state.poses[c - K:c].cpu()
            span = ctx.now() - t_chunk
        ctx.sync()

    # the chunks followed: the early chunks, and the chunk that runs at
    # each of these times (seconds into the window; a chunk is taken to
    # last as long as the one before it), or the next outside the traced
    # slice
    chk = tr["check"]
    rng = np.random.RandomState(ctx.seed % 2 ** 32)
    early = set(rng.choice(chk["early_range"], chk["early_chunks"],
                           replace=False).tolist())
    snaps["early"] = early
    follow_at = sorted(rng.uniform(0, chk["window_share"], chk["chunks"])
                       * ctx.seconds)
    tc = tr["trace"]
    traced = range(tc["start_chunk"], tc["start_chunk"] + tc["chunks"])
    lat, done_at, counts = [], [], []
    chunk = 0
    prof = None
    t0 = ctx.open_window()
    deadline = t0 + ctx.seconds
    while True:
        if ctx.trace and chunk == traced.start:
            counts.append(lattice_of(vo.state))
            prof = profiled(True)
            holder = prof.__enter__()
            sl = torch.profiler.record_function(SLICE)
            sl.__enter__()
        t_chunk = ctx.now()
        at = bool(follow_at) and t_chunk + span - t0 > follow_at[0]
        followed = ((at or chunk in early)
                    and not (ctx.trace and chunk in traced))
        if followed:
            if at:
                follow_at.pop(0)
            snaps[f"pre{chunk}"] = (frame, copy_state(vo.state))
        for k in range(K):
            if k == K - 1:
                t_hand = ctx.now()
            with torch.profiler.record_function("vo.handoff"):
                hand(frame)
            frame += 1
        with torch.profiler.record_function("vo.pose_readout"):
            c = vo.state.counter
            vo.state.poses[c - K:c].cpu()
        t_done = ctx.now()
        span = t_done - t_chunk
        lat.append(t_done - t_hand)
        done_at.append(t_done)
        if followed:
            snaps[f"post{chunk}"] = copy_state(vo.state)
        if prof is not None and chunk in traced:
            counts.append(lattice_of(vo.state))
            if chunk == traced[-1]:
                sl.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                prof = None
        chunk += 1
        if t_done >= deadline and (not ctx.trace or chunk > traced[-1]):
            break
    window = done_at[-1] - t0
    ctx.close_window()
    n_frames = K * len(done_at)
    tenths = [0] * 10
    for t in done_at:
        tenths[min(int(10 * (t - t0) / window), 9)] += K
    print(f"vo: {len(done_at)} chunks, {n_frames} frames in {window:.4f} s; "
          "frames/s by tenth of the window: "
          + " ".join(f"{10 * v / window:.2f}" for v in tenths), flush=True)
    print("vo: chunks followed by the check: " + " ".join(
        k[3:] + ("e" if int(k[3:]) in early else "")
        for k in snaps if k.startswith("pre")), flush=True)
    print(f"vo: pose latency ms median {1e3 * statistics.median(lat):.3f}, "
          f"max {1e3 * max(lat):.3f}; graph launches a chunk "
          f"{vo._vo_chunk.captured}", flush=True)
    out = {
        "metrics": {
            "vo_frames_per_s": n_frames / window,
            "pose_latency_ms_p95": 1e3 * float(np.percentile(lat, 95)),
        },
        "attempted": len(done_at), "failed": 0,
        "memory_peak_bytes": ctx.memory_peak(),
    }
    if ctx.trace:
        t = holder.trace
        counts = [lattice_counts(c, cfg) for c in counts]
        pairs = list(zip(counts[:-1], counts[1:]))
        t.work = {
            "kind": "vo", "mode": mode, "frames": K * len(pairs), "H": H, "W": W,
            "M": cfg.M, "lattice": (cfg.NI, cfg.T, cfg.M), "bins": bins,
            "dtype_bytes": 2 if cfg.MIXED_PRECISION else 4,
            # per traced frame: the mean of the chunk's two ends
            "edges": [(a[0] + b[0]) / 2 for a, b in pairs for _ in range(K)],
            "target_slots": [(a[1] + b[1]) / 2 for a, b in pairs
                             for _ in range(K)],
            "host_slots": [(a[2] + b[2]) / 2 for a, b in pairs
                           for _ in range(K)],
        }
        out["trace"] = t
    # the program's state is freed before the reference runs
    del vo
    ctx.free()
    out["checks"] = check_vo.check(ctx, cfg, sd, snaps, events, images, intr,
                                   K)
    return out
