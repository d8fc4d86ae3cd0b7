"""Run one cell of the benchmark (`vobench`) with the program's tracing on,
and read the traced slice by the program's own spans.

    python3 trace_cells.py --workload ms_eval --seed 2148500001
        [--seconds 51] [--trace 0|1] [--tracing 0|1]

The cell runs as `python3 -m vobench.run` runs it and prints its result
line first. `--tracing 1` (the default) turns the program's spans on
(`utils.timing.set_tracing`) before the cell builds anything; `--tracing 1
--trace 0` therefore runs the cell untraced with the spans on, which is
what the spans cost without a profiler. Then, in a VO cell:

- `chunks`: host ms a chunk in `vo.chunk.stage`, `.launch` and `.wait`
  (the chunk's own counters, `frames.host`, read after every chunk) by
  tenth of the window, beside the window's frames/s by tenth, with
  tracing on or off;
- `stage map`: the graph's nodes by stage (`frames.stage_nodes`);

and with `--trace 1` (the benchmark's traced slice, its profiler session
kept and reduced by `rampvo_tpu_torch.probes.stages`):

- VO: the activities of each replay against the map's nodes, device ms a
  frame by stage (the seven, `vo.frame.other`, and the five groups of
  `probes/breakdown.py`'s split)
  against the replays' busy ms a frame, each stage's top kernels, device
  work launched outside the replays by span, host ms a chunk in stage and
  launch from the spans, and the idle gaps named by program span (else by
  the benchmark's span, else "other");
- training: host s a step under the `data.*` spans (their union) against
  the device's idle time under `loader.next`, host µs a launch under
  `train.forward`, `.backward` and `.apply`, and the idle gaps by span.

The benchmark's own traced slice and readers are untouched: this keeps
the profiler session that `vobench/trace.py` opens (by wrapping
`torch.profiler.profile`) and reads it a second time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict



def patch(kept: dict):
    """Keep the profiler sessions, the window's opening, the RampVO
    objects and their chunk counters after each chunk."""
    import torch
    import torch.profiler

    import rampvo_tpu_torch.vo as pvo
    import vobench.run as vr

    class Kept(torch.profiler.profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept["prof"].append(self)
            return out

    torch.profiler.profile = Kept

    open_window = vr.Context.open_window

    def opened(self):
        t = open_window(self)
        kept["t0"] = time.perf_counter()
        return t

    vr.Context.open_window = opened

    class Recorded(pvo.RampVO):       # the VO loop imports it at run time
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            kept["vo"].append(self)

        def flush(self):
            super().flush()
            h = self._vo_chunk.host if self._vo_chunk is not None else None
            if h and (not kept["chunks"]
                      or kept["chunks"][-1][1]["chunks"] != h["chunks"]):
                kept["chunks"].append((time.perf_counter(), dict(h)))

    pvo.RampVO = Recorded


def by_tenth(kept: dict):
    """Host ms a chunk in stage, launch and wait, by tenth of the window
    (the chunks that ended in it)."""
    t0 = kept["t0"]
    rec = [r for r in kept["chunks"] if r[0] >= t0]
    if len(rec) < 2:
        return
    first = [r for r in kept["chunks"] if r[0] < t0]
    prev = first[-1][1] if first else rec[0][1]
    span = rec[-1][0] - t0
    cols = {k: [0.0] * 10 for k in ("stage", "launch", "wait", "chunks")}
    for t, h in rec:
        i = min(int(10 * (t - t0) / span), 9)
        for k in cols:
            cols[k][i] += h[k] - prev[k]
        prev = h
    n = cols["chunks"]
    for k in ("stage", "launch", "wait"):
        print(f"chunks: host ms a chunk in vo.chunk.{k} by tenth: "
              + " ".join(f"{1e3 * v / c:.3f}" if c else "-"
                         for v, c in zip(cols[k], n)))
    w = {k: sum(cols[k]) for k in cols}
    print("chunks: window mean host ms a chunk: " + ", ".join(
        f"{k} {1e3 * w[k] / w['chunks']:.4f}" for k in ("stage", "launch",
                                                         "wait"))
          + f" ({w['chunks']} chunks); stage + launch "
          f"{1e3 * (w['stage'] + w['launch']) / w['chunks']:.4f}")


def stage_map(vo):
    from rampvo_tpu_torch.probes.stages import PROGRAM

    m = vo._vo_chunk.stage_nodes
    if m is None:
        print("stage map: none (libcuda gave no node count)")
        return None
    by = defaultdict(int)
    for s, n in m:
        by[s] += n
    K = vo.chunk
    order = [s for s in PROGRAM if s in by] + sorted(
        s for s in by if s not in PROGRAM)
    print(f"stage map: {sum(by.values())} nodes, {len(m)} stretches; "
          "nodes a frame " + ", ".join(f"{s} {by[s] / K:g}" for s in order))
    return m


def read_vo(ev, lo, hi, m, K):
    from rampvo_tpu_torch.probes import stages as pst
    from vobench.trace import SPANS

    reps = pst.replays(ev)
    total = sum(n for _, n in m) if m else None
    counts = sorted({len(r) for r in reps})
    print(f"replays: {len(reps)}, activities a replay {counts}, map nodes "
          f"{total}: " + ("equal" if counts == [total] else "DIFFER"))
    frames = K * len(reps)
    if frames and counts == [total]:
        st = pst.stage_device_us(ev, m)
        busy = sum(sum(e - s for s, e in pst.union_us(
            [(a[1], a[2]) for a in r])) for r in reps)
        order = [s for s in pst.PROGRAM if s in st] + [
            s for s in st if s not in pst.PROGRAM]
        print("stages: device ms a frame " + ", ".join(
            f"{s} {st[s] / 1e3 / frames:.4f}" for s in order)
              + f"; other share {st.get('vo.frame.other', 0) / busy:.4f}")
        g = pst.group(st)
        print("stages (five groups): " + ", ".join(
            f"vo_stage_ms.{k} {v / 1e3 / frames:.4f}" for k, v in g.items())
              + f"; sum {sum(g.values()) / 1e3 / frames:.4f} against the "
              f"replays' busy {busy / 1e3 / frames:.4f} ms a frame "
              f"({100 * sum(g.values()) / busy:.2f}%)")
        top = defaultdict(lambda: defaultdict(float))
        for r in reps:
            for s, acts in pst.split_replay(r, m):
                for n, a, b, _ in acts:
                    top[s][n] += b - a
        for s in order:
            ks = sorted(top[s].items(), key=lambda kv: -kv[1])[:4]
            print(f"  {s}: " + "; ".join(
                f"{n[:60]} {v / 1e3 / frames:.4f}" for n, v in ks))
    eager = pst.eager_device_us(pst.Events(
        [d for d in ev.device if lo <= d[1] <= hi], ev.launches, ev.spans))
    print("eager device ms a frame by span: " + ", ".join(
        f"{k} {v / 1e3 / max(frames, 1):.4f}" for k, v in sorted(
            eager.items(), key=lambda kv: -kv[1])))
    chunk = defaultdict(float)
    for n, s, e in ev.spans:
        if n.startswith("vo.chunk.") and lo <= s <= hi:
            chunk[n] += e - s
    if reps:
        print("slice: host ms a chunk from the spans " + ", ".join(
            f"{k} {v / 1e3 / len(reps):.4f}" for k, v in chunk.items())
              + "; stage + launch " + f"{(chunk['vo.chunk.stage'] + chunk['vo.chunk.launch']) / 1e3 / len(reps):.4f}")
    gaps(ev, lo, hi, SPANS)


def gaps(ev, lo, hi, fallback):
    from rampvo_tpu_torch.probes import stages as pst

    by = defaultdict(list)
    for n, s, e in pst.idle_gaps(ev, lo, hi, fallback):
        by[n].append(e - s)
    print("idle gaps by span (ms in all, count, count > 0.5 ms, longest ms): "
          + "; ".join(f"{n} {sum(v) / 1e3:.3f}, {len(v)}, "
                      f"{sum(x > 500 for x in v)}, {max(v) / 1e3:.3f}"
                      for n, v in sorted(by.items(), key=lambda kv: -sum(kv[1]))))


def read_train(ev, lo, hi, steps):
    from rampvo_tpu_torch.probes import stages as pst
    from vobench.trace import SPANS

    loader = pst.span_union_us(ev, pst.LOADER) / 1e6 / steps
    nexts = [(s, e) for n, s, e in ev.spans if n == "loader.next"]
    idle = sum(e - s for _, s, e in pst.idle_gaps(ev, lo, hi)
               if any(a <= (s + e) / 2 <= b for a, b in nexts)) / 1e6 / steps
    split = {n: pst.span_union_us(ev, [n]) / 1e6 / steps for n in pst.LOADER}
    print(f"loader: loader_s_per_step {loader:.4f} (data.* union) against "
          f"idle under loader.next {idle:.4f} s a step "
          f"({100 * (loader / idle - 1):+.2f}%); by span "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    us = pst.host_us_per_launch(ev)
    step = {n: pst.span_union_us(ev, [n]) / 1e6 / steps
            for n in pst.TRAIN_STEP + ("train.h2d",)}
    kern = {c for n, _, _, c in ev.device if pst.is_kernel(n)}
    n = sum(1 for _, s, _, c in ev.launches if c in kern and lo <= s <= hi)
    print(f"step: host_us_per_launch.train {us:.3f}; {n / steps:.0f} kernel "
          "launches a step; host s a step " + ", ".join(
              f"{k} {v:.4f}" for k, v in step.items()))
    gaps(ev, lo, hi, SPANS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--tracing", type=int, choices=(0, 1), default=1)
    ap.add_argument("--dump", default=None,
                    help="write the traced slice's events (probes.stages."
                    "Events, the stage map and the slice) to this .json.gz")
    args = ap.parse_args(argv)
    import vobench.run as vr

    vr.set_cache_dirs()
    from rampvo_tpu_torch.probes import stages as pst
    from rampvo_tpu_torch.utils.timing import set_tracing
    from vobench.trace import SLICE, SPANS

    set_tracing(bool(args.tracing))
    kept = {"prof": [], "vo": [], "chunks": [], "t0": None}
    patch(kept)
    out = vr.run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    print(f"tracing {'on' if args.tracing else 'off'}, trace {args.trace}")
    vo = kept["vo"][-1] if kept["vo"] else None
    m = None
    if vo is not None:
        by_tenth(kept)
        m = stage_map(vo)
    if args.trace and kept["prof"]:
        t = time.perf_counter()
        ev = pst.from_profiler(kept["prof"][-1], SPANS + (SLICE,))
        sl = [(s, e) for n, s, e in ev.spans if n == SLICE]
        lo, hi = sl[-1]
        if args.dump:
            import gzip

            with gzip.open(args.dump, "wt") as f:
                json.dump({"device": ev.device, "launches": ev.launches,
                           "spans": ev.spans, "stage_nodes": m,
                           "slice": [lo, hi]}, f)
        corr = {c for *_, c in ev.launches}
        print(f"trace: {len(ev.device)} device activities "
              f"({sum(d[3] in corr for d in ev.device)} with a launch call "
              f"of their correlation id), {len(ev.launches)} launch calls, "
              f"{len(ev.program_spans())} program spans (read in "
              f"{time.perf_counter() - t:.1f} s)")
        if vo is not None:
            read_vo(ev, lo, hi, m, vo.chunk)
        else:
            read_train(ev, lo, hi, 2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
