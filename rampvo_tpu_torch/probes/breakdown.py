"""The VO frame split by stage (the port's counterpart of
scripts/breakdown.py, probe_frame_ablate.py, probe_update_ablate.py,
probe_commit_ablate.py, probe_keyframe.py, probe_ba_stages.py and
probe_encoder_pallas.py / probe_encoder.py). `python -m
rampvo_tpu_torch.cli.bench --breakdown` runs it.

`run_breakdown` warms a state with eager frames (a config that never
evicts keeps the windows full), then:

(a) captures each variant of probes/frame.py as a chunk of K frames (one
    CUDA graph, `vo.graph.make_vo_frames_chunk`) and times its replays
    by CUDA events around the replay, from the warmed state restored
    into the graph's state before each replay, outside the timed window.
    The variants run in interleaved turns (all, v1, all, v2, ...), so
    that drift of the host and the clocks hits all alike; each gets the
    median and quartiles of its ms/frame. A stage's time is a difference
    of medians (STAGES); a difference smaller than all's interquartile
    spread prints as unresolved. Beside each stage: its difference in
    kernels a frame (one profiled eager frame of each variant, the
    kernels its graph holds) and that count times P2's host µs a launch
    (`probes.grid_overhead`), the stage's share of the host-bound eager
    frame.
(b) times each stage alone on the warmed state, by CUDA events around
    calls queued behind a spin (`utils.timing.queued_ms`): the encoder
    (whole, the chain alone, the heads at batch 1 and 8), the lattice
    correlation, the update network, one windowed BA,
    the keyframe step and its cell remap, and ba/core.py's stages on
    probe_ba_stages.py's synthetic lattice.
(c) profiles one replay of `all` (in the same profiler session): the 15
    kernels that take the most device time, with their counts, and the
    largest gaps between kernels, so that two runs compare kernel by
    kernel. The profiler slows a replay down and widens its gaps: its
    span is printed beside the unprofiled time.

It raises RuntimeError unless `all` equals the production frame's graph
bit for bit from the same state, each variant's captured kernel launches
are the expected ones (on the card), and every state a variant leaves is
finite. On the CPU the same run goes through the plain versions, each
chunk eagerly; its times are the host's, and nothing is profiled.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..ba import core as bac
from ..lie import ops as lops
from ..models.vonet import VONet, filter_features
from ..vo import runtime as rt
from ..vo.config import VOConfig
from ..vo.graph import copy_state, make_vo_frames_chunk, state_tensors
from ..vo.state import edge_table, host_of_row
from ..utils.timing import queued_ms
from . import grid_overhead
from .frame import VARIANTS, make_probe_frame

# stage -> ({variant: coefficient}, what it measures): the tables of
# probe_frame_ablate.py:198-208, probe_update_ablate.py:188-192 and
# probe_commit_ablate.py:153-157
STAGES = {
    "keyframe": ({"all": 1, "no_kf": -1}, "all - no_kf"),
    "update total": ({"all": 1, "no_update": -1}, "all - no_update"),
    "corr+net": ({"all": 1, "oracle": -1}, "all - oracle"),
    "corr kernel": ({"all": 1, "zero_corr": -1}, "all - zero_corr"),
    "update net": ({"zero_corr": 1, "oracle": -1}, "zero_corr - oracle"),
    "BA+misc": ({"oracle": 1, "no_update": -1}, "oracle - no_update"),
    "GN iteration": ({"oracle": 1, "oracle_ba1": -1}, "oracle - oracle_ba1"),
    "reproject floor": ({"oracle_ba0": 1, "no_update": -1},
                        "oracle_ba0 - no_update"),
    "encoder": ({"all": 1, "no_encoder": -1}, "all - no_encoder"),
    "commit/select": ({"no_update": 1, "all": -2, "no_kf": 1,
                       "no_encoder": 1},
                      "residual: no_update - keyframe - encoder"),
    "update: net": ({"all": 1, "corr_only": -1}, "all - corr_only"),
    "update: corr": ({"corr_only": 1, "oracle": -1}, "corr_only - oracle"),
    "update: BA": ({"all": 1, "no_ba": -1}, "all - no_ba"),
    "commit: select": ({"all": 1, "no_select": -1}, "all - no_select"),
    "commit: extract": ({"no_select": 1, "no_extract": -1},
                        "no_select - no_extract"),
    "commit: writes": ({"no_extract": 1, "no_commit": -1},
                       "no_extract - no_commit"),
}

ENC_KERNEL = {"MultiScale": ("lstm_fold_cm", 3),
              "SingleScale": ("lstm_carry_fold_cm", 1)}
CORR_KERNEL = {"fused3": "corr_lattice", "fused4": "corr_lattice_cb",
               "fused2": "corr_lattice_paired", "folded": "corr_folded_cuda"}


def expected_launches(input_mode: str, layout: str, flags: dict) -> dict:
    """Kernel launches a frame of a variant: the encoder's kernel unless
    the encoder is removed, the correlation's once an update unless the
    update or its correlation is."""
    want = {}
    if flags.get("encoder", True):
        name, per = ENC_KERNEL[input_mode]
        want[name] = per
    if flags.get("update", True) and flags.get("corr", True):
        want[CORR_KERNEL[layout]] = 1
    return want


def restore(dst, src):
    """Every tensor and host scalar of state `src` into state `dst`."""
    for a, b in zip(state_tensors(dst), state_tensors(src)):
        a.copy_(b)
    dst.n, dst.counter, dst.initialized = src.n, src.counter, src.initialized


def finite(state) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in state_tensors(state)
               if t.is_floating_point())


def quartiles(xs):
    """(q1, median, q3) of a list, by linear interpolation."""
    v = sorted(xs)

    def q(p):
        i = p * (len(v) - 1)
        lo = int(i)
        return v[lo] + (v[min(lo + 1, len(v) - 1)] - v[lo]) * (i - lo)

    return q(0.25), q(0.5), q(0.75)


def device_events(fn, pad: float = 0.0):
    """[(name, start µs, end µs)] of the device activities (kernels,
    copies, fills) of `fn()`, by torch.profiler, in order of start; the
    session sleeps `pad` s on the host before `fn` and after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    out = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    if not out:
        raise RuntimeError("the profiler saw no device activity")
    return sorted(out, key=lambda e: e[1])


def _profiled(steps, chunks, names, static, snap, evs, ims, intr,
              per_session: int = 3):
    """Profiler sessions on the card: one eager frame of each variant in
    `names` (`per_session` to a session), each from the restored state
    between two P2 "noop" launches (markers), then one replay of `all`'s
    graph in a session of its own. Returns each one's device activities:
    [variant's frame, ..., all's replay]. On the card a session can lose
    its first device activities (seen after minutes of profiling in one
    process: tens to hundreds of them), so a session starts with 1024
    spin launches to spare, its markers check that each frame is whole,
    and a session that lost a marker runs again with a longer host sleep
    around it. The replay's session holds nothing else: it feeds the
    kernel list of its own."""
    dev = static.poses.device
    tabs = grid_overhead.make_tabs(True)[0].to(dev)

    def marker():
        grid_overhead.grid_probe_cuda("noop", tabs, [])

    def frame(v):
        restore(static, snap)
        view = dataclasses.replace(
            static, n=torch.tensor(static.n, device=dev),
            counter=torch.tensor(static.counter, device=dev))
        marker()
        steps[v].frame_init(view, evs[0], ims[0], intr)
        marker()

    def session(group):
        for _ in range(1024):
            torch.cuda._sleep(100)
        for v in group:
            frame(v)

    out = []
    for first in range(0, len(names), per_session):
        group = names[first:first + per_session]
        for pad in (0.1, 0.4, 1.6):
            ev = device_events(lambda: session(group), pad)
            cut = [i for i, e in enumerate(ev) if "grid_noop" in e[0]]
            if len(cut) == 2 * len(group):
                break
        else:
            raise RuntimeError(f"a profile holds {len(cut)} markers, want "
                               f"{2 * len(group)} ({len(ev)} activities)")
        out += [ev[a + 1:b] for a, b in zip(cut[::2], cut[1::2])]
    restore(static, snap)
    return out + [device_events(lambda: chunks["all"](static, evs, ims, intr),
                                0.1)]


def input_frames(n: int, H: int, W: int, bins: int, device, seed: int = 0):
    """n (events [1, H, W, bins], image [1, H, W, 3]) from
    np.random.RandomState(seed), on `device`."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return [(t(rng.rand(1, H, W, bins)), t(rng.rand(1, H, W, 3)))
            for _ in range(n)]


def synthetic_ba(cfg: VOConfig, device, n: int = 40, seed: int = 0):
    """probe_ba_stages.py:22-60's inputs at cfg's lattice (NI = T = 25,
    Mp = 96 by default, E = 60000): stage name -> call of ba/core.py."""
    rng = np.random.RandomState(seed)
    NI, T, Mp, r = cfg.NI, cfg.T, cfg.M, cfg.PATCH_LIFETIME
    Nwin, PW = cfg.OPTIMIZATION_WINDOW, cfg.POSE_WINDOW
    E, Mwin, base = NI * T * Mp, PW * Mp, n - PW
    i = n - 1 - np.mod(n - 1 - np.arange(NI)[:, None], NI) + 0 * np.arange(T)
    j = i + np.arange(T)[None, :] - (r - 1)
    cellv = (i >= 0) & (j >= 0) & (j <= n - 1) & (i >= n - (NI - 3))
    ii = np.broadcast_to(i[:, :, None], (NI, T, Mp))
    jj = np.broadcast_to(j[:, :, None], (NI, T, Mp))
    kk = ii * Mp + np.arange(Mp)[None, None, :]
    valid = np.broadcast_to(cellv[:, :, None], (NI, T, Mp))
    li = lambda a: torch.as_tensor(np.where(valid, a, 0).reshape(E),
                                   device=device)
    iif, jjf, kkf = li(ii - base), li(jj - base), li(kk - base * Mp)
    vf = torch.as_tensor(valid.reshape(E), device=device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    poses = lops.se3_exp(f32(0.01 * rng.randn(64, 6)))
    centers = f32(rng.rand(E, 3))
    intr = f32([320.0, 320.0, 320.0, 240.0])
    intr_e = intr.expand(E, 4)
    targets, weights = f32(rng.rand(E, 2) * 400), f32(rng.rand(E, 2))
    coords, _, Ji, Jj, Jz = bac.linearize_center(poses, centers, intr_e,
                                                 intr_e, iif, jjf)
    w = weights * vf[:, None]
    rr = (targets - coords) * vf[:, None]
    si, sj = iif - (PW - Nwin), jjf - (PW - Nwin)
    Bm, Em, C, v, u, _ = bac._assemble(rr, w, Ji, Jj, Jz, si, sj, kkf, Nwin,
                                       Mwin)
    dX, _ = bac._solve_schur(Bm, Em, C, v, u, 1e-4, 1.0, 1e-4, Nwin)
    wf = base + torch.arange(PW, device=device)
    held = host_of_row(torch.remainder(wf, NI), n, NI) == wf
    win_rows = torch.where(held & (wf < n), torch.remainder(wf, NI),
                           torch.full_like(wf, -1))
    ii_c, jj_c = iif.reshape(-1, Mp)[:, 0], jjf.reshape(-1, Mp)[:, 0]
    return {
        "linearize (flat)": lambda: bac.linearize_center(
            poses, centers, intr_e, intr_e, iif, jjf),
        "linearize (cells)": lambda: bac.linearize_center_cells(
            poses, centers, intr, ii_c, jj_c, Mp),
        "assemble (flat)": lambda: bac._assemble(
            rr, w, Ji, Jj, Jz, si, sj, kkf, Nwin, Mwin),
        "assemble (cellwise)": lambda: bac._assemble_cellwise(
            rr, w, Ji, Jj, Jz, si, sj, Nwin, Mwin, (NI, T, Mp), win_rows),
        "solve (Schur)": lambda: bac._solve_schur(
            Bm, Em, C, v, u, 1e-4, 1.0, 1e-4, Nwin),
        "retract": lambda: bac._retract(poses, dX, PW - Nwin, Nwin),
    }


def stage_calls(cfg: VOConfig, vo, snap, frame, intr):
    """Each stage of the frame alone on copies of the warmed state `snap`
    (device n and counter, as in the graph's frame): name -> (call, calls
    to queue at once; few enough that their launches fit the card's
    queue, see `queued_ms`). The whole update alone launches more kernels
    than the queue holds; the ablation's "update total" times it."""
    dev = vo.device
    one = np.ones(1, dtype=bool)
    ev, im = frame
    view = lambda: dataclasses.replace(
        copy_state(snap), n=torch.tensor(snap.n, device=dev),
        counter=torch.tensor(snap.counter, device=dev))
    st, st_kf = view(), view()
    step = vo._vo_frame
    net_h = rt._half(cfg, vo.vonet)
    enc = net_h.patchify.encoder
    dt = rt._fdt(cfg)
    if vo.vonet.input_mode == "MultiScale":
        from ..ops.encoder_kernels import (
            multiscale_chain,
            multiscale_heads,
            multiscale_weights,
        )

        ss, _ = multiscale_chain(enc, ev.to(dt), im.to(dt), one, st.enc,
                                 multiscale_weights(enc))

        def heads(b):
            x = [s.expand(b, -1, -1, -1).contiguous() for s in ss]
            return lambda: multiscale_heads(enc, x)
    else:
        h = enc.events_convlstm.hidden_size
        ss = st.enc["ss"][:h].reshape(1, h, *ev.shape[1:3]).to(dt)

        def heads(b):
            x = ss.expand(b, -1, -1, -1).contiguous()
            return lambda: enc.heads(x)
    update_fn = rt.make_update_fn(cfg, net_h, cfg.MIXED_PRECISION,
                                  cfg.corr_fc1_layout)
    lat = (cfg.NI, cfg.T, cfg.M)
    ii, jj, kk, valid = edge_table(cfg, st.n, st.cell_valid)
    target0, corr_in, ctx = rt._edge_corr_ctx_lattice(cfg, st)
    h0 = st.net.reshape(-1, rt.DIM)
    _, (delta, weight) = update_fn(h0, ctx, corr_in, ii, jj, kk, valid, lat)
    target = target0 + delta
    weight = filter_features(weight, target, st.hw4)
    weight = torch.where(valid[:, None], weight, torch.zeros_like(weight))
    evict = torch.ones((), dtype=torch.bool, device=dev)
    calls = {
        "encoder (whole)": (lambda: step.encode_fn(ev, im, one, st.enc), 4),
        "encoder chain": (lambda: step.encode_fn(ev, im, one, st.enc,
                                                 heads=False), 16),
        "encoder heads, batch 1": (heads(1), 4),
        "encoder heads, batch 8": (heads(8), 4),
        "corr (lattice)": (lambda: rt._edge_corr_ctx_lattice(cfg, st), 8),
        "update net": (lambda: update_fn(h0, ctx, corr_in, ii, jj, kk, valid,
                                         lat), 4),
        "BA (window, ba_infer)": (lambda: rt._window_ba(
            cfg, st, target, weight, ii, jj, kk, valid), 1),
        "keyframe": (lambda: rt._keyframe_dev(cfg, st_kf), 1),
        "keyframe: cell remap": (lambda: rt._remap_cells(
            cfg, st_kf, st_kf.n, st_kf.n - cfg.KEYFRAME_INDEX, evict), 16),
    }
    for name, fn in synthetic_ba(cfg, dev).items():
        calls["BA synthetic: " + name] = (fn, 4)
    return calls


def run_breakdown(cfg: VOConfig, vonet: VONet, input_mode: str, H: int,
                  W: int, device="cuda", variants=None, turns: int = 5,
                  K: int = 8, warm: int = 40, log=print) -> dict:
    """The split (module docstring) of `vonet`'s frame under `cfg` at
    H x W; `variants` (names of probes.frame.VARIANTS, every one by
    default; `all` always runs). Returns the last line's dict."""
    from ..vo import RampVO

    dev = resolve_device(device)
    card = dev.type == "cuda"
    names = ["all"] + [v for v in (variants or VARIANTS) if v != "all"]
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: "
                         f"{', '.join(VARIANTS)}")
    marks, seconds = [time.perf_counter()], {}

    def mark(part):
        marks.append(time.perf_counter())
        seconds[part] = round(marks[-1] - marks[-2], 1)

    bins = vonet.evs_ch
    vo = RampVO(cfg, vonet, input_mode=input_mode, num_event_bins=bins,
                ht=H, wd=W, device=dev, seed=0)
    frames = input_frames(warm + K, H, W, bins, dev)
    intr = torch.tensor([320.0, 320.0, W / 2, H / 2], device=dev)
    for f, (ev, im) in enumerate(frames[:warm]):
        vo(f, ev, im, [True], intr)
    if not vo.state.initialized:
        raise RuntimeError(f"the VO did not initialize in {warm} frames")
    snap = copy_state(vo.state)
    static = copy_state(snap)
    evs = torch.stack([ev for ev, _ in frames[warm:]])
    ims = torch.stack([im for _, im in frames[warm:]])
    sync = torch.cuda.synchronize if card else (lambda: None)
    mark("warm-up")
    name = torch.cuda.get_device_name(dev) if card else "cpu"
    layout = cfg.CORR_LAYOUT

    # capture (the first call of a chunk) and the checks
    chunks = {"production": make_vo_frames_chunk(cfg, vo.vonet, K, dev,
                                                 frame=vo._vo_frame)}
    steps = {v: make_probe_frame(cfg, vo.vonet, dev, **VARIANTS[v])
             for v in names}
    for v in names:
        chunks[v] = make_vo_frames_chunk(cfg, vo.vonet, K, dev,
                                         frame=steps[v])
    checks = {"launches": {}, "finite": {}}
    for v in ["production"] + names:
        restore(static, snap)
        chunks[v](static, evs, ims, intr)
        sync()
        if v == "production":
            prod = copy_state(static)
            continue
        checks["finite"][v] = finite(static)
        if v == "all":
            checks["all_equals_production"] = (
                (static.n, static.counter) == (prod.n, prod.counter)
                and all(torch.equal(a, b) for a, b in zip(
                    state_tensors(static), state_tensors(prod))))
        if card:
            got = {k: c / K for k, c in chunks[v].captured.items()}
            want = expected_launches(input_mode, layout, VARIANTS[v])
            checks["launches"][v] = got
            if got != want:
                raise RuntimeError(f"{v}: captured launches a frame {got}, "
                                   f"want {want}")
    del prod
    if not checks["all_equals_production"]:
        raise RuntimeError("all differs from the production frame's graph")
    bad = [v for v, ok in checks["finite"].items() if not ok]
    if bad:
        raise RuntimeError(f"non-finite state after {bad}")

    mark("captures and checks")

    # (a) interleaved turns
    ms = {v: [] for v in names}

    def replay(v):
        restore(static, snap)
        if card:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            chunks[v](static, evs, ims, intr, timing=(a, b))
            return a.elapsed_time(b) / K
        t = time.perf_counter()
        chunks[v](static, evs, ims, intr)
        return (time.perf_counter() - t) * 1e3 / K

    order = ([x for v in names[1:] for x in ("all", v)] if len(names) > 1
             else ["all"])
    for _ in range(turns):
        for v in order:
            ms[v].append(replay(v))
    mark("turns")
    kernels, ev = {}, None
    if card:
        ev = _profiled(steps, chunks, names, static, snap, evs, ims, intr)
        kernels = {v: len(e) for v, e in zip(names, ev)}
        ev = ev[-1]
        host_us = grid_overhead.host_us_per_launch()
    stats = {v: quartiles(x) for v, x in ms.items()}
    spread = stats["all"][2] - stats["all"][0]
    clock = "" if card else " (host clock, plain versions: not a device time)"
    mode = input_mode.lower()
    log(f"{name}: {input_mode} {H}x{W} M={cfg.M} {layout} "
        f"{'bf16' if cfg.MIXED_PRECISION else 'f32'}, {warm} warm frames "
        f"(n = {snap.n}), graphs of {K} frames, {turns} turns{clock}")
    for v in names:
        q1, med, q3 = stats[v]
        k = (f", {kernels[v]} kernels/frame, captured launches/frame "
             f"{checks['launches'][v]}" if card else "")
        log(f"  [{v}] {med:.4f} ms/frame (q1 {q1:.4f}, q3 {q3:.4f}){k}")

    # the stage table
    stages = {}
    if card:
        log(f"stages (differences of medians; unresolved below all's "
            f"interquartile spread {spread:.4f} ms; P2 host issue "
            f"{host_us:.2f} us a launch):")
    for stage, (coef, what) in STAGES.items():
        if any(v not in ms for v in coef):
            continue
        d = sum(c * stats[v][1] for v, c in coef.items())
        resolved = abs(d) >= spread
        row = {"ms": d if resolved else None, "of": what}
        txt = f"{d:8.4f} ms" if resolved else "unresolved "
        if card:
            dk = sum(c * kernels[v] for v, c in coef.items())
            row.update(kernels=dk, eager_host_ms=dk * host_us / 1e3)
            txt += (f"  {dk:+6d} kernels/frame, eager host "
                    f"{dk * host_us / 1e3:7.3f} ms")
        stages[stage] = row
        log(f"  {stage:<16} {txt}  ({what})")

    # (c) the profiled replay of `all`
    top = None
    if card:
        busy = sum(e - s for _, s, e in ev)
        span = ev[-1][2] - ev[0][1]
        agg = {}
        for k, s, e in ev:
            c, t = agg.get(k, (0, 0.0))
            agg[k] = (c + 1, t + e - s)
        top = sorted(agg.items(), key=lambda x: -x[1][1])[:15]
        gaps = sorted(((ev[i + 1][1] - ev[i][2], ev[i][0], ev[i + 1][0])
                       for i in range(len(ev) - 1)), reverse=True)[:5]
        log(f"one profiled replay of all: {len(ev) / K:.2f} activities a "
            f"frame (kernels, and the chunk's input copies), "
            f"device busy {busy / K / 1e3:.4f} ms/frame, "
            f"{100 * busy / span:.1f}% of its span ({span / K / 1e3:.4f} "
            f"ms/frame under the profiler); top 15 by device time:")
        for k, (c, t) in top:
            log(f"  {t / K / 1e3:.4f} ms/frame {c / K:6.2f}/frame {k[:100]}")
        log("largest gaps in the profiled replay:")
        for g, a, b in gaps:
            log(f"  {g:.1f} us after {a[:60]} before {b[:60]}")
    mark("kernel counts, profile")

    # (b) each stage alone
    alone = {}
    with torch.no_grad():
        for stage, (fn, n) in stage_calls(cfg, vo, snap, frames[warm],
                                          intr).items():
            alone[stage] = queued_ms(fn, n if card else 1, dev)
            log(f"  alone {stage}: {alone[stage]:.4f} ms{clock}")
    ba = [alone.get("BA synthetic: " + s) for s in (
        "linearize (cells)", "assemble (cellwise)", "solve (Schur)")]
    log(f"  BA synthetic: two iterations of linearize + assemble + solve "
        f"{2 * sum(ba):.4f} ms (+ retract and glue){clock}")
    mark("stages alone")
    log(f"breakdown seconds: {seconds}")
    return {"metric": f"vo_frame_breakdown_{mode}_{H}x{W}",
            "value": stats["all"][1], "unit": "ms/frame", "stages": stages,
            "variants": {v: {"q1": stats[v][0], "median": stats[v][1],
                             "q3": stats[v][2],
                             "kernels": kernels.get(v)} for v in names},
            "alone": alone, "checks": checks,
            "top15": [[k, c / K, t / K / 1e3] for k, (c, t) in top]
            if card else None,
            "seconds": seconds, "device": name}
