#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (rampvo_tpu_torch) on one card.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --k3-variants    # only K3's build variants, timed

Phases: (1) print the card, build the kernels from csrc/ (one nvcc each,
all started together); (2) hold each kernel (K1 corr_lattice, K2
lstm_fold_cm, K3 lstm_carry_fold_cm) against its plain PyTorch version at
the main paths' full-size shapes and time both; (3) check small VO runs
on the card against the same runs on the CPU (plain versions), MultiScale
and SingleScale, each with an events-only frame; (4) drive the two main
paths, each with the launch counters reset just before and read just
after: RampVO at 480x640, 96 patches, bf16, for 40 frames plus
events-only frames, then final_refinement and terminate, and a profile of
four more frames -- MultiScale, then SingleScale -- and a shorter
MultiScale pass with the default keyframe threshold so the eviction remap
runs; (5) the evaluation CLI's run -> evaluate_sequence -> score ->
save_stamped_trajectories in both input modes on an in-memory 480x640
scene of 24 frames and 6 events-only frames, with the motion probe off
and launch counts that show every frame tracked (the card's machine has
no h5py, so the scene files are not written and read; the file readers
are covered by the CPU tests). Prints one {"kernels": [...]} line and, last,
{"ok": true, "device": {...}}. Any failure exits non-zero. Needs CUDA and
the repository around it; imports nothing of JAX or rampvo_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HBM_BPS = 3.35e12                  # H100 SXM device memory, bytes/s
PEAK = {"bf16": 989e12, "f32": 67e12}   # dense FLOP/s (bf16 tensor, f32 CUDA cores)
H, W, M = 480, 640, 96
FRAMES = 40


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, flops: float, dt: str):
    tb, to = nbytes / HBM_BPS, flops / PEAK[dt]
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_lstm_fold(torch, ek, out):
    """K2 at the three full-size scales (h = 16/32/64 at HW = 307200 /
    76800 / 19200), bf16 and f32. Tolerance: max |kernel - plain| <=
    tol * max(1, max |plain|), tol = 1e-2 (bf16, one output rounding) or
    1e-4 (f32; only the summation order and the transcendental functions
    differ)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    scales = [(16, H * W), (32, (H // 2) * (W // 2)), (64, (H // 4) * (W // 4))]
    for dt, name, tol in ((torch.bfloat16, "bf16", 1e-2),
                          (torch.float32, "f32", 1e-4)):
        args = []
        for h, hw in scales:
            rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
            args.append((rn(8, hw).to(dt), rn(h, hw).to(dt),
                         rn(8, 8 * h) * 0.5, rn(8 * h) * 0.1,
                         rn(3 * h, h) / (3 * h) ** 0.5, rn(h) * 0.1))
        err = 0.0
        for a in args:
            k = ek.lstm_fold_cuda(*a).float()
            p = ek.lstm_fold_ref(*a).float()
            torch.cuda.synchronize()
            e = (k - p).abs().max().item()
            if not e <= tol * max(1.0, p.abs().max().item()):
                fail(f"lstm_fold {name} h={a[1].shape[0]}: max err {e}")
            err = max(err, e)
        ms = cuda_ms(lambda: [ek.lstm_fold_cuda(*a) for a in args])
        plain = cuda_ms(lambda: [ek.lstm_fold_ref(*a) for a in args], reps=3)
        es = torch.finfo(dt).bits // 8
        nbytes = sum(hw * (8 + 2 * h) * es + 4 * (8 * 8 * h + 8 * h + 3 * h * h + h)
                     for h, hw in scales)
        flops = sum(hw * 2 * (8 * 6 * h + 3 * h * h) for h, hw in scales)
        bms, by = bound_ms(nbytes, flops, name)
        print(f"K2 lstm_fold_cm {name}: 3 scales/frame kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), "
              f"max err {err:.3e}")
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                         max_abs_err=err)


def check_lstm_carry_fold(torch, sk, out, defines=()):
    """K3 at the full-size SingleScale shapes (hp = 16, HW = 480 * 640),
    bf16 and f32, presence (1, 1), (1, 0) and (0, 1). Tolerance: max
    |kernel - plain| <= tol * max(1, max |plain|) over both outputs, tol =
    1e-2 (bf16, one output rounding) or 1e-4 (f32; only the summation
    order and the transcendental functions differ). Timed with both
    modalities present (the main path's case). `defines` picks a build
    variant of the kernel."""
    g = torch.Generator(device="cuda").manual_seed(4)
    hp, hw = 16, H * W
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    for dt, name, tol in ((torch.bfloat16, "bf16", 1e-2),
                          (torch.float32, "f32", 1e-4)):
        base = (rn(8, hw).to(dt), rn(4 * hp, hw).to(dt), rn(hp, hw).to(dt),
                rn(8, 8 * hp) * 0.5, rn(2 * hp, 8 * hp) / (2 * hp) ** 0.5,
                rn(8 * hp) * 0.1, rn(2 * hp, hp) / (2 * hp) ** 0.5,
                rn(hp) * 0.1)
        err = 0.0
        for pres in ((1, 1), (1, 0), (0, 1)):
            a = (*base, torch.tensor(pres, dtype=torch.int32, device="cuda"))
            k = sk.lstm_carry_fold_cuda(*a, defines=defines)
            p = sk.lstm_carry_fold_ref(*a)
            torch.cuda.synchronize()
            for kk, pp in zip(k, p):
                kk, pp = kk.float(), pp.float()
                e = (kk - pp).abs().max().item()
                if not e <= tol * max(1.0, pp.abs().max().item()):
                    fail(f"lstm_carry_fold {name} pres={pres}: max err {e}")
                err = max(err, e)
        a = (*base, torch.ones(2, dtype=torch.int32, device="cuda"))
        ms = cuda_ms(lambda: sk.lstm_carry_fold_cuda(*a, defines=defines),
                     reps=20)
        plain = cuda_ms(lambda: sk.lstm_carry_fold_ref(*a), reps=3)
        es = torch.finfo(dt).bits // 8
        nbytes = (hw * (8 + 5 * hp) * es + hw * 5 * hp * es
                  + 4 * (8 * 8 * hp + 2 * hp * 8 * hp + 8 * hp
                         + 2 * hp * hp + hp) + 8)
        flops = hw * (2 * (8 + 2 * hp) * 8 * hp + 2 * 2 * 2 * hp * hp)
        bms, by = bound_ms(nbytes, flops, name)
        print(f"K3 lstm_carry_fold_cm {name}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bms:.4f} ms ({by}), max err {err:.3e}")
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                         max_abs_err=err)


K3_VARIANTS = (             # (label, -D defines of csrc/lstm_carry_fold.cu)
    ("2 blocks/SM, rolled fold start (shipped)", ()),
    ("1 block/SM, rolled", ("K3_MIN_BLOCKS=1",)),
    ("3 blocks/SM, rolled", ("K3_MIN_BLOCKS=3",)),
    ("2 blocks/SM, unrolled fold start", ("K3_FOLD_UNROLL=16",)),
    ("1 block/SM, unrolled", ("K3_MIN_BLOCKS=1", "K3_FOLD_UNROLL=16")),
)


def compare_k3_variants(torch, sk, build):
    """`--k3-variants`: build the K3 variants in parallel, print each one's
    registers and spills, and hold each against the plain version and
    time it as the K3 check does, in one process."""
    logs = build.build_all([("lstm_carry_fold", d) for _, d in K3_VARIANTS])
    for label, d in K3_VARIANTS:
        regs = [ln.strip() for ln in logs[("lstm_carry_fold", d)].splitlines()
                if "registers" in ln or "spill" in ln]
        out = {}
        check_lstm_carry_fold(torch, sk, out, defines=d)
        print(f"K3 variant {label}: bf16 {out['bf16']['ms']:.4f} ms, f32 "
              f"{out['f32']['ms']:.4f} ms; ptxas {regs}")


def synthetic_lattice(torch, dt, seed=3):
    """A full-size lattice (NI=25, T=25, M=96, MEM=40, 120x160 and 30x40
    rings) at a steady-state n with a seeded mix of dead cells, and patch
    coordinates spread over and beyond the map borders."""
    from rampvo_tpu_torch.vo.config import VOConfig

    cfg = VOConfig()
    NI, T, r, MEM = cfg.NI, cfg.T, cfg.PATCH_LIFETIME, cfg.MEM
    g = torch.Generator(device="cuda").manual_seed(seed)
    h1, w1 = H // 4, W // 4
    gmap = torch.randn(MEM, M, 3, 3, 128, generator=g, device="cuda").to(dt)
    f1 = torch.randn(MEM, h1, w1, 128, generator=g, device="cuda").to(dt)
    f2 = torch.randn(MEM, h1 // 4, w1 // 4, 128, generator=g,
                     device="cuda").to(dt)
    NC = NI * T
    cen = (torch.rand(NC, M, 1, 2, generator=g, device="cuda")
           * torch.tensor([w1 + 16.0, h1 + 16.0], device="cuda") - 8.0)
    off = torch.rand(NC, M, 9, 2, generator=g, device="cuda") * 6.0 - 3.0
    uv = (cen + off).reshape(NC, M * 9, 2)
    cell_valid = torch.rand(NI, T, generator=g, device="cuda") < 0.85
    n = 60
    slotmap = torch.full((512,), -1, dtype=torch.int64, device="cuda")
    slotmap[n - 38:n] = torch.arange(38, device="cuda") % MEM
    return (gmap, f1, f2, uv[..., 0].contiguous(), uv[..., 1].contiguous(),
            cell_valid, n, slotmap, r, (NI, T, M))


def check_corr_lattice(torch, ck, out):
    """K1 on the synthetic full-size lattice, bf16 and f32. Tolerance: max
    |kernel - plain| <= tol * max |plain| with tol = 1e-2 (bf16: one output
    rounding) or 1e-5 (f32: summation order only)."""
    for dt, name, tol in ((torch.bfloat16, "bf16", 1e-2),
                          (torch.float32, "f32", 1e-5)):
        (gmap, f1, f2, u, v, cv, n, slotmap, r,
         lat) = synthetic_lattice(torch, dt)
        NI, T, Mm = lat
        cells = ck.cell_tables(NI, T, r, n, cv, slotmap, gmap.shape[0])
        a = (gmap, f1, f2, u, v, cells, Mm)
        k = ck.corr_lattice_cuda(*a).float()
        p = ck.corr_lattice_ref(*a).float()
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        scale = p.abs().max().item()
        if not err <= tol * scale:
            fail(f"corr_lattice {name}: max err {err} (scale {scale})")
        live = (cells[:, 0] >= 0)
        n_live = int(live.sum())
        if n_live == 0 or not bool((k.reshape(NI * T, Mm, -1)[~live] == 0).all()):
            fail("corr_lattice: dead cells must be zero / no live cells")
        ms = cuda_ms(lambda: ck.corr_lattice_cuda(*a), reps=20)
        plain = cuda_ms(lambda: ck.corr_lattice_ref(*a), reps=2, warm=1)
        es = torch.finfo(dt).bits // 8
        E = NI * T * Mm
        Ev = n_live * Mm
        t_slots = torch.unique(cells[live, 0]).numel()
        g_slots = torch.unique(cells[live, 1]).numel()
        nbytes = (E * 882 * es + 2 * E * 9 * 4 + cells.numel() * 4
                  + g_slots * Mm * 9 * 128 * es
                  + t_slots * (f1[0].numel() + f2[0].numel()) * es)
        flops = Ev * 9 * 2 * 64 * 128 * 2
        bms, by = bound_ms(nbytes, flops, name)
        print(f"K1 corr_lattice {name}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bms:.4f} ms ({by}), live cells "
              f"{n_live}/{NI * T}, max err {err:.3e} (scale {scale:.3e})")
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                         max_abs_err=err)


# ---------------------------------------------------------------------------
# phases 3 and 4: the VO slice
# ---------------------------------------------------------------------------

def make_frames(torch, n, ht, wd, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return [(torch.rand(1, ht, wd, 5, generator=g, device=device),
             torch.rand(1, ht, wd, 3, generator=g, device=device))
            for _ in range(n)]


def check_small_slice(torch, input_mode):
    """The same small f32 VO run on the card (kernels) and on the CPU (plain
    versions), 12 frames and an events-only frame after frame 5:
    identical keyframe bookkeeping at every frame, poses within 1e-2. The
    card runs float32 convolutions and products without TF32
    (torch.backends.cudnn.allow_tf32 and cuda.matmul.allow_tf32 are set
    False in main()); cuDNN and the kernels still sum in other orders, and
    the init burst's 12 Gauss-Newton updates on a random network amplify
    that, hence 1e-2."""
    from rampvo_tpu_torch.models.vonet import VONet, init_weights
    from rampvo_tpu_torch.vo import RampVO, VOConfig

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("small slice: TF32 must be off for the cuda-vs-cpu check")
    ht, wd = 64, 96
    cfg = VOConfig(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=5,
                   OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
                   MIXED_PRECISION=False, PROBE_THRESH=-1.0, MAX_FRAMES=64,
                   MEM=16)
    net = init_weights(VONet(input_mode), torch.Generator().manual_seed(5))
    vos = {d: RampVO(cfg, net, ht=ht, wd=wd, device=d, seed=1)
           for d in ("cpu", "cuda")}
    intr = torch.tensor([50.0, 50.0, wd / 2, ht / 2])
    for f, (ev, im) in enumerate(make_frames(torch, 12, ht, wd, 7, "cpu")):
        for d, vo in vos.items():
            vo(f, ev.to(d), im.to(d), [True], intr.to(d))
            if f == 5:
                vo(f + 0.5, ev.to(d), im.to(d), [False], intr.to(d))
        a, b = vos["cpu"].state, vos["cuda"].state
        same = (a.n == b.n and torch.equal(a.l2g, b.l2g.cpu())
                and torch.equal(a.slotmap, b.slotmap.cpu())
                and torch.equal(a.cell_valid, b.cell_valid.cpu()))
        dp = (a.poses[:a.counter] - b.poses[:a.counter].cpu()).abs().max().item()
        if not same or not dp <= 1e-2:
            fail(f"small {input_mode} slice cuda vs cpu, frame {f}: "
                 f"same={same} dpose={dp}")
    print(f"small {input_mode} slice 64x96 M=8: cuda == cpu bookkeeping over "
          f"12 frames + 1 events-only, max pose diff {dp:.3e}")


def profile_frames(torch, vo, frames, intr, frame_ms):
    """Device time of a few steady frames by kernel (torch.profiler): the
    device-busy time against the unprofiled frame time `frame_ms` (the
    profiler's own start-up makes the profiled wall time meaningless), the
    kernels launched per frame and the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f, (ev, im) in enumerate(frames):
            vo(1000 + f, ev, im, [True], intr)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / n
    calls = sum(e.count for e in dev) / n
    print(f"profile ({n} steady frames): device busy {busy:.3f} ms/frame, "
          f"{100 * busy / frame_ms:.1f}% of the {frame_ms:.3f} ms frame; "
          f"{calls:.0f} kernels/frame")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/frame "
              f"{e.count / n:6.1f}x  {e.key[:90]}")


def run_main_path(torch, counters, input_mode, frames):
    """RampVO at 480x640, M=96, bf16, `input_mode`: FRAMES frames and an
    events-only frame after every tenth, then final_refinement(2) and
    terminate, with every launch counter set to 0 just before and read
    just after. The encoder kernel of the mode (K2: 3 launches per encoded
    frame, K3: 1) and K1 (one per update) must have run exactly as often
    as the path asks. Returns (counts, median steady ms/frame, the
    RampVO)."""
    from rampvo_tpu_torch.models.vonet import VONet, init_weights
    from rampvo_tpu_torch.vo import RampVO, VOConfig

    cfg = VOConfig(BUFFER_SIZE=512, MAX_FRAMES=512, PATCHES_PER_FRAME=M,
                   MIXED_PRECISION=True, PROBE_THRESH=-1.0,
                   KEYFRAME_THRESH=0.0)
    net = init_weights(VONet(input_mode), torch.Generator().manual_seed(0))
    vo = RampVO(cfg, net, input_mode=input_mode, ht=H, wd=W, device="cuda",
                seed=0)
    intr = torch.tensor([320.0, 320.0, W / 2, H / 2], device="cuda")
    torch.cuda.synchronize()

    for c in counters.values():
        c.launches = 0
    times, events_only = [], 0
    for f, (ev, im) in enumerate(frames):
        t = time.perf_counter()
        vo(f, ev, im, [True], intr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if f % 10 == 5:           # an events-only frame: encoder state only
            vo(f + 0.5, ev, im, [False], intr)
            events_only += 1
    vo.final_refinement(2)
    traj, tst = vo.terminate()
    torch.cuda.synchronize()
    counts = {k: c.launches for k, c in counters.items()}

    st = vo.state
    encoded = FRAMES + events_only
    want = {"K1": 12 + (FRAMES - 8) + 2,
            "K2": 3 * encoded if input_mode == "MultiScale" else 0,
            "K3": encoded if input_mode == "SingleScale" else 0}
    if not st.initialized or st.n != FRAMES:
        fail(f"{input_mode} main path: initialized={st.initialized} n={st.n}")
    if counts != want:
        fail(f"{input_mode} launch counts {counts}, want {want}")
    if not bool(torch.isfinite(st.poses[:st.counter]).all()) \
            or traj.shape != (FRAMES, 7) or not (abs(traj).max() < 1e6):
        fail(f"{input_mode} main path: non-finite poses or bad trajectory")
    steady = sorted(times[10:])
    ms = 1e3 * steady[len(steady) // 2]
    print(f"main path 480x640 M=96 {input_mode} bf16: {FRAMES} frames + "
          f"{events_only} events-only, median steady frame {ms:.3f} ms "
          f"(frames 10..), init-burst frame {1e3 * times[7]:.1f} ms; "
          f"launches {counts}")
    return counts, ms, vo


def run_eviction_pass(torch, frames):
    """The default keyframe threshold on the MultiScale path: the eviction
    remap runs on the card."""
    from rampvo_tpu_torch.models.vonet import VONet, init_weights
    from rampvo_tpu_torch.vo import RampVO, VOConfig

    cfg = VOConfig(BUFFER_SIZE=512, MAX_FRAMES=512, PATCHES_PER_FRAME=M,
                   MIXED_PRECISION=True, PROBE_THRESH=-1.0)
    net = init_weights(VONet(), torch.Generator().manual_seed(0))
    vo = RampVO(cfg, net, ht=H, wd=W, device="cuda", seed=0)
    intr = torch.tensor([320.0, 320.0, W / 2, H / 2], device="cuda")
    for f, (ev, im) in enumerate(frames[:16]):
        vo(f, ev, im, [True], intr)
    traj, _ = vo.terminate()
    torch.cuda.synchronize()
    evicted = 16 - vo.state.n
    if evicted <= 0 or traj.shape != (16, 7) or not (abs(traj).max() < 1e6):
        fail(f"eviction pass: evicted={evicted}")
    print(f"eviction pass (KEYFRAME_THRESH=15): 16 frames, {evicted} "
          f"keyframes evicted, trajectory finite")


# ---------------------------------------------------------------------------
# phase 5: the evaluation CLI
# ---------------------------------------------------------------------------

def synthetic_scene(n_frames=24, every=4, fx=320.0, seed=0):
    """An in-memory 480x640 scene in the loader's format: a smoothed random
    texture on a plane 2 m away, the camera moving 2 cm per voxel along x.
    Each voxel holds 5 count bins of intensity-change events (int8 signs
    at 5 sub-steps); the image is the loader's float16 normalization.
    After every `every` frames one voxel is events-only (mask False).
    Returns (data list, reference trajectory poses [n, 7] xyz+xyzw
    camera-to-world, frame timestamps)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    tex = rng.rand(H, 3 * W) * 255.0
    for axis in (0, 1):              # box blur: informative gradients
        tex = sum(np.roll(tex, s, axis) for s in range(-2, 3)) / 5.0
    Wt = tex.shape[1]

    def render(x_cam):
        u = np.arange(W) + fx * x_cam / 2.0
        u0 = np.floor(u).astype(int)
        a = (u - u0)[None, :]
        return (1 - a) * tex[:, u0 % Wt] + a * tex[:, (u0 + 1) % Wt]

    intr = np.array([fx, fx, W / 2, H / 2], np.float32)
    data, poses, stamps = [], [], []
    for i in range(n_frames + n_frames // every):
        events_only = i % (every + 1) == every
        x0, x1 = 0.02 * (i - 1), 0.02 * i
        sub = [render(x0 + (x1 - x0) * b / 5.0) for b in range(6)]
        ev = np.stack([np.sign(sub[b + 1] - sub[b])
                       * (np.abs(sub[b + 1] - sub[b]) > 2.0)
                       for b in range(5)], -1).astype(np.int8)
        img = np.repeat(sub[-1][..., None], 3, -1)
        img = (2 * (img / 255.0) - 0.5).astype(np.float16)
        data.append({"events": ev[None], "image": img[None],
                     "intrinsics": intr, "mask": np.asarray([not events_only])})
        if not events_only:
            poses.append([x1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
            stamps.append(0.1 * i)
    return data, np.asarray(poses), np.asarray(stamps)


def run_cli_phase(torch, counters):
    """cli.evaluate.run -> evaluate_sequence -> eval_utils.score and
    save_stamped_trajectories, in both input modes, on the in-memory scene
    with config_vo/default.yaml and random weights from a seed. The motion
    probe is off (PROBE_THRESH=-1): a random network's probe flow says
    nothing of the scene's motion, and with the gate on it dropped every
    frame, so the VO never initialized. The launch counts must show the
    run initialized and tracked every frame (K1: the 12-update init burst,
    one update per later frame, the 12 terminal updates), the ATE must be
    finite (and not the 1000 sentinel) and both stamped trajectory files
    must be written."""
    import dataclasses

    import numpy as np

    from rampvo_tpu_torch.cli import eval_utils as eu
    from rampvo_tpu_torch.cli import evaluate as ev
    from rampvo_tpu_torch.models.vonet import VONet, init_weights
    from rampvo_tpu_torch.vo import VOConfig

    data, ref_poses, stamps = synthetic_scene()
    traj_ref = eu.traj_from_xyzw(ref_poses[:, :3], ref_poses[:, 3:], stamps)
    cfg = dataclasses.replace(VOConfig.from_yaml(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "config_vo",
        "default.yaml")), PROBE_THRESH=-1.0)
    n_vo = int(sum(d["mask"][0] for d in data))
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("MultiScale", "SingleScale"):
            eval_cfg = {"data_loader": {"train": {"args": {
                "input_mode": mode, "event_bias": True,
                "num_event_bins": 5}}}}
            net = init_weights(VONet(mode), torch.Generator().manual_seed(1))
            for c in counters.values():
                c.launches = 0
            t = time.perf_counter()
            ate, rot, traj_est, ref, _ = ev.evaluate_sequence(
                cfg, net, eval_cfg, data, traj_ref, stamps, seed=0)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            out = os.path.join(tmp, mode)
            eu.save_stamped_trajectories(out, ref, traj_est)
            files = [os.path.join(out, f) for f in (
                "stamped_groundtruth.txt", "stamped_traj_estimate.txt")]
            est = np.loadtxt(files[1])
            counts = {k: c.launches for k, c in counters.items()}
            want = {"K1": 12 + (n_vo - 8) + 12,
                    "K2": 3 * len(data) if mode == "MultiScale" else 0,
                    "K3": len(data) if mode == "SingleScale" else 0}
            if counts != want:
                fail(f"CLI phase {mode}: launch counts {counts}, want {want}")
            if not (np.isfinite(ate) and ate != 1000.0) \
                    or not all(os.path.getsize(f) > 0 for f in files) \
                    or est.shape != (n_vo, 8):
                fail(f"CLI phase {mode}: ate={ate} est={est.shape}")
            print(f"CLI phase {mode} 480x640 (config_vo/default.yaml, "
                  f"PROBE_THRESH=-1): {len(data)} voxels ({n_vo} frames), "
                  f"ate {ate:.5f}, rot {[round(r, 4) for r in rot]}, "
                  f"{sec:.2f} s, launches {counts}, trajectory files written")


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k3-variants", action="store_true",
                    help="only compare the K3 build variants")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    try:
        from rampvo_tpu_torch.ops import build
        from rampvo_tpu_torch.ops import corr_kernels as ck
        from rampvo_tpu_torch.ops import encoder_kernels as ek
        from rampvo_tpu_torch.ops import singlescale_kernels as sk
    except ImportError as e:
        print(f"rampvo_tpu_torch not found next to chip_smoke.py: {e}",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda)
    if args.k3_variants:
        compare_k3_variants(torch, sk, build)
        return 0
    t = time.perf_counter()
    logs = build.build_all(["corr_lattice", "lstm_fold", "lstm_carry_fold"])
    print(f"built kernels in {time.perf_counter() - t:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    k2, k1, k3 = {}, {}, {}
    check_lstm_fold(torch, ek, k2)
    check_corr_lattice(torch, ck, k1)
    check_lstm_carry_fold(torch, sk, k3)
    for mode in ("MultiScale", "SingleScale"):
        check_small_slice(torch, mode)

    counters = {"K1": ck.corr_lattice, "K2": ek.lstm_fold_cm,
                "K3": sk.lstm_carry_fold_cm}
    frames = make_frames(torch, FRAMES, H, W, 1, "cuda")
    intr = torch.tensor([320.0, 320.0, W / 2, H / 2], device="cuda")
    n_ms, ms_ms, vo = run_main_path(torch, counters, "MultiScale", frames)
    profile_frames(torch, vo, frames[:4], intr, ms_ms)
    n_ss, ms_ss, vo = run_main_path(torch, counters, "SingleScale", frames)
    profile_frames(torch, vo, frames[:4], intr, ms_ss)
    del vo
    run_eviction_pass(torch, frames)
    run_cli_phase(torch, counters)

    kernels = [
        dict(name="corr_lattice", route="cuda",
             source="rampvo_tpu_torch/csrc/corr_lattice.cu",
             replaces="rampvo_tpu/ops/corr_pallas.py:1117",
             launches=n_ms["K1"], library_ms=None, **k1["bf16"]),
        dict(name="lstm_fold_cm", route="cuda",
             source="rampvo_tpu_torch/csrc/lstm_fold.cu",
             replaces="rampvo_tpu/ops/encoder_pallas.py:77",
             launches=n_ms["K2"], library_ms=None, **k2["bf16"]),
        dict(name="lstm_carry_fold_cm", route="cuda",
             source="rampvo_tpu_torch/csrc/lstm_carry_fold.cu",
             replaces="rampvo_tpu/ops/encoder_pallas.py:235",
             launches=n_ss["K3"], library_ms=None, **k3["bf16"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
