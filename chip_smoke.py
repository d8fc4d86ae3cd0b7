#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (rampvo_tpu_torch) on one card.

    python3 chip_smoke.py

Phases: (1) print the card, build the kernels from csrc/ (one nvcc each,
in parallel); (2) hold each kernel against its plain PyTorch version at
the main path's full-size shapes and time both; (3) check a small VO run
on the card against the same run on the CPU (plain versions); (4) drive
the main path: RampVO at 480x640, 96 patches, MultiScale, bf16, for 40
frames with the launch counters reset just before, then final_refinement
and terminate, a profile of four more frames, and a shorter pass with the
default keyframe threshold so the eviction remap runs. Prints one {"kernels": [...]} line and, last,
{"ok": true, "device": {...}}. Any failure exits non-zero. Needs CUDA and
the repository around it; imports nothing of JAX or rampvo_tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
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


def check_small_slice(torch):
    """The same small f32 VO run on the card (kernels) and on the CPU (plain
    versions): identical keyframe bookkeeping at every frame, poses within
    1e-2 (cuDNN and the kernels sum in other orders; the init burst's 12
    Gauss-Newton updates on a random network amplify that)."""
    from rampvo_tpu_torch.models.vonet import VONet, init_weights
    from rampvo_tpu_torch.vo import RampVO, VOConfig

    ht, wd = 64, 96
    cfg = VOConfig(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=5,
                   OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
                   MIXED_PRECISION=False, PROBE_THRESH=-1.0, MAX_FRAMES=64,
                   MEM=16)
    net = init_weights(VONet(), torch.Generator().manual_seed(5))
    vos = {d: RampVO(cfg, net, ht=ht, wd=wd, device=d, seed=1)
           for d in ("cpu", "cuda")}
    intr = torch.tensor([50.0, 50.0, wd / 2, ht / 2])
    for f, (ev, im) in enumerate(make_frames(torch, 12, ht, wd, 7, "cpu")):
        for d, vo in vos.items():
            vo(f, ev.to(d), im.to(d), [True], intr.to(d))
        a, b = vos["cpu"].state, vos["cuda"].state
        same = (a.n == b.n and torch.equal(a.l2g, b.l2g.cpu())
                and torch.equal(a.slotmap, b.slotmap.cpu())
                and torch.equal(a.cell_valid, b.cell_valid.cpu()))
        dp = (a.poses[:a.counter] - b.poses[:a.counter].cpu()).abs().max().item()
        if not same or not dp <= 1e-2:
            fail(f"small slice cuda vs cpu, frame {f}: same={same} dpose={dp}")
    print(f"small slice 64x96 M=8: cuda == cpu bookkeeping over 12 frames, "
          f"max pose diff {dp:.3e}")


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


def run_main_path(torch, ck, ek):
    from rampvo_tpu_torch.models.vonet import VONet, init_weights
    from rampvo_tpu_torch.vo import RampVO, VOConfig

    cfg = VOConfig(BUFFER_SIZE=512, MAX_FRAMES=512, PATCHES_PER_FRAME=M,
                   MIXED_PRECISION=True, PROBE_THRESH=-1.0,
                   KEYFRAME_THRESH=0.0)
    net = init_weights(VONet(), torch.Generator().manual_seed(0))
    vo = RampVO(cfg, net, ht=H, wd=W, device="cuda", seed=0)
    frames = make_frames(torch, FRAMES, H, W, 1, "cuda")
    intr = torch.tensor([320.0, 320.0, W / 2, H / 2], device="cuda")
    torch.cuda.synchronize()

    ck.corr_lattice.launches = 0
    ek.lstm_fold_cm.launches = 0
    times = []
    for f, (ev, im) in enumerate(frames):
        t = time.perf_counter()
        vo(f, ev, im, [True], intr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if f == FRAMES // 2:      # an events-only frame: encoder state only
            vo(f + 0.5, ev, im, [False], intr)
    vo.final_refinement(2)
    traj, tst = vo.terminate()
    torch.cuda.synchronize()
    k1, k2 = ck.corr_lattice.launches, ek.lstm_fold_cm.launches

    st = vo.state
    updates = 12 + (FRAMES - 8) + 2
    if not st.initialized or st.n != FRAMES:
        fail(f"main path: initialized={st.initialized} n={st.n}")
    if k2 != 3 * (FRAMES + 1) or k1 != updates:
        fail(f"launch counts K1={k1} (want {updates}) K2={k2} "
             f"(want {3 * (FRAMES + 1)})")
    if not bool(torch.isfinite(st.poses[:st.counter]).all()) \
            or traj.shape != (FRAMES, 7) or not (abs(traj).max() < 1e6):
        fail("main path: non-finite poses or bad trajectory")
    steady = sorted(times[10:])
    ms = 1e3 * steady[len(steady) // 2]
    print(f"main path 480x640 M=96 MultiScale bf16: {FRAMES} frames + 1 "
          f"events-only, median steady frame {ms:.3f} ms (frames 10..), "
          f"init-burst frame {1e3 * times[7]:.1f} ms; launches K1={k1} "
          f"K2={k2}")
    profile_frames(torch, vo, frames[:4], intr, ms)

    # default keyframe threshold: the eviction remap runs on the card
    cfg2 = VOConfig(BUFFER_SIZE=512, MAX_FRAMES=512, PATCHES_PER_FRAME=M,
                    MIXED_PRECISION=True, PROBE_THRESH=-1.0)
    vo2 = RampVO(cfg2, net, ht=H, wd=W, device="cuda", seed=0)
    for f, (ev, im) in enumerate(frames[:16]):
        vo2(f, ev, im, [True], intr)
    traj2, _ = vo2.terminate()
    torch.cuda.synchronize()
    evicted = 16 - vo2.state.n
    if evicted <= 0 or traj2.shape != (16, 7) or not (abs(traj2).max() < 1e6):
        fail(f"eviction pass: evicted={evicted}")
    print(f"eviction pass (KEYFRAME_THRESH=15): 16 frames, {evicted} "
          f"keyframes evicted, trajectory finite")
    return k1, k2, ms


def main() -> int:
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
    t = time.perf_counter()
    logs = build.build_all(["corr_lattice", "lstm_fold"])
    print(f"built kernels in {time.perf_counter() - t:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    k2 = {}
    check_lstm_fold(torch, ek, k2)
    k1 = {}
    check_corr_lattice(torch, ck, k1)
    check_small_slice(torch)
    n1, n2, _ = run_main_path(torch, ck, ek)

    kernels = [
        dict(name="corr_lattice", route="cuda",
             source="rampvo_tpu_torch/csrc/corr_lattice.cu",
             replaces="rampvo_tpu/ops/corr_pallas.py:1117", launches=n1,
             library_ms=None, **k1["bf16"]),
        dict(name="lstm_fold_cm", route="cuda",
             source="rampvo_tpu_torch/csrc/lstm_fold.cu",
             replaces="rampvo_tpu/ops/encoder_pallas.py:77", launches=n2,
             library_ms=None, **k2["bf16"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
