#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (rampvo_tpu_torch) on one card.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --k3-variants    # only K3's build variants, timed

Phases: (1) print the card, build the kernels from csrc/ (one nvcc each,
all started together); (2) hold each kernel (K1 corr_lattice, K2
lstm_fold_cm, K3 lstm_carry_fold_cm, K7/K8 the training correlation's
forward and backward) against its plain PyTorch version at the main
paths' full-size shapes and time both; (3) check small VO runs and small
trainings on the card against the same runs on the CPU (plain versions),
MultiScale and SingleScale, each VO run with an events-only frame; (4)
drive the two main paths, each with the launch counters reset just
before and read just after: RampVO at 480x640, 96 patches, bf16, for 40
frames plus events-only frames, then final_refinement and terminate, and
a profile of four more frames -- MultiScale, then SingleScale -- and a
shorter MultiScale pass with the default keyframe threshold so the
eviction remap runs; (5) the evaluation CLI's run -> evaluate_sequence
-> score -> save_stamped_trajectories in both input modes on an
in-memory 480x640 scene of 24 frames and 6 events-only frames, with the
motion probe off and launch counts that show every frame tracked (the
card's machine has no h5py, so the scene files are not written and read;
the file readers are covered by the CPU tests); (6) the training main
path: 3 optimizer steps of the MultiScale recipe
(config_net/MultiScale_TartanEvent.json) at 480x640 through the training
CLI's loop on an in-memory 30-voxel window of the same scene, with
launch counts, a checkpoint round trip, s/step, peak memory and a
profiled step. Prints one {"kernels": [...]} line and, last,
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


def synthetic_corr_train(torch, dt, seed=5):
    """The training correlation's full-size inputs: the recipe's edge
    schedule (15 frames, 80 patches, 18 steps: E = 18000), gmap
    [1200, 3, 3, 128], 120x160 maps and their 4x pool, 3x3 patches whose
    centers spread over and 8 px beyond the map, and an output gradient
    with the training forward's per-level keep masks (p = 0.2)."""
    from rampvo_tpu_torch.ops.corr import avg_pool2d
    from rampvo_tpu_torch.train.forward import KEEP_P, edge_schedule

    s = edge_schedule(15, 80, 18)
    E, NG, NF = s.ii.shape[0], 15 * 80, 15
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *sh: torch.randn(*sh, generator=g, device="cuda")
    ru = lambda *sh: torch.rand(*sh, generator=g, device="cuda")
    h1, w1 = H // 4, W // 4
    gmap = rn(NG, 3, 3, 128).to(dt)
    f1 = rn(NF, h1, w1, 128)
    f2 = avg_pool2d(f1, 4).to(dt).contiguous()
    f1 = f1.to(dt)
    cen = ru(E, 1, 1, 2) * torch.tensor([w1 + 16.0, h1 + 16.0],
                                        device="cuda") - 8.0
    grid = torch.stack(torch.meshgrid(torch.arange(3.0, device="cuda") - 1,
                                      torch.arange(3.0, device="cuda") - 1,
                                      indexing="xy"), -1)
    coords = (cen + grid + 0.2 * rn(E, 3, 3, 2)).contiguous()
    kk = torch.as_tensor(s.kk, device="cuda").long()
    jj = torch.as_tensor(s.jj, device="cuda").long()
    lvl = torch.arange(882, device="cuda") % 2
    keep = torch.where(lvl == 0, (ru(E) < KEEP_P)[:, None],
                       (ru(E) < KEEP_P)[:, None])
    ct = rn(E, 882) * keep
    return gmap, f1, f2, coords, kk, jj, ct


def check_corr_train(torch, ctk, out_f, out_b):
    """K7 (forward) and K8 (backward) on the full-size training inputs,
    bf16 and f32, held against the plain version (`corr_train_ref`,
    `corr_train_bwd_ref`). Tolerances: forward max |kernel - plain| <=
    tol * max |plain|, tol = 1e-5 (f32: summation order) or 1e-2 (bf16:
    one output rounding); each of the three gradients within 1e-4 (f32:
    the atomic sums' order changes from run to run) or 2e-2 (bf16) of its
    largest entry. The bounds count each input read once and each output
    written once; K8's operations count the (edge, level) pairs whose
    output gradient this run keeps (the rest cost one warp vote)."""
    for dt, name, tf, tb in ((torch.bfloat16, "bf16", 1e-2, 2e-2),
                             (torch.float32, "f32", 1e-5, 1e-4)):
        gmap, f1, f2, coords, kk, jj, ct = synthetic_corr_train(torch, dt)
        a = (gmap, f1, f2, coords, kk, jj)
        E = coords.shape[0]
        k = ctk.corr_train_cuda(*a).float()
        p = ctk.corr_train_ref(*a)
        kb = ctk.corr_train_bwd_cuda(ct, *a)
        pb = ctk.corr_train_bwd_ref(ct, *a)
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        scale = p.abs().max().item()
        if not err <= tf * scale:
            fail(f"corr_train fwd {name}: max err {err} (scale {scale})")
        errb = 0.0
        for what, x, y in zip(("gmap", "fmap1", "fmap2"), kb, pb):
            e = (x - y).abs().max().item()
            sc = y.abs().max().item()
            if not (sc > 0 and e <= tb * sc):
                fail(f"corr_train bwd {name} grad {what}: max err {e} "
                     f"(scale {sc})")
            errb = max(errb, e / sc)
        ms = cuda_ms(lambda: ctk.corr_train_cuda(*a), reps=20)
        plain = cuda_ms(lambda: ctk.corr_train_ref(*a), reps=2, warm=1)
        ms_b = cuda_ms(lambda: ctk.corr_train_bwd_cuda(ct, *a), reps=20)
        plain_b = cuda_ms(lambda: ctk.corr_train_bwd_ref(ct, *a), reps=2,
                          warm=1)
        es = torch.finfo(dt).bits // 8
        maps = (f1.numel() + f2.numel() + gmap.numel())
        small = E * 9 * 2 * 4 + 2 * E * 4          # coords, kk, jj
        nbytes = E * 882 * es + maps * es + small
        flops = E * 9 * 2 * 64 * 128 * 2
        bms, by = bound_ms(nbytes, flops, name)
        kept = int((ct.reshape(E, 441, 2) != 0).any(1).sum())
        nbytes_b = E * 882 * 4 + maps * es + maps * 4 + small
        flops_b = kept * 9 * 64 * 128 * 4
        bms_b, by_b = bound_ms(nbytes_b, flops_b, name)
        print(f"K7 corr_train fwd {name} E={E}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bms:.4f} ms ({by}), max err "
              f"{err:.3e} (scale {scale:.3e})")
        print(f"K8 corr_train bwd {name} E={E}, {kept}/{2 * E} (edge, level) "
              f"pairs kept: kernel {ms_b:.4f} ms, plain {plain_b:.4f} ms, "
              f"bound {bms_b:.4f} ms ({by_b}), max rel err {errb:.3e}")
        out_f[name] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                           max_abs_err=err)
        out_b[name] = dict(ms=ms_b, plain_ms=plain_b, bound_ms=bms_b,
                           bound_by=by_b,
                           max_abs_err=max((x - y).abs().max().item()
                                           for x, y in zip(kb, pb)))


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
            "K3": encoded if input_mode == "SingleScale" else 0,
            "K7": 0, "K8": 0}
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
                    "K3": len(data) if mode == "SingleScale" else 0,
                    "K7": 0, "K8": 0}
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


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

def small_train_run(torch, device, net0, batch, draws, steps=2):
    """`steps` optimizer steps of TrainForward + Trainer on `device` from a
    copy of `net0`, the same draws each time. Returns (losses, gradients
    of the first step after clipping, parameter changes)."""
    import copy

    from rampvo_tpu_torch.train.forward import TrainForward
    from rampvo_tpu_torch.train.step import Trainer

    net = copy.deepcopy(net0).to(device)
    p0 = [p.detach().clone() for p in net.parameters()]
    fwd = TrainForward(net, n_frames=9, M=8, steps=9)
    tr = Trainer(net, {"steps": 300, "lr": 8e-5, "clip": 0.1,
                       "weight_decay": 1e-6, "pct_start": 0.01})
    b = {k: (torch.as_tensor(v).to(device) if k != "mask" else v)
         for k, v in batch.items()}
    losses, grads = [], None
    for k in range(steps):
        d = {n: v.to(device) for n, v in draws[k].items()}
        loss, _, _ = tr.step(lambda: fwd(
            b["events"], b["images"], b["poses"], b["disps"],
            b["intrinsics"], b["mask"], draws=d))
        losses.append(float(loss))
        if grads is None:
            grads = [p.grad.detach().cpu().clone() for p in net.parameters()]
    delta = [(p.detach() - q).cpu() for p, q in zip(net.parameters(), p0)]
    return losses, grads, delta, tr


def check_small_training(torch, mode, counters):
    """The same small training on the card (K7/K8) and on the CPU (plain
    versions): 64x96, 9 frames (MultiScale: one voxel between frames;
    SingleScale: one voxel per frame, as its encoder needs), 8 patches, 9
    unrolled steps, 2 optimizer steps from the same seeded weights (flow
    head scaled by 0.1, as in the CPU parity tests) and the same draws,
    TF32 off. Tolerances: each step's loss within 1e-3 relative; the first
    step's clipped gradients within 1e-2 in relative L1 over all
    parameters; the parameter changes within 5e-2 in relative L1 and each
    within 2 (lr_0 + lr_1), the most two AdamW steps can differ by (a
    parameter whose gradient is rounding noise, such as a bias ahead of an
    instance norm, moves by +-lr either way). K7 and K8 launch once per
    unrolled step."""
    import numpy as np

    from rampvo_tpu_torch.lie import ops as lops
    from rampvo_tpu_torch.models.vonet import VONet, init_weights
    from rampvo_tpu_torch.train.forward import TrainForward

    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("small training: TF32 must be off for the cuda-vs-cpu check")
    ht, wd, NF = 64, 96, 9
    g = torch.Generator().manual_seed(11)
    if mode == "MultiScale":
        mask = np.zeros(2 * NF, bool)
        mask[0] = True
        mask[2::2] = True
    else:
        mask = np.ones(NF, bool)
    batch = {
        "events": torch.rand(mask.size, ht, wd, 5, generator=g),
        "images": torch.rand(NF, ht, wd, 3, generator=g),
        "poses": lops.se3_exp(0.05 * torch.randn(NF, 6, generator=g)),
        "disps": 0.5 + 0.1 * torch.rand(NF, ht, wd, generator=g),
        "intrinsics": torch.tensor([50.0, 50.0, wd / 2, ht / 2]).expand(NF, 4),
        "mask": mask}
    net0 = init_weights(VONet(mode), torch.Generator().manual_seed(5))
    with torch.no_grad():
        net0.update.d[1].weight.mul_(0.1)
    probe = TrainForward(net0, n_frames=NF, M=8, steps=9)
    draws = [probe.draw(torch.Generator().manual_seed(100 + k), "cpu")
             for k in range(2)]
    cpu = small_train_run(torch, "cpu", net0, batch, draws)
    for c in counters.values():
        c.launches = 0
    gpu = small_train_run(torch, "cuda", net0, batch, draws)
    torch.cuda.synchronize()
    n7, n8 = counters["K7"].launches, counters["K8"].launches
    l1 = lambda a, b: (sum(float((x - y).abs().sum()) for x, y in zip(a, b))
                       / max(sum(float(y.abs().sum()) for y in b), 1e-30))
    dl = max(abs(a - b) / abs(b) for a, b in zip(gpu[0], cpu[0]))
    dg = l1(gpu[1], cpu[1])
    dp = l1(gpu[2], cpu[2])
    lr_sum = cpu[3].lr(0) + cpu[3].lr(1)
    dmax = max(float((x - y).abs().max()) for x, y in zip(gpu[2], cpu[2]))
    ok = (all(np.isfinite(gpu[0])) and dl <= 1e-3 and dg <= 1e-2
          and dp <= 5e-2 and dmax <= 2 * lr_sum and n7 == n8 == 18)
    print(f"small {mode} training 64x96 NF=9 M=8, 9 unrolled steps x 2: "
          f"cuda losses {gpu[0]}, cpu {cpu[0]} (max rel diff {dl:.2e}); "
          f"step-1 grads rel L1 {dg:.2e}; parameter changes rel L1 "
          f"{dp:.2e}, max diff {dmax:.2e} (2 x lr sum {2 * lr_sum:.2e}); "
          f"K7 {n7} K8 {n8} launches")
    if not ok:
        fail(f"small {mode} training: cuda and cpu disagree")


def train_window():
    """The full-width training window in the dataset's format: 30 voxels
    (one between frames) and 15 frames at 480x640 of the textured-plane
    scene of `synthetic_scene`, disparities 0.5 (the plane 2 m away), its
    camera-to-world poses and intrinsics."""
    import numpy as np

    data, poses, _ = synthetic_scene(n_frames=15, every=1)
    mask = np.array([bool(d["mask"][0]) for d in data])
    nf = int(mask.sum())
    return {
        "events": np.concatenate([d["events"] for d in data]).astype(
            np.float32),
        "images": np.concatenate([d["image"] for d in data if d["mask"][0]]
                                 ).astype(np.float32),
        "poses": poses.astype(np.float32),
        "disps": np.full((nf, H, W), 0.5, np.float32),
        "intrinsics": np.tile(data[0]["intrinsics"], (nf, 1)),
        "mask": mask}


class InMemoryWindows:
    """A training dataset of one window (the card's machine has no h5py)."""

    def __init__(self, window):
        self.window = window

    def __len__(self):
        return 2

    def __getitem__(self, idx):
        return self.window


def run_train_main_path(torch, counters):
    """The training main path at full width: the training CLI's loop
    (cli/train.py TrainLoop) with config_net/MultiScale_TartanEvent.json's
    recipe (480x640, 15 frames, 30 voxels, 80 patches, 18 unrolled steps,
    E = 18000, AdamW lr 8e-5, clip 0.1) and --structure_only_steps 1 on
    the in-memory window, 3 optimizer steps with the launch counters set
    to 0 just before and read just after: K7 and K8 launch once per
    unrolled step (54 each), the inference kernels never. Then: finite
    losses, parameters changed, a checkpoint written and restored by a new
    loop, s/step (mean of steps 2 and 3, and the median of three more warm
    steps), peak device memory, and the device-busy share of one more,
    profiled, step against its own wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rampvo_tpu_torch.ckpt.train_state import restore_checkpoint
    from rampvo_tpu_torch.cli import train as ct

    root = os.path.dirname(os.path.abspath(__file__))
    cfg_path = os.path.join(root, "config_net", "MultiScale_TartanEvent.json")
    with open(cfg_path) as f:
        config = json.load(f)
    data = InMemoryWindows(train_window())
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)                  # checkpoints/<name>/ lands here
        try:
            argv = ["--config_path", cfg_path, "--structure_only_steps", "1",
                    "--name", "chip_smoke", "--print_every", "1"]
            loop = ct.TrainLoop(ct.parse_args(argv), config, data)
            before = [p.detach().clone() for p in loop.net.parameters()]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            loop.run(n_steps=3)
            torch.cuda.synchronize()
            counts = {k: c.launches for k, c in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            want = {"K1": 0, "K2": 0, "K3": 0, "K7": 54, "K8": 54}
            if counts != want:
                fail(f"training launch counts {counts}, want {want}")
            hist = list(loop.history)
            losses = [h["loss"] for h in hist]
            if len(hist) != 3 or not all(
                    all(map(lambda v: v == v and abs(v) < 1e30, h.values()))
                    for h in hist):
                fail(f"training: non-finite metrics {hist}")
            changed = sum(not torch.equal(a, p.detach())
                          for a, p in zip(before, loop.net.parameters()))
            if changed < len(before) // 2:
                fail(f"training: only {changed}/{len(before)} parameters "
                     "changed")
            path = loop.save()
            again = ct.TrainLoop(ct.parse_args(
                argv + ["--ckpt", os.path.dirname(path)]), config, data)
            r = restore_checkpoint(path)
            same = (r["step"] == 3 and again.step_count == 3
                    and again.trainer.count == 3 and all(
                        torch.equal(a, b) for a, b in
                        zip(again.net.state_dict().values(),
                            loop.net.state_dict().values())))
            if not same:
                fail("training: checkpoint round trip differs")
            del again
            sec = [h["seconds"] for h in hist]
            s_step = sum(sec[1:3]) / 2
            # warm steps 4-6 (pose BA has run once), then a profiled step 7
            loop.run(n_steps=3)
            warm = sorted(h["seconds"] for h in list(loop.history)[3:6])
            s_warm = warm[1]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                loop.run(n_steps=1)
                torch.cuda.synchronize()
            s_prof = loop.history[-1]["seconds"]
        finally:
            os.chdir(cwd)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    n_kern = sum(e.count for e in dev)
    print(f"training main path 480x640 MultiScale f32 (recipe "
          f"config_net/MultiScale_TartanEvent.json, E=18000, 18 unrolled "
          f"steps, structure-only step 1): 3 steps, losses {losses}, "
          f"seconds/step {sec}, median of steps 2-3 {s_step} s/step; "
          f"warm steps 4-6 {warm} s, median {s_warm} s/step; peak device "
          f"memory {peak:.2f} GiB; {changed}/{len(before)} parameter tensors "
          f"changed; checkpoint step 3 written and restored; launches "
          f"{counts}")
    print(f"profile (training step 7): device busy {busy} s of the profiled "
          f"step's {s_prof} s wall ({100 * busy / s_prof:.1f}% busy; "
          f"{100 * busy / s_warm:.1f}% of the warm median); {n_kern} kernels")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:7d}x  "
              f"{e.key[:90]}")
    return counts, s_step, peak, busy / s_prof


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
        from rampvo_tpu_torch.ops import corr_train_kernels as ctk
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
    logs = build.build_all(["corr_lattice", "lstm_fold", "lstm_carry_fold",
                            "corr_train"])
    print(f"built kernels in {time.perf_counter() - t:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    k2, k1, k3, k7, k8 = {}, {}, {}, {}, {}
    check_lstm_fold(torch, ek, k2)
    check_corr_lattice(torch, ck, k1)
    check_lstm_carry_fold(torch, sk, k3)
    check_corr_train(torch, ctk, k7, k8)
    counters = {"K1": ck.corr_lattice, "K2": ek.lstm_fold_cm,
                "K3": sk.lstm_carry_fold_cm, "K7": ctk.corr_train_cuda,
                "K8": ctk.corr_train_bwd_cuda}
    for mode in ("MultiScale", "SingleScale"):
        check_small_slice(torch, mode)
        check_small_training(torch, mode, counters)

    frames = make_frames(torch, FRAMES, H, W, 1, "cuda")
    intr = torch.tensor([320.0, 320.0, W / 2, H / 2], device="cuda")
    n_ms, ms_ms, vo = run_main_path(torch, counters, "MultiScale", frames)
    profile_frames(torch, vo, frames[:4], intr, ms_ms)
    n_ss, ms_ss, vo = run_main_path(torch, counters, "SingleScale", frames)
    profile_frames(torch, vo, frames[:4], intr, ms_ss)
    del vo
    run_eviction_pass(torch, frames)
    run_cli_phase(torch, counters)
    del frames
    torch.cuda.empty_cache()
    n_tr, _, _, _ = run_train_main_path(torch, counters)

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
        dict(name="corr_train_fwd", route="cuda",
             source="rampvo_tpu_torch/csrc/corr_train.cu",
             replaces="rampvo_tpu/ops/corr_pallas.py:1766",
             launches=n_tr["K7"], library_ms=None, **k7["f32"]),
        dict(name="corr_train_bwd", route="cuda",
             source="rampvo_tpu_torch/csrc/corr_train.cu",
             replaces="rampvo_tpu/ops/corr_pallas.py:2002",
             launches=n_tr["K8"], library_ms=None, **k8["f32"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
