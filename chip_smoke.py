#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (rampvo_tpu_torch) on one card.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --k3-variants    # only K3's build variants, timed
    python3 chip_smoke.py --corr-bins      # only K6 and K5 in every build
                                           # variant and bin tile, timed
    python3 chip_smoke.py --k1-variants    # only K1's build variants, timed
    python3 chip_smoke.py --k8-variants    # only K8's build variants, timed
    python3 chip_smoke.py --k7-variants    # only K7's build variants, timed
    python3 chip_smoke.py --k2-variants    # only K2's build variants, timed
    python3 chip_smoke.py --chunk-only     # only the chunked path (4b)
    python3 chip_smoke.py --breakdown-only # only the stage split (4c)
    python3 chip_smoke.py --pose-only      # only pose prediction (5b)
    python3 chip_smoke.py --selection-only # only patch selection (5c)
    python3 chip_smoke.py --native-only    # only the native builders (5d)
    python3 chip_smoke.py --bins-only      # only K2/K3 at every checked Cx,
                                           # the 10-bin path (5e) and the
                                           # geometry and Lie groups (5f)
    python3 chip_smoke.py --truth-only     # only ground-truth tracking (5g)
                                           # and learned weights (5h)
    python3 chip_smoke.py --train-hw-only  # only the hardware training
                                           # run (6b)
    python3 chip_smoke.py --dp-only        # only data-parallel training (7)
    python3 chip_smoke.py --train-bench-only  # only cli.bench --train (7b)
    python3 chip_smoke.py --harness-only   # only the ATE harness (7c)
    python3 chip_smoke.py --ab DIR         # K7, K2, K3 and the folded
                                           # correlation here and in the
                                           # tree at DIR, in turns

Phases: (1) print the card, build the kernels from csrc/ (one nvcc each,
all started together); (2) hold each kernel (K1 corr_lattice, K2
lstm_fold_cm, K3 lstm_carry_fold_cm, K4 corr_bands and corr_folded, K5
corr_paired, K6 corr_lattice_cb, K7/K8 the training correlation's forward
and backward) against its plain PyTorch version at the main paths'
full-size shapes and time both (K1 and K7/K8 on two coordinate sets,
pixels spread +-3 px and patch-shaped, and on a smaller adversarial set
that drives the kernels' slow path, borders and non-finite coordinates;
K2 scale by scale and K3 in each presence case, in bf16 also against the
plain mirrors of their roundings, each at Cx = 8 input rows and at 4, 13,
18 and 64); hold K4-K6 against K1 (K6, K5 and K4's
folded kernel bit for bit, the folded kernel on all three coordinate
sets; K4's band with the PyTorch finish within two bf16 roundings); run
the probes P1 (dynlane) and
P2 (grid_probe, three variants and a host-clock launch loop) against their
plain versions; (3) check small VO runs and small trainings on the card
against the same runs on the CPU (plain versions), MultiScale and
SingleScale, each VO run with an events-only frame, and the small
MultiScale VO run once more under each of CORR_LAYOUT fused2, fused4 and
folded; (4) drive the main paths, each with the launch counters reset
just before and read just after: RampVO at 480x640, 96 patches, bf16, for
40 frames plus events-only frames, then final_refinement and terminate,
and a profile of four more frames -- MultiScale, SingleScale, then
MultiScale under CORR_LAYOUT fused2, fused4 and folded (each layout's
kernel launches once per update, the other correlation kernels never;
the folded path runs no PyTorch finish on the card) --
and a shorter MultiScale pass with the default keyframe threshold so the
eviction remap runs; (4b) the chunked path, RampVO(chunk=8), whose
initialized frames are one CUDA-graph replay per 8 frames, held bit for
bit against the eager driver from the same state in both modes, under
every layout and with evicted and kept frames inside one replay past
NI, and timed against it and against the branchless frame run eagerly in
turns (`run_chunk_path`); (4c) the VO frame split by stage, `cli.bench
--breakdown` (probes/breakdown.py): every variant of probes/frame.py
captured as a chunk=8 graph from one warmed MultiScale state, all, no_encoder
and zero_corr from a SingleScale one, timed in interleaved turns, with
`all` bit for bit against the production frame's graph, each variant's
launches and finite states (`run_breakdown_phase`); (5) the evaluation CLI's run -> evaluate_sequence
-> score -> save_stamped_trajectories in both input modes on an
in-memory 480x640 scene of 24 frames and 6 events-only frames, with the
motion probe off and launch counts that show every frame tracked (the
card's machine has no h5py, so the scene files are not written and read;
the file readers are covered by the CPU tests); (5b) pose prediction:
predict_future_pose on the card against the CPU from one small state,
then evaluate_sequence(use_pose_pred=True) on a 24-frame in-memory
480x640 scene (12 frames tracked, 12 predicted), launch counts, ATE and
ms per prediction split into host and card time (`run_pose_phase`);
(5c) patch selection without event bias: RampVO(event_bias=False) with
GRADIENT_BIAS true and false, MultiScale eager and chunk=8 twins held
bit for bit on the same selection draws and timed, SingleScale eager
(`run_selection_phase`); (5d) the native event builders, built by g++,
bit for bit against numpy on a 400k-event 480x640 stream and timed
(`run_native_phase`); (5e) the VO path at 10 event bins (x of Cx = 13
rows into K2 and K3): small CUDA-vs-CPU runs in both modes, MultiScale
40 eager frames and a chunk=8 graph twin bit for bit, SingleScale 24
eager frames, launch counts and ms/frame (`run_bins_phase`); (5f)
geometry.transform with Jacobians and the Lie groups on the card
against the CPU at E = 18000 (`run_geometry_phase`); (5g) the VO with
ground-truth update targets on the synthetic curved trajectory, full
windows, the sliding window and an evicting case, each ATE below its
bound, K1 never launched (`run_tracking_phase`); (5h) the learned-weights
check: 40 training steps from the JAX test's initial network on the
in-memory synthetic scene (the loss must fall), the checkpoint saved and
loaded back through the evaluation CLI's loader, four times; the mean
trained ATE below 0.75 of the initial network's (`run_overfit_phase`,
through `cli.overfit_synthetic.run`); 5g runs the cases of
tests/test_torch_tracking.py, 5h the JAX test's initial network from
tests/test_torch_overfit.py; (6) the training main path: 3 optimizer
steps of the MultiScale recipe (config_net/MultiScale_TartanEvent.json) at
480x640 through the training CLI's loop on an in-memory 30-voxel window
of the same scene, with launch counts, a checkpoint round trip, s/step,
peak memory and a profiled step, then one step of the recipe without
event bias (gradient_bias true, `run_selection_training`); (6b) the
hardware training run, `cli.train_hw_run` at its defaults (480x640, 15
frames, 18 unrolled steps, M=80, 120 steps on the 60-frame synthetic
curved scene in memory), its checkpoint restored, the random and the
trained network through the evaluation CLI (chunk 8), launch counts,
the loss falling, trained ATE below random (`run_hw_train_phase`); (7c)
the ATE-parity harness (cli/real_ckpt_eval.py) run_scenario -> evaluate ->
emit_table for a SingleScale and a MultiScale scenario on the CLI phase's
in-memory scene with reference-format .pth weights
(`run_harness_phase`); (7b) `cli.bench --train`: the full recipe step
(M=96, 18 unrolled steps) timed, then each --ablate variant, with launch
counts (`run_train_bench_phase`); (7) data-parallel training: one step
with no mesh on two full-width windows, the same step in two ranks
spawned onto the card over gloo (gradients within DP_TOL, parameters bit
for bit equal across ranks, K7/K8 launches per rank) and in a
world-size-1 NCCL group (`run_dp_phase`). Prints one
{"kernels": [...]} line (ten kernels) and, last, {"ok": true,
"device": {...}}. Any failure exits non-zero. Needs
CUDA and the repository around it; imports nothing of JAX or rampvo_tpu.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

HBM_BPS = 3.35e12                  # H100 SXM device memory, bytes/s
PEAK = {"bf16": 989e12, "f32": 67e12}   # dense FLOP/s (bf16 tensor, f32 CUDA cores)
SFU_PER_CLK, SM_CLOCK = 16, 1.98e9      # transcendental ops a clock an SM; boost clock
H, W, M = 480, 640, 96
FRAMES = 40
K2_SCALES = ((16, H * W), (32, (H // 2) * (W // 2)), (64, (H // 4) * (W // 4)))


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


def device_ms(torch, fn, key: str, n: int = 20) -> float:
    """Device time in ms per call of `fn` of the kernels whose name holds
    `key` (torch.profiler's kernel durations over n calls, after one
    warm-up call): a kernel's own time where the host issues its launches
    slower than the card runs them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and key in e.key]
    if not ev:
        fail(f"no kernel named *{key}* in the profile")
    return sum(e.self_device_time_total for e in ev) / n / 1e3


def queued_ms(torch, fn, n: int = 20) -> float:
    """Device ms per call of `fn` by CUDA events around n calls queued
    behind a spinning kernel (torch.cuda._sleep): the host issues every
    launch while the card spins, so the events time the kernels back to
    back and not the host's issue (the encoder wrappers cost the host
    more per call than their kernels take). The spin grows until the
    first event is still waiting when the last call has been issued."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000                  # ~10 ms at the boost clock
    for _ in range(5):
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        queued = not a.query()
        torch.cuda.synchronize()
        if queued:
            return a.elapsed_time(b) / n
        cycles *= 4
    fail("queued_ms: the host issued slower than the card spun")


def bound_ms(nbytes: float, flops: float, dt: str):
    tb, to = nbytes / HBM_BPS, flops / PEAK[dt]
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def k2_scale_inputs(torch, dt, seed=2, cx=8):
    """K2's full-size inputs, one tuple (x, ss, wg, bg, wf, bf) per scale
    (h = 16/32/64 at HW = 307200 / 76800 / 19200), x with cx rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    return [(rn(cx, hw).to(dt), rn(h, hw).to(dt),
             rn(cx, 8 * h) * 0.5 * (8 / cx) ** 0.5,
             rn(8 * h) * 0.1, rn(3 * h, h) / (3 * h) ** 0.5, rn(h) * 0.1)
            for h, hw in K2_SCALES]


def bf16_half_ulp(torch, v):
    """Half a bf16 ulp at each value of v (float32): 2^(e - 8) for
    |v| in [2^(e-1), 2^e)."""
    return torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 9)


def check_lstm_fold(torch, ek, out, defines=(), cx=8):
    """K2 at the three full-size scales (h = 16/32/64 at HW = 307200 /
    76800 / 19200) with cx input rows (event bins + 3; 8 on the 5-bin
    main path), bf16 and f32, each scale against the plain version:
    max |kernel - plain| <= tol * max(1, max |plain|), tol = 1e-2 (bf16:
    bf16 operands and roundings of h and the output) or 1e-4 (f32; only
    the summation order and the transcendental functions differ). bf16
    also against the plain mirror of its roundings (`lstm_fold_bf16_ref`,
    unrounded output): within half an output ulp plus 1e-3 of scale (the
    SFU approximations, and the rare h that they send to the other bf16
    neighbour). Each scale and the frame (three launches) timed with the
    weights packed beforehand, as the VO runtime packs them once, by CUDA
    events around launches queued behind a spin (`queued_ms`): the
    wrapper's host cost per call is of the kernel's order, so a plain
    event-timed loop of launches measures the host (printed beside).
    Bound: bytes, operations (bf16 tensor cores; f32 CUDA cores) or the
    SFU (4 transcendental functions a unit at 16 a clock an SM), the
    largest. `defines` picks a build variant."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dt, name, tol in ((torch.bfloat16, "bf16", 1e-2),
                          (torch.float32, "f32", 1e-4)):
        args = k2_scale_inputs(torch, dt, cx=cx)
        packs = [ek.pack_fold_weights(*a[2:]) for a in args]
        run = lambda a, w: ek.lstm_fold_cuda(*a, packed=w, defines=defines)
        frame = lambda: [run(a, w) for a, w in zip(args, packs)]
        err = errm = 0.0
        per = []
        for (h, hw), a, w in zip(K2_SCALES, args, packs):
            k = run(a, w).float()
            p = ek.lstm_fold_ref(*a).float()
            torch.cuda.synchronize()
            e = (k - p).abs().max().item()
            if not e <= tol * max(1.0, p.abs().max().item()):
                fail(f"lstm_fold {name} Cx={cx} h={h}: max err {e}")
            err = max(err, e)
            if name == "bf16":
                m = ek.lstm_fold_bf16_ref(*a)
                em = ((k - m).abs() - bf16_half_ulp(torch, m)).max().item()
                if not em <= 1e-3 * max(1.0, m.abs().max().item()):
                    fail(f"lstm_fold bf16 Cx={cx} h={h}: {em} beyond half "
                         "an ulp of the bf16 mirror")
                errm = max(errm, em)
            per.append(queued_ms(torch, lambda: run(a, w)))
        ms = queued_ms(torch, frame)
        loop = cuda_ms(frame, reps=20)
        plain = cuda_ms(lambda: [ek.lstm_fold_ref(*a) for a in args], reps=3)
        es = torch.finfo(dt).bits // 8
        nbytes = sum(hw * (cx + 2 * h) * es + 4 * (cx * 8 * h + 8 * h
                                                   + 3 * h * h + h)
                     for h, hw in K2_SCALES)
        flops = sum(hw * 2 * (cx * 6 * h + 3 * h * h) for h, hw in K2_SCALES)
        sfu = sum(hw * 2 * h * 4 for h, hw in K2_SCALES)
        bms, by = bound_ms(nbytes, flops, name)
        sfu_ms = sfu / (SFU_PER_CLK * sms * SM_CLOCK) * 1e3
        if sfu_ms > bms:
            bms, by = sfu_ms, "operations"
        print(f"K2 lstm_fold_cm {name} Cx={cx}: 3 scales/frame kernel "
              f"{ms:.4f} ms of device time (h=16/32/64 {per[0]:.4f} / "
              f"{per[1]:.4f} / {per[2]:.4f} ms, sum {sum(per):.4f}; "
              f"event-timed loop {loop:.4f} ms a frame), plain {plain:.4f} "
              f"ms, bound {bms:.4f} ms ({by}; bytes "
              f"{nbytes / HBM_BPS * 1e3:.4f}, products "
              f"{flops / PEAK[name] * 1e3:.4f}, SFU {sfu_ms:.4f}), max err "
              f"{err:.3e}" + (f", beyond half an ulp of the bf16 mirror "
                              f"{errm:.3e}" if name == "bf16" else ""))
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                         max_abs_err=err, scale_ms=per, loop_ms=loop, cx=cx)


def k3_inputs(torch, dt, seed=4, cx=8):
    """K3's full-size inputs (x, hc, ss, wg, wh, bg, wf, bf) at hp = 16,
    HW = 480 * 640, x with cx rows: dense random weights (the kernel takes
    any)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    hp, hw = 16, H * W
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    return (rn(cx, hw).to(dt), rn(4 * hp, hw).to(dt), rn(hp, hw).to(dt),
            rn(cx, 8 * hp) * 0.5 * (8 / cx) ** 0.5,
            rn(2 * hp, 8 * hp) / (2 * hp) ** 0.5,
            rn(8 * hp) * 0.1, rn(2 * hp, hp) / (2 * hp) ** 0.5,
            rn(hp) * 0.1)


def check_lstm_carry_fold(torch, sk, out, defines=(), cx=8):
    """K3 at the full-size SingleScale shapes (hp = 16, HW = 480 * 640)
    with cx input rows (event bins + 3; 8 on the 5-bin main path), bf16
    and f32, presence (1, 1), (1, 0) and (0, 1), weights packed
    beforehand as the VO runtime packs them once. Against the plain
    version: max |kernel - plain| <= tol * max(1, max |plain|) over both
    outputs, tol = 1e-2 (bf16: bf16 operands and roundings of h', ss1 and
    the outputs) or 1e-4 (f32; only the summation order and the
    transcendental functions differ). bf16 also against the plain mirror
    of its roundings (`lstm_carry_fold_bf16_ref`, unrounded outputs),
    stage by stage: the mirror's folds take the kernel's own bf16 h' (its
    output) and, with both folds, its own bf16 ss1 (the (1, 0) case's
    output), so that a bf16 intermediate the SFU approximations sent to
    the other neighbour, which the folds' weights carry on, does not hide
    behind a looser bound; then within half an output ulp plus 1e-3 of
    scale (K2's rule). The free-running mirror's distance is printed
    beside. Timed with both modalities present (the main path's
    case) by CUDA events around launches queued behind a spin
    (`queued_ms`): the wrapper's host cost per call is of the kernel's
    order, so a plain event-timed loop (printed beside) measures the
    host. Bound: bytes, operations (bf16 tensor cores; f32
    CUDA cores) or the SFU (5 transcendental functions a unit at 16 a
    clock an SM), the largest. `defines` picks a build variant."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hp, hw = 16, H * W
    for dt, name, tol in ((torch.bfloat16, "bf16", 1e-2),
                          (torch.float32, "f32", 1e-4)):
        base = k3_inputs(torch, dt, seed=4 if name == "bf16" else 5, cx=cx)
        w = sk.pack_carry_fold_weights(*base[3:])
        run = lambda a: sk.lstm_carry_fold_cuda(*a, packed=w, defines=defines)
        err = errm = errf = 0.0
        beyond = lambda k, m: ((k - m).abs() - bf16_half_ulp(torch, m)).max(
        ).item()
        ss1 = None
        for pres in ((1, 0), (1, 1), (0, 1)):
            a = (*base, torch.tensor(pres, dtype=torch.int32, device="cuda"))
            k = run(a)
            p = sk.lstm_carry_fold_ref(*a)
            for kk, pp in zip(k, p):
                kk, pp = kk.float(), pp.float()
                e = (kk - pp).abs().max().item()
                if not e <= tol * max(1.0, pp.abs().max().item()):
                    fail(f"lstm_carry_fold {name} Cx={cx} pres={pres}: max "
                         f"err {e}")
                err = max(err, e)
            if name != "bf16":
                continue
            m = sk.lstm_carry_fold_bf16_ref(
                *a, h=k[1][:2 * hp], ss1=ss1 if pres == (1, 1) else None)
            for kk, mm in zip(k, m):
                em = beyond(kk.float(), mm)
                if not em <= 1e-3 * max(1.0, mm.abs().max().item()):
                    fail(f"lstm_carry_fold bf16 Cx={cx} pres={pres}: {em} "
                         "beyond half an ulp of the bf16 mirror")
                errm = max(errm, em)
            errf = max(errf, *(beyond(kk.float(), mm) for kk, mm in zip(
                k, sk.lstm_carry_fold_bf16_ref(*a))))
            if pres == (1, 0):
                ss1 = k[0]
        a = (*base, torch.ones(2, dtype=torch.int32, device="cuda"))
        ms = queued_ms(torch, lambda: run(a))
        loop = cuda_ms(lambda: run(a), reps=20)
        plain = cuda_ms(lambda: sk.lstm_carry_fold_ref(*a), reps=3)
        es = torch.finfo(dt).bits // 8
        wbytes = (w.frag.numel() * 2 + w.bias.numel() * 4 if name == "bf16"
                  else 4 * sum(t.numel() for t in w[:5]))
        nbytes = hw * (cx + 5 * hp) * es + hw * 5 * hp * es + wbytes + 8
        flops = hw * (2 * (cx + 2 * hp) * 8 * hp + 2 * 2 * 2 * hp * hp)
        sfu_ms = hw * 2 * hp * 5 / (SFU_PER_CLK * sms * SM_CLOCK) * 1e3
        bms, by = bound_ms(nbytes, flops, name)
        if sfu_ms > bms:
            bms, by = sfu_ms, "operations"
        print(f"K3 lstm_carry_fold_cm {name} Cx={cx}: kernel {ms:.4f} ms of "
              f"device time (event-timed loop {loop:.4f} ms a launch), plain "
              f"{plain:.4f} ms, bound {bms:.4f} ms ({by}; bytes "
              f"{nbytes / HBM_BPS * 1e3:.4f}, products "
              f"{flops / PEAK[name] * 1e3:.4f}, SFU {sfu_ms:.4f}), max err "
              f"{err:.3e}" + (f", beyond half an ulp of the bf16 mirror "
                              f"{errm:.3e} stage by stage, {errf:.3e} "
                              "free-running" if name == "bf16" else ""))
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                         max_abs_err=err, loop_ms=loop, cx=cx)


BIN_CXS = (4, 13, 18, 64)    # 1, 10, 15 and 61 event bins + 3 image channels


def check_enc_bins(torch, ek, sk, k2, k3):
    """K2 and K3 at the input row counts of other event-bin counts
    (`BIN_CXS`: the instances of two and three x k-steps, and the run-time
    one at Cx = 64), each checked and timed as at Cx = 8; each one's bf16
    and f32 ms, bound and error go into k2["bins"] / k3["bins"]."""
    for cx in BIN_CXS:
        o2, o3 = {}, {}
        check_lstm_fold(torch, ek, o2, cx=cx)
        check_lstm_carry_fold(torch, sk, o3, cx=cx)
        for out, o in ((k2, o2), (k3, o3)):
            out.setdefault("bins", {})[cx] = {
                n: {k: o[n][k] for k in ("ms", "bound_ms", "max_abs_err")}
                for n in ("bf16", "f32")}


K3_VARIANTS = (             # (label, -D defines of csrc/lstm_carry_fold.cu)
    ("4 warps/block, 32-pixel tiles, 3 blocks/SM, tanh.approx, two tile "
     "buffers (shipped)", ()),
    ("8 warps/block", ("K3_WARPS=8", "K3_MIN_BLOCKS=1")),
    ("16-pixel tiles, 4 blocks/SM", ("K3_MT=1", "K3_MIN_BLOCKS=4")),
    ("accurate expf/tanhf in the bf16 path", ("K3_EXACT_TANH=1",)),
    ("one tile buffer a warp (no copy under the work)", ("K3_ONE_BUFFER=1",)),
)


def compare_k3_variants(torch, sk, build):
    """`--k3-variants`: build the K3 variants in parallel, print each one's
    registers and spills, and hold each against the plain versions and
    time it as the K3 check does, in one process."""
    logs = build.build_all([("lstm_carry_fold", d) for _, d in K3_VARIANTS])
    for label, d in K3_VARIANTS:
        out = {}
        check_lstm_carry_fold(torch, sk, out, defines=d)
        print(f"K3 variant {label}: bf16 {out['bf16']['ms']:.4f} ms, f32 "
              f"{out['f32']['ms']:.4f} ms (device time); ptxas "
              f"{ptxas_lines(logs[('lstm_carry_fold', d)])}")


def patch_grid(torch):
    """[3, 3, 2] (x, y) offsets of a 3x3 patch, -1..1 px."""
    ar = torch.arange(3.0, device="cuda") - 1
    return torch.stack(torch.meshgrid(ar, ar, indexing="xy"), -1)


def max_err_nan(k, p):
    """max |k - p| where p is not NaN; None when the NaNs of k and p are
    not at the same places."""
    import torch

    nan = torch.isnan(p)
    if not torch.equal(torch.isnan(k), nan):
        return None
    return (torch.where(nan, torch.zeros_like(k), k - p)).abs().max().item()


def synthetic_lattice(torch, dt, seed=3, coords="spread3", cfg=None):
    """A full-size lattice (the default VOConfig's NI=25, T=25, M=96,
    MEM=40, or `cfg`'s, at 120x160 and 30x40 rings) at a steady-state n
    with a seeded mix of dead cells, and patch coordinates spread over and
    beyond the map borders: `coords` "spread3" scatters a patch's 9 pixels
    +-3 px around its center, "patch" puts them on a 3x3 grid +-1 px with
    0.2 px jitter (the shape of a reprojected patch), "adversarial" takes
    `adversarial_coords` (slow path, borders, far and non-finite coords),
    "clustered" puts every patch of the lattice on one spot (every edge of
    a target in one bin of the binned kernels, the largest bins)."""
    from rampvo_tpu_torch.vo.config import VOConfig

    cfg = cfg or VOConfig()
    NI, T, r, MEM, Mm = cfg.NI, cfg.T, cfg.PATCH_LIFETIME, cfg.MEM, cfg.M
    g = torch.Generator(device="cuda").manual_seed(seed)
    h1, w1 = H // 4, W // 4
    gmap = torch.randn(MEM, Mm, 3, 3, 128, generator=g, device="cuda").to(dt)
    f1 = torch.randn(MEM, h1, w1, 128, generator=g, device="cuda").to(dt)
    f2 = torch.randn(MEM, h1 // 4, w1 // 4, 128, generator=g,
                     device="cuda").to(dt)
    NC = NI * T
    cen = (torch.rand(NC, Mm, 1, 2, generator=g, device="cuda")
           * torch.tensor([w1 + 16.0, h1 + 16.0], device="cuda") - 8.0)
    off = torch.rand(NC, Mm, 9, 2, generator=g, device="cuda") * 6.0 - 3.0
    if coords in ("patch", "clustered"):
        off = patch_grid(torch).reshape(9, 2) + 0.2 * torch.randn(
            NC, Mm, 9, 2, generator=g, device="cuda")
    if coords == "clustered":
        cen = torch.tensor([61.4, 45.6], device="cuda") + 0.3 * torch.rand(
            NC, Mm, 1, 2, generator=g, device="cuda")
    uv = (cen + off).reshape(NC, Mm * 9, 2)
    if coords == "adversarial":
        uv = adversarial_coords(torch, NC * Mm, w1, h1, g)[0].reshape(
            NC, Mm * 9, 2)
    cell_valid = torch.rand(NI, T, generator=g, device="cuda") < 0.85
    n = 60
    slotmap = torch.full((512,), -1, dtype=torch.int64, device="cuda")
    slotmap[n - 38:n] = torch.arange(38, device="cuda") % MEM
    return (gmap, f1, f2, uv[..., 0].contiguous(), uv[..., 1].contiguous(),
            cell_valid, n, slotmap, r, (NI, T, Mm))


def adversarial_coords(torch, n, w1, h1, g, nan=True):
    """[n, 3, 3, 2] level-1 coords that stress the kernels' box arithmetic,
    by patch index mod 8: 0 a plain patch; 1 pixels +-7 px apart (spans
    beyond the box cap: the slow path); 2 boxes crossing a border; 3 boxes
    wholly outside the map; 4 all nine pixels identical; 5 integer
    coordinates (fraction 0); 6 a patch with one far pixel (+-1e30); 7 a
    patch with one NaN, +inf or -inf pixel coordinate (`nan` False: +-inf
    only). Returns (coords, mask of the patches of kind 7)."""
    ru = lambda *s: torch.rand(*s, generator=g, device="cuda")
    size = torch.tensor([float(w1), float(h1)], device="cuda")
    kind = torch.arange(n, device="cuda") % 8
    cen = ru(n, 1, 1, 2) * (size - 16.0) + 8.0
    edge_pt = torch.stack([torch.where(ru(n) < 0.5, -0.5, w1 - 0.5),
                           ru(n) * h1], -1)
    swap = (ru(n) < 0.5)[:, None]
    edge_pt = torch.where(swap, edge_pt, torch.stack(
        [ru(n) * w1, torch.where(ru(n) < 0.5, -0.5, h1 - 0.5)], -1))
    far = torch.where(ru(n, 2) < 0.5, -14.0 - 20 * ru(n, 2),
                      size + 14.0 + 20 * ru(n, 2))
    k = kind[:, None, None, None]
    cen = torch.where(k == 2, edge_pt[:, None, None], cen)
    cen = torch.where(k == 3, far[:, None, None], cen)
    co = cen + patch_grid(torch) + 0.2 * torch.randn(
        n, 3, 3, 2, generator=g, device="cuda")
    co = torch.where(k == 1, cen + ru(n, 3, 3, 2) * 14.0 - 7.0, co)
    co = torch.where(k == 4, cen + 0.37, co)
    co = torch.where(k == 5, torch.round(co), co)
    idx = torch.arange(n, device="cuda")
    bad = torch.tensor([1e30, -1e30], device="cuda")[(idx // 8) % 2]
    co[:, 1, 2, 0] = torch.where(kind == 6, bad, co[:, 1, 2, 0])
    bad = torch.tensor([float("inf"), float("-inf"), float("nan")],
                       device="cuda")[(idx // 8) % (3 if nan else 2)]
    co[:, 2, 0, 1] = torch.where(kind == 7, bad, co[:, 2, 0, 1])
    return co.contiguous(), kind == 7


def adversarial_lattice(torch, dt, seed=13, NC=64):
    """A small lattice (NC cells of M patches, 8 ring slots, a few dead
    cells) over `adversarial_coords`, in K1's argument order."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h1, w1, MEM = H // 4, W // 4, 8
    gmap = torch.randn(MEM, M, 3, 3, 128, generator=g, device="cuda").to(dt)
    f1 = torch.randn(MEM, h1, w1, 128, generator=g, device="cuda").to(dt)
    f2 = torch.randn(MEM, h1 // 4, w1 // 4, 128, generator=g,
                     device="cuda").to(dt)
    co, _ = adversarial_coords(torch, NC * M, w1, h1, g)
    co = co.reshape(NC, M * 9, 2)
    cells = torch.randint(0, MEM, (NC, 2), generator=g, device="cuda",
                          dtype=torch.int32)
    cells[::7, 0] = -1
    return (gmap, f1, f2, co[..., 0].contiguous(), co[..., 1].contiguous(),
            cells, M)


def check_corr_lattice(torch, ck, out, defines=()):
    """K1 on the synthetic full-size lattice, bf16 and f32, with the 9
    pixels of a patch spread +-3 px (the set the kernels line reports) and
    patch-shaped (3x3 grid +-1 px), both compared element-wise with the
    plain version and timed; then on the adversarial lattice (smaller E:
    spreads beyond the box cap, boxes crossing and outside each border,
    identical pixels, integer coordinates, NaN / inf / 1e30 coordinates,
    dead cells) against the plain version, and the plain box mirror
    (float32, unrounded) against it too, NaN outputs (non-finite
    coordinates) at the same places. Tolerance: max
    |kernel - plain| <= tol * max |plain| with tol = 1e-2 (bf16: one output
    rounding) or 1e-5 (f32: summation order only). The kernel's
    slow-path counter must be 0 on the patch-shaped set and equal the box
    mirror's count (> 0) on the adversarial set. `defines` picks a build
    variant of the kernel."""
    for dt, name, tol in ((torch.bfloat16, "bf16", 1e-2),
                          (torch.float32, "f32", 1e-5)):
        for coords in ("spread3", "patch"):
            (gmap, f1, f2, u, v, cv, n, slotmap, r,
             lat) = synthetic_lattice(torch, dt, coords=coords)
            NI, T, Mm = lat
            cells = ck.cell_tables(NI, T, r, n, cv, slotmap, gmap.shape[0])
            a = (gmap, f1, f2, u, v, cells, Mm)
            ck.corr_lattice_slow_edges(defines=defines)
            k = ck.corr_lattice_cuda(*a, defines=defines).float()
            slow = ck.corr_lattice_slow_edges(defines=defines)
            p = ck.corr_lattice_ref(*a).float()
            torch.cuda.synchronize()
            err = (k - p).abs().max().item()
            scale = p.abs().max().item()
            if not err <= tol * scale:
                fail(f"corr_lattice {name} {coords}: max err {err} (scale "
                     f"{scale})")
            live = (cells[:, 0] >= 0)
            n_live = int(live.sum())
            if n_live == 0 or not bool(
                    (k.reshape(NI * T, Mm, -1)[~live] == 0).all()):
                fail("corr_lattice: dead cells must be zero / no live cells")
            if coords == "patch" and slow != 0:
                fail(f"corr_lattice {name}: {slow} patch-shaped edges took "
                     "the slow path")
            ms = cuda_ms(lambda: ck.corr_lattice_cuda(*a, defines=defines),
                         reps=20)
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
            # what the kernel reads through the caches: every tap of every
            # live edge's two boxes, once
            le = live.repeat_interleave(Mm)
            taps = sum(float((b.bw * b.bh)[le].sum()) for b in (
                ck.window_boxes(u.reshape(E, 9) * sc, v.reshape(E, 9) * sc,
                                f.shape[1], f.shape[2])
                for f, sc in ((f1, 1.0), (f2, 0.25))))
            print(f"K1 corr_lattice {name} {coords}: kernel {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), live "
                  f"cells {n_live}/{NI * T}, slow-path edges {slow}, max "
                  f"err {err:.3e} (scale {scale:.3e}); {taps / Ev:.1f} box "
                  f"taps per live edge, {taps * 128 * es / 1e9:.3f} GB of "
                  f"tap reads, {taps * 128 * es / ms / 1e9:.3f} TB/s")
            res = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                       max_abs_err=err)
            if coords == "spread3":
                out[name] = res
            else:
                out[name]["patch_ms"] = ms
        a = adversarial_lattice(torch, dt)
        ck.corr_lattice_slow_edges(defines=defines)
        k = ck.corr_lattice_cuda(*a, defines=defines).float()
        slow = ck.corr_lattice_slow_edges(defines=defines)
        p = ck.corr_lattice_ref(*a).float()
        pbox, slow_ref = ck.corr_lattice_box_ref(*a)
        torch.cuda.synchronize()
        scale = torch.nan_to_num(p).abs().max().item()
        err, errb = max_err_nan(k, p), max_err_nan(pbox, p)
        n_nan, n_slow = int(torch.isnan(p).sum()), int(slow_ref.sum())
        dead = (a[5][:, 0] < 0).repeat_interleave(a[6])
        if err is None or errb is None or not err <= tol * scale \
                or not errb <= tol * scale or n_nan == 0 or n_slow == 0 \
                or bool((k[dead] != 0).any()):
            fail(f"corr_lattice {name} adversarial: max err {err}, box "
                 f"mirror {errb} (scale {scale}), {n_nan} NaN outputs, "
                 f"{n_slow} slow edges")
        if slow != n_slow:
            fail(f"corr_lattice adversarial: the kernel sent {slow} edges "
                 f"down its slow path, the box mirror {n_slow}")
        print(f"K1 corr_lattice {name} adversarial E={k.shape[0]}: max err "
              f"{err:.3e} (scale {scale:.3e}), plain box mirror vs plain "
              f"{errb:.3e}, NaN outputs at the same {n_nan} places, "
              f"slow-path edges {slow} (box mirror {n_slow})")


K1_VARIANTS = (             # (label, -D defines of csrc/corr_lattice.cu)
    ("4 edges/block, registers for 4 blocks/SM (shipped)", ()),
    ("4 edges/block, registers for 5 blocks/SM", ("CORR_MIN_BLOCKS=5",)),
    ("2 edges/block, 8 blocks/SM", ("CORR_WARPS=2", "CORR_MIN_BLOCKS=8")),
    ("next tile's loads started before the mmas", ("CORR_PREFETCH=1",)),
)

K8_VARIANTS = (             # (label, -D defines of csrc/corr_train.cu)
    ("4 warps/edge (shipped)", ()),
    ("2 warps/edge", ("K8_WARPS=2",)),
    ("8 warps/edge", ("K8_WARPS=8",)),
    ("4 warps/edge, scalar atomics", ("K8_SCALAR_ATOMICS=1",)),
)


K7_VARIANTS = (             # (label, -D defines of csrc/corr_train.cu)
    ("4 edges/block, registers for 4 blocks/SM (shipped)", ()),
    ("4 edges/block, registers for 5 blocks/SM", ("CORR_MIN_BLOCKS=5",)),
    ("2 edges/block, 8 blocks/SM", ("CORR_WARPS=2", "CORR_MIN_BLOCKS=8")),
    ("next tile's loads started before the mmas", ("CORR_PREFETCH=1",)),
)

K2_VARIANTS = (             # (label, -D defines of csrc/lstm_fold.cu)
    ("4 warps/block, 4 blocks/SM, tanh.approx, two tile buffers (shipped)",
     ()),
    ("8 warps/block", ("K2_WARPS=8", "K2_MIN_BLOCKS=2")),
    ("4 warps/block, registers for 8 blocks/SM", ("K2_MIN_BLOCKS=8",)),
    ("accurate expf/tanhf in the bf16 path", ("K2_EXACT_TANH=1",)),
    ("one tile buffer a warp (no copy under the work)", ("K2_ONE_BUFFER=1",)),
)


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def ab_measure(torch):
    """One side of `--ab`: device times in the tree whose rampvo_tpu_torch
    is imported, each through the wrapper as that tree defines it: K7
    (profiler), K2 and K3 at Cx = 8 with their weights packed beforehand
    (`queued_ms`; K2 each scale and the frame's three launches), and the
    folded layout's
    correlation `corr_lattice2_stacked(folded=True)` on the synthetic
    lattice (every kernel of the call: the band kernel and its PyTorch
    finish, or the folded kernel)."""
    from rampvo_tpu_torch.ops import build
    from rampvo_tpu_torch.ops import corr_band_kernels as bk
    from rampvo_tpu_torch.ops import corr_train_kernels as ctk
    from rampvo_tpu_torch.ops import encoder_kernels as ek
    from rampvo_tpu_torch.ops import singlescale_kernels as sk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all(["corr_train", "lstm_fold", "lstm_carry_fold",
                     "corr_bands"])
    res = {}
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for coords in ("patch", "spread3"):
            a = synthetic_corr_train(torch, dt, coords=coords)[:6]
            res[f"K7 {name} {coords}"] = device_ms(
                torch, lambda: ctk.corr_train_cuda(*a), "corr_train_fwd")
        args = k2_scale_inputs(torch, dt)
        packs = [ek.pack_fold_weights(*a[2:]) for a in args]
        for (h, _), a, w in zip(K2_SCALES, args, packs):
            res[f"K2 {name} h={h}"] = queued_ms(
                torch, lambda: ek.lstm_fold_cuda(*a, packed=w))
        res[f"K2 {name} frame"] = queued_ms(torch, lambda: [
            ek.lstm_fold_cuda(*a, packed=w) for a, w in zip(args, packs)])
        a = (*k3_inputs(torch, dt),
             torch.ones(2, dtype=torch.int32, device="cuda"))
        w = sk.pack_carry_fold_weights(*a[3:8])
        res[f"K3 {name}"] = queued_ms(
            torch, lambda: sk.lstm_carry_fold_cuda(*a, packed=w))
        s = synthetic_lattice(torch, dt)
        res[f"folded corr {name}"] = device_ms(
            torch, lambda: bk.corr_lattice2_stacked(*s, folded=True), "")
    return res


AB_SIDE = """
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location("chip_smoke_ab", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
print("AB " + json.dumps(cs.ab_measure(torch)))
"""


def compare_ab(parent: str):
    """`--ab DIR`: the device times of `ab_measure` in the tree at DIR (the
    parent's, unpacked with git archive) and in this one, in one call on
    one card, in turns: parent, change, change, parent. Each side is a process of
    its own, run from its tree (so it imports that tree's package and
    builds that tree's sources) with `ab_measure` from this file."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for tree in (parent, here, here, parent):
        res = subprocess.run([sys.executable, "-c", AB_SIDE,
                              os.path.abspath(__file__)],
                             cwd=os.path.abspath(tree), capture_output=True,
                             text=True)
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
        if res.returncode != 0 or not line:
            fail(f"A/B side in {tree}: rc {res.returncode}\n{res.stderr[-3000:]}")
        runs.append(json.loads(line[0][3:]))
    print("A/B, device ms a launch (K2 frame: the three scales' launches; "
          "folded corr: every kernel of the call) (parent, change, change, "
          "parent):")
    for key in runs[0]:
        print(f"  {key:22s} " + "  ".join(f"{r[key]:.4f}" for r in runs))


def compare_k1_variants(torch, ck, build):
    """`--k1-variants`: build K1's variants in parallel, print each one's
    registers and spills, hold each against the plain version and time it
    as the K1 check does, in one process."""
    logs = build.build_all([("corr_lattice", d) for _, d in K1_VARIANTS])
    for label, d in K1_VARIANTS:
        out = {}
        check_corr_lattice(torch, ck, out, defines=d)
        print(f"K1 variant {label}: bf16 spread3 {out['bf16']['ms']:.4f} ms, "
              f"patch {out['bf16']['patch_ms']:.4f} ms; f32 "
              f"{out['f32']['ms']:.4f} / {out['f32']['patch_ms']:.4f} ms; "
              f"ptxas {ptxas_lines(logs[('corr_lattice', d)])}")


def compare_k8_variants(torch, ctk, build):
    """`--k8-variants`: the same for K8 (with K7, which shares its
    source)."""
    logs = build.build_all([("corr_train", d) for _, d in K8_VARIANTS])
    for label, d in K8_VARIANTS:
        of, ob = {}, {}
        check_corr_train(torch, ctk, of, ob, defines=d)
        print(f"K8 variant {label}: f32 patch {ob['f32']['ms']:.4f} ms, "
              f"spread3 {ob['f32']['spread3_ms']:.4f} ms; bf16 "
              f"{ob['bf16']['ms']:.4f} / {ob['bf16']['spread3_ms']:.4f} ms; "
              f"ptxas {ptxas_lines(logs[('corr_train', d)])}")


def compare_k7_variants(torch, ctk, build):
    """`--k7-variants`: the same for K7 (K8 runs along: one source)."""
    logs = build.build_all([("corr_train", d) for _, d in K7_VARIANTS])
    for label, d in K7_VARIANTS:
        of, ob = {}, {}
        check_corr_train(torch, ctk, of, ob, defines=d)
        print(f"K7 variant {label}: f32 patch {of['f32']['ms']:.4f} ms, "
              f"spread3 {of['f32']['spread3_ms']:.4f} ms; bf16 "
              f"{of['bf16']['ms']:.4f} / {of['bf16']['spread3_ms']:.4f} ms; "
              f"ptxas {ptxas_lines(logs[('corr_train', d)])}")


def compare_k2_variants(torch, ek, build):
    """`--k2-variants`: the same for K2."""
    logs = build.build_all([("lstm_fold", d) for _, d in K2_VARIANTS])
    for label, d in K2_VARIANTS:
        out = {}
        check_lstm_fold(torch, ek, out, defines=d)
        print(f"K2 variant {label}: bf16 {out['bf16']['ms']:.4f} ms a frame "
              f"({' / '.join(f'{x:.4f}' for x in out['bf16']['scale_ms'])}"
              f"), f32 {out['f32']['ms']:.4f} ms; ptxas "
              f"{ptxas_lines(logs[('lstm_fold', d)])}")


def bit_equal(torch, a, b) -> bool:
    """a and b hold the same bits (NaN payloads included)."""
    it = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(it), b.view(it))


def lattice_args(torch, ck, coords):
    """K1's arguments (gmap, f1, f2, u, v, cells, M) on the synthetic
    lattice (`coords` "spread3" or "patch") or the adversarial one, for
    both dtypes: {dtype name: args}."""
    res = {}
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        if coords == "adversarial":
            res[name] = adversarial_lattice(torch, dt)
            continue
        (gmap, f1, f2, u, v, cv, n, slotmap, r,
         (NI, T, Mm)) = synthetic_lattice(torch, dt, coords=coords)
        cells = ck.cell_tables(NI, T, r, n, cv, slotmap, gmap.shape[0])
        res[name] = (gmap, f1, f2, u, v, cells, Mm)
    return res


def check_folded(torch, ck, bk):
    """K4's folded kernel == K1 through folded_corr_perm bit for bit, in
    bf16 and f32, on the +-3 px, patch-shaped and adversarial lattices
    (NaN outputs included), dead cells zero."""
    from rampvo_tpu_torch.ops.corr_perms import folded_corr_perm

    finv = torch.tensor(folded_corr_perm(3, 3), dtype=torch.long,
                        device="cuda")
    for coords in ("spread3", "patch", "adversarial"):
        for name, a in lattice_args(torch, ck, coords).items():
            k1 = ck.corr_lattice_cuda(*a)
            kf = bk.corr_folded_cuda(*a)
            dead = (a[5][:, 0] < 0).repeat_interleave(a[6])
            torch.cuda.synchronize()
            if not bit_equal(torch, kf, k1[:, finv]):
                fail(f"K4 folded kernel {name} {coords}: differs from K1 "
                     "through folded_corr_perm")
            if not bool(dead.any()) or bool((kf[dead] != 0).any()):
                fail(f"K4 folded kernel {name} {coords}: a dead cell is not "
                     "zero (or none is dead)")
    print("K4 folded kernel == K1 through folded_corr_perm bit for bit, bf16 "
          "and f32, on the +-3 px, patch-shaped and adversarial lattices; "
          "dead cells zero")


def check_corr_layouts(torch, ck, bk, outs):
    """K4 on the synthetic full-size lattice, bf16 and f32, against its
    plain version (tolerance as K1's: tol * max |plain|, tol = 1e-2 bf16
    for one output rounding, 1e-5 f32 for the summation order) and against
    K1: K4 with its folded finish, mapped back through
    folded_corr_perm, within 2e-2 of K1's scale in bf16 (two roundings:
    the bands and the output) and 1e-5 in f32 (the blend in PyTorch's
    order). Dead cells zero in every output. K4's folded kernel (what the
    folded layout runs on the card): bit-equal to K1 through
    folded_corr_perm (`check_folded`, all three coordinate sets), within
    tol of its plain version, and within the finish's tolerance above of
    the band + finish. Times each kernel, K4's finish, the folded kernel
    (beside the band kernel, the band + finish and its bound) and the
    plain versions; `outs` gets {"K4"|"K4 finish"|"K4 folded": {dtype:
    numbers}}. K5 and K6: `check_binned`."""
    from rampvo_tpu_torch.ops.corr_perms import folded_corr_perm

    finv = torch.tensor(folded_corr_perm(3, 3), dtype=torch.long,
                        device="cuda")
    check_folded(torch, ck, bk)
    for dt, name, tol in ((torch.bfloat16, "bf16", 1e-2),
                          (torch.float32, "f32", 1e-5)):
        (gmap, f1, f2, u, v, cv, n, slotmap, r,
         lat) = synthetic_lattice(torch, dt)
        NI, T, Mm = lat
        MEM = gmap.shape[0]
        cells = ck.cell_tables(NI, T, r, n, cv, slotmap, MEM)
        a = (gmap, f1, f2, u, v, cells, Mm)
        k1 = ck.corr_lattice_cuda(*a)
        k4 = bk.corr_bands_cuda(*a)
        p4 = bk.corr_bands_ref(*a)
        E = NI * T * Mm
        vmask = ck.cell_vmask(NI, T, r, n, cv)[:, :, None].expand(
            NI, T, Mm).reshape(-1)
        fol = bk.stack_levels(*bk.finish_bands(k4, u, v, vmask),
                              folded=True).to(dt)
        kf = bk.corr_folded_cuda(*a)
        pf = bk.corr_folded_ref(*a)
        torch.cuda.synchronize()
        live = (cells[:, 0] >= 0).repeat_interleave(Mm)
        scale = k1.float().abs().max().item()
        back = torch.empty_like(fol)
        back[:, finv] = fol
        e41 = (back.float() - k1.float()).abs().max().item()
        ftol = (2e-2 if name == "bf16" else 1e-5) * scale
        if not e41 <= ftol:
            fail(f"K4 + folded finish {name}: max err {e41} against K1 "
                 f"(scale {scale})")
        eff = (kf.float() - fol.float()).abs().max().item()
        if not eff <= ftol:
            fail(f"K4 folded kernel {name}: max err {eff} against the band + "
                 f"finish (scale {scale})")
        errs = {}
        for key, k, p in (("K4", k4, p4), ("K4 folded", kf, pf)):
            e = (k.float() - p.float()).abs().max().item()
            sc = p.float().abs().max().item()
            if not e <= tol * sc:
                fail(f"{key} {name}: max err {e} against its plain version "
                     f"(scale {sc})")
            if bool((k.reshape(E, -1)[~live] != 0).any()):
                fail(f"{key} {name}: a dead cell is not zero")
            errs[key] = e
        es = torch.finfo(dt).bits // 8
        n_live = int((cells[:, 0] >= 0).sum())
        t_slots = torch.unique(cells[cells[:, 0] >= 0, 0]).numel()
        g_slots = torch.unique(cells[cells[:, 0] >= 0, 1]).numel()
        ins = (2 * E * 9 * 4 + g_slots * Mm * 9 * 128 * es
               + t_slots * (f1[0].numel() + f2[0].numel()) * es)
        flops = n_live * Mm * 9 * 2 * 64 * 128 * 2
        tabs_b = {"K4": cells.numel() * 4, "K4 folded": cells.numel() * 4}
        ncol = {"K4": 1152, "K4 folded": 882}
        runs = {"K4": (lambda: bk.corr_bands_cuda(*a),
                       lambda: bk.corr_bands_ref(*a)),
                "K4 folded": (lambda: bk.corr_folded_cuda(*a),
                              lambda: bk.corr_folded_ref(*a))}
        k1_ms = cuda_ms(lambda: ck.corr_lattice_cuda(*a), reps=20)
        for key, (kern, plain_fn) in runs.items():
            ms = cuda_ms(kern, reps=20)
            plain = cuda_ms(plain_fn, reps=2, warm=1)
            bms, by = bound_ms(E * ncol[key] * es + ins + tabs_b[key], flops,
                               name)
            print(f"{key} {name}: kernel {ms:.4f} ms (K1 {k1_ms:.4f} ms), "
                  f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), max err "
                  f"{errs[key]:.3e}" + (f"; K4 + folded finish vs K1 max err "
                                        f"{e41:.3e} (scale {scale:.3e})"
                                        if key == "K4" else ""))
            outs.setdefault(key, {})[name] = dict(
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                max_abs_err=errs[key])
        fin = cuda_ms(lambda: bk.stack_levels(
            *bk.finish_bands(k4, u, v, vmask), folded=True).to(dt), reps=10)
        fb, fby = bound_ms(E * 1152 * es + 2 * E * 9 * 4 + E + E * 882 * es,
                           E * 9 * 2 * 49 * 7, name)
        band = outs["K4"][name]["ms"]
        fold = outs["K4 folded"][name]
        print(f"K4 folded finish (plain PyTorch) {name}: {fin:.4f} ms, bound "
              f"{fb:.4f} ms ({fby}); K4 band + finish {fin + band:.4f} ms; "
              f"K4 folded kernel {fold['ms']:.4f} ms (bound "
              f"{fold['bound_ms']:.4f} ms, {fold['bound_by']}), K1 "
              f"{k1_ms:.4f} ms; folded kernel vs band + finish max err "
              f"{eff:.3e}, == K1 through folded_corr_perm bit for bit")
        outs.setdefault("K4 finish", {})[name] = dict(ms=fin, bound_ms=fb)
        fold["band_ms"] = band


BIN_SETS = ("spread3", "patch", "adversarial", "clustered")


def binned_args(torch, ck, dt, coords, cfg=None):
    """K1's, K6's and K5's arguments on one synthetic lattice: (K1/K5 args,
    K6 args, cell_vmask-style live mask per edge)."""
    (gmap, f1, f2, u, v, cv, n, slotmap, r,
     (NI, T, Mm)) = synthetic_lattice(torch, dt, coords=coords, cfg=cfg)
    MEM = gmap.shape[0]
    cells = ck.cell_tables(NI, T, r, n, cv, slotmap, MEM)
    tables = ck.cell_tables_a(NI, T, r, n, cv, slotmap, MEM)
    return ((gmap, f1, f2, u, v, cells, Mm), (gmap, f1, f2, u, v, tables, Mm),
            (cells[:, 0] >= 0).repeat_interleave(Mm))


def binned_bound(torch, a, ncol, table_bytes):
    """K1's bound on these inputs with `ncol` output columns: each output
    written once, coords, the live host patches and target ring slots
    read once; the dots of the live edges' exact windows."""
    gmap, f1, f2, u, v, cells, Mm = a
    es = gmap.element_size()
    live = cells[:, 0] >= 0
    E = cells.shape[0] * Mm
    ins = (2 * E * 9 * 4 + torch.unique(cells[live, 1]).numel() * Mm * 9
           * 128 * es + torch.unique(cells[live, 0]).numel()
           * (f1[0].numel() + f2[0].numel()) * es)
    flops = int(live.sum()) * Mm * 9 * 2 * 64 * 128 * 2
    return bound_ms(E * ncol * es + ins + table_bytes, flops,
                    "bf16" if es == 2 else "f32")


def check_bins_built(torch, ck, cb, a6, scratch, grid, what):
    """The bins K6's launch built on the card (read back from its scratch)
    against the plain builder (ops/corr_bins.py::edge_bins) on the same
    edges: every key, every bin's count and bbox equal; the permutation a
    partition of the live edges in bin order; the work items cover each
    bin in runs."""
    gmap, f1, f2, u, v, tables, Mm = a6
    E = u.numel() // 9
    view = cb.scratch_views(scratch, E, grid)
    groups, cells_a, walked = (t.cpu() for t in tables)
    tb = cells_a.shape[0] // groups.shape[0]
    slot = torch.full((E,), -1, dtype=torch.int64)
    for g, (_, _, sl, _, lo, hi) in enumerate(groups.tolist()):
        cenc = cells_a[g * tb + lo:g * tb + hi + 1, 0].long()
        c = torch.where(cenc >= 0, cenc, -1 - cenc)
        e = (c[:, None] * Mm + torch.arange(Mm)).reshape(-1)
        slot[e] = torch.where(cenc >= 0, sl, -1).repeat_interleave(Mm)
    key, bbox, counts = cb.edge_bins(
        u.reshape(E, 9).cpu(), v.reshape(E, 9).cpu(), slot, f1.shape[1],
        f1.shape[2], f2.shape[1], f2.shape[2], grid)
    k_key = view["key"].cpu().long()
    k_counts = view["counts"].cpu().long()
    used = counts[:-1] > 0
    if not (torch.equal(k_key, key) and torch.equal(k_counts, counts)
            and torch.equal(view["bbox"].cpu().long()[used], bbox[used])):
        fail(f"K6 bins {what}: the card's bins differ from the plain builder")
    perm = view["perm"].cpu().long()[:int(counts.sum())]
    if not (torch.equal(torch.sort(perm).values,
                        torch.nonzero(key >= 0)[:, 0])
            and bool((k_key[perm][1:] >= k_key[perm][:-1]).all())):
        fail(f"K6 bins {what}: the permutation is not the live edges in bin "
             "order")
    ctrl = view["ctrl"].cpu().tolist()
    items = view["items"].cpu()[:ctrl[0]]
    if ctrl[0] != int(((counts[:-1] + cb.IE - 1) // cb.IE).sum()) \
            or ctrl[1] != int(counts[-1]) or int(items[:, 2].sum()) \
            != int(counts[:-1].sum()) or int(items[:, 2].max()) > cb.IE:
        fail(f"K6 bins {what}: work items {ctrl} do not cover the bins")
    return (int(used.sum()), int(counts[:-1].max()), int(counts[-1]),
            int(counts[:-1].sum()))


def check_binned(torch, ck, pk, cb, outs):
    """K6 and K5 (the binned kernels) on four synthetic full-size coordinate
    sets (pixels spread +-3 px, patch-shaped, adversarial: slow path,
    borders, far and non-finite coords, and clustered: every patch of the
    lattice on one spot, so every edge of a target falls in one bin), bf16
    and f32: K6 == K1 bit for bit and K5 == K1 through paired_corr_perm bit
    for bit (NaN outputs included), K5's zero columns zero, dead cells zero;
    each within its tolerance of its plain version (tol * max |plain|, tol
    = 1e-2 bf16, 1e-5 f32, NaNs at the same places; the plain versions on
    the +-3 px and adversarial sets); the slow-path counts of K6 and K5
    equal K1's; the bins K6 built on the card equal the plain builder's
    (bf16). Times K1, K6 and K5 in turns on each set with their bounds, and
    the bin building's share of K6 and K5 (device time of the bin kernels,
    bf16 +-3 px); `outs` gets {"K5"|"K6": {dtype: numbers of the +-3 px
    set, plus the other sets' ms}}."""
    from rampvo_tpu_torch.ops.corr_perms import paired_corr_perm

    pidx = torch.tensor(paired_corr_perm(3, 3), dtype=torch.long,
                        device="cuda")
    for dt, name, tol in ((torch.bfloat16, "bf16", 1e-2),
                          (torch.float32, "f32", 1e-5)):
        for coords in BIN_SETS:
            a, a6, live = binned_args(torch, ck, dt, coords)
            gmap, f1, f2, u, v, cells, Mm = a
            E = live.numel()
            grid = cb.bin_grid(f1.shape[1], f1.shape[2], gmap.shape[0])
            scratch = torch.empty(cb.scratch_words(E, grid),
                                  dtype=torch.int32, device="cuda")
            slow_counts = (ck.corr_lattice_slow_edges,
                           ck.corr_lattice_cb_slow_edges,
                           pk.corr_paired_slow_edges)
            for f in slow_counts:   # reset
                f()
            k1 = ck.corr_lattice_cuda(*a)
            k6 = ck.corr_lattice_cb_cuda(*a6, scratch=scratch)
            k5 = pk.corr_lattice_paired_cuda(*a)
            slow = [f() for f in slow_counts]
            torch.cuda.synchronize()
            if not bit_equal(torch, k6, k1):
                fail(f"K6 corr_lattice_cb {name} {coords}: differs from K1")
            if not bit_equal(torch, k5[:, pidx >= 0].contiguous(),
                             k1[:, pidx[pidx >= 0]].contiguous()) \
                    or bool((k5[:, pidx < 0] != 0).any()):
                fail(f"K5 corr_paired {name} {coords}: differs from K1 "
                     "through the perm or a zero column is not zero")
            if bool((k6[~live] != 0).any()) or bool((k5[~live] != 0).any()):
                fail(f"K5/K6 {name} {coords}: a dead cell is not zero")
            if len(set(slow)) != 1 or (coords == "adversarial") != (
                    slow[0] > 0):
                fail(f"K1/K6/K5 slow-path edges {slow} on {coords}")
            bins = (check_bins_built(torch, ck, cb, a6, scratch, grid,
                                     f"{name} {coords}")
                    if name == "bf16" else None)
            errs = {}
            if coords in ("spread3", "adversarial"):
                for key, k, p in (
                        ("K6", k6, ck.corr_lattice_cb_ref(*a6)),
                        ("K5", k5, pk.corr_lattice_paired_ref(*a))):
                    err = max_err_nan(k.float(), p.float())
                    sc = torch.nan_to_num(p.float()).abs().max().item()
                    if err is None or not err <= tol * sc:
                        fail(f"{key} {name} {coords}: max err {err} against "
                             f"its plain version (scale {sc})")
                    errs[key] = err
            del k1, k5, k6
            runs = {"K1": lambda: ck.corr_lattice_cuda(*a),
                    "K6": lambda: ck.corr_lattice_cb_cuda(*a6),
                    "K5": lambda: pk.corr_lattice_paired_cuda(*a)}
            ms = {k: [] for k in runs}
            for turn in ("K1", "K6", "K5", "K5", "K6", "K1"):
                ms[turn].append(cuda_ms(runs[turn], reps=10))
            ms = {k: sum(x) / len(x) for k, x in ms.items()}
            tb6 = sum(x.numel() for x in a6[5]) * 4
            b6 = binned_bound(torch, a, 882, tb6)
            b5 = binned_bound(torch, a, 1152, cells.numel() * 4)
            line = (f"K6/K5 {name} {coords}: K1 {ms['K1']:.4f} ms, K6 "
                    f"{ms['K6']:.4f} ms (bound {b6[0]:.4f}, {b6[1]}), K5 "
                    f"{ms['K5']:.4f} ms (bound {b5[0]:.4f}, {b5[1]}); K6 == "
                    f"K1 and K5 == K1 through the perm bit for bit, slow-path "
                    f"edges {slow[0]}")
            if bins:
                line += (f"; {bins[0]} bins, largest {bins[1]} edges, "
                         f"{bins[3]} binned and {bins[2]} residual edges")
            if errs:
                line += (f"; max err vs plain K6 {errs['K6']:.3e}, K5 "
                         f"{errs['K5']:.3e}")
            print(line)
            for key, b in (("K6", b6), ("K5", b5)):
                o = outs.setdefault(key, {}).setdefault(name, {})
                o[f"{coords}_ms"] = ms[key]
                o[f"{coords}_k1_ms"] = ms["K1"]
                if coords == "spread3":
                    plain = cuda_ms({"K6": lambda: ck.corr_lattice_cb_ref(
                        *a6), "K5": lambda: pk.corr_lattice_paired_ref(
                        *a)}[key], reps=2, warm=1)
                    o.update(ms=ms[key], plain_ms=plain, bound_ms=b[0],
                             bound_by=b[1], max_abs_err=errs[key],
                             k1_ms=ms["K1"])
            if name == "bf16" and coords == "spread3":
                for key in ("K6", "K5"):
                    fn = runs[key]
                    binning = (device_ms(torch, fn, "_keys")
                               + device_ms(torch, fn, "bins_"))
                    total = device_ms(torch, fn, "")
                    outs[key][name]["binning_ms"] = binning
                    outs[key][name]["device_ms"] = total
                    print(f"{key} bf16 spread3: device time {total:.4f} ms "
                          f"a launch, of it the bin building {binning:.4f} ms")


def time_precise(torch, ck, pk, cb, outs):
    """K1, K6 and K5 once at the lattice of config_vo/precise.yaml (NI = 45,
    T = 65, M = 300: 877,500 edges) on the 480x640 rings, bf16, +-3 px and
    patch-shaped: K6 == K1 and K5 == K1 through paired_corr_perm bit for
    bit, each timed in turns beside its bound."""
    from rampvo_tpu_torch.ops.corr_perms import paired_corr_perm
    from rampvo_tpu_torch.vo.config import VOConfig

    cfg = VOConfig.from_yaml(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "config_vo", "precise.yaml"))
    pidx = torch.tensor(paired_corr_perm(3, 3), dtype=torch.long,
                        device="cuda")
    for coords in ("spread3", "patch"):
        a, a6, live = binned_args(torch, ck, torch.bfloat16, coords, cfg)
        k1 = ck.corr_lattice_cuda(*a)
        if not bit_equal(torch, ck.corr_lattice_cb_cuda(*a6), k1):
            fail(f"K6 at precise.yaml's lattice {coords}: differs from K1")
        k5 = pk.corr_lattice_paired_cuda(*a)
        if not bit_equal(torch, k5[:, pidx >= 0].contiguous(),
                         k1[:, pidx[pidx >= 0]].contiguous()):
            fail(f"K5 at precise.yaml's lattice {coords}: differs from K1")
        del k1, k5
        torch.cuda.empty_cache()
        runs = {"K1": lambda: ck.corr_lattice_cuda(*a),
                "K6": lambda: ck.corr_lattice_cb_cuda(*a6),
                "K5": lambda: pk.corr_lattice_paired_cuda(*a)}
        ms = {k: [] for k in runs}
        for turn in ("K1", "K6", "K5", "K5", "K6", "K1"):
            ms[turn].append(cuda_ms(runs[turn], reps=5, warm=1))
        ms = {k: sum(x) / len(x) for k, x in ms.items()}
        b6 = binned_bound(torch, a, 882, sum(x.numel() for x in a6[5]) * 4)
        b5 = binned_bound(torch, a, 1152, a[5].numel() * 4)
        print(f"precise.yaml lattice ({a[5].shape[0]} cells x {a[6]} patches, "
              f"{int(live.sum())} live edges) bf16 {coords}: K1 "
              f"{ms['K1']:.4f} ms, K6 {ms['K6']:.4f} ms (bound {b6[0]:.4f}, "
              f"{b6[1]}), K5 {ms['K5']:.4f} ms (bound {b5[0]:.4f}, {b5[1]}); "
              "K6 == K1 and K5 == K1 through the perm bit for bit")
        for key, b in (("K6", b6), ("K5", b5)):
            outs[key]["bf16"][f"precise_{coords}"] = dict(
                ms=ms[key], k1_ms=ms["K1"], bound_ms=b[0])
        del a, a6
        torch.cuda.empty_cache()


CB_VARIANTS = (             # (label, -D defines of csrc/corr_bins.cuh)
    ("8 warps, items of 64, boxes <= 12, 4 n-tiles interleaved (shipped)",
     ()),
    ("8 warps, items of 16", ("CB_K=2",)),
    ("4 warps, items of 64", ("CB_WARPS=4", "CB_K=16")),
    ("12 warps, items of 60", ("CB_WARPS=12", "CB_K=5")),
    ("8 warps, 2 n-tiles interleaved", ("CB_ILP=2",)),
    ("8 warps, boxes <= 14 (raw rows of 200 floats)", ("CB_BMAX=14",)),
    ("binned order only: 8 warps, items of 64, loads from global memory",
     ("CB_STAGE=0",)),
)


def compare_corr_bins(torch, ck, pk, cb, build):
    """`--corr-bins`: K6 and K5 on the synthetic full-size lattice (bf16,
    +-3 px and patch-shaped, each tile) and at precise.yaml's lattice
    (patch-shaped, the shipped tile) for each build variant (CB_VARIANTS),
    against K1 in the same process: each must equal K1 bit for bit
    (K5 through the perm); prints each one's time, K1's in turns beside
    it. Variants whose shared memory does not fit a block are listed as
    such."""
    from rampvo_tpu_torch.ops.corr_perms import paired_corr_perm

    pidx = torch.tensor(paired_corr_perm(3, 3), dtype=torch.long,
                        device="cuda")
    logs = build.build_all(["corr_lattice"] + [
        (lib, d) for _, d in CB_VARIANTS
        for lib in ("corr_lattice_cb", "corr_paired")])
    for it, log in logs.items():
        if isinstance(it, tuple):
            used = [ln for ln in ptxas_lines(log) if "registers" in ln]
            print(f"  ptxas {it}: {used}")
    grids = (((12, 12), 12, 9), ((16, 8), 12, 9), ((8, 8), 12, 9),
             ((16, 4), 12, 9), ((8, 8), 14, 10))
    from rampvo_tpu_torch.vo.config import VOConfig

    precise = VOConfig.from_yaml(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "config_vo", "precise.yaml"))
    for coords, cfg in (("spread3", None), ("patch", None),
                        ("patch", precise)):
        a, a6, _ = binned_args(torch, ck, torch.bfloat16, coords, cfg)
        k1 = ck.corr_lattice_cuda(*a)
        f1 = a[1]
        for label, d in CB_VARIANTS:
            times = []
            for ts, b1, b2 in grids[:1] if cfg else grids:
                grid = cb.bin_grid(f1.shape[1], f1.shape[2], f1.shape[0], ts,
                                   b1, b2)
                try:
                    k6 = ck.corr_lattice_cb_cuda(*a6, grid=grid, defines=d)
                    k5 = pk.corr_lattice_paired_cuda(*a, grid=grid,
                                                     defines=d)
                except RuntimeError as e:
                    times.append(f"ts={ts} b1={b1} b2={b2} does not fit ({e})")
                    continue
                if not bit_equal(torch, k6, k1) or not bit_equal(
                        torch, k5[:, pidx >= 0].contiguous(),
                        k1[:, pidx[pidx >= 0]].contiguous()):
                    fail(f"--corr-bins {label} ts={ts}: differs from K1")
                del k5, k6
                reps = 3 if cfg else 10
                t6 = cuda_ms(lambda: ck.corr_lattice_cb_cuda(
                    *a6, grid=grid, defines=d), reps=reps)
                t1 = cuda_ms(lambda: ck.corr_lattice_cuda(*a), reps=reps)
                t5 = cuda_ms(lambda: pk.corr_lattice_paired_cuda(
                    *a, grid=grid, defines=d), reps=reps)
                times.append(f"ts={ts} b1={b1} b2={b2}: K6 {t6:.4f} K5 "
                             f"{t5:.4f} (K1 {t1:.4f})")
            what = coords + (" at precise.yaml's lattice" if cfg else "")
            print(f"corr bins {what}, {label}, ms: " + "; ".join(times))


def probe_device_us(torch, launch, variants, n=100):
    """Mean device time of one launch of each variant (torch.profiler's
    kernel durations over `n` launches), in microseconds: what the card
    spends, where the event-timed loop may measure the host's issue rate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for var in variants:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                launch(var)
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "grid_" in e.key]
        out[var] = (sum(e.self_device_time_total for e in dev)
                    / max(sum(e.count for e in dev), 1))
    return out


def check_probes(torch, p1, p2, counters, outs):
    """P1 and P2 on the card against their plain versions, exactly (the
    same float32 adds; zero rows at the same places). The probes' run --
    P1 once, P2's three variants once each and 1000 back-to-back launches
    of variant A -- is counted with the counters set to 0 before it; then
    each is timed per launch with CUDA events, and variant A's 1000
    launches on the host clock (the host's issue cost per launch, since
    the empty blocks finish faster than the host issues them)."""
    for c in counters.values():
        c.launches = 0
    tabs, vcol, x = p1.inputs(seed=1, device="cuda")
    o_k = torch.zeros((1, p1.T * p1.SP, p1.W), device="cuda")
    o_p = torch.zeros_like(o_k)
    p1.dynlane_cuda(tabs, vcol, x, o_k)
    p1.dynlane_ref(tabs, vcol, x, o_p)
    torch.cuda.synchronize()
    if not torch.equal(o_k, o_p) or not bool((o_k[0, 2 * p1.SP] != 0).any()):
        fail("P1 dynlane differs from its plain version")
    gt, n_live = p2.make_tabs(True)
    gt = gt.cuda()
    outs_k, outs_p = {}, {}
    for var in p2.VARIANTS:
        outs_k[var] = [torch.full(s, 7.0, dtype=torch.bfloat16, device="cuda")
                       for s in p2.output_shapes(var)]
        outs_p[var] = [o.clone() for o in outs_k[var]]
        p2.grid_probe_cuda(var, gt, outs_k[var])
        p2.grid_probe_ref(var, gt, outs_p[var])
    torch.cuda.synchronize()
    for var in p2.VARIANTS:
        if not all(torch.equal(a, b) for a, b in zip(outs_k[var],
                                                     outs_p[var])):
            fail(f"P2 grid_probe {var} differs from its plain version")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(1000):
        p2.grid_probe_cuda("noop", gt, [])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / 1000
    counts = {"P1": counters["P1"].launches, "P2": counters["P2"].launches}
    if counts != {"P1": 1, "P2": 1003}:
        fail(f"probe launch counts {counts}")
    ms1 = cuda_ms(lambda: p1.dynlane_cuda(tabs, vcol, x, o_k), reps=20)
    plain1 = cuda_ms(lambda: p1.dynlane_ref(tabs, vcol, x, o_p), reps=5)
    walked = 5 * p1.SP
    b1, by1 = bound_ms(8 + walked * 2 * 4 + x.numel() * 4 + walked * p1.W * 4,
                       walked * p1.W, "f32")
    print(f"P1 dynlane: kernel {ms1:.4f} ms, plain {plain1:.4f} ms, bound "
          f"{b1:.6f} ms ({by1}), exact")
    outs["P1"] = dict(ms=ms1, plain_ms=plain1, bound_ms=b1, bound_by=by1,
                      max_abs_err=0.0, launches=counts["P1"])
    rows = len({(int(a), int(b)) for a, b in zip(gt[:, 4], gt[:, 1])})
    p2ms = {}
    for var in p2.VARIANTS:
        o = outs_k[var]
        p2ms[var] = cuda_ms(lambda: p2.grid_probe_cuda(var, gt, o), reps=50,
                            warm=5)
    dev_us = probe_device_us(torch, lambda var: p2.grid_probe_cuda(
        var, gt, outs_k[var]), p2.VARIANTS)
    plain2 = cuda_ms(lambda: p2.grid_probe_ref("two", gt, outs_p["two"]),
                     reps=5)
    b2, by2 = bound_ms(gt.numel() * 4 + 2 * rows * p2.ROW * 2, 0, "bf16")
    NB = p2.NB
    print(f"P2 grid_probe NB={NB} blocks ({n_live} live cells, {rows} distinct "
          f"rows): per launch A no-op {p2ms['noop']:.5f} ms, B two outputs "
          f"{p2ms['two']:.5f} ms, C one output {p2ms['one']:.5f} ms; per block "
          f"A {1e3 * p2ms['noop'] / NB:.4f} us, B {1e3 * p2ms['two'] / NB:.4f}"
          f" us; host issue (1000 launches of A, host clock) "
          f"{host_ms:.5f} ms per launch; device time per launch (profiler) "
          f"A {dev_us['noop']:.3f} us, B {dev_us['two']:.3f} us, C "
          f"{dev_us['one']:.3f} us; plain (B) {plain2:.4f} ms; bound (B) "
          f"{b2:.6f} ms ({by2}); exact")
    outs["P2"] = dict(ms=p2ms["two"], plain_ms=plain2, bound_ms=b2,
                      bound_by=by2, max_abs_err=0.0, launches=counts["P2"],
                      noop_ms=p2ms["noop"], one_output_ms=p2ms["one"],
                      host_issue_ms=host_ms,
                      device_us={k: round(v, 4) for k, v in dev_us.items()})


def synthetic_corr_train(torch, dt, seed=5, coords="patch"):
    """The training correlation's full-size inputs: the recipe's edge
    schedule (15 frames, 80 patches, 18 steps: E = 18000), gmap
    [1200, 3, 3, 128], 120x160 maps and their 4x pool, 3x3 patches whose
    centers spread over and 8 px beyond the map (`coords` "patch": a 3x3
    grid +-1 px with 0.2 px jitter, the set the kernels line reports;
    "spread3": the 9 pixels +-3 px around the center), and an output
    gradient with the training forward's per-level keep masks (p = 0.2)."""
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
    off = patch_grid(torch) + 0.2 * rn(E, 3, 3, 2)
    if coords == "spread3":
        off = ru(E, 3, 3, 2) * 6.0 - 3.0
    coords = (cen + off).contiguous()
    kk = torch.as_tensor(s.kk, device="cuda").long()
    jj = torch.as_tensor(s.jj, device="cuda").long()
    lvl = torch.arange(882, device="cuda") % 2
    keep = torch.where(lvl == 0, (ru(E) < KEEP_P)[:, None],
                       (ru(E) < KEEP_P)[:, None])
    ct = rn(E, 882) * keep
    return gmap, f1, f2, coords, kk, jj, ct


def adversarial_corr_train(torch, dt, seed=17, E=4096):
    """Training-correlation inputs over `adversarial_coords` at a smaller
    E: gmap [64 + 8, 3, 3, 128], 4 frames. The patches with an infinite
    coordinate read gmap rows 64..71, which no other edge reads (their
    blend weights are NaN: the plain backward puts NaN there, the kernel
    skips taps outside the map). No NaN coordinate: the plain version's
    float-to-int conversion of NaN is undefined and differs between the
    CPU and the card. Returns (args, ct, mask of those rows)."""
    from rampvo_tpu_torch.ops.corr import avg_pool2d

    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *sh: torch.randn(*sh, generator=g, device="cuda")
    h1, w1, NG, NF = H // 4, W // 4, 64, 4
    gmap = rn(NG + 8, 3, 3, 128).to(dt)
    f1 = rn(NF, h1, w1, 128)
    f2 = avg_pool2d(f1, 4).to(dt).contiguous()
    f1 = f1.to(dt)
    coords, nonfinite = adversarial_coords(torch, E, w1, h1, g, nan=False)
    kk = torch.randint(0, NG, (E,), generator=g, device="cuda")
    kk = torch.where(nonfinite, NG + kk % 8, kk)
    jj = torch.randint(0, NF, (E,), generator=g, device="cuda")
    keep = torch.rand(E, 1, 2, generator=g, device="cuda") < 0.5
    ct = (rn(E, 441, 2) * keep).reshape(E, 882)
    rows = torch.arange(NG + 8, device="cuda") >= NG
    return (gmap, f1, f2, coords, kk, jj), ct, rows


def adversarial_corr_train_fwd(torch, dt, seed=19, E=4096):
    """K7's adversarial inputs: `adversarial_coords` with NaN as well (the
    forward's plain version puts NaN where the kernel does), gmap [64, 3,
    3, 128], 4 frames, and kk or jj out of range (-1 or one past the end)
    on two edges in 13, where the kernel writes zeros (the plain version
    indexes with them). Returns (args, mask of the in-range edges)."""
    from rampvo_tpu_torch.ops.corr import avg_pool2d

    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *sh: torch.randn(*sh, generator=g, device="cuda")
    h1, w1, NG, NF = H // 4, W // 4, 64, 4
    gmap = rn(NG, 3, 3, 128).to(dt)
    f1 = rn(NF, h1, w1, 128)
    f2 = avg_pool2d(f1, 4).to(dt).contiguous()
    f1 = f1.to(dt)
    coords, _ = adversarial_coords(torch, E, w1, h1, g)
    kk = torch.randint(0, NG, (E,), generator=g, device="cuda")
    jj = torch.randint(0, NF, (E,), generator=g, device="cuda")
    idx = torch.arange(E, device="cuda")
    kk = torch.where(idx % 13 == 0, torch.where(idx % 2 == 0, -1, NG), kk)
    jj = torch.where(idx % 13 == 6, torch.where(idx % 2 == 0, NF, -1), jj)
    live = (kk >= 0) & (kk < NG) & (jj >= 0) & (jj < NF)
    return (gmap, f1, f2, coords, kk, jj), live


def check_corr_train(torch, ctk, out_f, out_b, defines=()):
    """K7 (forward) and K8 (backward) on the full-size training inputs,
    bf16 and f32, patch-shaped (the set the kernels line reports) and with
    the pixels spread +-3 px, each held against the plain version
    (`corr_train_ref`, `corr_train_bwd_ref`) and timed; K7's and K8's
    slow-path counters must stay 0 on the patch-shaped set. Then K8 on the
    adversarial inputs (smaller E: spreads beyond the box cap, boxes
    crossing and outside each border, identical pixels, integer
    coordinates, 1e30 / inf coordinates) against the plain version
    and the plain box mirror; the gmap rows that only the inf patches
    read are left out (the plain backward puts NaN there) and must be
    finite in the kernel's gradient; the kernel's slow-path count must
    equal the box mirror's (> 0). Then K7 on its adversarial inputs (NaN
    coordinates too, kk/jj out of range on some edges) against the plain
    version on the in-range edges and against the plain box mirror
    (`corr_train_box_ref`) on all: NaN at the same places, zero rows where
    kk or jj is out of range, slow-path count equal to the mirror's (> 0).
    Tolerances: forward max |kernel - plain|
    <= tol * max |plain|, tol = 1e-5 (f32: summation order) or 1e-2 (bf16:
    one output rounding); each of the three gradients within 1e-4 (f32:
    the atomic sums' order changes from run to run) or 2e-2 (bf16) of its
    largest entry. The bounds count each input read once and each output
    written once; K8's operations count the (edge, level) pairs whose
    output gradient this run keeps (the rest cost one pass over their ct
    row). The wrapper's three zero fills are part of K8's time; they are
    timed alone once. `defines` picks a build variant of the library
    (K7's CORR_* and K8's K8_* defines)."""
    slow = torch.zeros(1, dtype=torch.int32, device="cuda")
    bwd = lambda ct, *a: ctk.corr_train_bwd_cuda(ct, *a, slow=slow,
                                                 defines=defines)
    for dt, name, tf, tb in ((torch.bfloat16, "bf16", 1e-2, 2e-2),
                             (torch.float32, "f32", 1e-5, 1e-4)):
        for coords in ("patch", "spread3"):
            gmap, f1, f2, co, kk, jj, ct = synthetic_corr_train(
                torch, dt, coords=coords)
            a = (gmap, f1, f2, co, kk, jj)
            E = co.shape[0]
            ctk.corr_train_slow_edges(defines=defines)
            k = ctk.corr_train_cuda(*a, defines=defines).float()
            slow7 = ctk.corr_train_slow_edges(defines=defines)
            p = ctk.corr_train_ref(*a)
            slow.zero_()
            kb = bwd(ct, *a)
            n_slow = int(slow.item())
            pb = ctk.corr_train_bwd_ref(ct, *a)
            torch.cuda.synchronize()
            err = (k - p).abs().max().item()
            scale = p.abs().max().item()
            if not err <= tf * scale:
                fail(f"corr_train fwd {name} {coords}: max err {err} (scale "
                     f"{scale})")
            errb = 0.0
            for what, x, y in zip(("gmap", "fmap1", "fmap2"), kb, pb):
                e = (x - y).abs().max().item()
                sc = y.abs().max().item()
                if not (sc > 0 and e <= tb * sc):
                    fail(f"corr_train bwd {name} {coords} grad {what}: max "
                         f"err {e} (scale {sc})")
                errb = max(errb, e / sc)
            if coords == "patch" and (n_slow != 0 or slow7 != 0):
                fail(f"corr_train {name}: {slow7} (fwd) and {n_slow} (bwd) "
                     "patch-shaped edges took the slow path")
            ms = cuda_ms(lambda: ctk.corr_train_cuda(*a, defines=defines),
                         reps=20)
            plain = cuda_ms(lambda: ctk.corr_train_ref(*a), reps=2, warm=1)
            ms_b = cuda_ms(lambda: bwd(ct, *a), reps=20)
            plain_b = cuda_ms(lambda: ctk.corr_train_bwd_ref(ct, *a), reps=2,
                              warm=1)
            fill = cuda_ms(lambda: [torch.zeros_like(x, dtype=torch.float32)
                                    for x in (gmap, f1, f2)], reps=20)
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
            # what K7 reads through the caches: every tap of both boxes
            taps = sum(float((b.bw * b.bh).sum()) for b in (
                ctk.window_boxes(co[..., 0].reshape(E, 9) * sc,
                                 co[..., 1].reshape(E, 9) * sc,
                                 f.shape[1], f.shape[2])
                for f, sc in ((f1, 1.0), (f2, 0.25))))
            print(f"K7 corr_train fwd {name} {coords} E={E}: kernel {ms:.4f} "
                  f"ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), max "
                  f"err {err:.3e} (scale {scale:.3e}), slow-path edges "
                  f"{slow7}; {taps / E:.1f} box taps per edge, "
                  f"{taps * 128 * es / 1e9:.3f} GB of tap reads, "
                  f"{taps * 128 * es / ms / 1e9:.3f} TB/s")
            print(f"K8 corr_train bwd {name} {coords} E={E}, {kept}/{2 * E} "
                  f"(edge, level) pairs kept: kernel {ms_b:.4f} ms (of which "
                  f"the wrapper's three zero fills {fill:.4f} ms), plain "
                  f"{plain_b:.4f} ms, bound {bms_b:.4f} ms ({by_b}), "
                  f"slow-path edges {n_slow}, max rel err {errb:.3e}")
            if coords == "spread3":
                out_b[name]["spread3_ms"] = ms_b
                out_f[name]["spread3_ms"] = ms
                continue
            out_f[name] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                               bound_by=by, max_abs_err=err)
            out_b[name] = dict(ms=ms_b, plain_ms=plain_b, bound_ms=bms_b,
                               bound_by=by_b, zero_fill_ms=fill,
                               max_abs_err=max((x - y).abs().max().item()
                                               for x, y in zip(kb, pb)))
        a, ct, rows = adversarial_corr_train(torch, dt)
        slow.zero_()
        kb = bwd(ct, *a)
        n_slow = int(slow.item())
        pb = ctk.corr_train_bwd_ref(ct, *a)
        pbox, slow_ref = ctk.corr_train_bwd_box_ref(ct, *a)
        torch.cuda.synchronize()
        errs = []
        for what, x, y, z in zip(("gmap", "fmap1", "fmap2"), kb, pb, pbox):
            if what == "gmap":
                if not bool(torch.isfinite(x[rows]).all()) \
                        or not bool(torch.isnan(y[rows]).any()):
                    fail("corr_train bwd adversarial: the inf patches' "
                         "gmap rows")
                x, y, z = x[~rows], y[~rows], z[~rows]
            sc = y.abs().max().item()
            e, ez = (x - y).abs().max().item(), (z - y).abs().max().item()
            if not (sc > 0 and e <= tb * sc and ez <= 1e-4 * sc):
                fail(f"corr_train bwd {name} adversarial grad {what}: max "
                     f"err {e}, box mirror {ez} (scale {sc})")
            errs.append(e / sc)
        if n_slow == 0 or n_slow != int(slow_ref.sum()):
            fail(f"corr_train bwd {name} adversarial: the kernel sent "
                 f"{n_slow} edges down its slow path, the box mirror "
                 f"{int(slow_ref.sum())}")
        print(f"K8 corr_train bwd {name} adversarial E={ct.shape[0]}: max "
              f"rel err {max(errs):.3e}, slow-path edges {n_slow} (box "
              f"mirror {int(slow_ref.sum())})")
        a, live = adversarial_corr_train_fwd(torch, dt)
        ctk.corr_train_slow_edges(defines=defines)
        k = ctk.corr_train_cuda(*a, defines=defines).float()
        n_slow = ctk.corr_train_slow_edges(defines=defines)
        pbox, slow_ref = ctk.corr_train_box_ref(*a)
        p = ctk.corr_train_ref(*a[:3], *(x[live] for x in a[3:]))
        torch.cuda.synchronize()
        scale = torch.nan_to_num(p).abs().max().item()
        err, errb = max_err_nan(k[live], p), max_err_nan(pbox[live], p)
        n_nan = int(torch.isnan(p).sum())
        if err is None or errb is None or not err <= tf * scale \
                or not errb <= 1e-5 * scale or n_nan == 0 \
                or bool((k[~live] != 0).any()) or bool(pbox[~live].any()):
            fail(f"corr_train fwd {name} adversarial: max err {err}, box "
                 f"mirror {errb} (scale {scale}), {n_nan} NaN outputs, "
                 "or a row with kk/jj out of range not zero")
        if n_slow == 0 or n_slow != int(slow_ref.sum()):
            fail(f"corr_train fwd {name} adversarial: the kernel sent "
                 f"{n_slow} edges down its slow path, the box mirror "
                 f"{int(slow_ref.sum())}")
        print(f"K7 corr_train fwd {name} adversarial E={k.shape[0]} "
              f"({int((~live).sum())} rows with kk/jj out of range, zero): "
              f"max err {err:.3e} (scale {scale:.3e}), plain box mirror vs "
              f"plain {errb:.3e}, NaN outputs at the same {n_nan} places, "
              f"slow-path edges {n_slow} (box mirror {int(slow_ref.sum())})")


# ---------------------------------------------------------------------------
# phases 3 and 4: the VO slice
# ---------------------------------------------------------------------------

def make_frames(torch, n, ht, wd, seed, device, bins=5):
    g = torch.Generator(device=device).manual_seed(seed)
    return [(torch.rand(1, ht, wd, bins, generator=g, device=device),
             torch.rand(1, ht, wd, 3, generator=g, device=device))
            for _ in range(n)]


def check_small_slice(torch, input_mode, layout="fused3", bins=5,
                      damp=False):
    """The same small f32 VO run on the card (kernels) and on the CPU (plain
    versions) under CORR_LAYOUT `layout` at `bins` event bins, 12 frames
    and an events-only frame after frame 5 (`damp`: the flow head's
    weight scaled by 0.1, as the CPU parity tests scale it; the 10-bin
    random SingleScale network is chaotic without it: on the CPU alone a
    1e-6 relative change of the events moves the init frame's poses by
    0.32):
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
                   MEM=16, CORR_LAYOUT=layout)
    net = init_weights(VONet(input_mode, evs_ch=bins),
                       torch.Generator().manual_seed(5))
    if damp:
        with torch.no_grad():
            net.update.d[1].weight.mul_(0.1)
    vos = {d: RampVO(cfg, net, num_event_bins=bins, ht=ht, wd=wd, device=d,
                     seed=1) for d in ("cpu", "cuda")}
    intr = torch.tensor([50.0, 50.0, wd / 2, ht / 2])
    for f, (ev, im) in enumerate(make_frames(torch, 12, ht, wd, 7, "cpu",
                                             bins)):
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
            fail(f"small {input_mode} {layout} {bins}-bin slice cuda vs cpu, "
                 f"frame {f}: same={same} dpose={dp}")
    print(f"small {input_mode} slice 64x96 M=8 {bins} bins CORR_LAYOUT "
          f"{layout}: cuda == "
          f"cpu bookkeeping over 12 frames + 1 events-only, max pose diff "
          f"{dp:.3e}")


def profile_frames(torch, vo, frames, intr, frame_ms):
    """Device time of a few steady frames by kernel (torch.profiler): the
    device-busy time, its share of the profiled run's own span (host
    clock from a synchronize before the frames to one after them, inside
    the profiler, so the kernels counted lie within it), the kernels
    launched per frame and the largest kernels. `frame_ms`, the
    unprofiled frame time, is printed beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for f, (ev, im) in enumerate(frames):
            vo(1000 + f, ev, im, [True], intr)
        torch.cuda.synchronize()
        span = (time.perf_counter() - t) * 1e3 / n
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / n
    calls = sum(e.count for e in dev) / n
    print(f"profile ({n} steady frames): device busy {busy:.3f} ms/frame, "
          f"{100 * busy / span:.1f}% of the profiled run's {span:.3f} "
          f"ms/frame span (unprofiled frame {frame_ms:.3f} ms); "
          f"{calls:.0f} kernels/frame")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/frame "
              f"{e.count / n:6.1f}x  {e.key[:90]}")
    return busy, calls, busy / span


LAYOUT_KERNEL = {"fused3": "K1", "fused4": "K6", "fused2": "K5",
                 "folded": "K4f"}


class FinishSpy:
    """Counts the calls of `corr_band_kernels.finish_bands` on CUDA
    tensors while it is entered: the folded layout must run none on the
    card (its correlation is one launch of K4's folded kernel)."""

    def __init__(self, bk):
        self.bk, self.finish, self.on_card = bk, bk.finish_bands, 0

    def __enter__(self):
        def spy(bands, *args):
            self.on_card += int(bands.is_cuda)
            return self.finish(bands, *args)
        self.bk.finish_bands = spy
        return self

    def __exit__(self, *exc):
        self.bk.finish_bands = self.finish


def run_main_path(torch, counters, input_mode, frames, layout="fused3"):
    """RampVO at 480x640, M=96, bf16, `input_mode`, CORR_LAYOUT `layout`:
    FRAMES frames and an events-only frame after every tenth, then
    final_refinement(2) and terminate, with every launch counter set to 0
    just before and read just after. The encoder kernel of the mode (K2: 3
    launches per encoded frame, K3: 1) and the layout's correlation kernel
    (one per update) must have run exactly as often as the path asks, and
    every other kernel never. Returns (counts, median steady ms/frame,
    the RampVO)."""
    from rampvo_tpu_torch.models.vonet import VONet, init_weights
    from rampvo_tpu_torch.vo import RampVO, VOConfig

    cfg = VOConfig(BUFFER_SIZE=512, MAX_FRAMES=512, PATCHES_PER_FRAME=M,
                   MIXED_PRECISION=True, PROBE_THRESH=-1.0,
                   KEYFRAME_THRESH=0.0, CORR_LAYOUT=layout)
    net = init_weights(VONet(input_mode), torch.Generator().manual_seed(0))
    vo = RampVO(cfg, net, input_mode=input_mode, ht=H, wd=W, device="cuda",
                seed=0)
    intr = torch.tensor([320.0, 320.0, W / 2, H / 2], device="cuda")
    torch.cuda.synchronize()

    from rampvo_tpu_torch.ops import corr_kernels as ck

    if layout == "fused3":
        ck.corr_lattice_slow_edges()
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
    want = dict.fromkeys(counters, 0)
    want.update({LAYOUT_KERNEL[layout]: 12 + (FRAMES - 8) + 2,
                 "K2": 3 * encoded if input_mode == "MultiScale" else 0,
                 "K3": encoded if input_mode == "SingleScale" else 0})
    what = f"{input_mode} {layout}"
    if not st.initialized or st.n != FRAMES:
        fail(f"{what} main path: initialized={st.initialized} n={st.n}")
    if counts != want:
        fail(f"{what} launch counts {counts}, want {want}")
    if not bool(torch.isfinite(st.poses[:st.counter]).all()) \
            or traj.shape != (FRAMES, 7) or not (abs(traj).max() < 1e6):
        fail(f"{what} main path: non-finite poses or bad trajectory")
    steady = sorted(times[10:])
    ms = 1e3 * steady[len(steady) // 2]
    print(f"main path 480x640 M=96 {input_mode} bf16 CORR_LAYOUT {layout}: "
          f"{FRAMES} frames + {events_only} events-only, median steady frame "
          f"{ms:.3f} ms (frames 10..), init-burst frame "
          f"{1e3 * times[7]:.1f} ms; launches {counts}"
          + (f"; K1 slow-path edges over the path "
             f"{ck.corr_lattice_slow_edges()}" if layout == "fused3" else ""))
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
# phase 4b: the chunked path, a CUDA-graph replay of the initialized frame
# ---------------------------------------------------------------------------

CHUNK_K = 8
EAGER_PAIRS, EAGER_TURN = 2, 10    # host-driven / branchless pairs, frames
ENC_KERNEL = {"MultiScale": ("lstm_fold_cm", 3),
              "SingleScale": ("lstm_carry_fold_cm", 1)}
CORR_WRAPPER = {"fused3": "corr_lattice", "fused4": "corr_lattice_cb",
                "fused2": "corr_lattice_paired", "folded": "corr_folded_cuda"}


def bench_vo(torch, mode, layout, K, thresh=0.0, event_bias=True,
             gradient=False, bins=5):
    """A RampVO at chunk=K on bench.py's VOConfig (KEYFRAME_THRESH
    `thresh`, GRADIENT_BIAS `gradient`) at 480x640, M=96, bf16,
    CORR_LAYOUT `layout`, seeded weights for `bins` event bins, patches
    selected by event density or, without `event_bias`, at random or by
    image gradient."""
    from rampvo_tpu_torch.models.vonet import VONet, init_weights
    from rampvo_tpu_torch.vo import RampVO, VOConfig

    cfg = VOConfig(BUFFER_SIZE=512, MAX_FRAMES=512, PATCHES_PER_FRAME=M,
                   MIXED_PRECISION=True, PROBE_THRESH=-1.0,
                   KEYFRAME_THRESH=thresh, CORR_LAYOUT=layout,
                   GRADIENT_BIAS=gradient)
    net = init_weights(VONet(mode, evs_ch=bins),
                       torch.Generator().manual_seed(0))
    return RampVO(cfg, net, input_mode=mode, num_event_bins=bins, ht=H,
                  wd=W, device="cuda", seed=0, chunk=K,
                  event_bias=event_bias)


def copy_into(vo, state, tlist):
    """Every tensor and scalar of `state` into `vo`'s own state."""
    from rampvo_tpu_torch.vo.graph import state_tensors

    for a, b in zip(state_tensors(vo.state), state_tensors(state)):
        a.copy_(b)
    for name in ("n", "counter", "initialized"):
        setattr(vo.state, name, getattr(state, name))
    vo.tlist = list(tlist)


def chunk_twins(torch, mode, layout, K, frames, intr, warm):
    """A RampVO at chunk=1 and its twin at chunk=K from one state
    (`bench_vo`, never evicting): the eager driver runs `warm` frames,
    then its state is copied into the twin's."""
    eager, graph = (bench_vo(torch, mode, layout, k) for k in (1, K))
    for f in range(warm):
        eager(f, *frames[f % len(frames)], [True], intr)
    copy_into(graph, eager.state, eager.tlist)
    return eager, graph


def state_diff(a, b) -> dict:
    """Max |a - b| over the compared fields of two states (poses and
    inverse depths of the committed frames, the lattice's hidden state),
    entries that differ in l2g and cell_valid, and n / counter gaps."""
    c = max(a.counter, b.counter)
    d = {"n": abs(a.n - b.n), "counter": abs(a.counter - b.counter)}
    for name in ("poses", "pat_d"):
        d[name] = float((getattr(a, name)[:c] - getattr(b, name)[:c])
                        .abs().max())
    d["net"] = float((a.net - b.net).abs().max())
    for name in ("l2g", "cell_valid"):
        d[name] = int((getattr(a, name) != getattr(b, name)).sum())
    return d


def drive_twins(torch, eager, graph, frames, intr, t0):
    """The same frames into both drivers; after every chunk the states are
    compared. Returns the largest difference of each field and the n of
    the graph's state before and after each replay."""
    worst, ns, K = {}, [], graph.chunk
    for f, (ev, im) in enumerate(frames):
        n0 = graph.state.n
        eager(t0 + f, ev, im, [True], intr)
        graph(t0 + f, ev, im, [True], intr)
        if f % K == K - 1:
            ns.append((n0, graph.state.n))
            for k, v in state_diff(eager.state, graph.state).items():
                worst[k] = max(worst.get(k, 0), v)
    torch.cuda.synchronize()
    return worst, ns


def timed_frames(torch, vo, frames, intr, t0) -> float:
    """ms/frame of `frames` through `vo`, host clock, ending in a flush and
    torch.cuda.synchronize()."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for f, (ev, im) in enumerate(frames):
        vo(t0 + f, ev, im, [True], intr)
    vo.flush()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / len(frames)


def branchless_frames(torch, vo, frames, intr, t0) -> float:
    """ms/frame of `frames` through the branchless initialized frame
    (`frame_init`, the frame a replay holds) run eagerly on `vo`'s state,
    one frame at a time with n read back after each (one wait a frame, as
    the host-driven frame's eviction read); host clock, ending in
    torch.cuda.synchronize(). `vo` runs at chunk=1."""
    import dataclasses

    st = vo.state
    n, counter = (torch.tensor(x, device="cuda") for x in (st.n, st.counter))
    view = dataclasses.replace(st, n=n, counter=counter)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for f, (ev, im) in enumerate(frames):
        vo._vo_frame.frame_init(view, ev, im, intr)
        st.n, st.counter = int(n), st.counter + 1
        vo.tlist.append(t0 + f)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / len(frames)


def check_twins(what, worst, captured, mode, layout, K):
    """Graph against eager: bit for bit (the same kernels on the same
    inputs; no float atomic on the path), and the capture holding each
    kernel of the path as often as K eager frames launch it."""
    enc, per = ENC_KERNEL[mode]
    want = {enc: per * K, CORR_WRAPPER[layout]: K}
    print(f"{what}: graph vs eager max diffs {worst}; captured launches "
          f"{captured}")
    if any(v != 0 for v in worst.values()):
        fail(f"{what}: the graph's state differs from eager: {worst}")
    if captured != want:
        fail(f"{what}: captured launches {captured}, want {want}")


def chunk_fused3(torch, p2, frames, intr, mode, summary):
    """Phase 4b (1) for one input mode: the twins' 40 frames against each
    other, then the timings in turns (EAGER_PAIRS pairs of the
    host-driven and the branchless frame run eagerly, alternating which
    runs first, and two graph turns) and the profiles of the graph and
    the host-driven frame."""
    from rampvo_tpu_torch.ops import corr_kernels as ck

    K, warm = CHUNK_K, FRAMES
    eager, graph = chunk_twins(torch, mode, "fused3", K, frames, intr, warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    for f, (ev, im) in enumerate(frames[:K]):       # the capture's chunk
        eager(warm + f, ev, im, [True], intr)
        graph(warm + f, ev, im, [True], intr)
    torch.cuda.synchronize()
    mem1 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved(),
            torch.cuda.max_memory_allocated())
    worst, _ = drive_twins(torch, eager, graph, frames[K:], intr, warm + K)
    captured = graph._vo_chunk.captured
    check_twins(f"chunk {mode} fused3 K={K}", worst, captured, mode,
                "fused3", K)
    gib = 2.0 ** 30
    print(f"chunk {mode}: memory allocated {mem0[0] / gib:.3f} -> "
          f"{mem1[0] / gib:.3f} GiB, reserved {mem0[1] / gib:.3f} -> "
          f"{mem1[1] / gib:.3f} GiB, peak {mem1[2] / gib:.3f} GiB over the "
          "capture's chunk (warm-up copy of the state, capture, replay)")

    # EAGER_PAIRS pairs of the eager frame's two forms, alternating which
    # runs first, with two graph turns in the middle
    turns = [k for i in range(EAGER_PAIRS) for k in (
        ("eager", "branchless") if i % 2 == 0 else ("branchless", "eager"))]
    turns[EAGER_PAIRS:EAGER_PAIRS] = ["graph", "graph"]
    ms, slow, host, t0 = {}, {}, [], warm + FRAMES
    for key in turns:
        host.append(p2.host_us_per_launch())
        ck.corr_lattice_slow_edges()
        run = branchless_frames if key == "branchless" else timed_frames
        fr = frames if key == "graph" else frames[:EAGER_TURN]
        ms.setdefault(key, []).append(run(
            torch, graph if key == "graph" else eager, fr, intr, t0))
        slow.setdefault(key, []).append(ck.corr_lattice_slow_edges())
        t0 += len(fr)
    busy_g, calls_g, share_g = profile_frames(torch, graph, frames[:K], intr,
                                              min(ms["graph"]))
    busy_e, calls_e, share_e = profile_frames(torch, eager, frames[:4], intr,
                                              min(ms["eager"]))
    enc, per = ENC_KERNEL[mode]
    per_frame = {k: v / K for k, v in captured.items()}
    stats = {k: quartiles(v) for k, v in ms.items()}
    print(f"chunk {mode} fused3 {H}x{W} M={M} bf16, ms/frame in turns "
          f"(eager and branchless {EAGER_TURN} frames a turn, graph "
          f"{FRAMES}): " + " / ".join(f"{k} {x:.3f}" for k, x in zip(
              turns, [ms[k][turns[:i].count(k)]
                      for i, k in enumerate(turns)])))
    print(f"chunk {mode}: quartiles (q1, median, q3) ms/frame " + "; ".join(
        f"{k} {tuple(round(x, 3) for x in q)}" for k, q in stats.items())
        + f"; branchless against host-driven eager median "
        f"{100 * (stats['branchless'][1] / stats['eager'][1] - 1):+.1f}%, "
        f"pairs the branchless turn won "
        f"{sum(b < e for b, e in zip(ms['branchless'], ms['eager']))} of "
        f"{EAGER_PAIRS}")
    print(f"chunk {mode}: P2 host issue before each turn "
          f"{' / '.join(f'{h:.2f}' for h in host)} us a launch; graph "
          f"device busy {busy_g:.3f} ms/frame, {100 * share_g:.1f}% of the "
          f"profiled replay's span ({calls_g:.0f} kernels/frame, one replay "
          f"of {K}), eager {busy_e:.3f} ms/frame, {100 * share_e:.1f}% "
          f"({calls_e:.0f} kernels/frame); captured launches a frame "
          f"{per_frame}; K1 slow-path edges a turn {slow}")
    if per_frame != {enc: per, "corr_lattice": 1}:
        fail(f"chunk {mode}: kernels a frame {per_frame}")
    summary.append(f"{mode} median eager {stats['eager'][1]:.3f} / eager "
                   f"branchless {stats['branchless'][1]:.3f} / graph "
                   f"{stats['graph'][1]:.3f} ms/frame, graph busy "
                   f"{busy_g:.3f} ms/frame ({100 * share_g:.1f}%)")


def quartiles(xs):
    """(q1, median, q3) of a list, by linear interpolation."""
    v = sorted(xs)

    def q(p):
        i = p * (len(v) - 1)
        lo = int(i)
        return v[lo] + (v[min(lo + 1, len(v) - 1)] - v[lo]) * (i - lo)

    return q(0.25), q(0.5), q(0.75)


def chunk_layout(torch, frames, intr, layout):
    """Phase 4b (2): MultiScale under `layout`, three replays."""
    K = CHUNK_K
    eager, graph = chunk_twins(torch, "MultiScale", layout, K, frames, intr,
                               FRAMES)
    worst, _ = drive_twins(torch, eager, graph, frames[:3 * K], intr, FRAMES)
    check_twins(f"chunk MultiScale {layout} K={K}, 3 replays", worst,
                graph._vo_chunk.captured, "MultiScale", layout, K)


def chunk_evictions(torch, frames, intr, K=4, warm=32, replays=4):
    """Phase 4b (3): evicted and kept frames inside one replay, once n has
    passed NI and the lattice rows wrap. A never-evicting driver warms
    `warm` frames (n = 32 > NI = 25); the median of its keyframe flows
    over the next K * `replays` frames, still never evicting, is the
    threshold; the twins start from the warm state at that threshold."""
    from rampvo_tpu_torch.vo import runtime as rt
    from rampvo_tpu_torch.vo.graph import copy_state

    base = bench_vo(torch, "MultiScale", "fused3", 1)
    for f in range(warm):
        base(f, *frames[f % len(frames)], [True], intr)
    snap, tlist, flows = copy_state(base.state), list(base.tlist), []
    nf = K * replays
    run = [frames[f % len(frames)] for f in range(warm, warm + nf)]
    for f, (ev, im) in enumerate(run):
        base(warm + f, ev, im, [True], intr)
        flows.append(float(rt._keyframe_flow(base.cfg, base.state)))
    thresh = sorted(flows)[nf // 2]
    del base
    eager, graph = (bench_vo(torch, "MultiScale", "fused3", k, thresh)
                    for k in (1, K))
    for vo in (eager, graph):
        copy_into(vo, snap, tlist)
    worst, ns = drive_twins(torch, eager, graph, run, intr, warm)
    check_twins(f"chunk eviction pass K={K} (KEYFRAME_THRESH={thresh:.4f})",
                worst, graph._vo_chunk.captured, "MultiScale", "fused3", K)
    evicted = [K - (b - a) for a, b in ns]
    print(f"chunk eviction pass: keyframe flows without eviction "
          f"{[round(x, 3) for x in flows]}, threshold their median "
          f"{thresh:.4f}; n before/after each replay {ns} (NI "
          f"{eager.cfg.NI}), evicted {evicted} of {K} inside the replays")
    if not any(0 < e < K for e in evicted):
        fail(f"chunk eviction pass: no replay both evicts and keeps frames "
             f"({ns})")
    if min(a for a, _ in ns) <= eager.cfg.NI:
        fail(f"chunk eviction pass: n did not pass NI ({ns})")


def run_chunk_path(torch, p2, frames, intr):
    """The chunked path on the card (RampVO(chunk=K), vo/graph.py): the
    initialized frames of a chunk as one CUDA-graph replay, held against
    the eager per-frame driver from the same state, bit for bit.
    (1) MultiScale and SingleScale under fused3 at chunk=8: 40 warm eager
    frames, 40 frames into both twins, states compared after every
    replay; then ms/frame in turns (EAGER_PAIRS alternating pairs of the
    eager host-driven and branchless frames, EAGER_TURN frames a turn, two
    graph turns of 40 frames; quartiles of
    each) beside P2's host µs a launch, the graph's
    device-busy time, its share of the profiled replay's span and kernels
    a frame (profiler over one replay), the launches the capture
    holds (kernels a frame = replays x captured launches, as eager), the
    graph pool's memory and K1's slow-path edges over the timed frames.
    (2) MultiScale under fused2, fused4 and folded: one capture and three
    replays each, against eager. (3) Chunk=4 from a never-evicting state
    warmed past NI, at a threshold that evicts some frames of a replay and
    keeps others, against eager. Each part runs
    whatever an earlier one did; the phase fails at its end if any part
    failed."""
    import traceback

    summary, failed = [], []
    parts = [(f"{mode} fused3", lambda m=mode: chunk_fused3(
        torch, p2, frames, intr, m, summary))
        for mode in ("MultiScale", "SingleScale")]
    parts += [(f"MultiScale {lay}", lambda lay=lay: chunk_layout(
        torch, frames, intr, lay)) for lay in ("fused2", "fused4", "folded")]
    parts.append(("evictions", lambda: chunk_evictions(torch, frames, intr)))
    for name, part in parts:
        try:
            part()
        except (Exception, SystemExit) as e:
            traceback.print_exc()
            failed.append(f"{name}: {e!r}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    if failed:
        fail("chunk path: " + "; ".join(failed))
    print("chunk path: " + "; ".join(summary))


# ---------------------------------------------------------------------------
# phase 4c: the VO frame split by stage
# ---------------------------------------------------------------------------

BREAKDOWN_TURNS = 3
BREAKDOWN_RUNS = (("MultiScale", None),
                  ("SingleScale", "all,no_encoder,zero_corr"))
CORR_OFF = ("zero_corr", "oracle", "no_update", "oracle_ba1", "oracle_ba0")


def run_breakdown_phase(torch, card):
    """Phase 4c: `cli.bench --breakdown` in this process at 480x640, M=96,
    bf16, fused3, seeded weights, 40 warm frames, graphs of 8 frames,
    BREAKDOWN_TURNS interleaved turns: MultiScale with every variant of
    probes/frame.py, SingleScale with all, no_encoder and zero_corr (so
    that K3 is split too). Fails unless `all` equals the production
    frame's graph bit for bit from the same state, each variant's captured
    launches a frame are K1 once (0 under zero_corr, oracle, no_update and
    the oracle_ba variants) and K2 three times or K3 once (0 under
    no_encoder), and every state a variant leaves is finite."""
    from rampvo_tpu_torch.cli import bench

    summary = []
    for mode, variants in BREAKDOWN_RUNS:
        argv = ["--breakdown", "--input_mode", mode, "--turns",
                str(BREAKDOWN_TURNS)]
        res = bench.main(argv + (["--variants", variants] if variants
                                 else []))
        torch.cuda.synchronize()
        ch = res["checks"]
        if ch["all_equals_production"] is not True:
            fail(f"breakdown {mode}: all differs from the production graph")
        enc, per = ENC_KERNEL[mode]
        for v in res["variants"]:
            want = {} if v == "no_encoder" else {enc: per}
            if v not in CORR_OFF:
                want["corr_lattice"] = 1
            if ch["launches"].get(v) != want:
                fail(f"breakdown {mode} {v}: launches a frame "
                     f"{ch['launches'].get(v)}, want {want}")
            if ch["finite"].get(v) is not True:
                fail(f"breakdown {mode} {v}: a non-finite state")
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(f"breakdown {mode}: after the run, SM clock, its maximum, "
              f"memory clock, power draw, temperature: {clocks}")
        st = res["stages"]
        summary.append(f"{mode} all {res['value']:.4f} ms/frame, " + ", ".join(
            f"{k} {'unresolved' if r['ms'] is None else round(r['ms'], 4)}"
            for k, r in st.items()))
        torch.cuda.empty_cache()
    print(f"breakdown on {card}: " + "; ".join(summary)
          + "; all == production, launches and finite states as expected")


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
            want = dict.fromkeys(counters, 0)
            want.update({"K1": 12 + (n_vo - 8) + 12,
                         "K2": 3 * len(data) if mode == "MultiScale" else 0,
                         "K3": len(data) if mode == "SingleScale" else 0})
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
# phase 5b: pose prediction
# ---------------------------------------------------------------------------

POSE_FRAMES = 24          # t_to_pred = 12: initialized, then 12 predicted


class PoseTimer:
    """Times each RampVO.predict_future_pose call on the host clock, ending
    in torch.cuda.synchronize(), and inside it the part on the card: the
    reprojection and the flat BA (vo/pose_prediction.py's transform_edges
    and ba_infer, synchronized before and after). The rest of the call is
    the host's: edge table copies, tracks, splines, bookkeeping."""

    def __init__(self, torch):
        from rampvo_tpu_torch.vo import pose_prediction as pp
        from rampvo_tpu_torch.vo import runtime as rt

        self.torch, self.pp, self.cls = torch, pp, rt.RampVO
        self.total, self.card, self.stage = [], [], 0.0

    def _timed(self, fn):
        def run(*a, **kw):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.stage += time.perf_counter() - t
            return out
        return run

    def __enter__(self):
        pp, cls = self.pp, self.cls
        self.saved = (pp.transform_edges, pp.ba_infer,
                      cls.predict_future_pose)
        pp.transform_edges = self._timed(self.saved[0])
        pp.ba_infer = self._timed(self.saved[1])
        predict = self.saved[2]

        def predict_timed(vo, *a, **kw):
            self.stage = 0.0
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            out = predict(vo, *a, **kw)
            self.torch.cuda.synchronize()
            self.total.append(1e3 * (time.perf_counter() - t))
            self.card.append(1e3 * self.stage)
            return out

        cls.predict_future_pose = predict_timed
        return self

    def __exit__(self, *exc):
        (self.pp.transform_edges, self.pp.ba_infer,
         self.cls.predict_future_pose) = self.saved


def check_small_pose_prediction(torch):
    """predict_future_pose on the card and on the CPU from one state: a
    small f32 VO (64x96, M=8, 12 frames) runs on the CPU, its state is
    copied into a RampVO on the card, and both predict a 3-step horizon.
    The predicted poses agree within 1e-4 and the bookkeeping is
    identical. The virtual frame's edges carry the splines' weights of
    1e-9 (as the reference's), so BA barely moves the predicted pose: the
    flat BA's whole output (every window pose and inverse depth) is held
    too, within 1e-4 (poses) and 1e-3 (inverse depths): float32
    Gauss-Newton in other summation orders, TF32 off."""
    from rampvo_tpu_torch.models.vonet import VONet, init_weights
    from rampvo_tpu_torch.vo import RampVO, VOConfig
    from rampvo_tpu_torch.vo import pose_prediction as pp

    ht, wd = 64, 96
    cfg = VOConfig(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=5,
                   OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
                   MIXED_PRECISION=False, PROBE_THRESH=-1.0, MAX_FRAMES=64,
                   MEM=16, KEYFRAME_THRESH=0.0)
    net = init_weights(VONet(), torch.Generator().manual_seed(5))
    with torch.no_grad():
        net.update.d[1].weight.mul_(0.1)
    vos = {d: RampVO(cfg, net, ht=ht, wd=wd, device=d, seed=1)
           for d in ("cpu", "cuda")}
    intr = torch.tensor([50.0, 50.0, wd / 2, ht / 2])
    for f, (ev, im) in enumerate(make_frames(torch, 12, ht, wd, 7, "cpu")):
        vos["cpu"](f, ev, im, [True], intr)
    copy_into(vos["cuda"], vos["cpu"].state, vos["cpu"].tlist)
    ba_out, ba = {"cpu": [], "cuda": []}, pp.ba_infer

    def recorded(*a, **kw):
        out = ba(*a, **kw)
        ba_out[a[0].device.type].append([x.cpu() for x in out])
        return out

    worst, pp.ba_infer = 0.0, recorded
    try:
        for k in range(1, 4):
            out = {d: vo.predict_future_pose(k, 11 + k, 12, deg=2,
                                             frequency=1.0)
                   for d, vo in vos.items()}
            worst = max(worst, float(abs(out["cuda"] - out["cpu"]).max()))
    finally:
        pp.ba_infer = ba
    dba = [max(float((x[i] - y[i]).abs().max())
               for x, y in zip(ba_out["cuda"], ba_out["cpu"]))
           for i in (0, 1)]
    a, b = vos["cpu"].state, vos["cuda"].state
    same = (a.n == b.n == 15 and a.counter == b.counter
            and torch.equal(a.l2g, b.l2g.cpu()) and len(ba_out["cuda"]) == 3)
    print(f"small pose prediction 64x96 M=8 f32, 3-step horizon from one "
          f"state: cuda vs cpu worst predicted-pose difference {worst:.3e} "
          f"(tolerance 1e-4); flat BA output, window poses {dba[0]:.3e} "
          f"(1e-4), inverse depths {dba[1]:.3e} (1e-3); bookkeeping "
          f"{'identical' if same else 'DIFFERS'}")
    if not same or not worst <= 1e-4 or not dba[0] <= 1e-4 \
            or not dba[1] <= 1e-3:
        fail("small pose prediction: cuda differs from cpu")


def run_pose_phase(torch, counters, card):
    """The pose-prediction mode end to end on the card:
    cli.evaluate.evaluate_sequence(use_pose_pred=True) with
    config_vo/default.yaml (PROBE_THRESH=-1), MultiScale under fused3, 96
    patches, bf16, on the in-memory 480x640 scene of the CLI phase cut to
    24 frames without events-only voxels: the VO runs frames 0-11
    (initialized at frame 8), final_refinement(12), predicts frames 12-23
    (`predict_future_pose`, one flat BA each), final_refinement(12). K1
    launches 12 (init burst) + 4 (one update a later frame) + 2 x 12
    (refinements) times, K2 3 times an ingested frame, nothing else; the
    ATE is finite and not the 1000 sentinel; the trajectory holds 24
    poses. Prints ms per predict_future_pose split into host and card
    time (`PoseTimer`)."""
    import dataclasses

    import numpy as np

    from rampvo_tpu_torch.cli import eval_utils as eu
    from rampvo_tpu_torch.cli import evaluate as ev
    from rampvo_tpu_torch.models.vonet import VONet, init_weights
    from rampvo_tpu_torch.vo import VOConfig

    check_small_pose_prediction(torch)
    data, ref_poses, stamps = synthetic_scene(n_frames=POSE_FRAMES,
                                              every=POSE_FRAMES + 1)
    traj_ref = eu.traj_from_xyzw(ref_poses[:, :3], ref_poses[:, 3:], stamps)
    cfg = dataclasses.replace(VOConfig.from_yaml(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "config_vo",
        "default.yaml")), PROBE_THRESH=-1.0)
    eval_cfg = {"data_loader": {"train": {"args": {
        "input_mode": "MultiScale", "event_bias": True,
        "num_event_bins": 5}}}}
    net = init_weights(VONet(), torch.Generator().manual_seed(1))
    t_pred = traj_ref.num_poses // 2
    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    with PoseTimer(torch) as timer:
        ate, rot, traj_est, _, _ = ev.evaluate_sequence(
            cfg, net, eval_cfg, data, traj_ref, stamps, use_pose_pred=True,
            seed=0)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    counts = {k: c.launches for k, c in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update({"K1": 12 + (t_pred - 8) + 2 * 12, "K2": 3 * t_pred})
    n_est = traj_est.positions_xyz.shape[0]
    print(f"pose-prediction phase 480x640 MultiScale fused3 bf16 "
          f"(config_vo/default.yaml, PROBE_THRESH=-1): {POSE_FRAMES} frames, "
          f"t_to_pred {t_pred}, {len(timer.total)} predictions, ate "
          f"{ate:.5f}, rot {[round(r, 4) for r in rot]}, {n_est} poses, "
          f"{sec:.2f} s; launches {counts}")
    if counts != want:
        fail(f"pose-prediction phase: launch counts {counts}, want {want}")
    if not (np.isfinite(ate) and ate != 1000.0) or n_est != POSE_FRAMES \
            or len(timer.total) != POSE_FRAMES - t_pred:
        fail(f"pose-prediction phase: ate={ate}, {n_est} poses, "
             f"{len(timer.total)} predictions")
    tot, dev = np.asarray(timer.total), np.asarray(timer.card)
    host = tot - dev
    print(f"pose prediction on {card}: ms per predict_future_pose (median, "
          f"min, max over {len(tot)} calls; the first builds the tracks "
          f"and splines) total {np.median(tot):.3f} / {tot.min():.3f} / "
          f"{tot.max():.3f}, host (edge table copies, tracks, splines) "
          f"{np.median(host):.3f} / {host.min():.3f} / {host.max():.3f}, "
          f"card (transform_edges + flat BA, synchronized) "
          f"{np.median(dev):.3f} / {dev.min():.3f} / {dev.max():.3f}; "
          f"first call total {tot[0]:.3f} (host {host[0]:.3f})")


# ---------------------------------------------------------------------------
# phase 5c: random and gradient-biased patch selection
# ---------------------------------------------------------------------------

SEL_WARM, SEL_CHUNKS = 10, 3          # eager warm frames, twin replays


def selection_twins(torch, p2, mode, gradient, frames, intr, card, summary):
    """RampVO(event_bias=False) at chunk=1 and its twin at chunk=8 from one
    state (GRADIENT_BIAS `gradient`, fused3, never evicting): the eager
    driver runs SEL_WARM frames with its own draws, its state is copied
    into the twin, then SEL_CHUNKS chunks of 8 frames go into both with
    the same selection draws, drawn on the card for each chunk from a
    seeded CUDA generator. After each chunk the states must be equal bit
    for bit and the capture hold each kernel as often as 8 eager frames
    launch it. The chunks after the capture's are timed, eager and graph
    in alternating order, with P2's host µs a launch before each."""
    from rampvo_tpu_torch.models.vonet import selection_draws

    K = CHUNK_K
    eager, graph = (bench_vo(torch, mode, "fused3", k, event_bias=False,
                             gradient=gradient) for k in (1, K))
    for f in range(SEL_WARM):
        eager(f, *frames[f], [True], intr)
    copy_into(graph, eager.state, eager.tlist)
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst, ms, host, t0 = {}, {"eager": [], "graph": []}, [], SEL_WARM
    for c in range(SEL_CHUNKS):
        fr = frames[SEL_WARM + c * K:SEL_WARM + (c + 1) * K]
        x, y = selection_draws(gradient, K, M, H, W, gen)
        order = ("eager", "graph") if c % 2 else ("graph", "eager")
        for key in order:
            vo = eager if key == "eager" else graph
            host.append(p2.host_us_per_launch())
            torch.cuda.synchronize()
            t = time.perf_counter()
            for k, (ev, im) in enumerate(fr):
                vo(t0 + k, ev, im, [True], intr,
                   sel_draws=(x[k:k + 1], y[k:k + 1]))
            vo.flush()
            torch.cuda.synchronize()
            if c > 0:
                ms[key].append((time.perf_counter() - t) * 1e3 / K)
        t0 += K
        for k, v in state_diff(eager.state, graph.state).items():
            worst[k] = max(worst.get(k, 0), v)
    what = (f"selection {mode} {'gradient' if gradient else 'random'} "
            f"chunk={K}")
    check_twins(what, worst, graph._vo_chunk.captured, mode, "fused3", K)
    if eager.state.n != SEL_WARM + SEL_CHUNKS * K:
        fail(f"{what}: n {eager.state.n}")
    med = {k: sum(v) / len(v) for k, v in ms.items()}
    print(f"{what} on {card}: graph == eager bit for bit over "
          f"{SEL_CHUNKS} replays; ms/frame eager {ms['eager']} graph "
          f"{ms['graph']} (chunks after the capture's); P2 host issue "
          f"{' / '.join(f'{h:.2f}' for h in host)} us a launch")
    summary.append(f"{mode} {'gradient' if gradient else 'random'}: eager "
                   f"{med['eager']:.3f} / graph {med['graph']:.3f} ms/frame "
                   f"(mean of {len(ms['graph'])} timed chunks)")


def selection_singlescale(torch, counters, frames, intr, card, summary):
    """RampVO(event_bias=False), SingleScale, random selection, eager: 24
    frames with the launch counters set to 0 just before and read just
    after (K3 once a frame, K1 12 + 16 times, nothing else); finite
    poses; the median steady ms/frame."""
    vo = bench_vo(torch, "SingleScale", "fused3", 1, event_bias=False)
    for c in counters.values():
        c.launches = 0
    times = []
    for f, (ev, im) in enumerate(frames[:24]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        vo(f, ev, im, [True], intr)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    counts = {k: c.launches for k, c in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update({"K3": 24, "K1": 12 + 16})
    st = vo.state
    if counts != want or st.n != 24 \
            or not bool(torch.isfinite(st.poses[:st.counter]).all()):
        fail(f"selection SingleScale random: launches {counts}, want "
             f"{want}, n {st.n}")
    ms = sorted(times[10:])[len(times[10:]) // 2]
    print(f"selection SingleScale random eager on {card}: 24 frames, median "
          f"steady frame {ms:.3f} ms (frames 10..); launches {counts}")
    summary.append(f"SingleScale random: eager {ms:.3f} ms/frame")


def run_selection_phase(torch, p2, counters, frames, intr, card):
    """Random and gradient-biased patch selection (event_bias=False) on the
    card at 480x640, M=96, bf16: MultiScale eager and chunk=8 twins with
    GRADIENT_BIAS true and false (`selection_twins`), SingleScale eager
    (`selection_singlescale`). Each part runs whatever an earlier one
    did; the phase fails at its end if any part failed."""
    import traceback

    summary, failed = [], []
    parts = [(f"MultiScale gradient={g}", lambda g=g: selection_twins(
        torch, p2, "MultiScale", g, frames, intr, card, summary))
        for g in (True, False)]
    parts.append(("SingleScale", lambda: selection_singlescale(
        torch, counters, frames, intr, card, summary)))
    for name, part in parts:
        try:
            part()
        except (Exception, SystemExit) as e:
            traceback.print_exc()
            failed.append(f"{name}: {e!r}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    if failed:
        fail("selection phase: " + "; ".join(failed))
    print(f"selection phase on {card}: "
          + "; ".join(summary))


def run_selection_training(torch, counters, card):
    """One full-width training step without event bias (the MultiScale
    recipe with event_bias false and gradient_bias true: patches ranked by
    image gradient) through cli.train.TrainLoop on the in-memory window,
    poses free: K7 and K8 launch once per unrolled step (18), the loss
    and every gradient are finite, and gradients are not all zero."""
    from rampvo_tpu_torch.cli import train as ct

    root = os.path.dirname(os.path.abspath(__file__))
    cfg_path = os.path.join(root, "config_net", "MultiScale_TartanEvent.json")
    with open(cfg_path) as f:
        config = json.load(f)
    config["data_loader"]["train"]["args"].update(event_bias=False,
                                                  gradient_bias=True)
    argv = ["--config_path", cfg_path, "--structure_only_steps", "0",
            "--name", "chip_smoke_sel", "--print_every", "1"]
    loop = ct.TrainLoop(ct.parse_args(argv), config,
                        InMemoryWindows(train_window()))
    if loop.fwd.event_bias or not loop.fwd.gradient_bias:
        fail("selection training: the config's selection was not read")
    for c in counters.values():
        c.launches = 0
    loop.run(n_steps=1)
    torch.cuda.synchronize()
    counts = {k: c.launches for k, c in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update({"K7": 18, "K8": 18})
    (hist,) = loop.history
    grads = [p.grad for p in loop.net.parameters() if p.grad is not None]
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    gsum = sum(float(g.abs().sum()) for g in grads)
    print(f"selection training step 480x640 (event_bias false, gradient_bias "
          f"true) on {card}: loss {hist['loss']}, {hist['seconds']:.3f} s, "
          f"{len(grads)} gradients finite={finite}, |g|_1 {gsum:.4e}; "
          f"launches {counts}")
    if counts != want or not finite or not gsum > 0 or not all(
            v == v and abs(v) < 1e30 for v in hist.values()):
        fail(f"selection training: launches {counts} (want {want}), "
             f"finite={finite}, |g|_1={gsum}, metrics {hist}")


# ---------------------------------------------------------------------------
# phase 5d: the native event-stack builder (host C++)
# ---------------------------------------------------------------------------

BINS = 10            # Cx = 13: the kernels' two-k-step instances, not 8k


def bins_eager(torch, counters, mode, frames, intr):
    """bench.py's VO at BINS event bins, eager, over `frames` with every
    launch counter set to 0 just before and read just after: the encoder
    kernel of the mode once an encoded frame (K2 3 launches, K3 1), K1
    12 + (n - 8) times, nothing else; finite poses. Returns (the RampVO,
    median steady ms/frame, counts)."""
    vo = bench_vo(torch, mode, "fused3", 1, bins=BINS)
    n = len(frames)
    for c in counters.values():
        c.launches = 0
    times = []
    for f, (ev, im) in enumerate(frames):
        torch.cuda.synchronize()
        t = time.perf_counter()
        vo(f, ev, im, [True], intr)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    counts = {k: c.launches for k, c in counters.items()}
    want = dict.fromkeys(counters, 0)
    enc = "K2" if mode == "MultiScale" else "K3"
    want.update({"K1": 12 + (n - 8), enc: (3 if enc == "K2" else 1) * n})
    st = vo.state
    if counts != want or st.n != n \
            or not bool(torch.isfinite(st.poses[:st.counter]).all()):
        fail(f"bins {mode}: launches {counts}, want {want}, n {st.n}")
    return vo, sorted(times[10:])[len(times[10:]) // 2], counts


def run_bins_phase(torch, p2, counters, card):
    """Phase 5e: the VO path at BINS = 10 event bins (x of Cx = 13 rows
    into K2 and K3, which are not a multiple of 8). Small 64x96 runs on the
    card against the CPU in both modes; then bench.py's VOConfig
    (480x640, M=96, bf16, fused3): MultiScale 40 eager frames (launch
    counts, ms/frame), a chunk=8 graph twin from the eager state held
    bit for bit over two replays, then timed in 40-frame turns against
    the same graph at 5 bins (10, 5, 5, 10) and both profiled over one
    replay; SingleScale
    24 eager frames; P2's host µs a launch beside each timing;
    terminate()'s trajectories finite. The small runs damp the flow head
    (`check_small_slice`)."""
    intr = torch.tensor([320.0, 320.0, W / 2, H / 2], device="cuda")
    for mode in ("MultiScale", "SingleScale"):
        check_small_slice(torch, mode, bins=BINS, damp=True)
    K = CHUNK_K
    frames = make_frames(torch, FRAMES + 2 * K, H, W, 11, "cuda", BINS)
    host = [p2.host_us_per_launch()]
    eager, ms_eager, counts = bins_eager(torch, counters, "MultiScale",
                                         frames[:FRAMES], intr)
    print(f"bins MultiScale {BINS} bins eager on {card}: {FRAMES} frames, "
          f"median steady frame {ms_eager:.3f} ms (frames 10..); launches "
          f"{counts}")
    graph = bench_vo(torch, "MultiScale", "fused3", K, bins=BINS)
    copy_into(graph, eager.state, eager.tlist)
    worst, _ = drive_twins(torch, eager, graph, frames[FRAMES:FRAMES + 2 * K],
                           intr, FRAMES)
    check_twins(f"bins MultiScale {BINS} bins chunk={K}", worst,
                graph._vo_chunk.captured, "MultiScale", "fused3", K)
    # the same graph at 5 bins, initialized on 5-bin frames, as the
    # control: 40-frame turns 10, 5, 5, 10 bins, then a profiled replay
    g5 = bench_vo(torch, "MultiScale", "fused3", K)
    f5 = make_frames(torch, FRAMES, H, W, 11, "cuda")
    for f, (ev, im) in enumerate(f5):
        g5(f, ev, im, [True], intr)
    g5.flush()
    ms, prof = {10: [], 5: []}, {}
    for bins in (10, 5, 5, 10):
        vo, fr = (graph, frames[:FRAMES]) if bins == 10 else (g5, f5)
        host.append(p2.host_us_per_launch())
        ms[bins].append(timed_frames(torch, vo, fr, intr, 1000 * len(host)))
    for bins, vo, fr in ((10, graph, frames), (5, g5, f5)):
        prof[bins] = profile_frames(torch, vo, fr[:K], intr, min(ms[bins]))
    for vo in (eager, graph, g5):
        traj, _ = vo.terminate()
        if not (abs(traj).max() < 1e6):
            fail("bins MultiScale: non-finite trajectory")
    del eager, graph, g5
    torch.cuda.empty_cache()
    host.append(p2.host_us_per_launch())
    ss, ms_ss, counts = bins_eager(torch, counters, "SingleScale",
                                   frames[:24], intr)
    traj, _ = ss.terminate()
    if not (abs(traj).max() < 1e6):
        fail("bins SingleScale: non-finite trajectory")
    print(f"bins SingleScale {BINS} bins eager on {card}: 24 frames, median "
          f"steady frame {ms_ss:.3f} ms (frames 10..); launches {counts}")
    print(f"bins phase on {card} ({BINS} bins, Cx = {BINS + 3}): MultiScale "
          f"eager {ms_eager:.3f} ms/frame; graph == eager bit for bit over 2 "
          f"replays; graph ms/frame in {FRAMES}-frame turns, 10 / 5 / 5 / 10 "
          f"bins: {ms[10][0]:.3f} / {ms[5][0]:.3f} / {ms[5][1]:.3f} / "
          f"{ms[10][1]:.3f}; device busy of a profiled replay 10 bins "
          f"{prof[10][0]:.3f} ms/frame ({100 * prof[10][2]:.1f}% of its span, "
          f"{prof[10][1]:.0f} kernels/frame), 5 bins {prof[5][0]:.3f} "
          f"({100 * prof[5][2]:.1f}%, {prof[5][1]:.0f}); SingleScale eager "
          f"{ms_ss:.3f} ms/frame; P2 host issue "
          f"{' / '.join(f'{h:.2f}' for h in host)} us a launch")


GEOM_FRAMES, GEOM_PATCHES, GEOM_E = 15, 80, 18000   # the training recipe's


def run_geometry_phase(torch, card):
    """Phase 5f: the projective ops and the Lie groups on the card against
    the CPU at the training recipe's edge count (15 frames of 80 patches,
    E = 18000 edges, 3x3 patches, seeded): `geometry.transform` plain, with
    depth and validity, translation-only, and with jacobian=True (coords,
    validity, Ji, Jj, Jz), `flow_mag` and `point_cloud`; exp, log, inv,
    mul and act of SO3, SE3, RxSO3 and Sim3 on E tangents. Within 1e-5 of
    each output's scale, float32, but Sim3 in float64: its exponential's
    (exp(sigma) - 1) / sigma (the JAX package's formula and thresholds)
    loses ~eps / |sigma| in float32 just above the Taylor threshold
    (1.5e-4 against float64 at sigma = 1.2e-4 on the CPU alone), so two
    devices' float32 results differ by that much; their float32
    difference is printed beside. The CUDA transform with Jacobians runs
    inside `utils.Timer` (CUDA events on the card)."""
    from rampvo_tpu_torch import geometry as geo
    from rampvo_tpu_torch import lie
    from rampvo_tpu_torch.utils import Timer

    g = torch.Generator().manual_seed(21)
    N, n = GEOM_FRAMES, GEOM_FRAMES * GEOM_PATCHES
    poses = lie.SE3.exp(0.05 * torch.randn(1, N, 6, generator=g))
    intr = torch.tensor([320.0, 320.0, W / 2, H / 2]).expand(1, N, 4)
    xy = torch.rand(1, n, 2, 1, 1, generator=g) * torch.tensor(
        [W - 40.0, H - 40.0])[:, None, None] + 20.0
    off = torch.stack(torch.meshgrid(torch.arange(3.0) - 1,
                                     torch.arange(3.0) - 1, indexing="xy"))
    patches = torch.cat([xy + off, 0.5 + 1.5 * torch.rand(
        1, n, 1, 3, 3, generator=g)], dim=2)
    kk = torch.randint(0, n, (GEOM_E,), generator=g)
    ii = kk // GEOM_PATCHES
    jj = (ii + torch.randint(1, N, (GEOM_E,), generator=g)) % N
    worst = {}

    def err(a, b):
        """Max |a - b| over nested lists of tensors (a on the card), and
        whether each tensor's is within 1e-5 of b's scale."""
        a, b = ([v] if torch.is_tensor(v) else v for v in (a, b))
        e, ok = 0.0, True
        for x, y in zip(a, b):
            if not torch.is_tensor(x):
                ei, oi = err(x, y)
            else:
                x, y = x.cpu().double(), y.double()
                ei = (x - y).abs().max().item()
                oi = ei <= 1e-5 * max(1.0, y.abs().max().item())
            e, ok = max(e, ei), ok and oi
        return e, ok

    def check(what, a, b):
        e, ok = err(a, b)
        if not ok:
            fail(f"geometry phase {what}: cuda vs cpu max err {e}")
        worst[what] = e

    dev = lambda *xs: [x.cuda() for x in xs]
    cpu_args = (poses, patches, intr, ii, jj, kk)
    cuda_args = (lie.SE3(poses.data.cuda()), *dev(patches, intr, ii, jj, kk))
    for opts in ({}, {"depth": True, "valid": True}, {"tonly": True}):
        check(f"transform {opts}", geo.transform(*cuda_args, **opts),
              geo.transform(*cpu_args, **opts))
    res = {}
    for _ in range(3):
        with Timer("transform_jacobian", results=res, device="cuda"):
            got = geo.transform(*cuda_args, jacobian=True)
    check("transform jacobian", got, geo.transform(*cpu_args, jacobian=True))
    check("flow_mag", geo.flow_mag(*cuda_args), geo.flow_mag(*cpu_args))
    ix = torch.arange(N)
    check("point_cloud", geo.point_cloud(cuda_args[0], cuda_args[1][:, :N],
                                         cuda_args[2], ix.cuda()),
          geo.point_cloud(poses, patches[:, :N], intr, ix))
    for name in ("SO3", "SE3", "RxSO3", "Sim3"):
        G = getattr(lie, name)
        xi = 0.8 * torch.randn(GEOM_E, G.K, generator=g)
        xi2 = 0.5 * torch.randn(GEOM_E, G.K, generator=g)
        pts = torch.randn(GEOM_E, 3, generator=g)

        def ops_of(x, y, p):
            X, Y = G.exp(x), G.exp(y)
            return [X.data, X.log(), X.inv().data, (X * Y).data, X.act(p)]

        if name == "Sim3":
            sim3_f32 = err(ops_of(xi.cuda(), xi2.cuda(), pts.cuda()),
                           ops_of(xi, xi2, pts))[0]
            xi, xi2, pts = xi.double(), xi2.double(), pts.double()
        check(name, ops_of(xi.cuda(), xi2.cuda(), pts.cuda()),
              ops_of(xi, xi2, pts))
    print(f"geometry phase on {card}: cuda == cpu within 1e-5 of scale at "
          f"E = {GEOM_E} (Sim3 in float64), max errors "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"; Sim3 in float32 {sim3_f32:.2e}"
          + "; transform(jacobian=True) on the card (Timer, CUDA events) "
          + " / ".join(f"{1e3 * x:.3f}" for x in res["transform_jacobian"])
          + " ms")


def run_native_phase(card):
    """data/native.py on this machine's host: g++ builds
    csrc/event_ops.cpp (the phase fails if it cannot); on an in-memory
    stream of 400k events at 480x640 (sorted timestamps, random pixels
    and polarities) `event_stack` and `voxel_grid` must equal the numpy
    versions bit for bit; each is timed against numpy (median of 5, in
    turns). The evaluation fleet is not driven here: its workers read
    scene files, which need h5py, and this machine has none."""
    import numpy as np

    from rampvo_tpu_torch.data import native
    from rampvo_tpu_torch.data import representations as rep
    from rampvo_tpu_torch.data.events import Events

    t = time.perf_counter()
    if native.library() is None:
        fail("native builders: the library did not build")
    build_s = time.perf_counter() - t
    rng = np.random.RandomState(0)
    n = 400_000
    ev = Events(x=rng.randint(0, W, n), y=rng.randint(0, H, n),
                t=np.sort(rng.randint(0, 50_000, n)), p=rng.randint(0, 2, n),
                width=W, height=H)
    out = []
    for name, fast, ref in (("event_stack", native.event_stack,
                             rep.stack_numpy),
                            ("voxel_grid", native.voxel_grid,
                             rep.voxel_numpy)):
        a, b = fast(ev, 5), ref(ev, 5)
        if a.dtype != b.dtype or a.shape != b.shape \
                or a.tobytes() != b.tobytes():
            fail(f"native {name} differs from numpy")
        tn, tr = [], []
        for _ in range(5):
            for fn, ts in ((fast, tn), (ref, tr)):
                t = time.perf_counter()
                fn(ev, 5)
                ts.append((time.perf_counter() - t) * 1e3)
        out.append(f"{name} native {sorted(tn)[2]:.3f} ms, numpy "
                   f"{sorted(tr)[2]:.3f} ms (bit for bit equal)")
    print(f"native builders on {card} host, {n} events at {H}x{W}, 5 bins "
          f"(g++ build and load {build_s:.2f} s): " + "; ".join(out))
    print("evaluation fleet: not driven on the card (its workers read "
          "scene files, which need h5py; this machine has none); "
          "tests/test_torch_fleet.py drives it on the CPU")


# ---------------------------------------------------------------------------
# phases 5g and 5h: the port against ground truth and learned weights
# ---------------------------------------------------------------------------

def port_tests():
    """The port's test modules whose drivers the card phases run (they
    hold what the CPU tests run, and need no JAX and nothing of
    tests/synthetic.py; importing them needs pytest): tests/ at the end
    of the path, so that none of its names shadows another module."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    import test_torch_overfit
    import test_torch_tracking

    return test_torch_tracking, test_torch_overfit


def launches(counters):
    return {k: c.launches for k, c in counters.items()}


def reset(counters):
    for c in counters.values():
        c.launches = 0


def run_tracking_phase(torch, counters, card):
    """tests/test_torch_tracking.py's cases on the card: RampVO with the
    ground-truth oracle over the 18 frames of the synthetic curved
    trajectory at 60x80, M=16, float32, then the terminal updates with
    the oracle (`track`). Each case must initialize, keep every frame
    where nothing may be evicted (evict at least one in the evicting
    case) and land below its ATE bound; the oracle replaces the
    correlation in every update, the terminal ones too, so K1 never
    launches, and K2 launches 3 times a frame."""
    tt, _ = port_tests()
    nf = tt.N_FRAMES
    for case, spec in tt.CASES.items():
        reset(counters)
        t = time.perf_counter()
        r = tt.track(case, device="cuda")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        counts = launches(counters)
        want = dict.fromkeys(counters, 0)
        want["K2"] = 3 * nf
        kept = r["evicted"] > 0 if spec[4] > 0 else r["n"] == nf
        print(f"tracking phase on {card}, case {case} (ow, pl, rw, finals, "
              f"KEYFRAME_THRESH = {spec[:5]}), 60x80 M=16 f32: ATE "
              f"{r['ate']:.6g} against the bound {r['bound']:.6g} "
              f"({spec[5]} x extent {r['extent']:.6g}), n {r['n']}, "
              f"{r['evicted']} evicted, {sec:.2f} s, launches {counts}")
        if counts != want:
            fail(f"tracking {case}: launch counts {counts}, want {want}")
        if not (r["initialized"] and r["frames"] == nf and kept
                and r["ate"] < r["bound"]):
            fail(f"tracking {case}: {r}")


OVERFIT_RUNS = 4


def counting_span(torch, counters, spans):
    """A `span(name)` for the CLIs' `run(span=)`: the launch counters set
    to 0 and the peak memory reset just before the span, and
    spans[name] = (launches, seconds, peak GiB) just after it."""

    @contextlib.contextmanager
    def span(name):
        torch.cuda.synchronize()
        reset(counters)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        yield
        torch.cuda.synchronize()
        spans[name] = (launches(counters), time.perf_counter() - t,
                       torch.cuda.max_memory_allocated() / 2 ** 30)

    return span


def eval_launches(counters, voxels, frames):
    """K1 and K2 launches of an evaluation that tracks every frame of
    `voxels` (`frames` of them with an image) eagerly: the init burst,
    one update a later frame, the 12 terminal updates; 3 encoder folds a
    voxel."""
    want = dict.fromkeys(counters, 0)
    want.update({"K1": 12 + (frames - 8) + 12, "K2": 3 * voxels})
    return want


def run_overfit_phase(torch, counters, card):
    """The learned-weights recipe on the card through its CLI,
    `cli.overfit_synthetic.run` (--steps 40, --memory_scene: this
    machine has no h5py), from the JAX test's initial network
    (`overfit_init`, the CPU twin's): 40 steps of TrainForward(n_frames=8,
    M=16, steps=10), AdamW 1e-4, clip 0.1, the weights saved and loaded
    back (run raises unless they are equal), then both networks through
    cli.evaluate.evaluate (the JAX test's VOConfig, 480x640 padded
    frames, the JAX test's one trial, seed 0). The card's atomics make
    each training a different draw of the recipe's outcome, so it trains
    OVERFIT_RUNS times from the same network, windows and draws (PERF.md
    §6); the initial network is evaluated in the first run only (its
    evaluation is deterministic on the card: PERF.md §6). Fails unless every
    run's last loss is finite and below its first, K7 and K8 launched
    once per unrolled step of training and nothing else, every
    evaluation tracked every frame (`eval_launches`) to a finite ATE,
    and the mean trained ATE is below 0.75 of the initial one."""
    import numpy as np

    from rampvo_tpu_torch.cli import overfit_synthetic as of
    from rampvo_tpu_torch.data import synthetic

    _, to = port_tests()
    scene = synthetic.memory_scene(of.SCENE_FRAMES, of.H, of.W)
    data, _, _ = synthetic.memory_eval_data(scene, of.eval_cfg("memory"))
    n_vo = int(sum(d["mask"][0] for d in data))
    want_train = dict.fromkeys(counters, 0)
    want_train.update({"K7": of.STEPS * of.UNROLL, "K8": of.STEPS * of.UNROLL})
    want_eval = eval_launches(counters, len(data), n_vo)
    del data
    runs, ate0 = [], None
    for _ in range(OVERFIT_RUNS):
        spans = {}
        with tempfile.TemporaryDirectory() as tmp:
            args = of.parse_args(["--steps", str(of.STEPS), "--memory_scene",
                                  "--out", tmp])
            r = of.run(args, net=to.overfit_init(), scene=scene,
                       span=counting_span(torch, counters, spans),
                       ate_initial=ate0)
        ate0 = r["ate_initial"]
        losses = r["losses"]
        if spans["train"][0] != want_train:
            fail(f"overfit training: launch counts {spans['train'][0]}, "
                 f"want {want_train}")
        for name in spans.keys() - {"train"}:
            if spans[name][0] != want_eval:
                fail(f"overfit {name}: launch counts {spans[name][0]}, "
                     f"want {want_eval}")
        if not (np.isfinite(losses[-1]) and losses[-1] < losses[0]):
            fail(f"overfit: losses {losses}")
        for ate in (r["ate_initial"], r["ate_trained"]):
            if not (np.isfinite(ate) and 0 < ate < 1000.0):
                fail(f"overfit evaluation: ATE {ate}")
        r["eval_s"] = [spans[n][1] for n in sorted(spans.keys() - {"train"})]
        runs.append(r)
        print("overfit phase losses: "
              + " ".join(f"{v:.6g}" for v in losses))
    ates = [r["ate_trained"] for r in runs]
    mean = float(np.mean(ates))
    sec = sorted(s for r in runs for s in r["seconds"][1:])
    print(f"overfit phase on {card} (cli.overfit_synthetic.run --steps "
          f"{of.STEPS} --memory_scene from the JAX test's initial network, "
          f"60x80 scene of {of.SCENE_FRAMES} frames in memory, "
          f"{OVERFIT_RUNS} trainings): losses "
          + ", ".join(f"{r['losses'][0]:.6g} -> {r['losses'][-1]:.6g}"
                      for r in runs)
          + f"; median {sec[len(sec) // 2]:.4f} s/step (first steps "
          + ", ".join(f"{r['seconds'][0]:.3f}" for r in runs)
          + f" s); training launches {want_train} each; ATE (seed 0) "
          f"initial {ate0:.6g}, trained "
          + ", ".join(f"{a:.6g}" for a in ates)
          + " (ratios " + ", ".join(f"{a / ate0:.4f}" for a in ates)
          + f"), mean {mean:.6g} (ratio {mean / ate0:.4f}, bound 0.75); "
          f"evaluations ({want_eval['K2'] // 3} voxels, {n_vo} frames) "
          + ", ".join(f"{s:.2f}" for r in runs for s in r["eval_s"])
          + f" s, launches {want_eval} each")
    if not mean < 0.75 * ate0:
        fail(f"overfit: mean trained ATE {mean:.6g} not below 0.75 x "
             f"initial {ate0:.6g} (ratio {mean / ate0:.4f})")


def run_hw_train_phase(torch, counters, card):
    """The hardware training run, `cli.train_hw_run` at its defaults on
    the card with --memory_scene (this machine has no h5py): the
    training CLI's loop at 480x640, 15 frames, 18 unrolled steps, M=80,
    120 steps on the 60-frame curved scene, the checkpoint restored, then
    the random and the trained network through cli.evaluate.evaluate
    (chunk 8). Fails unless K7 and K8 launch once per unrolled step of
    training and nothing else does, each evaluation launches K1 and K2
    as an eager evaluation that tracks every frame (`eval_launches`),
    every loss is finite, the mean of the last 10 losses is below that of
    the first 10, the checkpoint is at step 120 and holds the trained
    weights tensor for tensor, both ATEs are finite, and the CLI's own
    check (trained ATE below random) passes. Returns the training's
    launch counts."""
    import numpy as np

    from rampvo_tpu_torch.cli import train_hw_run as hw

    spans = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        args = hw.parse_args(["--memory_scene", "--out", tmp])
        r = hw.run(args, span=counting_span(torch, counters, spans))
    sec = time.perf_counter() - t0
    summary, hist = r["summary"], r["history"]
    n_unrolled = args.steps * args.unroll
    want_train = dict.fromkeys(counters, 0)
    want_train.update({"K7": n_unrolled, "K8": n_unrolled})
    if spans["train"][0] != want_train:
        fail(f"hardware run training: launch counts {spans['train'][0]}, "
             f"want {want_train}")
    for tag in ("random", "trained"):
        want = eval_launches(counters, *r["evaluations"][tag])
        if spans[f"evaluate {tag}"][0] != want:
            fail(f"hardware run evaluation {tag}: launch counts "
                 f"{spans[f'evaluate {tag}'][0]}, want {want}")
        if not (np.isfinite(summary[f"ate_{tag}"])
                and 0 <= summary[f"ate_{tag}"] < 1000.0):
            fail(f"hardware run evaluation {tag}: {summary}")
    losses = [h["loss"] for h in hist]
    if len(hist) != args.steps or not all(
            np.isfinite(v) for h in hist for v in h.values()):
        fail(f"hardware run: {len(hist)} steps, metrics {hist}")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    if not last < first:
        fail(f"hardware run: mean loss of the last 10 steps {last} not "
             f"below the first 10's {first}")
    state = r["net"].state_dict()
    if int(r["restored"]["step"]) != args.steps or not all(
            torch.equal(r["restored"]["params"][k], v.cpu())
            for k, v in state.items()):
        fail("hardware run: the checkpoint differs from the trained net")
    code = hw.check(summary)
    seconds = [h["seconds"] for h in hist]
    warm = float(np.median(seconds[1:]))
    ratio = summary["ate_trained"] / summary["ate_random"]
    print(f"hardware training run on {card} (cli.train_hw_run --memory_scene"
          f": {args.hw}, {args.n_frames} frames, {args.unroll} unrolled "
          f"steps, M=80, {args.steps} steps, {args.scene_frames}-frame "
          f"curved scene): warm median {warm:.4f} s/step, first step "
          f"{seconds[0]:.3f} s, wall {summary['wall_s']:.1f} s; peak device "
          f"memory {spans['train'][2]:.2f} GiB; loss at steps "
          + ", ".join(f"{k} {losses[k - 1]:.4f}" for k in
                      (1, 10, 40, 100, 120) if k <= len(losses))
          + f" (mean of the first 10 {first:.4f}, last 10 {last:.4f}); ATE "
          f"random {summary['ate_random']:.6g}, trained "
          f"{summary['ate_trained']:.6g} (ratio {ratio:.4f}); evaluations "
          + ", ".join(f"{t} {spans['evaluate ' + t][1]:.1f} s "
                      f"({r['evaluations'][t][0]} voxels, "
                      f"{r['evaluations'][t][1]} frames)"
                      for t in ("random", "trained"))
          + f"; launches: training {spans['train'][0]}; phase {sec:.1f} s")
    if code != 0:
        fail(f"hardware run: trained ATE {summary['ate_trained']:.6g} not "
             f"below random {summary['ate_random']:.6g}")
    return spans["train"][0]


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

def rel_l1(a, b):
    """Relative L1 distance of the tensor lists a and b (from b)."""
    return (sum(float((x - y).abs().sum()) for x, y in zip(a, b))
            / max(sum(float(y.abs().sum()) for y in b), 1e-30))


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
    draws = [probe.draw(torch.Generator().manual_seed(100 + k), "cpu", ht, wd)
             for k in range(2)]
    cpu = small_train_run(torch, "cpu", net0, batch, draws)
    for c in counters.values():
        c.launches = 0
    gpu = small_train_run(torch, "cuda", net0, batch, draws)
    torch.cuda.synchronize()
    n7, n8 = counters["K7"].launches, counters["K8"].launches
    dl = max(abs(a - b) / abs(b) for a, b in zip(gpu[0], cpu[0]))
    dg = rel_l1(gpu[1], cpu[1])
    dp = rel_l1(gpu[2], cpu[2])
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


@functools.lru_cache(maxsize=2)
def train_window(seed=0):
    """The full-width training window in the dataset's format: 30 voxels
    (one between frames) and 15 frames at 480x640 of the textured-plane
    scene of `synthetic_scene` (texture from `seed`), disparities 0.5 (the
    plane 2 m away), its camera-to-world poses and intrinsics. Kept for
    the next caller, who only reads it: it takes seconds of host numpy."""
    import numpy as np

    data, poses, _ = synthetic_scene(n_frames=15, every=1, seed=seed)
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
    loop, s/step (mean of steps 2 and 3, and one more warm step), peak
    device memory, and the device-busy share of one more, profiled, step
    against its own wall time."""
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
            want = dict.fromkeys(counters, 0)
            want.update({"K7": 54, "K8": 54})
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
            # a warm step 4 (pose BA has run once), then a profiled step 5
            loop.run(n_steps=1)
            s_warm = loop.history[3]["seconds"]
            torch.cuda.synchronize()
            # device events only: the host events of ~79k launches take
            # the profiler tens of seconds to aggregate, and none is read
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
          f"warm step 4 {s_warm} s; peak device "
          f"memory {peak:.2f} GiB; {changed}/{len(before)} parameter tensors "
          f"changed; checkpoint step 3 written and restored; launches "
          f"{counts}")
    print(f"profile (training step 5): device busy {busy} s of the profiled "
          f"step's {s_prof} s wall ({100 * busy / s_prof:.1f}% busy; "
          f"{100 * busy / s_warm:.1f}% of the warm step); {n_kern} kernels")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:7d}x  "
              f"{e.key[:90]}")
    for e in dev:                  # K7 and K8 in the step, real coordinates
        if "corr_train" in e.key:
            print(f"  K7/K8 in the step: {e.self_device_time_total / 1e3:.3f}"
                  f" ms {e.count}x {e.key[:60]}")
    return counts, s_step, peak, busy / s_prof


# ---------------------------------------------------------------------------
# phase 7: data-parallel training, the training bench, the ATE harness
# ---------------------------------------------------------------------------

DP_STEPS = 9          # unrolled steps of the DP phase (the recipe's 18, cut)
DP_TOL = 2e-3         # relative L1 of gradients between runs on the card


def recipe_config():
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "config_net", "MultiScale_TartanEvent.json")
              ) as f:
        return json.load(f)


def dp_inputs(torch):
    """Two full-width windows (textures 0 and 1) as a batch of two with
    world-to-camera poses, seeded weights (the flow head scaled by 0.1, as
    the CUDA-vs-CPU trainings) and each sample's draws."""
    import numpy as np

    from rampvo_tpu_torch.lie import ops as lops
    from rampvo_tpu_torch.models.vonet import VONet, init_weights
    from rampvo_tpu_torch.train.forward import TrainForward

    wins = [train_window(), train_window(1)]     # (the cache's two keys)
    batch = {k: torch.as_tensor(np.stack([w[k] for w in wins]))
             for k in wins[0]}
    batch["poses"] = lops.se3_inv(batch["poses"])
    net = init_weights(VONet("MultiScale"), torch.Generator().manual_seed(7))
    with torch.no_grad():
        net.update.d[1].weight.mul_(0.1)
    probe = TrainForward(net, n_frames=15, M=80, steps=DP_STEPS)
    draws = [probe.draw(torch.Generator().manual_seed(30 + b), "cpu", H, W)
             for b in range(2)]
    return net.state_dict(), batch, draws, probe.E


def dp_step(torch, state, batch, draws, mesh=None):
    """One step of parallel.make_train_step (the recipe's optimizer, its
    M=80, DP_STEPS unrolled steps) from `state` on the given samples, on
    the mesh's device (or cuda). Returns (loss, gradients after the clip,
    parameters after the step, seconds), the tensors on the CPU."""
    from rampvo_tpu_torch.models.vonet import VONet
    from rampvo_tpu_torch.parallel import make_train_step
    from rampvo_tpu_torch.train.forward import TrainForward
    from rampvo_tpu_torch.train.step import Trainer

    dev = mesh.device if mesh is not None else torch.device("cuda")
    net = VONet("MultiScale")
    net.load_state_dict(state)
    net.to(dev)
    tr = Trainer(net, recipe_config()["data_loader"]["train"]["args"])
    step = make_train_step(TrainForward(net, n_frames=15, M=80,
                                        steps=DP_STEPS), tr, mesh)
    batch = {k: (v if k == "mask" else v.to(dev)) for k, v in batch.items()}
    draws = [{k: v.to(dev) for k, v in d.items()} for d in draws]
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    loss, _ = step(batch, draws=draws)
    loss = float(loss)
    sec = time.perf_counter() - t
    return (loss, [p.grad.cpu() for p in tr.params],
            [p.detach().cpu() for p in tr.params], sec)


def dp_rank(rank, tmp):
    """A rank of the DP phase: joins a 2-rank gloo group through a file,
    takes its block of the batch and its sample's draws on cuda:0, and
    writes (loss, gradients, parameters, seconds, K7 and K8 launches,
    peak GiB) to tmp/rank{rank}.pt."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from rampvo_tpu_torch.ops import corr_train_kernels as ctk
    from rampvo_tpu_torch.parallel import make_mesh, shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=300))
    try:
        inp = torch.load(f"{tmp}/in.pt")
        mesh = make_mesh("cuda:0")
        shard = shard_batch(mesh, inp["batch"])
        for c in (ctk.corr_train_cuda, ctk.corr_train_bwd_cuda):
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = dp_step(torch, inp["state"], shard, [inp["draws"][rank]], mesh)
        torch.cuda.synchronize()
        torch.save(out + ((ctk.corr_train_cuda.launches,
                           ctk.corr_train_bwd_cuda.launches),
                          torch.cuda.max_memory_allocated() / 2 ** 30,
                          (mesh.world_size, mesh.rank)),
                   f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_dp_phase(torch, counters, card):
    """Data-parallel training on the card (parallel/mesh.py): the
    MultiScale recipe at 480x640, 15 frames, M=80, DP_STEPS unrolled steps
    (E from the recipe's schedule at that depth), two windows. (a) One
    step with no mesh on the batch of two; (b) two ranks spawned onto
    cuda:0 over gloo (NCCL refuses two ranks on one device), one window
    each: gradients within DP_TOL in relative L1 of (a)'s (K8's and
    index_add_'s atomics change the sums' order from run to run),
    parameters after the step bit for bit equal across the ranks, K7 and
    K8 DP_STEPS launches in each rank; (c) one step in a world-size-1 NCCL
    group through the same make_train_step on the batch of two: within
    DP_TOL of (a). Same weights and draws throughout, TF32 off."""
    import multiprocessing as mp
    from datetime import timedelta

    import torch.distributed as dist

    from rampvo_tpu_torch.models.vonet import VONet
    from rampvo_tpu_torch.parallel import make_mesh

    state, batch, draws, E = dp_inputs(torch)
    net0 = VONet("MultiScale")
    net0.load_state_dict(state)
    reset(counters)
    torch.cuda.reset_peak_memory_stats()
    ref = dp_step(torch, state, batch, draws)
    torch.cuda.synchronize()
    n_ref = launches(counters)
    peak_ref = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"state": state, "batch": batch, "draws": draws},
                   f"{tmp}/in.pt")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=dp_rank, args=(r, tmp)) for r in (0, 1)]
        t = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(600 - (time.perf_counter() - t), 1))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        wall = time.perf_counter() - t
        if hung or any(p.exitcode != 0 for p in procs):
            fail(f"DP phase: ranks exit codes {[p.exitcode for p in procs]}"
                 f" ({len(hung)} hung)")
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in (0, 1)]
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg1",
                                rank=0, world_size=1,
                                timeout=timedelta(seconds=300))
        try:
            mesh = make_mesh()
            reset(counters)
            nccl = dp_step(torch, state, batch, draws, mesh)
            torch.cuda.synchronize()
            n_nccl = launches(counters)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    d_rank = [rel_l1(r[1], ref[1]) for r in ranks]
    d_nccl = rel_l1(nccl[1], ref[1])
    same = all(torch.equal(a, b) for a, b in zip(ranks[0][2], ranks[1][2]))
    moved = sum(not torch.equal(a, b.detach()) for a, b in
                zip(ranks[0][2], net0.parameters()))
    want = dict.fromkeys(counters, 0)
    want.update({"K7": 2 * DP_STEPS, "K8": 2 * DP_STEPS})
    print(f"DP phase on {card} (MultiScale recipe 480x640, 15 frames, M=80, "
          f"{DP_STEPS} unrolled steps, E={E}): no mesh, batch 2: loss "
          f"{ref[0]:.6f}, {ref[3]:.3f} s, peak {peak_ref:.2f} GiB, launches "
          f"{n_ref}; gloo ranks on cuda:0: losses "
          f"{[round(r[0], 6) for r in ranks]}, s/step "
          f"{[round(r[3], 3) for r in ranks]}, peak GiB per rank "
          f"{[round(r[5], 2) for r in ranks]}, K7/K8 per rank "
          f"{[r[4] for r in ranks]}, grads rel L1 vs no mesh "
          f"{[f'{d:.2e}' for d in d_rank]} (tol {DP_TOL}), parameters "
          f"bit-equal across ranks {same}, spawn to join {wall:.1f} s; "
          f"world-size-1 {backend} group: loss {nccl[0]:.6f}, {nccl[3]:.3f} "
          f"s, grads rel L1 {d_nccl:.2e}, launches {n_nccl}")
    if not (same and all(d <= DP_TOL for d in d_rank + [d_nccl])
            and n_ref == want == n_nccl and backend == "nccl"
            and all(r[4] == (DP_STEPS, DP_STEPS) for r in ranks)
            and all(r[6] == (2, i) for i, r in enumerate(ranks))
            and moved > 0):
        fail("DP phase: the data-parallel step disagrees (see the line "
             "above)")
    return [r[4] for r in ranks]


def run_train_bench_phase(torch, counters, card):
    """cli.bench --train in this process: the full recipe step (480x640,
    15 frames, M=96, 18 unrolled steps, f32) with --iters 2, K7 = K8 = 54
    (three steps); then each --ablate variant at 9 unrolled steps, --iters
    1: K7 = 18 where the correlation runs, 0 under "corr"; K8 = 18 where
    a gradient flows back into the feature maps: 0 under "corr", under
    "encoder" (zero maps) and under "ba" (without BA the loss does not
    depend on the network: no backward at all). Returns (the full step's
    s/step, {variant: s/step})."""
    from rampvo_tpu_torch.cli import bench

    reset(counters)
    full = bench.main(["--train", "--iters", "2"])
    torch.cuda.synchronize()
    want = dict.fromkeys(counters, 0)
    want.update({"K7": 54, "K8": 54})
    if launches(counters) != want or not full["value"] > 0:
        fail(f"train bench: launches {launches(counters)}, want {want}; "
             f"{full}")
    times = {}
    for name, probes in bench.ABLATE_VARIANTS.items():
        reset(counters)
        res = bench.main(["--train", "--iters", "1", "--steps", "9",
                          "--ablate", name])
        torch.cuda.synchronize()
        want.update({"K7": 0 if "corr" in probes else 18,
                     "K8": 0 if probes & {"corr", "encoder", "ba"} else 18})
        if launches(counters) != want:
            fail(f"train bench --ablate {name}: launches "
                 f"{launches(counters)}, want {want}")
        times[name] = res["value"]
        torch.cuda.empty_cache()
    print(f"train bench on {card}: full recipe {full['value']:.4f} s/step "
          f"(metric {full['metric']}); ablate variants at 9 unrolled steps "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + " s/step; launches as expected")
    return full["value"], times


def run_harness_phase(torch, counters, card):
    """The ATE-parity harness (cli/real_ckpt_eval.py) on the card:
    run_scenario -> evaluate -> emit_table for "apollo" (SingleScale, K3)
    and "tartanevent" (MultiScale, K1 and K2), each with its config_net
    cut to one scene directory (empty: evaluate's `read_scene` gives the
    in-memory 480x640 scene of the CLI phase, the card's machine has no
    h5py), config_vo/default.yaml with the motion probe off, and seeded
    weights written as a reference .pth (the harness resolves and loads
    it through load_pth). Launch counts as the CLI phase's, one trial at
    chunk 1; the ATE finite and not the 1000 sentinel; the table written
    with both rows."""
    import argparse
    import dataclasses

    from rampvo_tpu_torch.cli import eval_utils as eu
    from rampvo_tpu_torch.cli import real_ckpt_eval as rce
    from rampvo_tpu_torch.models.vonet import VONet, init_weights
    from rampvo_tpu_torch.vo import VOConfig

    root = os.path.dirname(os.path.abspath(__file__))
    data, ref_poses, stamps = synthetic_scene()
    traj_ref = eu.traj_from_xyzw(ref_poses[:, :3], ref_poses[:, 3:], stamps)
    n_vo = int(sum(d["mask"][0] for d in data))

    def read_scene(scene, eval_cfg, downsample_fact):
        return data, traj_ref, stamps, tuple(data[0]["intrinsics"])

    rows, secs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(VOConfig.from_yaml(os.path.join(
            root, "config_vo", "default.yaml")), PROBE_THRESH=-1.0)
        vo_yaml = os.path.join(tmp, "vo.yaml")
        with open(vo_yaml, "w") as f:
            f.writelines(f"{k}: {json.dumps(v)}\n"
                         for k, v in dataclasses.asdict(cfg).items())
        os.makedirs(os.path.join(tmp, "weights"))
        args = argparse.Namespace(
            weights_dir=os.path.join(tmp, "weights"),
            data_root=os.path.join(tmp, "data"), trials=1, chunk=1,
            save_dir=os.path.join(tmp, "runs"), device="cuda")
        for name, mode in (("apollo", "SingleScale"),
                           ("tartanevent", "MultiScale")):
            spec = dict(rce.SCENARIOS[name], config_vo=vo_yaml,
                        config_net=os.path.join(tmp, f"{name}.json"))
            with open(os.path.join(root, rce.SCENARIOS[name]["config_net"])
                      ) as f:
                ecfg = json.load(f)
            ecfg["data_loader"]["test"]["test_split"] = ["scene0"]
            with open(spec["config_net"], "w") as f:
                json.dump(ecfg, f)
            os.makedirs(os.path.join(tmp, "data", spec["data_subdir"],
                                     "scene0"))
            net = init_weights(VONet(mode), torch.Generator().manual_seed(1))
            rce.write_reference_pth(os.path.join(tmp, "weights",
                                                 spec["weights"]), net)
            reset(counters)
            t = time.perf_counter()
            res = rce.run_scenario(name, spec, args, read_scene=read_scene)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
            counts = launches(counters)
            want = dict.fromkeys(counters, 0)
            want.update({"K1": 12 + (n_vo - 8) + 12,
                         "K2": 3 * len(data) if mode == "MultiScale" else 0,
                         "K3": len(data) if mode == "SingleScale" else 0})
            ate = (res or {}).get("scene0", float("nan"))
            if counts != want or not (ate == ate and ate != 1000.0):
                fail(f"harness {name}: {res}, launches {counts}, want {want}")
            rows[name] = res
        out = os.path.join(tmp, "ATE_PARITY.md")
        rce.emit_table(rows, {}, out)
        with open(out) as f:
            table = f.read()
    if not all(f"| {n} | scene0 |" in table for n in rows):
        fail("harness: the table lacks a scenario's row")
    print(f"harness phase on {card}: apollo ATE {rows['apollo']['scene0']:.5f}"
          f" in {secs['apollo']:.2f} s, tartanevent ATE "
          f"{rows['tartanevent']['scene0']:.5f} in {secs['tartanevent']:.2f} "
          f"s ({len(data)} voxels, {n_vo} frames each, launches as the CLI "
          "phase's), table written")
    return secs


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k3-variants", action="store_true",
                    help="only compare the K3 build variants")
    ap.add_argument("--corr-bins", action="store_true",
                    help="only time K6 and K5 in every build variant and "
                    "bin tile against K1")
    ap.add_argument("--k1-variants", action="store_true",
                    help="only compare the K1 build variants")
    ap.add_argument("--k8-variants", action="store_true",
                    help="only compare the K8 build variants")
    ap.add_argument("--k7-variants", action="store_true",
                    help="only compare the K7 build variants")
    ap.add_argument("--k2-variants", action="store_true",
                    help="only compare the K2 build variants")
    ap.add_argument("--chunk-only", action="store_true",
                    help="only the chunked path (CUDA-graph replay) phase")
    ap.add_argument("--breakdown-only", action="store_true",
                    help="only the stage split of the VO frame (4c)")
    ap.add_argument("--pose-only", action="store_true",
                    help="only the pose-prediction phase (5b)")
    ap.add_argument("--selection-only", action="store_true",
                    help="only the patch-selection phase (5c) and its "
                    "training step")
    ap.add_argument("--native-only", action="store_true",
                    help="only the native event-builder phase (5d)")
    ap.add_argument("--bins-only", action="store_true",
                    help="only K2 and K3 at every checked Cx and the "
                    "event-bins phase (5e)")
    ap.add_argument("--truth-only", action="store_true",
                    help="only the ground-truth tracking (5g) and the "
                    "learned-weights (5h) phases")
    ap.add_argument("--train-hw-only", action="store_true",
                    help="only the hardware training run (6b)")
    ap.add_argument("--dp-only", action="store_true",
                    help="only the data-parallel training phase (7)")
    ap.add_argument("--train-bench-only", action="store_true",
                    help="only the training bench phase (7b)")
    ap.add_argument("--harness-only", action="store_true",
                    help="only the ATE-parity harness phase (7c)")
    ap.add_argument("--ab", metavar="DIR",
                    help="only time K7, K2, K3 and the folded correlation "
                    "in the tree at DIR and in this one, in turns")
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
        from rampvo_tpu_torch.ops import corr_band_kernels as bk
        from rampvo_tpu_torch.ops import corr_bins as cb
        from rampvo_tpu_torch.ops import corr_kernels as ck
        from rampvo_tpu_torch.ops import corr_paired_kernels as pk
        from rampvo_tpu_torch.ops import corr_train_kernels as ctk
        from rampvo_tpu_torch.ops import encoder_kernels as ek
        from rampvo_tpu_torch.ops import singlescale_kernels as sk
        from rampvo_tpu_torch.probes import dynlane as p1
        from rampvo_tpu_torch.probes import grid_overhead as p2
    except ImportError as e:
        print(f"rampvo_tpu_torch not found next to chip_smoke.py: {e}",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda)
    if args.ab:
        compare_ab(args.ab)
        return 0
    if args.k3_variants:
        compare_k3_variants(torch, sk, build)
        return 0
    if args.corr_bins:
        compare_corr_bins(torch, ck, pk, cb, build)
        return 0
    if args.k1_variants or args.k8_variants or args.k7_variants \
            or args.k2_variants:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if args.k1_variants:
            compare_k1_variants(torch, ck, build)
        if args.k8_variants:
            compare_k8_variants(torch, ctk, build)
        if args.k7_variants:
            compare_k7_variants(torch, ctk, build)
        if args.k2_variants:
            compare_k2_variants(torch, ek, build)
        return 0
    t = time.perf_counter()
    logs = build.build_all(["corr_lattice", "lstm_fold", "lstm_carry_fold",
                            "corr_train", "corr_lattice_cb", "corr_paired",
                            "corr_bands", "probes"])
    print(f"built kernels in {time.perf_counter() - t:.1f} s")
    for name, log in logs.items():
        for line in ptxas_lines(log):
            print(f"  ptxas {name}: {line}")
            if "spill" in line and "0 bytes spill stores, 0 bytes spill " \
                    "loads" not in line and name.startswith("corr_"):
                fail(f"{name}: a correlation kernel spills registers")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.chunk_only:
        build.build_all(["corr_lattice", "lstm_fold", "lstm_carry_fold",
                         "corr_lattice_cb", "corr_paired", "corr_bands",
                         "probes"])
        run_chunk_path(torch, p2, make_frames(torch, FRAMES, H, W, 1, "cuda"),
                       torch.tensor([320.0, 320.0, W / 2, H / 2],
                                    device="cuda"))
        return 0
    counters = {"K1": ck.corr_lattice, "K2": ek.lstm_fold_cm,
                "K3": sk.lstm_carry_fold_cm, "K4": bk.corr_lattice_bands,
                "K4f": bk.corr_folded_cuda,
                "K5": pk.corr_lattice_paired, "K6": ck.corr_lattice_cb,
                "K7": ctk.corr_train_cuda, "K8": ctk.corr_train_bwd_cuda,
                "P1": p1.dynlane, "P2": p2.grid_probe}
    if args.breakdown_only:
        run_breakdown_phase(torch, card)
        return 0
    if args.bins_only:
        k2, k3 = {}, {}
        check_lstm_fold(torch, ek, k2)
        check_lstm_carry_fold(torch, sk, k3)
        check_enc_bins(torch, ek, sk, k2, k3)
        run_bins_phase(torch, p2, counters, card)
        run_geometry_phase(torch, card)
        return 0
    if args.truth_only:
        run_tracking_phase(torch, counters, card)
        run_overfit_phase(torch, counters, card)
        return 0
    if args.train_hw_only:
        run_hw_train_phase(torch, counters, card)
        return 0
    if args.dp_only or args.train_bench_only or args.harness_only:
        if args.harness_only:
            run_harness_phase(torch, counters, card)
        if args.train_bench_only:
            run_train_bench_phase(torch, counters, card)
        if args.dp_only:
            run_dp_phase(torch, counters, card)
        return 0
    if args.pose_only or args.selection_only or args.native_only:
        if args.native_only:
            run_native_phase(card)
        if args.pose_only:
            run_pose_phase(torch, counters, card)
        if args.selection_only:
            run_selection_phase(
                torch, p2, counters, make_frames(torch, FRAMES, H, W, 1,
                                                 "cuda"),
                torch.tensor([320.0, 320.0, W / 2, H / 2], device="cuda"),
                card)
            torch.cuda.empty_cache()
            run_selection_training(torch, counters, card)
        return 0

    marks, seconds = [time.perf_counter()], {}

    def mark(name):
        marks.append(time.perf_counter())
        seconds[name] = round(marks[-1] - marks[-2], 1)

    k2, k1, k3, k7, k8, lay, probes = {}, {}, {}, {}, {}, {}, {}
    check_lstm_fold(torch, ek, k2)
    check_corr_lattice(torch, ck, k1)
    check_corr_layouts(torch, ck, bk, lay)
    check_binned(torch, ck, pk, cb, lay)
    time_precise(torch, ck, pk, cb, lay)
    check_lstm_carry_fold(torch, sk, k3)
    check_enc_bins(torch, ek, sk, k2, k3)
    check_corr_train(torch, ctk, k7, k8)
    check_probes(torch, p1, p2, counters, probes)
    for mode in ("MultiScale", "SingleScale"):
        check_small_slice(torch, mode)
        check_small_training(torch, mode, counters)
    for layout in ("fused2", "fused4", "folded"):
        check_small_slice(torch, "MultiScale", layout)
    mark("kernel and small checks")

    frames = make_frames(torch, FRAMES, H, W, 1, "cuda")
    intr = torch.tensor([320.0, 320.0, W / 2, H / 2], device="cuda")
    paths, summary = {}, []
    for mode, layout in (("MultiScale", "fused3"), ("SingleScale", "fused3"),
                         ("MultiScale", "fused2"), ("MultiScale", "fused4"),
                         ("MultiScale", "folded")):
        with FinishSpy(bk) as spy:
            counts, ms, vo = run_main_path(torch, counters, mode, frames,
                                           layout)
            busy, calls, _ = profile_frames(torch, vo, frames[:4], intr, ms)
        if layout == "folded":
            if spy.on_card:
                fail(f"folded main path: the PyTorch finish ran {spy.on_card} "
                     "times on the card")
            print("folded main path: no PyTorch finish on the card, "
                  f"{calls:.0f} kernels/frame")
        paths[mode, layout] = counts
        summary.append(f"{mode} {layout} {ms:.3f} ms/frame, device busy "
                       f"{busy:.3f} ms/frame, {calls:.0f} kernels/frame")
        del vo
        torch.cuda.empty_cache()
    print("main paths: " + "; ".join(summary))
    run_eviction_pass(torch, frames)
    mark("main paths")
    run_chunk_path(torch, p2, frames, intr)
    mark("chunk")
    run_breakdown_phase(torch, card)
    mark("breakdown")
    run_cli_phase(torch, counters)
    run_pose_phase(torch, counters, card)
    run_selection_phase(torch, p2, counters, frames, intr, card)
    run_native_phase(card)
    mark("CLI, pose, selection, native")
    run_bins_phase(torch, p2, counters, card)
    run_geometry_phase(torch, card)
    mark("bins, geometry")
    del frames
    torch.cuda.empty_cache()
    run_tracking_phase(torch, counters, card)
    run_overfit_phase(torch, counters, card)
    mark("tracking, overfit")
    torch.cuda.empty_cache()
    n_tr, _, _, _ = run_train_main_path(torch, counters)
    torch.cuda.empty_cache()
    run_selection_training(torch, counters, card)
    mark("training")
    torch.cuda.empty_cache()
    n_hw = run_hw_train_phase(torch, counters, card)
    mark("hardware training run")
    torch.cuda.empty_cache()
    run_harness_phase(torch, counters, card)
    mark("harness")
    run_train_bench_phase(torch, counters, card)
    mark("train bench")
    torch.cuda.empty_cache()
    dp = run_dp_phase(torch, counters, card)
    mark("data parallel")
    print(f"phase seconds (after the build): {seconds}")

    n_ms = paths["MultiScale", "fused3"]
    n_ss = paths["SingleScale", "fused3"]
    ker = dict(route="cuda", library_ms=None)
    kernels = [
        dict(name="corr_lattice", source="rampvo_tpu_torch/csrc/corr_lattice.cu",
             replaces="rampvo_tpu/ops/corr_pallas.py:1117",
             launches=n_ms["K1"], **ker, **k1["bf16"]),
        dict(name="lstm_fold_cm", source="rampvo_tpu_torch/csrc/lstm_fold.cu",
             replaces="rampvo_tpu/ops/encoder_pallas.py:77",
             launches=n_ms["K2"], **ker, **k2["bf16"],
             checked_cx=[8, *BIN_CXS], by_cx=k2["bins"]),
        dict(name="lstm_carry_fold_cm",
             source="rampvo_tpu_torch/csrc/lstm_carry_fold.cu",
             replaces="rampvo_tpu/ops/encoder_pallas.py:235",
             launches=n_ss["K3"], **ker, **k3["bf16"],
             checked_cx=[8, *BIN_CXS], by_cx=k3["bins"]),
        dict(name="corr_folded", source="rampvo_tpu_torch/csrc/corr_bands.cu",
             replaces="rampvo_tpu/ops/corr_pallas.py:461",
             launches=paths["MultiScale", "folded"]["K4f"], **ker,
             **lay["K4 folded"]["bf16"]),
        dict(name="corr_paired", source="rampvo_tpu_torch/csrc/corr_paired.cu",
             replaces="rampvo_tpu/ops/corr_pallas.py:721",
             launches=paths["MultiScale", "fused2"]["K5"], **ker,
             **lay["K5"]["bf16"]),
        dict(name="corr_lattice_cb",
             source="rampvo_tpu_torch/csrc/corr_lattice_cb.cu",
             replaces="rampvo_tpu/ops/corr_pallas.py:1486",
             launches=paths["MultiScale", "fused4"]["K6"], **ker,
             **lay["K6"]["bf16"]),
        dict(name="corr_train_fwd", source="rampvo_tpu_torch/csrc/corr_train.cu",
             replaces="rampvo_tpu/ops/corr_pallas.py:1766",
             launches=n_tr["K7"] + n_hw["K7"], hw_train_launches=n_hw["K7"],
             dp_launches=[r[0] for r in dp], **ker, **k7["f32"]),
        dict(name="corr_train_bwd", source="rampvo_tpu_torch/csrc/corr_train.cu",
             replaces="rampvo_tpu/ops/corr_pallas.py:2002",
             launches=n_tr["K8"] + n_hw["K8"], hw_train_launches=n_hw["K8"],
             dp_launches=[r[1] for r in dp], **ker, **k8["f32"]),
        dict(name="dynlane", source="rampvo_tpu_torch/csrc/probes.cu",
             replaces="scripts/probe_dynlane.py:50", **ker, **probes["P1"]),
        dict(name="grid_probe", source="rampvo_tpu_torch/csrc/probes.cu",
             replaces="scripts/probe_grid_overhead.py:70", **ker,
             **probes["P2"]),
    ]
    print(card)   # again beside the results: the log's head may be cut
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
