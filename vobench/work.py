"""The benchmark's frozen work arithmetic: the bytes and operations that
each measured kernel and each whole step must move and compute, from the
shapes alone, and the H100's peaks.

Peaks (NVIDIA H100 SXM data sheet, dense): 989 TFLOP/s bf16 on the tensor
cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM; the special
function units run 16 transcendental operations a clock on each of the
132 SMs, at the 1.98 GHz boost clock. A kernel's least time is the largest of its bytes
over the bandwidth, its operations over the peak of its type and (K2, K3)
its transcendental functions over the SFU rate; each input byte counts
once and each output byte once, whatever the kernel reads again.

Sources of the counts: the kernel table of PERF.md (section 6, the "Bound
ms" column, as chip_smoke.py's checks compute it) for K1, K2, K3, K7 and
K8; the model FLOPs of a VO frame and a training step re-derived from the
network's shapes (replacing PERF_MODEL.md's TPU-era per-stage counts).
"""

from __future__ import annotations

HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "f32": 67e12}
SFU_PER_CLK, SM_CLOCK, SMS = 16, 1.98e9, 132

C = 128            # feature channels of the correlation
P = 3              # patch side
WIN = 8            # raw correlation window side (7x7 after the blend)
NCOL = 2 * 49 * P * P   # 882 columns of the stacked two-level correlation
DIM = 384          # update operator width
KEEP_P = 0.2       # training correlation's gradient keep probability


def least_s(nbytes: float, flops: float, dtype: str,
            sfu_ops: float = 0.0) -> float:
    """A kernel's least time in seconds."""
    return max(nbytes / HBM_BPS, flops / PEAK[dtype],
               sfu_ops / (SFU_PER_CLK * SMS * SM_CLOCK))


# --------------------------------------------------------------------------
# K1: the VO update's lattice correlation (fused3)
# --------------------------------------------------------------------------

def corr_lattice_bytes(cells: int, M: int, live_edges: float,
                       target_slots: float, host_slots: float, h4: int,
                       w4: int, es: int) -> float:
    """The [cells * M, 882] output (every lattice edge: dead ones are
    written as zeros), the live edges' level-1 coordinates (u, v float32,
    9 pixels), the cell table, the host frames' patch features and the
    target frames' two feature levels, once each."""
    return (cells * M * NCOL * es + live_edges * 9 * 2 * 4 + cells * 2 * 4
            + host_slots * M * P * P * C * es
            + target_slots * (h4 * w4 + (h4 // 4) * (w4 // 4)) * C * es)


def corr_flops(edges: float) -> float:
    """Dot products of the two levels' 8x8 windows with the 9 patch
    pixels' features."""
    return edges * P * P * 2 * WIN * WIN * C * 2


# --------------------------------------------------------------------------
# K2 / K3: the encoder's recurrent fold (a frame at H x W)
# --------------------------------------------------------------------------

def lstm_fold_work(H: int, W: int, cx: int, es: int):
    """K2 (MultiScale), one frame: (bytes, flops, SFU operations) over the
    three scales (hidden 16, 32, 64 at H x W, H/2 x W/2, H/4 x W/4)."""
    scales = ((16, H * W), (32, (H // 2) * (W // 2)),
              (64, (H // 4) * (W // 4)))
    nbytes = sum(hw * (cx + 2 * h) * es
                 + 4 * (cx * 8 * h + 8 * h + 3 * h * h + h)
                 for h, hw in scales)
    flops = sum(hw * 2 * (cx * 6 * h + 3 * h * h) for h, hw in scales)
    sfu = sum(hw * 2 * h * 4 for h, hw in scales)
    return nbytes, flops, sfu


def lstm_carry_fold_work(H: int, W: int, cx: int, es: int, hp: int = 16):
    """K3 (SingleScale), one frame: (bytes, flops, SFU operations) of the
    carried event and image LSTMs (hidden padded to hp) and the shared
    fold; the packed bf16 weights (fragments and float32 biases)."""
    hw = H * W
    cp = 8 * -(-cx // 8)
    nch = 2 * hp // 8
    wbytes = (nch * 4 * (cp // 8 * 64 + 256) + 512) * 2 + 9 * hp * 4
    nbytes = hw * (cx + 5 * hp) * es + hw * 5 * hp * es + wbytes + 8
    flops = hw * (2 * (cx + 2 * hp) * 8 * hp + 2 * 2 * 2 * hp * hp)
    sfu = hw * 2 * hp * 5
    return nbytes, flops, sfu


# --------------------------------------------------------------------------
# K7 / K8: the training correlation, forward and backward
# --------------------------------------------------------------------------

def corr_train_work(E: int, NF: int, M: int, h4: int, w4: int, es: int):
    """((forward bytes, flops), (backward bytes, flops)) of one unrolled
    step's two-level correlation over E edges: the forward reads the
    frames' two feature levels and the patch features once and writes
    [E, 882]; the backward reads the float32 output gradient and writes
    the three float32 input gradients, with the dot products of the
    (edge, level) pairs whose gradient the dropout keeps (KEEP_P of
    them)."""
    maps = NF * (h4 * w4 + (h4 // 4) * (w4 // 4)) * C + NF * M * P * P * C
    small = E * 9 * 2 * 4 + 2 * E * 4
    fwd = (E * NCOL * es + maps * es + small, corr_flops(E))
    kept = KEEP_P * 2 * E
    bwd = (E * NCOL * 4 + maps * es + maps * 4 + small,
           kept * P * P * WIN * WIN * C * 4)
    return fwd, bwd


# --------------------------------------------------------------------------
# model FLOPs
# --------------------------------------------------------------------------

def update_flops(edges: float, M: int, NI: int) -> float:
    """The update operator over `edges` live edges: the correlation MLP
    (882 -> 384 -> 384 -> 384), the two temporal convolutions c1 and c2
    (two linears each), both soft aggregations' f and g per edge and h per
    group (NI * M patch tracks, edges / M frame pairs), the gated
    residual GRU (three linears, twice) and the two heads (384 -> 2)."""
    per_edge = (NCOL * DIM + 2 * DIM * DIM + 4 * DIM * DIM + 4 * DIM * DIM
                + 6 * DIM * DIM + 2 * 2 * DIM)
    groups = NI * M + edges / M
    return 2 * (edges * per_edge + groups * DIM * DIM)


def ba_flops(edges: float, iters: int = 2) -> float:
    """Gauss-Newton over the live edges: each edge's 2 x 13 Jacobian
    (pose i, pose j, its depth) into the 13 x 13 normal block, per
    iteration."""
    return iters * edges * 2 * 13 * 13 * 2


def encoder_flops(mode: str, H: int, W: int, bins: int) -> float:
    """The encoder's FLOPs on one frame (the recurrent chain and both
    heads), counted by torch's FLOP counter over the reference's module on
    meta tensors (shapes only)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.models.vonet import VONet
    from .reference.vo.config import VOConfig
    from .reference.vo.runtime import (make_enc_state,
                                       singlescale_state_to_cl)

    with torch.device("meta"):
        net = VONet(mode, evs_ch=bins)
        enc = net.patchify.encoder
        ev = torch.zeros(1, H, W, bins)
        im = torch.zeros(1, H, W, 3)
        st = make_enc_state(VOConfig(MIXED_PRECISION=False), mode, H, W,
                            "meta")
        with FlopCounterMode(display=False) as fc:
            if mode == "MultiScale":
                enc(ev, im, torch.ones(1, dtype=torch.bool, device="cpu"),
                    st)
            else:
                enc(ev, im, singlescale_state_to_cl(st, H, W))
    return float(fc.get_total_flops())


def train_window_encoder_flops(H: int, W: int, bins: int, voxels: int,
                               frames: int) -> float:
    """The MultiScale encoder's forward FLOPs over a training window
    (`encode_window`: every voxel through the recurrent chain, the heads
    on the frames), on meta tensors."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.models.vonet import VONet

    every = voxels // frames
    mask = torch.tensor([i % every == every - 1 for i in range(voxels)])
    with torch.device("meta"):
        net = VONet("MultiScale", evs_ch=bins)
    ev = torch.zeros(voxels, H, W, bins, device="meta")
    im = torch.zeros(frames, H, W, 3, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        net.encode(ev, im, mask, frames)
    return float(fc.get_total_flops())


def train_step_flops(encoder_fwd: float, valid_edges, M: int,
                     n_frames: int) -> float:
    """Model FLOPs of one optimizer step: three times the forward (the
    backward costs two), the forward being the window's encoder and, for
    each unrolled step, the correlation, the update and two BA iterations
    over that step's valid edges (`valid_edges`, one count a step)."""
    fwd = encoder_fwd + sum(corr_flops(e) + update_flops(e, M, n_frames)
                            + ba_flops(e) for e in valid_edges)
    return 3 * fwd
