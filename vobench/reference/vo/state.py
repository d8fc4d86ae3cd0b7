"""VOState: the SLAM state as a dataclass of fixed-shape tensors (port of
rampvo_tpu/vo/state.py).

Frame-global buffers are indexed by an immutable global frame id; `l2g`
maps logical keyframe -> global id and `slotmap` logical keyframe ->
feature-ring slot, with `slot_free` as the free list. Edges live on the
fixed-shape lattice [NI hosts, T offsets, M patches]: edge (host row i,
t, m) links host frame i to target i + t - (r-1). The scalars (n,
counter, initialized) are plain Python values, and the host-driven frame
decides its branches on them; the branchless initialized frame
(vo/runtime.py) runs on a view of the state whose n and counter are 0-d
int64 device tensors. The runtime updates the tensors in place and never
rebinds a tensor field.

Feature rings hold the 1/4-res fmap and its 4x pool unpadded
[MEM, h, w, 128]: the correlation kernel masks out-of-bounds taps itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import resolve_device
from .config import VOConfig


@dataclasses.dataclass
class VOState:
    # frame-global buffers (row = global frame id)
    poses: torch.Tensor        # [F, 7] world-to-camera SE3
    pat_x: torch.Tensor        # [F, M*P*P] pixel x at 1/4 res
    pat_y: torch.Tensor        # [F, M*P*P]
    pat_d: torch.Tensor        # [F, M] inverse depth (per patch)
    pat_cx: torch.Tensor       # [F, M] center-pixel x
    pat_cy: torch.Tensor       # [F, M]
    colors: torch.Tensor       # [F, M, 3]
    delta_parent: torch.Tensor  # [F] int32, -1 = none
    delta_dP: torch.Tensor     # [F, 7] relative SE3 of removed/skipped frames
    # logical maps
    l2g: torch.Tensor          # [L] int64 logical keyframe -> global id (-1)
    slotmap: torch.Tensor      # [L] int64 logical keyframe -> ring slot (-1)
    slot_free: torch.Tensor    # [MEM] bool
    # feature rings (row = ring slot)
    imap_r: torch.Tensor       # [MEM, M, DIM]
    gmap_r: torch.Tensor       # [MEM, M, P, P, 128]
    fmap1_r: torch.Tensor      # [MEM, h, w, 128]
    fmap2_r: torch.Tensor      # [MEM, h/4, w/4, 128]
    # edge lattice [NI, T, M]
    cell_valid: torch.Tensor   # [NI, T] bool
    net: torch.Tensor          # [NI, T, M, DIM] hidden state
    last_weight: torch.Tensor  # [NI, T, M, 2]
    # encoder recurrent state (channel-major super-states)
    enc: Any
    intrinsics: torch.Tensor   # [4] fx fy cx cy at 1/4 res
    # host scalars
    n: int = 0                 # live logical keyframes
    counter: int = 0           # next global frame id
    initialized: bool = False
    hw4: tuple = (0, 0)        # (h, w) of the level-1 rings


def host_of_row(i_row, n, NI: int):
    """Logical host frame held by lattice row i_row with n keyframes live:
    the i in (n-1-NI, n-1] with i == i_row (mod NI); negative when the row
    is unoccupied. Floor-mod, as the reference's jnp.mod."""
    return n - 1 - torch.remainder(n - 1 - i_row, NI)


def edge_table(cfg: VOConfig, n, cell_valid):
    """Flat (ii, jj, kk, valid) view of the lattice, row-major, with invalid
    rows sanitized to 0."""
    NI, T, M = cfg.NI, cfg.T, cfg.M
    r = cfg.PATCH_LIFETIME
    dev = cell_valid.device
    i_row = torch.arange(NI, device=dev)[:, None, None]
    t = torch.arange(T, device=dev)[None, :, None]
    m = torch.arange(M, device=dev)[None, None, :]
    ii = (host_of_row(i_row, n, NI) + 0 * t + 0 * m).expand(NI, T, M)
    jj = ii + (t - (r - 1))
    kk = ii * M + m
    valid = (cell_valid[:, :, None] & (ii >= 0) & (jj >= 0)
             & (ii <= n - 1) & (jj <= n - 1))
    zero = torch.zeros_like(ii)
    E = NI * T * M
    return (torch.where(valid, ii, zero).reshape(E),
            torch.where(valid, jj, zero).reshape(E),
            torch.where(valid, kk, zero).reshape(E),
            valid.reshape(E))


def init_state(cfg: VOConfig, enc_state, ht: int, wd: int, P: int = 3,
               dim: int = 384, device="cuda") -> VOState:
    """Empty state for ht x wd input; feature maps live at 1/4."""
    dev = resolve_device(device)
    F, L, M, MEM = cfg.MAX_FRAMES, cfg.BUFFER_SIZE, cfg.M, cfg.MEM
    NI, T = cfg.NI, cfg.T
    h, w = ht // 4, wd // 4
    fdt = torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32
    f32 = dict(dtype=torch.float32, device=dev)

    def ident(k):
        x = torch.zeros((k, 7), **f32)
        x[:, 6] = 1.0
        return x

    return VOState(
        poses=ident(F),
        pat_x=torch.zeros((F, M * P * P), **f32),
        pat_y=torch.zeros((F, M * P * P), **f32),
        pat_d=torch.zeros((F, M), **f32),
        pat_cx=torch.zeros((F, M), **f32),
        pat_cy=torch.zeros((F, M), **f32),
        colors=torch.zeros((F, M, 3), **f32),
        delta_parent=torch.full((F,), -1, dtype=torch.int64, device=dev),
        delta_dP=ident(F),
        l2g=torch.full((L,), -1, dtype=torch.int64, device=dev),
        slotmap=torch.full((L,), -1, dtype=torch.int64, device=dev),
        slot_free=torch.ones((MEM,), dtype=torch.bool, device=dev),
        imap_r=torch.zeros((MEM, M, dim), dtype=fdt, device=dev),
        gmap_r=torch.zeros((MEM, M, P, P, 128), dtype=fdt, device=dev),
        fmap1_r=torch.zeros((MEM, h, w, 128), dtype=fdt, device=dev),
        fmap2_r=torch.zeros((MEM, h // 4, w // 4, 128), dtype=fdt, device=dev),
        cell_valid=torch.zeros((NI, T), dtype=torch.bool, device=dev),
        net=torch.zeros((NI, T, M, dim), **f32),
        last_weight=torch.zeros((NI, T, M, 2), **f32),
        enc=enc_state,
        intrinsics=torch.zeros((4,), **f32),
        hw4=(h, w),
    )
