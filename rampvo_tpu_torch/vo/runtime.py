"""The VO runtime (port of the lattice path of rampvo_tpu/vo/runtime.py;
reference ramp/Ramp_vo.py).

One call per frame: encode -> patch select/extract -> commit -> motion-probe
gate -> edge append -> (init burst | update + keyframe). Every step writes
into the state's own tensors (in-place indexing and `copy_`) and rebinds no
tensor field, so a frame run eagerly and one replayed from a CUDA graph
act on the same storage.

Two forms of the frame:
- the host-driven frame (`make_vo_frame`'s `vo_frame`; every frame of
  `RampVO(chunk=1)` and every frame before initialization): `n` and
  `counter` are host ints and three decisions are read back on the host,
  as the reference does: the probe gate (pre-init only), the init burst
  and the keyframe eviction;
- the branchless initialized frame (`vo_frame.frame_init`, the port of the
  JAX frame with traced scalars): `n` and `counter` are 0-d int64 device
  tensors, both eviction outcomes are computed and one is selected on the
  device, and nothing is read on the host. `vo/graph.py` captures K of
  them into one CUDA graph (`make_vo_frames_chunk`, `RampVO(chunk=K)`).
  Initialized n never decreases below INIT_FRAMES, so a run that reaches
  this form stays in it. `chunk=1` keeps the host-driven form: run
  eagerly one frame at a time, the branchless frame issues ~200 more
  launches a frame and was not shown to be as fast (chip_smoke.py's
  chunk phase times the two in alternating pairs; PERF.md §6).

Per update the correlation runs through the kernel `cfg.CORR_LAYOUT` picks
(vo/config.py CORR_LAYOUTS: K1 `corr_lattice`, K6 `corr_lattice_cb`, K5
`corr_lattice_paired` or K4 `corr_lattice2_stacked(folded=True)`; the
Hopper kernel on CUDA tensors), and the update operator reads its layout
through a corr_fc1 weight folded once per driver; the encoder chain runs
through
`ops.encoder_kernels.lstm_fold_cm` (MultiScale) or
`ops.singlescale_kernels.lstm_carry_fold_cm` (SingleScale); the motion
probe's M-edge correlation is the plain exact `ops.corr.corr`, as in the
reference (XLA there).

Both forms open the same seven stage spans (`STAGES`, `utils.timing.span`:
profiler spans with tracing on, nothing otherwise): the encoder with its
heads; patch selection and extraction; the commit with the edge append
(the probe gate too, before initialization); the edge table, reprojection
and correlation; the update network; the weight filter, windowed BA and
write-back; the keyframe step. A graph capture maps its nodes to them
(vo/graph.py).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .. import resolve_device
from ..ba.core import ba_infer
from ..geometry.projective import flow_mag_edges, transform_edges
from ..lie import ops as lops
from ..models.encoders import SS_LSTM_DIM, multiscale_init_state
from ..models.vonet import (
    VONet,
    extract_patches,
    filter_features,
    fold_corr_fc1,
    select_coords_event_bias,
    select_coords_gradient_bias,
    select_coords_random,
    selection_draws,
)
from ..ops.corr import avg_pool2d, corr, corr_stack
from ..ops.corr_band_kernels import corr_lattice2_stacked
from ..ops.corr_kernels import corr_lattice, corr_lattice_cb
from ..ops.corr_paired_kernels import corr_lattice_paired
from ..ops.encoder_kernels import multiscale_encode, multiscale_weights
from ..ops.singlescale_kernels import (
    singlescale_encode,
    singlescale_init_state,
    singlescale_weights,
)
from ..utils.timing import span
from .config import VOConfig
from .state import VOState, edge_table, host_of_row, init_state

DIM = 384
STAGES = ("vo.frame.encoder", "vo.frame.patchify", "vo.frame.commit",
          "vo.frame.corr", "vo.frame.update_net", "vo.frame.ba",
          "vo.frame.keyframe")
INIT_FRAMES = 8      # keyframes before the init burst (Ramp_vo.py:389)
INIT_UPDATES = 12    # updates of the init burst


def _fdt(cfg: VOConfig):
    return torch.bfloat16 if cfg.MIXED_PRECISION else torch.float32


def make_enc_state(cfg: VOConfig, input_mode: str, ht: int, wd: int,
                   device="cuda"):
    """Encoder carry (channel-major), bf16 under MIXED_PRECISION; the
    runtime keeps the carry's dtype. MultiScale: the per-scale
    super-states; SingleScale: the LSTM carries and the super-state."""
    dev = resolve_device(device)
    if input_mode == "SingleScale":
        return singlescale_init_state(ht, wd, SS_LSTM_DIM, dtype=_fdt(cfg),
                                      device=dev)
    if input_mode == "MultiScale":
        return multiscale_init_state(ht, wd, dtype=_fdt(cfg), device=dev)
    raise ValueError(f"Invalid input mode: {input_mode}")


def _clip(x, lo, hi):
    if isinstance(x, int):
        return min(max(x, lo), hi)
    return x.clamp(lo, hi)


def _at_least(x, lo: int):
    return max(x, lo) if isinstance(x, int) else x.clamp(min=lo)


def _take(x, i):
    """x[i] along dim 0 for an int or an index tensor. A 0-d index tensor
    is gathered on the device: Python indexing reads a 0-d tensor index on
    the host, which a CUDA graph cannot hold."""
    if isinstance(i, torch.Tensor) and i.dim() == 0:
        return x[i.reshape(1)][0]
    return x[i]


def _put(x, i, v):
    """x[i] = v along dim 0, in place, for an int or a 0-d index tensor."""
    if isinstance(i, torch.Tensor):
        x.index_copy_(0, i.reshape(1),
                      v.to(x.dtype).reshape((1,) + x.shape[1:]))
    else:
        x[i] = v


def _assign(dst, src):
    """Copy a tree (dicts and lists) of tensors into one of the same
    structure, in place."""
    if isinstance(dst, dict):
        for key in dst:
            _assign(dst[key], src[key])
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            _assign(a, b)
    else:
        dst.copy_(src)


def _gather_pose(state: VOState, logical):
    """Pose of a logical keyframe (clamped gather through l2g)."""
    g = _take(state.l2g, _clip(logical, 0, state.l2g.shape[0] - 1))
    return _take(state.poses, g.clamp(0, state.poses.shape[0] - 1))


def _patch_rows(state: VOState, kk_logical, M: int):
    """Global patch-buffer rows of logical patch ids."""
    host = torch.div(kk_logical, M, rounding_mode="floor")
    g = state.l2g[host.clamp(0, state.l2g.shape[0] - 1)]
    return g * M + torch.remainder(kk_logical, M)


def _patches_rows(state: VOState, rows, P: int = 3):
    """Interleaved [E, 3, P, P] patches of global patch rows."""
    F, M = state.pat_d.shape
    PP = P * P
    gf = torch.div(rows, M, rounding_mode="floor").clamp(0, F - 1)
    m = torch.remainder(rows, M)
    px = state.pat_x.reshape(F, M, PP)[gf, m].reshape(-1, P, P)
    py = state.pat_y.reshape(F, M, PP)[gf, m].reshape(-1, P, P)
    pd = state.pat_d[gf, m][:, None, None].expand_as(px)
    return torch.stack([px, py, pd], dim=1)


def _motion_model_pose(cfg: VOConfig, state: VOState):
    """Damped-linear extrapolation (Ramp_vo.py:356-366). A device `n` is
    an initialized one, so n > 1."""
    if isinstance(state.n, int) and state.n <= 1:
        return lops.se3_identity((), device=state.poses.device)
    P1 = _gather_pose(state, state.n - 1)
    P2 = _gather_pose(state, state.n - 2)
    xi = cfg.MOTION_DAMPING * lops.se3_log(lops.se3_mul(P1, lops.se3_inv(P2)))
    return lops.se3_mul(lops.se3_exp(xi), P1)


def _commit(cfg: VOConfig, state: VOState, fmap, gmap, imap_vec,
            patches_new, clr, intrinsics, rand_d):
    """Write the new frame at global row g = counter (Ramp_vo.py:344-383).
    `rand_d` [M]: the pre-initialization depths. Does not advance n; with
    host `n`/`counter` the counter is rebound, a device one is advanced in
    place."""
    M, L, MEM, F = cfg.M, cfg.BUFFER_SIZE, cfg.MEM, cfg.MAX_FRAMES
    g, n = state.counter, state.n
    dev = state.poses.device
    _put(state.poses, g, _motion_model_pose(cfg, state))

    # depth init: random before initialization, then the median of the
    # last 3 frames over the full [3, M, P*P] (depth replicated per pixel)
    P = patches_new.shape[-1]
    PP = P * P
    if state.initialized:
        g3 = state.l2g[(n - 3 + torch.arange(3, device=dev)).clamp(0, L - 1)]
        d3 = state.pat_d[g3.clamp(0, F - 1)]
        d0 = torch.quantile(d3[:, :, None].expand(3, M, PP).reshape(-1), 0.5)
        d0 = d0.expand(M)
    else:
        d0 = rand_d.to(device=dev, dtype=torch.float32)
    _put(state.pat_x, g, patches_new[0, :, 0].reshape(M * PP))
    _put(state.pat_y, g, patches_new[0, :, 1].reshape(M * PP))
    _put(state.pat_d, g, d0)
    _put(state.pat_cx, g, patches_new[0, :, 0, P // 2, P // 2])
    _put(state.pat_cy, g, patches_new[0, :, 1, P // 2, P // 2])
    _put(state.colors, g, clr[0])

    # free the ring slots of frames that aged out of the feature window
    # (slot MEM takes the writes of the logical frames that hold none).
    # Every write is the same True, so a plain scatter needs no sort or
    # atomics: repeated slots give the same result in any order.
    old = torch.arange(L, device=dev) < n - cfg.FEATURE_WINDOW
    sm = state.slotmap
    freed = torch.zeros(MEM + 1, dtype=torch.bool, device=dev)
    freed.scatter_(0, torch.where(old & (sm >= 0), sm, MEM), True)
    state.slot_free |= freed[:MEM]
    sm.masked_fill_(old, -1)

    # allocate the first free slot for the new frame and fill the rings
    s = torch.argmax(state.slot_free.int())
    state.slot_free.index_fill_(0, s.reshape(1), False)
    _put(state.slotmap, n, s)
    _put(state.imap_r, s, imap_vec[0])
    _put(state.gmap_r, s, gmap[0])
    _put(state.fmap1_r, s, fmap[0])
    _put(state.fmap2_r, s, avg_pool2d(fmap, 4)[0])

    # provisional logical registration (kept only if the frame is)
    _put(state.l2g, n, g)
    if isinstance(g, int):
        state.counter = g + 1
    else:
        g.add_(1)
    state.intrinsics.copy_(intrinsics.to(torch.float32) / 4.0)


def _quat_project(Gij, px, py, d, intrinsics):
    """Pinhole reprojection of planar pixel arrays through per-row relative
    poses Gij [R, 7] (px/py/d broadcast to [R, K]). Returns u, v."""
    fx, fy, cx, cy = intrinsics.unbind(-1)
    x0 = (px - cx) / fx
    y0 = (py - cy) / fy
    tx_, ty_, tz_ = Gij[..., 0:1], Gij[..., 1:2], Gij[..., 2:3]
    qx, qy, qz, qw = Gij[..., 3:4], Gij[..., 4:5], Gij[..., 5:6], Gij[..., 6:7]
    uvx = 2.0 * (qy - qz * y0)
    uvy = 2.0 * (qz * x0 - qx)
    uvz = 2.0 * (qx * y0 - qy * x0)
    X1 = x0 + qw * uvx + (qy * uvz - qz * uvy) + d * tx_
    Y1 = y0 + qw * uvy + (qz * uvx - qx * uvz) + d * ty_
    Z1 = 1.0 + qw * uvz + (qx * uvy - qy * uvx) + d * tz_
    Z = torch.clamp(Z1, min=0.1)
    return fx * (X1 / Z) + cx, fy * (Y1 / Z) + cy


def _lattice_hosts(cfg: VOConfig, state: VOState):
    """Host frame of every lattice row and its clamped global id."""
    rows = torch.arange(cfg.NI, device=state.poses.device)
    hosts = host_of_row(rows, state.n, cfg.NI)
    gh = state.l2g[hosts.clamp(0, state.l2g.shape[0] - 1)].clamp(
        0, state.poses.shape[0] - 1)
    return hosts, gh


def _reproject_lattice_planar(cfg: VOConfig, state: VOState):
    """Planar lattice reprojection: (u, v [NI*T, M*PP], uc, vc [NI*T, M]).
    Patch data depends only on (host row, m) and all edges of a cell share
    the relative pose. Dead cells give garbage that consumers mask."""
    M, NI, T, r = cfg.M, cfg.NI, cfg.T, cfg.PATCH_LIFETIME
    L = state.l2g.shape[0]
    F = state.poses.shape[0]
    MPP = state.pat_x.shape[1]
    PP = MPP // M
    hosts, gh = _lattice_hosts(cfg, state)
    px, py, pd = state.pat_x[gh], state.pat_y[gh], state.pat_d[gh]
    jj_c = hosts[:, None] + (torch.arange(T, device=gh.device)[None, :]
                             - (r - 1))
    pi = state.poses[gh]
    pj = state.poses[state.l2g[jj_c.clamp(0, L - 1)].clamp(0, F - 1)]
    Gij = lops.se3_mul(pj, lops.se3_inv(pi)[:, None, :])      # [NI, T, 7]
    dpp = pd[:, :, None].expand(NI, M, PP).reshape(NI, 1, MPP)
    u, v = _quat_project(Gij, px[:, None, :], py[:, None, :], dpp,
                         state.intrinsics)
    uc, vc = _quat_project(Gij, state.pat_cx[gh][:, None, :],
                           state.pat_cy[gh][:, None, :], pd[:, None, :],
                           state.intrinsics)
    NC = NI * T
    return (u.reshape(NC, MPP), v.reshape(NC, MPP),
            uc.reshape(NC, M), vc.reshape(NC, M))


def _lattice_corr(cfg: VOConfig, *args):
    """The update's lattice correlation in cfg.CORR_LAYOUT's kernel and
    output layout (ref vo/runtime.py:342-422)."""
    if cfg.CORR_LAYOUT == "fused4":
        return corr_lattice_cb(*args)
    if cfg.CORR_LAYOUT == "fused2":
        return corr_lattice_paired(*args)
    if cfg.CORR_LAYOUT == "folded":
        return corr_lattice2_stacked(*args, folded=True)
    return corr_lattice(*args)


def _reproject_lattice_edges(cfg: VOConfig, state: VOState):
    """Every lattice edge's reprojected patch [E, P, P, 2] (x, y), in
    edge_table's order (the oracle's input; ref vo/runtime.py::
    _reproject_edges_lattice)."""
    u, v, _, _ = _reproject_lattice_planar(cfg, state)
    P = state.gmap_r.shape[-3]
    return torch.stack([u, v], dim=-1).reshape(-1, P, P, 2)


def _edge_corr_ctx_lattice(cfg: VOConfig, state: VOState,
                           corr_fn=_lattice_corr):
    """Correlation + context for the full lattice. Returns (target [E, 2]
    center reprojections, corr_in [E, 882 or 1152] in cfg.CORR_LAYOUT's
    layout, ctx [NI*M, DIM] t-compressed). `corr_fn` computes corr_in
    (`_lattice_corr`'s arguments; probes/frame.py swaps in zeros).

    The context of lattice row i is the imap of its host frame's patches,
    looked up from the row's host directly in every layout (the reference
    reads it through the sanitized t = 0 edge, which is wrong for rows
    whose t = 0 cell is dead; see ROADMAP)."""
    M, MEM, NI = cfg.M, cfg.MEM, cfg.NI
    u, v, uc, vc = _reproject_lattice_planar(cfg, state)
    target = torch.stack([uc.reshape(-1), vc.reshape(-1)], dim=-1)
    corr_in = corr_fn(
        cfg, state.gmap_r, state.fmap1_r, state.fmap2_r, u, v,
        state.cell_valid, state.n, state.slotmap, cfg.PATCH_LIFETIME,
        (NI, cfg.T, M))
    hosts, _ = _lattice_hosts(cfg, state)
    slot_k = state.slotmap[hosts.clamp(0, state.slotmap.shape[0] - 1)]
    gidx = (slot_k.clamp(0, MEM - 1)[:, None] * M
            + torch.arange(M, device=hosts.device)[None, :]).reshape(-1)
    ctx = state.imap_r.reshape(MEM * M, -1)[gidx].float()
    return target, corr_in, ctx


def _edge_corr_ctx(cfg: VOConfig, state: VOState, ii, jj, kk):
    """Exact correlation + context for an arbitrary edge set (the probe's
    M edges; Ramp_vo.py:175-182), in the reference layout whatever
    cfg.CORR_LAYOUT, as the JAX probe."""
    M, MEM = cfg.M, cfg.MEM
    P = state.gmap_r.shape[-3]
    L = state.l2g.shape[0]
    F = state.poses.shape[0]
    poses_i = state.poses[state.l2g[ii.clamp(0, L - 1)].clamp(0, F - 1)]
    poses_j = state.poses[state.l2g[jj.clamp(0, L - 1)].clamp(0, F - 1)]
    rows = _patch_rows(state, kk, M).clamp(0, F * M - 1)
    coords = transform_edges(poses_i, poses_j, _patches_rows(state, rows),
                             state.intrinsics)
    slot_k = state.slotmap[torch.div(kk, M, rounding_mode="floor").clamp(
        0, L - 1)]
    gidx = slot_k.clamp(0, MEM - 1) * M + torch.remainder(kk, M)
    slot_j = state.slotmap[jj.clamp(0, L - 1)].clamp(0, MEM - 1)
    gflat = state.gmap_r.reshape(MEM * M, P, P, 128)
    c1 = corr(gflat, state.fmap1_r, coords, gidx, slot_j, 3)
    c2 = corr(gflat, state.fmap2_r, coords / 4.0, gidx, slot_j, 3)
    corr_in = corr_stack(c1, c2)
    ctx = state.imap_r.reshape(MEM * M, -1)[gidx].float()
    return coords[:, P // 2, P // 2, :], corr_in, ctx


def _probe_median(cfg: VOConfig, update_fn, state: VOState):
    """Median predicted flow for the new, uncommitted frame
    (Ramp_vo.py:210-225); `update_fn` reads the reference layout."""
    M, n = cfg.M, state.n
    dev = state.poses.device
    kk = (n - 1) * M + torch.arange(M, device=dev)
    ii = torch.full((M,), n - 1, dtype=torch.int64, device=dev)
    jj = torch.full((M,), n, dtype=torch.int64, device=dev)
    _t, corr_in, ctx = _edge_corr_ctx(cfg, state, ii, jj, kk)
    net0 = torch.zeros((M, DIM), dtype=torch.float32, device=dev)
    _, (delta, _w) = update_fn(net0, ctx, corr_in, ii, jj, kk, None, None)
    return torch.quantile(torch.linalg.norm(delta, dim=-1), 0.5)


def _append_edges(cfg: VOConfig, state: VOState):
    """Factors of the newly committed frame nf = n-1 (Ramp_vo.py:194-201,
    312-325): its row takes the backward cells t in [0, r-1], and each of
    the r-1 previous hosts gains the forward cell to nf."""
    M, r, NI, T = cfg.M, cfg.PATCH_LIFETIME, cfg.NI, cfg.T
    nf = state.n - 1
    rf = nf % NI
    state.cell_valid[rf] = False
    state.net[rf] = 0.0
    state.last_weight[rf] = 0.0
    ok_b = [(nf + t - (r - 1)) >= 0 for t in range(r)]
    state.cell_valid[rf, :r] = torch.tensor(ok_b, device=state.net.device)
    for k in range(r - 1):
        host = nf - 1 - k
        if host < 0:
            continue
        row, t = host % NI, nf - host + (r - 1)
        state.cell_valid[row, t] = True
        state.net[row, t] = 0.0
        state.last_weight[row, t] = 0.0


def _append_edges_dev(cfg: VOConfig, state: VOState):
    """`_append_edges` with a device `n`: the host loop as masked writes
    (ref vo/runtime.py:508-541). The forward cells t = r + k, k < r-1, are
    distinct, so each write touches its own cell."""
    r, NI = cfg.PATCH_LIFETIME, cfg.NI
    dev = state.net.device
    nf = state.n - 1
    rf = torch.remainder(nf, NI).reshape(1)
    for x in (state.cell_valid, state.net, state.last_weight):
        x.index_fill_(0, rf, 0)
    tb = torch.arange(r, device=dev)
    state.cell_valid[rf, :r] = ((nf + tb - (r - 1)) >= 0)[None]
    k = torch.arange(r - 1, device=dev)
    hosts = nf - 1 - k
    rows, tf, ok = torch.remainder(hosts, NI), k + r, hosts >= 0
    state.cell_valid[rows, tf] = state.cell_valid[rows, tf] | ok
    for x in (state.net, state.last_weight):
        x[rows, tf] = torch.where(ok[:, None, None], 0.0, x[rows, tf])


def _update(cfg: VOConfig, update_fn, state: VOState, oracle=None,
            corr_fn=_lattice_corr):
    """One VO update: reproject -> corr -> update net -> BA
    (Ramp_vo.py:276-310).

    `oracle(state, ii, jj, kk, coords [E, P, P, 2]) -> (delta, weight)`
    [E, 2] each, when given, replaces the correlation and the update
    network (the hidden state is left as it is), e.g. to drive BA with
    ground-truth targets (ref vo/runtime.py:545-580). An `update_fn` that
    returns no hidden state (None) leaves it as it is too. `corr_fn` (see
    `_edge_corr_ctx_lattice`) computes the correlation."""
    M, PW = cfg.M, cfg.POSE_WINDOW
    n = state.n
    with span("vo.frame.corr"):
        ii, jj, kk, valid = edge_table(cfg, n, state.cell_valid)
        if oracle is None:
            target0, corr_in, ctx = _edge_corr_ctx_lattice(cfg, state,
                                                           corr_fn)
        else:
            coords = _reproject_lattice_edges(cfg, state)
    with span("vo.frame.update_net"):
        if oracle is None:
            net, (delta, weight) = update_fn(
                state.net.reshape(-1, DIM), ctx, corr_in, ii, jj, kk, valid,
                (cfg.NI, cfg.T, M))
        else:
            P = coords.shape[1]
            delta, weight = oracle(state, ii, jj, kk, coords)
            target0, net = coords[:, P // 2, P // 2, :], None
    with span("vo.frame.ba"):
        target = target0 + delta
        weight = filter_features(weight, target, state.hw4)
        weight = torch.where(valid[:, None], weight, torch.zeros_like(weight))

        posew2, dwin2, win_g, k = _window_ba(cfg, state, target, weight, ii,
                                             jj, kk, valid)
        # write back the k live window frames; with a device k, window rows
        # past it repeat row k - 1 (the same value written twice)
        live = (slice(0, k) if isinstance(k, int) else
                torch.minimum(torch.arange(PW, device=win_g.device), k - 1))
        state.poses[win_g[live]] = posew2[live]
        state.pat_d[win_g[live]] = dwin2.reshape(PW, M)[live]
        if net is not None:
            state.net.copy_(net.reshape(state.net.shape))
        state.last_weight.copy_(weight.reshape(state.last_weight.shape))


def _window_ba(cfg: VOConfig, state: VOState, target, weight, ii, jj, kk,
               valid):
    """BA over the trailing window of PW logical frames starting at base =
    max(n - PW, 0), writing nothing: (poses' [PW, 7], inverse depths'
    [PW * M], the window's global frame ids win_g [PW], its live frame
    count k)."""
    M, PW, NI = cfg.M, cfg.POSE_WINDOW, cfg.NI
    n = state.n
    dev = state.poses.device
    base = _at_least(n - PW, 0)
    k = n - base                                   # live window frames
    L, F = state.l2g.shape[0], state.poses.shape[0]
    win_log = base + torch.arange(PW, device=dev)
    win_ok = win_log < n
    win_g = state.l2g[win_log.clamp(0, L - 1)]
    win_gc = torch.where(win_ok, win_g, torch.zeros_like(win_g)).clamp(0, F - 1)
    posew = state.poses[win_gc]
    cwin = torch.stack([state.pat_cx[win_gc], state.pat_cy[win_gc],
                        state.pat_d[win_gc]], dim=-1).reshape(PW * M, 3)
    t0 = _at_least(n - cfg.OPTIMIZATION_WINDOW if state.initialized else 1,
                   1)
    wrow = torch.remainder(win_log, NI)
    held = host_of_row(wrow, n, NI) == win_log
    win_rows = torch.where(held & win_ok, wrow, torch.full_like(wrow, -1))
    posew2, dwin2 = ba_infer(
        posew, cwin, state.intrinsics, target, weight, 1e-4,
        ii - base, jj - base, kk - base * M, t0 - base, n - base,
        N=cfg.OPTIMIZATION_WINDOW, M=PW * M, lattice=(NI, cfg.T, M),
        win_rows=win_rows, iterations=cfg.BA_ITERS, valid=valid)
    return posew2, dwin2, win_g, k


def _keyframe(cfg: VOConfig, state: VOState):
    """Evict a redundant keyframe and age out old edges
    (Ramp_vo.py:237-274). The eviction decision is read on the host."""
    L, MEM, NI = cfg.BUFFER_SIZE, cfg.MEM, cfg.NI
    F = state.poses.shape[0]
    n = state.n
    dev = state.poses.device
    evict = bool(_keyframe_flow(cfg, state) < cfg.KEYFRAME_THRESH)
    k = n - cfg.KEYFRAME_INDEX

    if evict:
        # trajectory delta of the removed frame (Ramp_vo.py:245-249)
        t0g = state.l2g[_clip(k - 1, 0, L - 1)]
        t1g = state.l2g[_clip(k, 0, L - 1)]
        dP = lops.se3_mul(state.poses[t1g.clamp(0, F - 1)],
                          lops.se3_inv(state.poses[t0g.clamp(0, F - 1)]))
        state.delta_parent[t1g] = t0g
        state.delta_dP[t1g] = dP

        n_new = n - 1
        _remap_cells(cfg, state, n_new, k, True)

        # map shifts (replace the reference's buffer moves :258-268)
        freed = state.slotmap[_clip(k, 0, L - 1)]
        state.slot_free[freed.clamp(0, MEM - 1)] |= freed >= 0
        state.l2g[k:] = torch.roll(state.l2g, -1)[k:]
        state.slotmap[k:] = torch.roll(state.slotmap, -1)[k:]
    else:
        n_new = n
        state.cell_valid &= (host_of_row(torch.arange(NI, device=dev), n,
                                         NI) >= 0)[:, None]

    # age out edges whose host left the removal window (:273-274)
    host_row = host_of_row(torch.arange(NI, device=dev), n_new, NI)
    state.cell_valid &= (host_row >= n_new - cfg.REMOVAL_WINDOW)[:, None]
    state.n = n_new


def _remap_cells(cfg: VOConfig, state: VOState, n_new, k, evict):
    """Renumber the lattice after frame k's removal, in place
    (Ramp_vo.py:251-256): new cell (i', t') pulls old cell
    (i mod NI, j - i + r - 1), i = i' + (i' >= k), j = j' + (j' >= k), and
    the cells of frame k's edges die. `evict` is a host True or a device
    bool; where it is false the remap is the identity."""
    NI, T, r = cfg.NI, cfg.T, cfg.PATCH_LIFETIME
    dev = state.net.device
    sh = evict.long() if isinstance(evict, torch.Tensor) else 1
    i_new = (host_of_row(torch.arange(NI, device=dev)[:, None], n_new, NI)
             + 0 * torch.arange(T, device=dev)[None, :])
    j_new = i_new + torch.arange(T, device=dev)[None, :] - (r - 1)
    i_old = i_new + sh * (i_new >= k).long()
    j_old = j_new + sh * (j_new >= k).long()
    t_old = j_old - i_old + (r - 1)
    gone = ((i_old == k) | (j_old == k)) & evict
    okc = (t_old >= 0) & (t_old < T) & (i_old >= 0) & ~gone
    src = (torch.remainder(i_old, NI) * T + t_old.clamp(0, T - 1)).reshape(-1)
    state.cell_valid.copy_(state.cell_valid.reshape(NI * T)[src].reshape(
        NI, T) & okc)
    for x in (state.net, state.last_weight):
        x.copy_(x.reshape((NI * T,) + x.shape[2:])[src].reshape(x.shape))


def _cell_flow(cfg: VOConfig, state: VOState, a, d: int):
    """Mean flow magnitude (beta 0.5) of the lattice cell from logical
    frame a to a + d, 0 where that cell is not live; `a` and `state.n`
    host ints or device scalars."""
    M, NI, T, r = cfg.M, cfg.NI, cfg.T, cfg.PATCH_LIFETIME
    F = state.poses.shape[0]
    n = state.n
    dev = state.poses.device
    row, t = a % NI, d + r - 1
    held = n - 1 - (n - 1 - row) % NI == a      # row `row` holds frame a
    if not 0 <= t < T or held is False:
        return torch.zeros((), device=dev)
    rows = _patch_rows(state, a * M + torch.arange(M, device=dev),
                       M).clamp(0, F * M - 1)
    flow = flow_mag_edges(
        _gather_pose(state, a).expand(M, 7),
        _gather_pose(state, a + d).expand(M, 7), _patches_rows(state, rows),
        state.intrinsics, beta=0.5).mean()
    return torch.where(_take(state.cell_valid[:, t], row) & held, flow,
                       torch.zeros_like(flow))


def _keyframe_flow(cfg: VOConfig, state: VOState):
    """The flow the eviction compares with KEYFRAME_THRESH
    (Ramp_vo.py:237-243): the mean of the two cells between the candidate
    frame's neighbours n-KEYFRAME_INDEX-1 and n-KEYFRAME_INDEX+1."""
    i = state.n - cfg.KEYFRAME_INDEX - 1
    return 0.5 * (_cell_flow(cfg, state, i, 2)
                  + _cell_flow(cfg, state, i + 2, -2))


def _keyframe_dev(cfg: VOConfig, state: VOState):
    """`_keyframe` with a device `n`: both outcomes computed and the
    eviction selected on the device (ref vo/runtime.py:636-723). The cell
    remap runs on every frame; without an eviction its indices are the
    identity."""
    L, MEM, NI = cfg.BUFFER_SIZE, cfg.MEM, cfg.NI
    F = state.poses.shape[0]
    n = state.n
    dev = state.poses.device
    evict = _keyframe_flow(cfg, state) < cfg.KEYFRAME_THRESH
    k = n - cfg.KEYFRAME_INDEX

    # trajectory delta of the removed frame (Ramp_vo.py:245-249)
    t0g = _take(state.l2g, _clip(k - 1, 0, L - 1))
    t1g = _take(state.l2g, _clip(k, 0, L - 1))
    dP = lops.se3_mul(_take(state.poses, t1g.clamp(0, F - 1)),
                      lops.se3_inv(_take(state.poses, t0g.clamp(0, F - 1))))
    t1 = t1g.clamp(0, F - 1).reshape(1)
    state.delta_parent[t1] = torch.where(evict, t0g, state.delta_parent[t1])
    state.delta_dP[t1] = torch.where(evict, dP, state.delta_dP[t1])

    n_new = n - evict.long()
    _remap_cells(cfg, state, n_new, k, evict)

    # map shifts
    freed = _take(state.slotmap, _clip(k, 0, L - 1))
    fs = freed.clamp(0, MEM - 1).reshape(1)
    state.slot_free[fs] = state.slot_free[fs] | (evict & (freed >= 0))
    shift = evict & (torch.arange(L, device=dev) >= k)
    for x in (state.l2g, state.slotmap):
        x.copy_(torch.where(shift, torch.roll(x, -1), x))

    # age out edges whose host left the removal window (:273-274)
    host_row = host_of_row(torch.arange(NI, device=dev), n_new, NI)
    state.cell_valid &= (host_row >= n_new - cfg.REMOVAL_WINDOW)[:, None]
    state.n.copy_(n_new)


# ---------------------------------------------------------------------------
# frame-level composition
# ---------------------------------------------------------------------------

def _half(cfg: VOConfig, vonet: VONet) -> VONet:
    """The network the frame step runs: a bf16 copy under MIXED_PRECISION
    (the reference's fp16 autocast, Ramp_vo.py:23), else the network."""
    if cfg.MIXED_PRECISION:
        return copy.deepcopy(vonet).to(torch.bfloat16).eval()
    return vonet.eval()


def make_update_fn(cfg: VOConfig, net: VONet, half: bool,
                   layout: str = "reference"):
    """update_fn(net, ctx, corr, ii, jj, kk, valid, lattice) -> (net',
    (delta, weight)) in float32; `half` runs the operator in bf16 (corr
    cast too, in every layout, as the reference's runtime.py:826).
    `layout`: the column layout of `corr` ("reference", "paired" or
    "folded"); its corr_fc1 weight is folded here, once."""
    w1 = None if layout == "reference" else fold_corr_fc1(net, layout)

    def update_fn(h, ctx, corr_in, ii, jj, kk, valid, lattice):
        dt = torch.bfloat16 if half else torch.float32
        h2, (delta, weight) = net.update(
            h.to(dt), ctx.to(dt), corr_in.to(dt), ii, jj, kk, valid, lattice,
            lattice_contig=True, corr_w1=w1)
        return h2.float(), (delta.float(), weight.float())

    return update_fn


def _make_encode_fn(net_h: VONet):
    """encode_fn(events, images, mask, enc_state, heads=True): the encoder
    step of the network the frame step runs (`_half`), its kernel weights
    packed once (the network is frozen). It advances the carry
    `enc_state` in place and returns (fmap/4, imap/4), or (None, None)
    with `heads=False` (events-only frames)."""
    enc = net_h.patchify.encoder
    if net_h.input_mode == "SingleScale":
        packed = singlescale_weights(enc)

        def encode(events, images, mask, enc_state, heads):
            return singlescale_encode(enc, events, images, enc_state, heads,
                                      packed)
    else:
        packed = multiscale_weights(enc)

        def encode(events, images, mask, enc_state, heads):
            return multiscale_encode(enc, events, images, mask, enc_state,
                                     heads, packed)

    @torch.no_grad()
    def encode_fn(events, images, mask, enc_state, heads=True):
        dt = next(net_h.parameters()).dtype
        fmap, imap, enc2 = encode(events.to(dt), images.to(dt), mask,
                                  enc_state, heads)
        _assign(enc_state, enc2)
        if not heads:
            return None, None
        return fmap / 4.0, imap / 4.0

    return encode_fn


def _select_coords(cfg: VOConfig, event_bias: bool, events, images, hw4,
                   sel):
    """The new frame's patch centres [1, M, 2] at 1/4 resolution: the top
    event-density locations of `events` [1, H, W, Ce] (event_bias), else
    ranked by the gradient of `images` (cfg.GRADIENT_BIAS) or uniform, from
    the draws `sel`."""
    if event_bias:
        return select_coords_event_bias(events, cfg.M, nms_rad=11)
    if cfg.GRADIENT_BIAS:
        return select_coords_gradient_bias(images[:1], cfg.M, draws=sel)
    return select_coords_random(1, cfg.M, *hw4, draws=sel)


def _extract(fmap, imap, images, coords):
    """(gmap, imap vectors, patches, colors) of the new frame at `coords`
    (unit disparities, P = 3)."""
    disps = torch.ones((1,) + tuple(fmap.shape[1:3]), dtype=torch.float32,
                       device=fmap.device)
    return extract_patches(fmap.float(), imap.float(), images[:1], disps,
                           coords, P=3)


def make_vo_frame(cfg: VOConfig, vonet: VONet, device="cuda", seed: int = 0,
                  event_bias: bool = True, oracle=None):
    """Build the per-frame step.

    vo_frame(state, events [1, H, W, Ce], images [1, H, W, 3], mask [1]
    (host bool, >= 1 true), intrinsics [4], rand_d [M] or None, sel_draws
    or None) -> state: the host-driven frame. `rand_d` overrides the
    pre-initialization depth draw (tests feed the reference's numbers);
    otherwise a generator seeded with `seed` draws them.
    `vonet` must live on `device`.

    Patch selection, in the reference's priority (ref vo/runtime.py:
    845-862): `event_bias` picks the top event-density locations;
    otherwise cfg.GRADIENT_BIAS ranks random candidates by image gradient,
    else the locations are uniform random. Their integers `sel_draws`
    ((x, y) [1, C], `models.vonet.selection_draws`) are handed in or drawn
    from the seeded generator, before the depths.

    `oracle` (see `_update`) replaces the update network of every update
    the frame runs.

    vo_frame.frame_init(state, events, images, intrinsics, sel) -> state:
    the branchless frame of an initialized state whose `n` and `counter`
    are 0-d int64 tensors on the state's device (mask true); it reads
    nothing on the host, so a CUDA graph can hold it (vo/graph.py).
    Without event_bias `sel` holds its selection draws on the state's
    device; it runs no oracle.
    """
    dev = resolve_device(device)
    net_h = _half(cfg, vonet)
    update_fn = make_update_fn(cfg, net_h, cfg.MIXED_PRECISION,
                               cfg.corr_fc1_layout)
    probe_fn = make_update_fn(cfg, net_h, cfg.MIXED_PRECISION)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)

    encode_fn = _make_encode_fn(net_h)

    def patches(events, images, fmap, imap, sel):
        """Patch selection (`_select_coords`) and extraction: (gmap, imap
        vectors, patches, colors) of the new frame."""
        return _extract(fmap, imap, images, _select_coords(
            cfg, event_bias, events, images, fmap.shape[1:3], sel))

    @torch.no_grad()
    def frame_post(state, events, images, mask, intrinsics, fmap, imap,
                   rand_d=None, sel=None):
        M = cfg.M
        mk = np.asarray(mask).reshape(-1).astype(bool)
        sup = int(np.argmax(mk)) if mk.any() else len(mk) - 1
        with span("vo.frame.patchify"):
            if not event_bias:
                if sel is None:
                    sel = selection_draws(cfg.GRADIENT_BIAS, 1, M,
                                          images.shape[1], images.shape[2],
                                          gen)
                sel = tuple(torch.as_tensor(x, device=dev) for x in sel)
            gmap, ictx, patches_new, clr = patches(events[sup:sup + 1],
                                                   images, fmap, imap, sel)
        with span("vo.frame.commit"):
            if rand_d is None:
                rand_d = torch.rand(M, generator=gen)
            _commit(cfg, state, fmap, gmap, ictx, patches_new, clr,
                    intrinsics, rand_d)

            # motion-probe gate (pre-init only, Ramp_vo.py:384-387)
            if not state.initialized and state.n > 0:
                med = _probe_median(cfg, probe_fn, state)
                if bool(med < cfg.PROBE_THRESH):
                    g = state.counter - 1
                    state.delta_parent[g] = g - 1
                    state.delta_dP[g] = lops.se3_identity((), device=dev)
                    s = state.slotmap[state.n]
                    state.slot_free[s.clamp(0, cfg.MEM - 1)] = True
                    state.slotmap[state.n] = -1
                    return state

            state.n += 1
            _append_edges(cfg, state)
        if not state.initialized and state.n == INIT_FRAMES:
            state.initialized = True
            for _ in range(INIT_UPDATES):
                _update(cfg, update_fn, state, oracle)
        elif state.initialized:
            _update(cfg, update_fn, state, oracle)
            with span("vo.frame.keyframe"):
                _keyframe(cfg, state)
        return state

    def vo_frame(state, events, images, mask, intrinsics, rand_d=None,
                 sel_draws=None):
        events = torch.as_tensor(events, device=dev).float()
        images = torch.as_tensor(images, device=dev).float()
        intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32,
                                     device=dev)
        with span("vo.frame.encoder"):
            fmap, imap = encode_fn(events, images, mask, state.enc)
        return frame_post(state, events, images, mask, intrinsics, fmap, imap,
                          rand_d, sel_draws)

    one = np.ones(1, dtype=bool)

    @torch.no_grad()
    def frame_init(state, events, images, intrinsics, sel=None):
        """The initialized frame with device scalars `n` and `counter`
        (ref vo/runtime.py:838-931 with a true mask): frame_post's commit,
        append, update and keyframe in their branchless forms."""
        if oracle is not None:
            raise ValueError("the branchless frame runs no oracle")
        if not event_bias and sel is None:
            raise ValueError("the branchless frame takes its selection "
                             "draws on the device (sel)")
        with span("vo.frame.encoder"):
            fmap, imap = encode_fn(events, images, one, state.enc)
        with span("vo.frame.patchify"):
            gmap, ictx, patches_new, clr = patches(events, images, fmap,
                                                   imap, sel)
        with span("vo.frame.commit"):
            _commit(cfg, state, fmap, gmap, ictx, patches_new, clr,
                    intrinsics, None)
            state.n.add_(1)
            _append_edges_dev(cfg, state)
        _update(cfg, update_fn, state)
        with span("vo.frame.keyframe"):
            _keyframe_dev(cfg, state)
        return state

    vo_frame.encode_fn = encode_fn
    vo_frame.frame_init = frame_init
    vo_frame.event_bias, vo_frame.oracle = event_bias, oracle
    return vo_frame


def _encode_only(encode_fn):
    """encode_only(state, events, images, mask) -> state over a frame
    step's `encode_fn`: advances the encoder state in place, no heads."""

    def encode_only(state, events, images, mask):
        dev = state.poses.device
        encode_fn(torch.as_tensor(events, device=dev).float(),
                  torch.as_tensor(images, device=dev).float(), mask,
                  state.enc, heads=False)
        return state

    return encode_only


def make_encode_only(cfg: VOConfig, vonet: VONet):
    """Events-only frames: advance the encoder state in place, no VO
    (Ramp_vo.py:338-342). encode_only(state, events, images, mask) ->
    state runs the whole recurrent step of `vonet` (bf16 under
    MIXED_PRECISION, as the frame step; for SingleScale the carried LSTMs
    as well as the super-state); the heads, whose output nobody reads, do
    not run. `vonet` lives on the state's device. RampVO shares its frame
    step's encoder instead (one bf16 copy, one weight packing)."""
    return _encode_only(_make_encode_fn(_half(cfg, vonet)))


def make_final_updates(cfg: VOConfig, vonet: VONet, iters: int = 12,
                       oracle=None):
    """Terminal refinement: `iters` extra updates in float32
    (evaluate.py:254-255), corr_fc1 folded once for cfg.CORR_LAYOUT.
    `oracle` (see `_update`) replaces the correlation and the update
    network of each of them (ref vo/runtime.py:1018-1040)."""
    update_fn = make_update_fn(cfg, vonet.eval(), half=False,
                               layout=cfg.corr_fc1_layout)

    @torch.no_grad()
    def final(state):
        for _ in range(iters):
            _update(cfg, update_fn, state, oracle)
        return state

    return final


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------

class RampVO:
    """Host-side driver mirroring the reference's Ramp_vo API
    (Ramp_vo.py:27-129,327-410).

    vonet: a `VONet` holding the weights (e.g. `ckpt.weights.load_pth`
    loaded into it, or `models.vonet.init_weights`); its `input_mode`
    picks the encoder, and `input_mode`, when given, must agree with it.
    `event_bias=False` selects patches by image gradient
    (cfg.GRADIENT_BIAS) or at random (`make_vo_frame`); `seed` seeds the
    draws.

    `chunk` K > 1 buffers frames and flushes them as the JAX driver does
    (ref vo/runtime.py:1085-1124): a full buffer of an initialized state
    runs as one chunk (`vo.graph.make_vo_frames_chunk`: one CUDA-graph
    replay on the card), a partial buffer or frames before initialization
    frame by frame. Events-only frames, `final_refinement`, `terminate`
    and `point_cloud` flush first; call `flush()` before reading `state`.
    K = 1 runs every frame eagerly as it comes.

    `predict_future_pose` extrapolates the trajectory past the last frame
    (`vo.pose_prediction`)."""

    def __init__(self, cfg: VOConfig, vonet: VONet, input_mode=None,
                 num_event_bins: int = 5, ht: int = 480, wd: int = 640,
                 event_bias: bool = True, seed: int = 0, device="cuda",
                 chunk: int = 1):
        from .graph import make_vo_frames_chunk  # graph.py imports this module

        input_mode = input_mode or vonet.input_mode
        if input_mode != vonet.input_mode:
            raise ValueError(f"input_mode {input_mode} but the network is "
                             f"{vonet.input_mode}")
        if num_event_bins != vonet.evs_ch:
            raise ValueError(f"num_event_bins {num_event_bins} but the "
                             f"network takes {vonet.evs_ch} event channels")
        self.cfg = cfg
        self.device = resolve_device(device)
        # a copy of its own: moving the caller's module to the device
        # would change the caller's object
        self.vonet = copy.deepcopy(vonet).to(self.device).eval()
        self.ht, self.wd = ht, wd
        self.tlist: list = []
        # pose-prediction caches (Ramp_vo.py:34-35)
        self._pp_tracks = None
        self._pp_models = None
        self.state = init_state(
            cfg, make_enc_state(cfg, input_mode, ht, wd, self.device), ht, wd,
            device=self.device)
        self._vo_frame = make_vo_frame(cfg, self.vonet, self.device, seed,
                                       event_bias)
        self._encode_only = _encode_only(self._vo_frame.encode_fn)
        self.chunk = max(int(chunk), 1)
        self._buf: list = []
        self._vo_chunk = (
            make_vo_frames_chunk(cfg, self.vonet, self.chunk, self.device,
                                 frame=self._vo_frame, seed=seed)
            if self.chunk > 1 else None)

    def flush(self):
        """Run the buffered frames (chunked mode)."""
        buf, self._buf = self._buf, []
        if len(buf) == self.chunk and self.state.initialized:
            # the chunk stacks the frames (in its vo.chunk.stage span)
            sel = None
            if all(b[5] is not None for b in buf):
                sel = [[b[5][i] for b in buf] for i in (0, 1)]
            self._vo_chunk(self.state, [b[0] for b in buf],
                           [b[1] for b in buf], buf[0][3], sel)
            return
        for events, image, mask, intrinsics, rand_d, sel in buf:
            self._vo_frame(self.state, events, image, mask, intrinsics,
                           rand_d, sel)

    def __call__(self, tstamp, events, image, mask, intrinsics, rand_d=None,
                 sel_draws=None):
        """events [T, H, W, C] (T == 1), image [1, H, W, 3] normalized, mask
        [T] host bool array, intrinsics [4]. `rand_d` [M] overrides the
        pre-initialization depth draw and `sel_draws` (x, y) [1, C] the
        selection draws of a frame without event_bias."""
        mask = np.asarray(mask).reshape(-1).astype(bool)
        if not mask.any():
            self.flush()
            self._encode_only(self.state, events, image, mask)
            return
        self.tlist.append(tstamp)
        if self.chunk > 1:
            self._buf.append((events, image, mask, intrinsics, rand_d,
                              sel_draws))
            if len(self._buf) == self.chunk:
                self.flush()
            return
        self._vo_frame(self.state, events, image, mask, intrinsics, rand_d,
                       sel_draws)

    def predict_future_pose(self, sec_to_pred_future, abs_time,
                            last_keyframe_number, deg=4, frequency=30.0):
        """Spline-based future-pose extrapolation (Ramp_vo.py:446-514): one
        virtual frame appended to the trajectory; returns its pose [7]
        (world-to-camera)."""
        self.flush()
        from .pose_prediction import predict_future_pose

        return predict_future_pose(self, sec_to_pred_future, abs_time,
                                   last_keyframe_number, deg=deg,
                                   frequency=frequency)

    def final_refinement(self, iters: int = 12):
        """`iters` terminal update iterations (evaluate.py:254-255)."""
        self.flush()
        if iters > 0:
            make_final_updates(self.cfg, self.vonet, iters)(self.state)

    def point_cloud(self):
        """World-space patch-center point cloud and colors of every
        committed frame for export (Ramp_vo.py:308-310,
        evaluate.py:256-258): numpy [counter * M, 3] each."""
        self.flush()
        st = self.state
        c = st.counter
        poses = st.poses[:c]                       # world-to-camera
        fx, fy, cx, cy = st.intrinsics.unbind(-1)
        d = st.pat_d[:c]
        X0 = torch.stack([(st.pat_cx[:c] - cx) / fx, (st.pat_cy[:c] - cy) / fy,
                          torch.ones_like(d), d], dim=-1)
        X1 = lops.se3_act4(lops.se3_inv(poses)[:, None, :], X0)
        pts = X1[..., :3] / torch.clamp(X1[..., 3:], min=1e-8)
        return (pts.reshape(-1, 3).cpu().numpy(),
                st.colors[:c].reshape(-1, 3).cpu().numpy())

    def terminate(self):
        """Interpolate removed/skipped frames through the delta chain and
        return (poses [N, 7] camera-to-world, tstamps [N])
        (Ramp_vo.py:162-173)."""
        self.flush()
        st = self.state
        n, counter = st.n, st.counter
        l2g = st.l2g[:n].cpu().numpy()
        poses = st.poses.cpu()
        parent = st.delta_parent.cpu().numpy()
        dP = st.delta_dP.cpu()
        traj = {int(g): poses[int(g)] for g in l2g if g >= 0}

        def get_pose(t):
            if t not in traj:
                traj[t] = lops.se3_mul(dP[t], get_pose(int(parent[t])))
            return traj[t]

        out = torch.stack([get_pose(t) for t in range(counter)])
        return (lops.se3_inv(out).numpy(),
                np.array(self.tlist, dtype=float))
