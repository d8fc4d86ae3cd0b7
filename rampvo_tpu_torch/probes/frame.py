"""The VO frame with stages removed (port of the variants of
scripts/probe_frame_ablate.py, probe_update_ablate.py and
probe_commit_ablate.py): what a frame costs without one stage, so that
differences against the whole frame split its time by stage.

`make_probe_frame(cfg, vonet, device, **flags)` returns a step with the
contract of `make_vo_frame(...)`'s branchless initialized frame: its
`frame_init(state, events, images, intrinsics, sel=None)` runs on a state
whose `n` and `counter` are 0-d device tensors and reads nothing on the
host, so `vo.graph.make_vo_frames_chunk(cfg, vonet, K, frame=step)`
captures K of them as one CUDA graph, as it captures the production frame.
It is built from the production frame's own pieces (`vo/runtime.py`:
`_make_encode_fn`, `make_update_fn`, `_select_coords`, `_extract`,
`_commit`, `_append_edges_dev`, `_update`, `_keyframe_dev`), and with no
flag set it runs exactly the production frame (event-biased selection).

A removed stage is not run at all, so its kernels are not launched: under
`corr=False` the update never calls the correlation kernel (K1 under
fused3), under `encoder=False` the encoder chain (K2 or K3) and its heads
never run. The JAX scripts leave that to XLA's dead-code elimination.

The update's oracle. `frame_init` of `make_vo_frame` refuses a host-side
oracle, and so does the chunk, because a Python oracle cannot sit inside a
graph capture. Both refusals stay. The probe's oracle is fixed and runs on
the device: a zero flow `delta` and a unit `weight`, made with
`torch.zeros`/`torch.ones` on the state's device; the step exposes
`oracle = None` to the chunk because nothing of it runs on the host.

Flags (their meaning in the JAX scripts):
  encoder   False: fmap and imap are zeros of the production dtype and
            shape, the encoder state is not advanced;
  select    False: patches on a fixed grid (probe_commit_ablate.py's);
  extract   False (needs select=False): zero patches, features, colors;
  commit    False (needs extract=False): nothing is written for the frame;
  update    False: no update at all;
  corr      False: no correlation; with the net, the net reads zeros
            (zero_corr); without it, BA runs on the oracle (oracle);
  net       False: the update network is not run: BA runs on the oracle's
            targets (with corr, the correlation is computed and dropped);
  ba_iters  Gauss-Newton iterations of BA in place of cfg.BA_ITERS;
  keyframe  False: no keyframe step (no eviction, no aging out).
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from .. import resolve_device
from ..models.vonet import VONet
from ..vo.config import VOConfig
from ..vo.runtime import (
    DIM,
    _append_edges_dev,
    _commit,
    _extract,
    _fdt,
    _half,
    _keyframe_dev,
    _lattice_corr,
    _make_encode_fn,
    _select_coords,
    _update,
    make_update_fn,
)

# the variants of the JAX scripts: name -> flags of make_probe_frame
VARIANTS = {
    "all": {},                                            # frame_ablate :185
    "no_kf": dict(keyframe=False),                        # :186
    "no_update": dict(update=False),                      # :187
    "oracle": dict(corr=False, net=False),                # :188
    "zero_corr": dict(corr=False),                        # :189
    "no_encoder": dict(encoder=False),                    # :190
    "oracle_ba1": dict(corr=False, net=False, ba_iters=1),  # :193-194
    "oracle_ba0": dict(corr=False, net=False, ba_iters=0),  # :195-196
    "corr_only": dict(net=False),                         # update_ablate :178
    "no_ba": dict(ba_iters=0),                            # :180
    "no_select": dict(select=False),                      # commit_ablate :149
    "no_extract": dict(select=False, extract=False),      # :150
    "no_commit": dict(select=False, extract=False, commit=False),  # :151
}

CORR_WIDTH = {"fused2": 1152}       # columns of corr_in; 882 otherwise


def check_flags(encoder=True, select=True, extract=True, commit=True,
                update=True, corr=True, net=True, ba_iters=None,
                keyframe=True):
    """Raise ValueError on a combination the JAX scripts do not define."""
    if not extract and select:
        raise ValueError("extract=False drops the patches select=True "
                         "picks: the commit variants are cumulative")
    if not commit and extract:
        raise ValueError("commit=False drops what extract=True gathers: "
                         "the commit variants are cumulative")
    if not update and (not corr or not net or ba_iters is not None):
        raise ValueError("corr, net and ba_iters split the update, which "
                         "update=False removes")
    if ba_iters is not None and (not isinstance(ba_iters, int)
                                 or ba_iters < 0):
        raise ValueError(f"ba_iters must be a count >= 0, not {ba_iters!r}")


def grid_coords(M: int, hw4, device):
    """probe_commit_ablate.py's fixed patch grid [1, M, 2]: 12 a row, 12
    px apart from (4, 4), clamped into a smaller map."""
    g = torch.arange(M, device=device, dtype=torch.float32)
    x = (4.0 + torch.remainder(g, 12) * 12.0).clamp(max=hw4[1] - 1)
    y = (4.0 + torch.div(g, 12, rounding_mode="floor") * 12.0).clamp(
        max=hw4[0] - 1)
    return torch.stack([x, y], dim=-1)[None]


def unit_oracle(state, ii, jj, kk, coords):
    """The probe's oracle: zero flow and unit weight [E, 2], on the
    device."""
    E = coords.shape[0]
    return (torch.zeros((E, 2), dtype=torch.float32, device=coords.device),
            torch.ones((E, 2), dtype=torch.float32, device=coords.device))


def zero_corr(cfg: VOConfig, gmap_r, *args):
    """`_lattice_corr`'s output shape and dtype, zeros, no kernel."""
    NI, T, M = args[-1]
    return torch.zeros((NI * T * M, CORR_WIDTH.get(cfg.CORR_LAYOUT, 882)),
                       dtype=gmap_r.dtype, device=gmap_r.device)


def make_probe_frame(cfg: VOConfig, vonet: VONet, device="cuda", *,
                     encoder: bool = True, select: bool = True,
                     extract: bool = True, commit: bool = True,
                     update: bool = True, corr: bool = True,
                     net: bool = True, ba_iters=None,
                     keyframe: bool = True):
    """The branchless initialized frame with the stages the flags remove
    (module docstring); `vonet` lives on `device`. Returns a step for
    `make_vo_frames_chunk(frame=)`: `frame_init`, `encode_fn`,
    `event_bias` (True), `oracle` (None) and `flags`."""
    flags = dict(encoder=encoder, select=select, extract=extract,
                 commit=commit, update=update, corr=corr, net=net,
                 ba_iters=ba_iters, keyframe=keyframe)
    check_flags(**flags)
    dev = resolve_device(device)
    net_h = _half(cfg, vonet)
    encode_fn = _make_encode_fn(net_h)
    ucfg = cfg if ba_iters is None else dataclasses.replace(
        cfg, BA_ITERS=ba_iters)
    if net:
        update_fn = make_update_fn(cfg, net_h, cfg.MIXED_PRECISION,
                                   cfg.corr_fc1_layout)
        oracle = None
    elif corr:
        # the correlation runs and is dropped; BA reads the oracle
        def update_fn(h, ctx, corr_in, ii, jj, kk, valid, lattice):
            return None, unit_oracle(None, ii, jj, kk, corr_in)  # E rows
        oracle = None
    else:
        update_fn, oracle = None, unit_oracle
    corr_fn = _lattice_corr if corr else zero_corr
    one = np.ones(1, dtype=bool)
    M, P = cfg.M, 3

    @torch.no_grad()
    def frame_init(state, events, images, intrinsics, sel=None):
        hw4 = state.hw4
        if encoder:
            fmap, imap = encode_fn(events, images, one, state.enc)
        else:
            dt = _fdt(cfg)
            fmap = torch.zeros((1,) + tuple(hw4) + (128,), dtype=dt,
                               device=dev)
            imap = torch.zeros((1,) + tuple(hw4) + (DIM,), dtype=dt,
                               device=dev)
        if extract:
            coords = (_select_coords(cfg, True, events, images, hw4, None)
                      if select else grid_coords(M, hw4, dev))
            gmap, ictx, patches_new, clr = _extract(fmap, imap, images,
                                                    coords)
        if commit:
            if not extract:
                z = lambda *s: torch.zeros(s, dtype=torch.float32,
                                           device=dev)
                gmap, ictx = z(1, M, P, P, 128), z(1, M, DIM)
                patches_new, clr = z(1, M, 3, P, P), z(1, M, 3)
            _commit(cfg, state, fmap, gmap, ictx, patches_new, clr,
                    intrinsics, None)
        state.n.add_(1)
        _append_edges_dev(cfg, state)
        if update:
            _update(ucfg, update_fn, state, oracle, corr_fn)
        if keyframe:
            _keyframe_dev(cfg, state)
        return state

    return types.SimpleNamespace(frame_init=frame_init, encode_fn=encode_fn,
                                 event_bias=True, oracle=None, flags=flags)
