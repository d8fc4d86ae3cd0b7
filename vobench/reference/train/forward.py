"""The unrolled training forward, plain (frozen copy of the port's
train/forward.py; ref ramp/net.py:252-378). Edit against the port's file:
the two-level correlation is the plain `corr_train` of ops/corr.py
(`corr_train_plain`) where the port launches K7 forward and K8 backward.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ba.core import ba_train
from ..geometry.projective import transform_edges
from ..lie import ops as lops
from ..models.vonet import (
    extract_patches,
    select_coords_event_bias,
    select_coords_gradient_bias,
    select_coords_random,
    selection_draws,
)
from ..ops.corr import avg_pool2d, corr_stack, corr_train
from .loss import masked_norm, pose_loss_terms

DIM = 384
KEEP_P = 0.2   # corr gradient keep probability (altcorr/correlation.py:35-40)
ABLATE = frozenset({"corr", "encoder", "ba", "update"})


def corr_train_plain(gmap, fmap1, fmap2, coords, kk, jj):
    """The two-level training correlation, plain (the port's
    `corr_train_ref`): level 1 (fmap1, coords) and level 2 (fmap2,
    coords / 4), stacked level-fastest, [E, 882]."""
    c1 = corr_train(gmap, fmap1, coords, kk, jj, 3)
    c2 = corr_train(gmap, fmap2, coords / 4.0, kk, jj, 3)
    return corr_stack(c1, c2)


class _CorrGradDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep):
        ctx.save_for_backward(keep)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (keep,) = ctx.saved_tensors
        return g * keep.to(g.dtype), None


def corr_grad_dropout(x, keep1, keep2):
    """Identity on the stacked correlation [E, 2*L] (level fastest, the
    reference layout); going backward each edge keeps its level-1 gradient
    where keep1 [E] is set and its level-2 gradient where keep2 is (ref
    forward.py::corr_grad_dropout, applied per level before corr_stack)."""
    lvl = torch.arange(x.shape[1], device=x.device) % 2
    keep = torch.where(lvl[None, :] == 0, keep1[:, None], keep2[:, None])
    return _CorrGradDropout.apply(x, keep)


class EdgeSchedule(NamedTuple):
    ii: np.ndarray           # [E]
    jj: np.ndarray           # [E]
    kk: np.ndarray           # [E]
    created_at: np.ndarray   # [E] step at which the edge appears
    n_pre: np.ndarray        # [steps] frames before insertion
    n_post: np.ndarray       # [steps] frames after insertion
    insert: np.ndarray       # [steps] bool: a frame is inserted this step


def edge_schedule(n_frames: int, M: int, steps: int) -> EdgeSchedule:
    """net.py:281,306-340's edge growth as static arrays."""
    ii, jj, kk, created = [], [], [], []

    def add(i, j, q, s):
        ii.append(i), jj.append(j), kk.append(q), created.append(s)

    for q in range(8 * M):            # patches of frames < 8 x frames 0..7
        for j in range(8):
            add(q // M, j, q, 0)
    n = 8
    n_pre, n_post, insert = [], [], []
    for s in range(steps):
        n_pre.append(n)
        ins = s >= 8 and n < n_frames
        insert.append(ins)
        if ins:
            for q in range(n * M):                 # old patches x {n}
                add(q // M, n, q, s)
            for q in range(n * M, (n + 1) * M):    # new patches x 0..n
                for j in range(n + 1):
                    add(q // M, j, q, s)
            n += 1
        n_post.append(n)
    i32 = lambda a: np.asarray(a, np.int32)
    return EdgeSchedule(i32(ii), i32(jj), i32(kk), i32(created), i32(n_pre),
                        i32(n_post), np.asarray(insert, bool))


def nanmedian_pair(x):
    """Median of a flat tensor as jnp.nanmedian takes it for an even count:
    the mean of the two middle values (torch.median returns the lower)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


class TrainForward:
    """The unrolled forward of one training window.

    __call__(events, images, poses, disps, intrinsics, mask, structure_only,
    generator, draws) -> (loss, metrics {loss, px1, flow_e, ro, tr}), with
    events [T, H, W, Ce], images [NF, H, W, 3], poses [NF, 7]
    world-to-camera, disps [NF, H, W], intrinsics [NF, 4], mask [T] bool
    (NF true entries). Gradients reach `vonet`'s parameters. Patches are
    selected by event density (`event_bias`), else by image gradient
    (`gradient_bias`), else at random (ref net.py:164-188).

    `ablate` takes stages out to split a step's time, with the JAX
    probes' meanings (rampvo_tpu/train/forward.py, read by
    scripts/probe_train_ablate.py; here by `cli.bench --train --ablate`):
    "corr" makes corr_in zeros that keep the coordinates in the graph (no
    K7 or K8 launch, the keep masks unread), "encoder" makes the feature
    maps zeros at H/4 x W/4, "ba" skips both BA iterations, "update" sets
    delta = 0 * corr and weight = 1 in place of the update operator."""

    def __init__(self, vonet, n_frames: int, M: int = 80, steps: int = 18,
                 flow_weight: float = 0.1, pose_weight: float = 10.0,
                 P: int = 3, event_bias: bool = True,
                 gradient_bias: bool = False,
                 ablate: frozenset = frozenset()):
        self.vonet = vonet
        self.n_frames = n_frames
        self.M = M
        self.steps = steps
        self.P = P
        self.flow_weight = flow_weight
        self.pose_weight = pose_weight
        self.event_bias = event_bias
        self.gradient_bias = gradient_bias
        self.ablate = frozenset(ablate)
        if not self.ablate <= ABLATE:
            raise ValueError(f"unknown ablate probes {sorted(self.ablate)}")
        self.sched = edge_schedule(n_frames, M, steps)
        s = self.sched
        ij = s.ii.astype(np.int64) * 12345 + s.jj
        # the SoftAgg groups' dense ids, compacted once for the whole table
        self._agg_ids = (np.unique(s.kk, return_inverse=True)[1],
                         np.unique(ij, return_inverse=True)[1])
        self._dev = {}

    @property
    def E(self) -> int:
        return int(self.sched.ii.shape[0])

    def _tables(self, device):
        """The schedule's tensors on `device`, made once."""
        if device not in self._dev:
            t = lambda a: torch.as_tensor(np.asarray(a), device=device)
            s = self.sched
            self._dev[device] = (
                t(s.ii).long(), t(s.jj).long(), t(s.kk).long(),
                t(s.created_at).long(),
                tuple(t(v).long() for v in self._agg_ids))
        return self._dev[device]

    def draw(self, generator, device, ht: int, wd: int):
        """Every random number of one window of ht x wd frames, from
        `generator`."""
        g = generator
        E, NM = self.E, self.n_frames * self.M
        rand = lambda *s: torch.rand(*s, generator=g, device=g.device).to(
            device)
        out = {"depth": rand(NM), "drop": rand(self.steps),
               "keep1": rand(self.steps, E) < KEEP_P,
               "keep2": rand(self.steps, E) < KEEP_P}
        if not self.event_bias:
            out["sel"] = tuple(x.to(device) for x in selection_draws(
                self.gradient_bias, self.n_frames, self.M, ht, wd, g))
        return out

    def _encode(self, events, images, mask):
        """The window encoder, recomputed in the backward pass (the
        reference's jax.checkpoint(_encode)): its activations at 480x640
        would otherwise stay alive through all unrolled steps."""
        enc = lambda ev, im: self.vonet.encode(ev, im, mask, self.n_frames)
        if torch.is_grad_enabled():
            return checkpoint(enc, events, images, use_reentrant=False)
        return enc(events, images)

    def __call__(self, events, images, poses, disps, intrinsics, mask,
                 structure_only: bool = False, generator=None, draws=None):
        M, P, NF = self.M, self.P, self.n_frames
        dev = events.device
        ii, jj, kk, created, agg_ids = self._tables(dev)
        E = self.E
        if draws is None:
            if generator is None:
                raise ValueError("TrainForward: give a generator or draws")
            draws = self.draw(generator, dev, *images.shape[1:3])
        intr4 = intrinsics[0] / 4.0            # shared pinhole at 1/4 res
        intr_frames = intr4.expand(NF, 4)

        if "encoder" in self.ablate:
            h4, w4 = events.shape[1] // 4, events.shape[2] // 4
            fmap = torch.zeros((NF, h4, w4, 128), device=dev)
            imap_full = torch.zeros((NF, h4, w4, DIM), device=dev)
        else:
            fmap, imap_full = self._encode(events, images, mask)
            fmap, imap_full = fmap.float(), imap_full.float()

        sup = [t for t, v in enumerate(torch.as_tensor(mask).tolist()) if v]
        sup = (sup + [events.shape[0] - 1] * NF)[:NF]
        if self.event_bias:
            coords = select_coords_event_bias(events[sup], M, nms_rad=11)
        elif self.gradient_bias:
            coords = select_coords_gradient_bias(images, M,
                                                 draws=draws["sel"])
        else:
            coords = select_coords_random(NF, M, *fmap.shape[1:3],
                                          draws=draws["sel"])
        gmap, imap, patches0, _ = extract_patches(
            fmap, imap_full, images, disps[:, 1::4, 1::4], coords, P=P)
        gmap_flat = gmap.reshape(NF * M, P, P, 128)
        imap_flat = imap.reshape(NF * M, DIM)
        pyr1 = fmap.contiguous()             # the kernels' layout, once
        pyr2 = avg_pool2d(pyr1, 4).contiguous()
        h4, w4 = fmap.shape[1], fmap.shape[2]
        bounds = (-64.0, -64.0, w4 + 64.0, h4 + 64.0)

        patches_gt = patches0.reshape(NF * M, 3, P, P)
        depth0 = draws["depth"].to(patches_gt.dtype)[:, None, None].expand(
            NF * M, P, P)
        patches = torch.cat([patches_gt[:, :2], depth0[:, None]], dim=1)
        Gs = poses.clone() if structure_only else lops.se3_identity(
            (NF,), dtype=torch.float32, device=dev)
        net = torch.zeros((E, DIM), dtype=torch.float32, device=dev)
        valid = created == 0
        dij = (ii - jj).abs()
        coords_g = transform_edges(poses[ii], poses[jj], patches_gt[kk], intr4)
        Zg = self._depth_of(poses, patches_gt, intr4, ii, jj, kk)

        outs = []
        for s in range(self.steps):
            n_pre = int(self.sched.n_pre[s])
            n_post = int(self.sched.n_post[s])
            Gs = Gs.detach()
            patches = patches.detach()
            if self.sched.insert[s]:
                Gs, patches, valid = self._insert(
                    Gs, patches, valid, s, n_pre, draws["drop"][s],
                    structure_only, ii, jj, created)

            coords_e = transform_edges(Gs[ii], Gs[jj], patches[kk], intr4)
            if "corr" in self.ablate:
                corr_in = torch.zeros((E, 2 * P * P * 49), device=dev) \
                    + 0.0 * coords_e.sum()
            else:
                corr_in = corr_train_plain(gmap_flat, pyr1, pyr2, coords_e,
                                           kk, jj)
                corr_in = corr_grad_dropout(corr_in, draws["keep1"][s],
                                            draws["keep2"][s]).float()
            if "update" in self.ablate:
                delta = 0.0 * corr_in[:, :2]
                weight = torch.ones_like(delta)
            else:
                net, (delta, weight) = self.vonet.update(
                    net, imap_flat[kk], corr_in, ii, jj, kk, valid,
                    agg_ids=agg_ids)
            target = coords_e[:, P // 2, P // 2, :] + delta
            wgt = weight * valid[:, None].to(weight.dtype)
            for _ in range(0 if "ba" in self.ablate else 2):
                Gs, patches = ba_train(
                    Gs, patches, intr_frames, target, wgt, 1e-4, ii, jj, kk,
                    bounds, ep=10.0, fixedp=1, structure_only=structure_only,
                    valid=valid)

            # per-step loss (net.py:369-377 + train.py:29-65)
            lmask = valid & (dij > 0) & (dij <= 2)
            coords_p = transform_edges(Gs[ii], Gs[jj], patches[kk], intr4)
            vg = (Zg > 0.2) & lmask
            diff = coords_p - coords_g
            e_pp = masked_norm(diff, vg[:, None, None].expand(diff.shape[:-1]))
            e_min = e_pp.reshape(E, P * P).amin(dim=-1)
            wv = vg.to(e_pp.dtype)
            flow_e = (e_min * wv).sum() / torch.clamp(wv.sum(), min=1.0)
            tr, ro = pose_loss_terms(Gs, poses, n_post)
            use_pose = float(not structure_only and s >= 2)
            step_loss = self.flow_weight * flow_e + (
                self.pose_weight * use_pose * (tr + ro))
            outs.append((step_loss, flow_e, tr, ro))

        loss = torch.stack([o[0] for o in outs]).sum()
        px1 = ((e_min < 0.25).to(wv.dtype) * wv).sum() / torch.clamp(
            wv.sum(), min=1.0)
        _, flow_e, tr, ro = outs[-1]
        return loss, {"loss": loss, "px1": px1, "flow_e": flow_e, "ro": ro,
                      "tr": tr}

    def _insert(self, Gs, patches, valid, s, n_pre, u_drop, structure_only,
                ii, jj, created):
        """Frame n_pre enters (net.py:306-340): motion-model pose, its new
        edges, the random drop of edges touching frame n_pre - 4 (p = 0.1),
        and the new patches' depth = median of the previous two frames'."""
        M = self.M
        if not structure_only:
            P1, P2 = Gs[n_pre - 1], Gs[n_pre - 2]
            xi = 0.5 * lops.se3_log(lops.se3_mul(P1, lops.se3_inv(P2)))
            boot = lops.se3_mul(lops.se3_exp(xi), P1)
            Gs = torch.cat([Gs[:n_pre], boot[None], Gs[n_pre + 1:]])
        valid = valid | (created == s)
        dropped = (ii == n_pre - 4) | (jj == n_pre - 4)
        valid = torch.where(u_drop < 0.1, valid & ~dropped, valid)
        med = nanmedian_pair(patches[(n_pre - 2) * M:n_pre * M, 2])
        d = patches[:, 2].clone()
        d[n_pre * M:(n_pre + 1) * M] = med
        patches = torch.cat([patches[:, :2], d[:, None]], dim=1)
        return Gs, patches, valid

    def _depth_of(self, G, ptc, intr, ii, jj, kk):
        """Z of each edge's patch center in the target frame."""
        P = self.P
        fx, fy, cx, cy = intr.unbind(-1)
        pk = ptc[kk]
        x, y, d = (pk[:, c, P // 2, P // 2] for c in range(3))
        X0 = torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(d),
                          d], dim=-1)
        Gij = lops.se3_mul(G[jj], lops.se3_inv(G[ii]))
        return lops.se3_act4(Gij, X0)[:, 2]
