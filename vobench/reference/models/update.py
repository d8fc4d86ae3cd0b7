"""The edge-wise recurrent update operator (port of
rampvo_tpu/models/update.py; ref ramp/net.py:34-90).

Submodule names are the reference's, so `state_dict()` keys are the .pth
keys (update.corr.0, update.agg_kk.f, update.gru.1.gate.0, ...).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.neighbors import neighbors
from .blocks import GatedResidual, GradClip, SoftAgg

DIM = 384  # net.py:31


class Update(nn.Module):
    def __init__(self, p: int = 3):
        super().__init__()
        self.c1 = nn.Sequential(nn.Linear(DIM, DIM), nn.ReLU(),
                                nn.Linear(DIM, DIM))
        self.c2 = nn.Sequential(nn.Linear(DIM, DIM), nn.ReLU(),
                                nn.Linear(DIM, DIM))
        self.norm = nn.LayerNorm(DIM, eps=1e-3)
        self.agg_kk = SoftAgg(DIM)
        self.agg_ij = SoftAgg(DIM)
        self.gru = nn.Sequential(
            nn.LayerNorm(DIM, eps=1e-3), GatedResidual(DIM),
            nn.LayerNorm(DIM, eps=1e-3), GatedResidual(DIM),
        )
        self.corr = nn.Sequential(
            nn.Linear(2 * 49 * p * p, DIM), nn.ReLU(), nn.Linear(DIM, DIM),
            nn.LayerNorm(DIM, eps=1e-3), nn.ReLU(), nn.Linear(DIM, DIM),
        )
        # index 2 of d (and of w) is the reference's GradientClip: the
        # identity going forward, NaN-zeroed and clamped gradients back
        self.d = nn.Sequential(nn.ReLU(), nn.Linear(DIM, 2), GradClip())
        self.w = nn.Sequential(nn.ReLU(), nn.Linear(DIM, 2), GradClip(),
                               nn.Sigmoid())

    def forward(self, net, inp, corr, ii, jj, kk, valid=None, lattice=None,
                lattice_contig: bool = False, agg_ids=None, corr_w1=None):
        """net [E, DIM]; corr [E, 882] (reference layout); ii/jj/kk [E].

        `corr_w1`: the first correlation weight folded for another layout
        of `corr` (`models.vonet.fold_corr_fc1`); None reads the reference
        layout with `corr.0`'s own weight.

        `lattice=(NI, T, M)`: the edge set is the full lattice in row-major
        order; `inp` may then arrive t-compressed as [NI*M, DIM]. Only the
        `lattice_contig=True` form is ported: each row's valid cells form a
        contiguous t-range (true in the VO runtime by construction), so the
        temporal neighbours are t-axis shifts. Without a lattice the flat
        path sorts by (kk, jj) for the neighbours.

        `agg_ids` (a static edge schedule, the training forward): the two
        SoftAgg groups' dense ids (kk ranks, (ii, jj) ranks), compacted
        once, so no torch.unique (a host sync) runs per call."""
        if lattice is not None and not lattice_contig:
            raise NotImplementedError("lattice updates need lattice_contig")
        if corr_w1 is None:
            cf = self.corr(corr)
        else:
            cf = self.corr[1:](F.linear(corr, corr_w1, self.corr[0].bias))
        if lattice is not None and inp.shape[0] != net.shape[0]:
            NI, T, M = lattice
            net = (net.reshape(NI, T, M, -1) + inp.reshape(NI, 1, M, -1)
                   + cf.reshape(NI, T, M, -1)).reshape(net.shape[0], -1)
        else:
            net = net + inp + cf
        net = self.norm(net)

        if lattice is not None:
            NI, T, M = lattice
            cellv = (torch.ones((NI, T), dtype=torch.bool, device=net.device)
                     if valid is None else valid.reshape(NI, T, M)[:, :, 0])
            nl = net.reshape(NI, T, M, -1)
            z = torch.zeros_like(nl[:, :1])
            no = torch.zeros((NI, 1), dtype=torch.bool, device=net.device)
            pm = torch.cat([no, cellv[:, :-1]], 1).to(net.dtype)[:, :, None, None]
            nm = torch.cat([cellv[:, 1:], no], 1).to(net.dtype)[:, :, None, None]
            prev = torch.cat([z, nl[:, :-1]], dim=1)
            net = net + self.c1((pm * prev).reshape(net.shape))
            # c2 reads the net AFTER the c1 update (ref net.py:77-82)
            nl2 = net.reshape(NI, T, M, -1)
            nxt = torch.cat([nl2[:, 1:], z], dim=1)
            net = net + self.c2((nm * nxt).reshape(net.shape))
        else:
            ix, jx = neighbors(kk, jj, valid=valid)
            E = net.shape[0]
            mask_ix = (ix >= 0).to(net.dtype)[:, None]
            mask_jx = (jx >= 0).to(net.dtype)[:, None]
            net = net + self.c1(mask_ix * net[ix.clamp(0, E - 1)])
            net = net + self.c2(mask_jx * net[jx.clamp(0, E - 1)])

        pre = agg_ids is not None
        kk_ids, ij_ids = agg_ids if pre else (kk, ii.long() * 12345 + jj.long())
        net = net + self.agg_kk(net, kk_ids, valid=valid, lattice=lattice,
                                axis=1, precompacted=pre)
        net = net + self.agg_ij(net, ij_ids, valid=valid, lattice=lattice,
                                axis=2, precompacted=pre)
        net = self.gru(net)
        return net, (self.d(net), self.w(net))
