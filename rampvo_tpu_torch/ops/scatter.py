"""Segment ops: softmax-weighted aggregation over index groups (port of
rampvo_tpu/ops/scatter.py, replacing the reference's torch_scatter)."""

from __future__ import annotations

import torch


def _rows(mask, x):
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def segment_softmax(x, seg_ids, num_segments: int, valid=None):
    """Softmax over rows sharing a segment id. x [E, D]; seg_ids [E] in
    [0, num_segments); invalid rows get weight 0 and do not affect their
    segment."""
    ninf = torch.full_like(x, float("-inf"))
    if valid is not None:
        x = torch.where(_rows(valid, x), x, ninf)
    idx = seg_ids.long()[:, None].expand_as(x)
    seg_max = torch.full((num_segments, x.shape[1]), float("-inf"),
                         dtype=x.dtype, device=x.device)
    seg_max = seg_max.scatter_reduce(0, idx, x, reduce="amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    ex = torch.exp(x - seg_max[seg_ids.long()])
    if valid is not None:
        ex = torch.where(_rows(valid, ex), ex, torch.zeros_like(ex))
    denom = torch.zeros((num_segments, x.shape[1]), dtype=x.dtype,
                        device=x.device).index_add_(0, seg_ids.long(), ex)
    return ex / torch.clamp(denom, min=1e-20)[seg_ids.long()]


def segment_sum(x, seg_ids, num_segments: int, valid=None):
    if valid is not None:
        x = torch.where(_rows(valid, x), x, torch.zeros_like(x))
    out = torch.zeros((num_segments,) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg_ids.long(), x)


def segment_mean(x, seg_ids, num_segments: int, valid=None):
    """Mean of the valid rows of each segment (zero where none)."""
    s = segment_sum(x, seg_ids, num_segments, valid)
    ones = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    cnt = segment_sum(ones, seg_ids, num_segments, valid)
    return s / _rows(torch.clamp(cnt, min=1.0), s)


def compact_ids(ids):
    """Dense ranks of arbitrary ids (torch.unique's inverse index)."""
    return torch.unique(ids, return_inverse=True)[1]
