"""VONet: encoder + update operator, and the parameter-free patch selection
and extraction (port of rampvo_tpu/models/vonet.py; ref ramp/net.py).

`VONet` holds `patchify.encoder` and `update` under the reference's module
names, so its `state_dict()` keys are the published .pth keys. Feature maps
are channels-last [n, h, w, C]; patches channels-first [n, M, 3, P, P].
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.corr import avg_pool2d, corr, corr_stack, pyramidify
from ..ops.corr import patchify as gather_patches
from ..ops.corr_perms import folded_corr_perm, paired_corr_perm
from .encoders import MultiScaleEncoder, SingleScaleEncoder
from .update import Update

INPUT_MODES = {"MultiScale": MultiScaleEncoder,
               "SingleScale": SingleScaleEncoder}


class Patchifier(nn.Module):
    """Encoder holder (ref net.py:128-157)."""

    def __init__(self, input_mode: str = "MultiScale", evs_ch: int = 5,
                 img_ch: int = 3):
        super().__init__()
        if input_mode not in INPUT_MODES:
            raise ValueError(f"Invalid input mode: {input_mode}")
        self.encoder = INPUT_MODES[input_mode](evs_ch, img_ch)


class VONet(nn.Module):
    def __init__(self, input_mode: str = "MultiScale", evs_ch: int = 5,
                 img_ch: int = 3, P: int = 3):
        super().__init__()
        self.input_mode = input_mode
        self.evs_ch = evs_ch            # event bins the encoder takes
        self.patchify = Patchifier(input_mode, evs_ch, img_ch)
        self.update = Update(P)

    def encode(self, events, images, mask, n_out: int):
        """Encode a training window from a fresh state (ref VONet.encode
        with the Patchifier's scaling): events [T, H, W, Ce], images
        [Ti, H, W, 3], mask [T] -> fmap [n_out, H/4, W/4, 128] / 4 and imap
        [n_out, H/4, W/4, 384] / 4, channels-last."""
        fmap, imap = self.patchify.encoder.encode_window(events, images, mask,
                                                         n_out)
        return fmap / 4.0, imap / 4.0


class CorrBlock:
    """Training-time two-level correlation closure (ref net.py:206-229;
    port of rampvo_tpu/models/vonet.py::CorrBlock): fmap [N, h, w, C]
    per-frame features, gmap [N*M, P, P, C] patch features;
    __call__(kk, jj, coords) -> [E, 2*49*P*P], the levels stacked as
    `corr_stack` stacks them."""

    def __init__(self, fmap, gmap, radius: int = 3, levels=(1, 4)):
        self.radius = radius
        self.levels = levels
        self.gmap = gmap
        self.pyramid = pyramidify(fmap, lvls=levels)

    def __call__(self, kk, jj, coords):
        return corr_stack(*[
            corr(self.gmap, self.pyramid[i], coords / lvl, kk, jj,
                 self.radius)
            for i, lvl in enumerate(self.levels)])


def fold_corr_fc1(net: VONet, layout: str):
    """The first weight of the update's correlation MLP (`update.corr.0`)
    for a kernel's output layout (port of rampvo_tpu/models/vonet.py::
    fold_corr_fc1): "paired" -> [384, 1152], reference columns gathered
    through `paired_corr_perm`, zero columns where it is -1; "folded" ->
    [384, 882], columns permuted by `folded_corr_perm`. A copy in the
    weight's dtype and device; the state_dict is untouched. Fold once per
    network, not per update."""
    W = net.update.corr[0].weight.detach()
    if layout == "paired":
        idx = torch.tensor(paired_corr_perm(3, 3), dtype=torch.long,
                           device=W.device)
        Wp = W[:, idx.clamp(min=0)]
        return torch.where((idx >= 0)[None, :], Wp, torch.zeros_like(Wp))
    if layout == "folded":
        inv = torch.tensor(folded_corr_perm(3, 3), dtype=torch.long,
                           device=W.device)
        return W[:, inv].contiguous()
    raise ValueError(f"unknown correlation layout {layout!r}")


def init_weights(net: nn.Module, generator: torch.Generator):
    """Seeded random initialisation of every parameter from `generator`
    (for runs without a checkpoint): convolutions and linears normal with
    variance 1/fan_in (2/fan_out for 3x3+ convolutions, the heads'
    kaiming), LSTMs uniform(+-1/sqrt(h)), norms and biases at identity."""
    with torch.no_grad():
        for name, mod in sorted(net.named_modules()):
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                w = mod.weight
                if isinstance(mod, nn.Conv2d) and w.shape[-1] > 1:
                    std = math.sqrt(2.0 / (w.shape[0] * w.shape[2] * w.shape[3]))
                else:
                    std = math.sqrt(1.0 / w[0].numel())
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LSTM):
                k = 1.0 / math.sqrt(mod.hidden_size)
                for p in mod.parameters():
                    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * k)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return net


# ---------------------------------------------------------------------------
# patch coordinate selection (parameter-free)
# ---------------------------------------------------------------------------

def nms_2d(x, kernel_size: int):
    """Keep values equal to their local max (ref utils.py:157-182).
    x [n, H, W]."""
    pad = (kernel_size - 1) // 2
    mx = F.max_pool2d(x[:, None], kernel_size, stride=1, padding=pad)[:, 0]
    return x * (mx == x).to(x.dtype)


def select_coords_event_bias(events, M: int, nms_rad: int = 11):
    """Top-M event-density locations at 1/4 resolution (ref
    utils.py:186-226, integer row/col split). events [n, H, W, C] ->
    coords [n, M, 2] float (x, y). Ties go to the lower flat index, like
    jax.lax.top_k (a stable descending sort)."""
    ev = avg_pool2d(events.abs(), 4).mean(dim=-1)         # [n, h, w]
    if nms_rad:
        ev = nms_2d(ev, nms_rad)
    n, h, w = ev.shape
    idx = torch.sort(ev.reshape(n, h * w), dim=1, descending=True,
                     stable=True).indices[:, :M]
    y = torch.div(idx, w, rounding_mode="floor").float()
    x = (idx % w).float()
    return torch.stack([x, y], dim=-1)


def selection_draws(gradient: bool, n: int, M: int, ht: int, wd: int,
                    generator: torch.Generator):
    """The integer draws of `select_coords_gradient_bias` (`gradient`) or
    `select_coords_random` for n frames of ht x wd images, from
    `generator` on its own device: (x, y) int64 [n, C], x in [1, w - 1)
    and y in [1, h - 1) of the map the selector ranks, C = 3M candidates
    of the (ht-1)/4 x (wd-1)/4 gradient map, or M of the ht/4 x wd/4
    feature map."""
    if gradient:
        return _draw_xy(n, 3 * M, (ht - 1) // 4, (wd - 1) // 4, generator)
    return _draw_xy(n, M, ht // 4, wd // 4, generator)


def _draw_xy(n: int, C: int, h: int, w: int, generator: torch.Generator):
    dev = generator.device
    x = torch.randint(1, w - 1, (n, C), generator=generator, device=dev)
    y = torch.randint(1, h - 1, (n, C), generator=generator, device=dev)
    return x, y


def select_coords_random(n: int, M: int, h: int, w: int, generator=None,
                         draws=None):
    """Uniform random interior coords at 1/4 resolution (ref
    net.py:186-188): [n, M, 2] float (x, y), x in [1, w - 1), y in
    [1, h - 1). `draws` (x, y) [n, M] are the integers (e.g. a JAX run's),
    else `generator` draws them."""
    if draws is None:
        draws = _draw_xy(n, M, h, w, generator)
    x, y = draws
    return torch.stack([x, y], dim=-1).float()


def select_coords_gradient_bias(images, M: int, generator=None, draws=None):
    """Random candidates ranked by image gradient magnitude (ref
    net.py:172-183, utils.py:110-119): the gray image's forward
    differences, their norm average-pooled 4x4, read at 3M random
    candidates, the top M kept (ties to the lower index, like
    jax.lax.top_k). images [n, H, W, 3] normalized; `draws` (x, y)
    [n, 3M], else `generator` draws them. Returns coords [n, M, 2] float
    (x, y)."""
    n, H, W, _ = images.shape
    gray = ((images + 0.5) * (255.0 / 2)).sum(dim=-1)
    dx = gray[:, :-1, 1:] - gray[:, :-1, :-1]
    dy = gray[:, 1:, :-1] - gray[:, :-1, :-1]
    g = avg_pool2d(torch.sqrt(dx * dx + dy * dy)[..., None], 4)[..., 0]
    if draws is None:
        draws = selection_draws(True, n, M, H, W, generator)
    x, y = (d.to(images.device) for d in draws)
    vals = g[torch.arange(n, device=g.device)[:, None], y, x]
    top = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :M]
    xs = torch.gather(x, 1, top).float()
    ys = torch.gather(y, 1, top).float()
    return torch.stack([xs, ys], dim=-1)


# ---------------------------------------------------------------------------
# patch gathering
# ---------------------------------------------------------------------------

def extract_patches(fmap, imap, images, disps, coords, P: int = 3):
    """Gather per-patch tensors (ref net.py:190-203).

    fmap [n, h, w, 128], imap [n, h, w, 384], images [n, H, W, 3],
    disps [n, h, w], coords [n, M, 2] at 1/4 res. Returns gmap
    [n, M, P, P, 128], imap_vec [n, M, 384], patches [n, M, 3, P, P]
    (x, y, inverse depth), clr [n, M, 3]."""
    n, h, w, _ = fmap.shape
    gmap = gather_patches(fmap, coords, 1)
    imap_vec = gather_patches(imap, coords, 0)[:, :, 0, 0, :]
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=fmap.dtype, device=fmap.device),
        torch.arange(w, dtype=fmap.dtype, device=fmap.device), indexing="ij")
    grid = torch.stack([xx.expand(n, h, w), yy.expand(n, h, w), disps], -1)
    patches = gather_patches(grid, coords, P // 2).permute(0, 1, 4, 2, 3)
    clr = gather_patches(images, 4.0 * (coords + 0.5), 0)[:, :, 0, 0, :]
    return gmap, imap_vec, patches, clr


def filter_features(confidences, target, data_shape):
    """Zero confidence for targets outside the image (ref
    utils.py:557-570). confidences/target [..., 2]."""
    ht, wd = data_shape
    ok = ((target[..., 0] >= 0) & (target[..., 0] <= wd)
          & (target[..., 1] >= 0) & (target[..., 1] <= ht))
    return torch.where(ok[..., None], confidences,
                       torch.zeros_like(confidences))
