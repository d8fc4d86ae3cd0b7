"""RAMP encoders (port of rampvo_tpu/models/encoders.py; ref
ramp/extractor.py:60-130, 187-269, 274-566).

This module holds the plain reference chains of both encoders:
- MultiScale: per scale, a zero-carry single-step pixel LSTM for events
  and for the image, then the super-state folds (events always, the image
  where the mask is set), then two pyramid CNN heads;
- SingleScale: carried pixel LSTMs for events and for the image, then the
  shared super-state fold of each modality that is present (not all
  zero), then two BasicEncoder4 heads.
The VO runtime runs the recurrent chains through the fused CUDA kernels
(ops/encoder_kernels.py, ops/singlescale_kernels.py); tests hold one
against the other. Training encodes a whole window of T voxels from a
fresh state (`encode_window` of either encoder) with the plain chain,
which is differentiable: the LSTMs are carried over the window, and each
of their steps is recomputed in the backward pass (checkpointed) rather
than stored.

Layouts: inputs and outputs channels-last (events [T, H, W, Ce] with
T == 1, fmap [1, h, w, 128]) like the JAX package; convolutions run NCHW
inside. The MultiScale super-states are channel-major [h_s, Hs*Ws] per
scale (the kernel's layout), see `multiscale_init_state`; the plain
SingleScale encoder keeps the JAX package's channels-last state
(`SingleScaleEncoder.init_state`), the kernel path a channel-major one.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

DIM = 32  # extractor.py:4
SCALES = (1, 2, 4)
LSTM_DIM = 16
SS_LSTM_DIM = 15  # SingleScale hidden size (extractor.py:187-269)


def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm2d(affine=False) on NCHW, statistics in float32."""
    xf = x.float()
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    var = xf.var(dim=(-2, -1), keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class ResidualBlock(nn.Module):
    """Two 3x3 convs with norm + relu and a strided shortcut
    (ref extractor.py:8-57). norm_fn "instance" or "none"."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.downsample = (
            nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=stride),
                          nn.Identity())
            if stride != 1 else None
        )

    def _norm(self, x):
        return instance_norm(x) if self.norm_fn == "instance" else x

    def forward(self, x):
        y = F.relu(self._norm(self.conv1(x)))
        y = F.relu(self._norm(self.conv2(y)))
        if self.downsample is not None:
            x = self._norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder4(nn.Module):
    """1/4-resolution head: conv7 s2 -> two residual stages -> 1x1 (ref
    extractor.py:60-130), the SingleScale encoder's. NCHW."""

    def __init__(self, output_dim: int, norm_fn: str, channel_dim: int = 5):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(channel_dim, DIM, 7, stride=2, padding=3)
        self.layer1 = nn.Sequential(ResidualBlock(DIM, DIM, norm_fn),
                                    ResidualBlock(DIM, DIM, norm_fn))
        self.layer2 = nn.Sequential(
            ResidualBlock(DIM, 2 * DIM, norm_fn, stride=2),
            ResidualBlock(2 * DIM, 2 * DIM, norm_fn),
        )
        self.conv2 = nn.Conv2d(2 * DIM, output_dim, 1)

    def forward(self, x):
        x = self.conv1(x)
        if self.norm_fn == "instance":
            x = instance_norm(x)
        x = self.layer2(self.layer1(F.relu(x)))
        return self.conv2(x)


class MultiScaleBasicEncoder4(nn.Module):
    """Pyramid-fusing head: injects the scale-2 and scale-4 super-states
    after each strided stage (ref extractor.py:274-311). NCHW."""

    def __init__(self, output_dim: int, norm_fn: str, channel_dim: int = 16):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = nn.Conv2d(channel_dim, DIM, 7, stride=2, padding=3)
        self.layer1 = nn.Sequential(ResidualBlock(DIM, DIM, norm_fn),
                                    ResidualBlock(DIM, DIM, norm_fn))
        c2 = 2 * channel_dim
        self.layer3 = nn.Sequential(
            ResidualBlock(DIM + c2, 2 * DIM, norm_fn, stride=2),
            ResidualBlock(2 * DIM, 2 * DIM, norm_fn),
        )
        self.conv3 = nn.Conv2d(2 * DIM + 4 * channel_dim, output_dim, 1)

    def forward(self, x, x_down2, x_down4):
        x = self.conv1(x)
        if self.norm_fn == "instance":
            x = instance_norm(x)
        x = self.layer1(F.relu(x))
        x = self.layer3(torch.cat([x, x_down2], dim=1))
        return self.conv3(torch.cat([x, x_down4], dim=1))


class LSTMEncoder(nn.Module):
    """Downsampling conv + pixel LSTM (ref extractor.py:314-390). Only the
    zero-carry single step runs (the reference never passes hx); nn.LSTM
    holds the parameters under the reference keys (weight_ih_l0, ...)."""

    def __init__(self, in_channels: int, downsample_scale: int,
                 out_channels: int):
        super().__init__()
        s = downsample_scale
        k, stride, pad = (1, 1, 0) if s <= 1 else (s + 1, s, 1)
        self.conv_1 = nn.Conv2d(in_channels, in_channels, k, stride=stride,
                                padding=pad)
        self.convlstm = nn.LSTM(in_channels, out_channels)

    def forward(self, x):
        """x [1, C, H, W] -> h [1, hid, Hs, Ws] of the zero-carry step."""
        return lstm_step_zero(self.convlstm, self.conv_1(x))


def lstm_step_zero(lstm: nn.LSTM, x):
    """Single LSTM step from a zero carry on NCHW pixels: the forget-gate
    and recurrent terms vanish exactly (gate order i, f, g, o)."""
    hid = lstm.hidden_size
    w = lstm.weight_ih_l0.to(x.dtype)                     # [4h, C]
    b = (lstm.bias_ih_l0 + lstm.bias_hh_l0).to(x.dtype)
    gates = torch.einsum("gc,nchw->nghw", w, x) + b[None, :, None, None]
    i, _f, g, o = gates.split(hid, dim=1)
    c = torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c)


def lstm_cell(lstm: nn.LSTM, x, h, c):
    """One carried LSTM step on channels-last pixels: x [..., C], h and c
    [..., hid] -> (h', c') (gate order i, f, g, o)."""
    hid = lstm.hidden_size
    b = (lstm.bias_ih_l0 + lstm.bias_hh_l0).to(x.dtype)
    gates = (x @ lstm.weight_ih_l0.to(x.dtype).t()
             + h.to(x.dtype) @ lstm.weight_hh_l0.to(x.dtype).t() + b)
    i, f, g, o = gates.split(hid, dim=-1)
    c = torch.sigmoid(f) * c.to(x.dtype) + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_scan(lstm: nn.LSTM, x):
    """The pixel LSTM carried over a window from a zero state (ref
    PixelLSTM's scan): x [T, ..., C] -> h of every step [T, ..., hid].
    Under autograd each step is checkpointed, as the reference's
    jax.checkpoint(step): the backward recomputes its gates."""
    h = x.new_zeros(x.shape[1:-1] + (lstm.hidden_size,))
    c = torch.zeros_like(h)
    cell = lambda xt, h, c: lstm_cell(lstm, xt, h, c)
    outs = []
    for t in range(x.shape[0]):
        if torch.is_grad_enabled():
            h, c = checkpoint(cell, x[t], h, c, use_reentrant=False)
        else:
            h, c = cell(x[t], h, c)
        outs.append(h)
    return torch.stack(outs)


def window_slots(mask, n_images: int, n_out: int):
    """Host bookkeeping of a training window: mask [T] bool -> (mask as a
    list of bools, image slot of each voxel (cumsum(mask) - 1, clipped,
    ref encoders.py:370), the first n_out supervised voxels padded with
    T - 1 (jnp.nonzero(size=n_out, fill_value=T - 1)))."""
    m = [bool(v) for v in torch.as_tensor(mask).reshape(-1).tolist()]
    T = len(m)
    slot, k = [], -1
    for v in m:
        k += int(v)
        slot.append(min(max(k, 0), n_images - 1))
    sup = [t for t in range(T) if m[t]][:n_out]
    return m, slot, sup + [T - 1] * (n_out - len(sup))


class SuperStateEncoder(nn.Module):
    """Super-state fold: the conv on concat(ss, data), NCHW (ref
    extractor.py:393-412)."""

    def __init__(self, out_channels: int, kernel_size: int = 1):
        super().__init__()
        self.encoder = nn.Conv2d(2 * out_channels, out_channels, kernel_size,
                                 padding=(kernel_size - 1) // 2)

    def forward(self, ss, data):
        return self.encoder(torch.cat([ss, data], dim=1))

    def fold_cl(self, ss, data):
        """The same fold on channels-last pixels [..., hid] (a 1x1 conv)."""
        w = self.encoder.weight[:, :, 0, 0].to(ss.dtype)
        return (torch.cat([ss, data], dim=-1) @ w.t()
                + self.encoder.bias.to(ss.dtype))


def scale_shape(H: int, W: int, s: int):
    """Spatial size of scale s's super-state (the LSTMEncoder conv)."""
    if s <= 1:
        return H, W
    return (H + 2 - (s + 1)) // s + 1, (W + 2 - (s + 1)) // s + 1


def multiscale_init_state(H: int, W: int, dtype=torch.float32,
                          device="cpu"):
    """Channel-major persistent super-states {"ss": [[16 s, Hs*Ws]]}."""
    ss = []
    for s in SCALES:
        Hs, Ws = scale_shape(H, W, s)
        ss.append(torch.zeros((LSTM_DIM * s, Hs * Ws), dtype=dtype,
                              device=device))
    return {"ss": ss}


class MultiScaleEncoder(nn.Module):
    """MultiScaleMergerDoubleNet (ref extractor.py:468-566), T == 1."""

    def __init__(self, evs_ch: int = 5, img_ch: int = 3,
                 output_dim_f: int = 128, output_dim_i: int = 384):
        super().__init__()
        hids = [LSTM_DIM * s for s in SCALES]
        self.ev_encoders = nn.ModuleList(
            [LSTMEncoder(evs_ch, s, h) for s, h in zip(SCALES, hids)])
        self.im_encoders = nn.ModuleList(
            [LSTMEncoder(img_ch, s, h) for s, h in zip(SCALES, hids)])
        self.super_state_ev_encoder = nn.ModuleList(
            [SuperStateEncoder(h) for h in hids])
        self.super_state_im_encoders = nn.ModuleList(
            [SuperStateEncoder(h) for h in hids])
        self.fmap_encoder = MultiScaleBasicEncoder4(output_dim_f, "instance",
                                                    hids[0])
        self.imap_encoder = MultiScaleBasicEncoder4(output_dim_i, "none",
                                                    hids[0])

    def heads(self, ss_nchw):
        """The two pyramid heads on the NCHW super-states."""
        return self.fmap_encoder(*ss_nchw), self.imap_encoder(*ss_nchw)

    def forward(self, events, images, mask, state):
        """events [1, H, W, Ce], images [1, H, W, Ci], mask [1] bool (host
        value), state from `multiscale_init_state`. Returns fmap
        [1, H/4, W/4, 128], imap [1, H/4, W/4, 384] (channels-last) and the
        new state."""
        if events.shape[0] != 1:
            raise ValueError("the MultiScale encoder port takes T == 1")
        m = bool(mask.reshape(-1)[0])
        ev = events.permute(0, 3, 1, 2)
        im = images[:1].permute(0, 3, 1, 2)
        new_ss, ss_nchw = [], []
        for si in range(len(SCALES)):
            h_ev = self.ev_encoders[si](ev)
            h_im = self.im_encoders[si](im)
            hid, Hs, Ws = h_ev.shape[1:]
            ss = state["ss"][si].reshape(1, hid, Hs, Ws).to(h_ev.dtype)
            ss = self.super_state_ev_encoder[si](ss, h_ev)
            if m:
                ss = self.super_state_im_encoders[si](ss, h_im)
            new_ss.append(ss.reshape(hid, Hs * Ws).to(state["ss"][si].dtype))
            ss_nchw.append(ss)
        fmap, imap = self.heads(ss_nchw)
        return (fmap.permute(0, 2, 3, 1), imap.permute(0, 2, 3, 1),
                {"ss": new_ss})

    def encode_window(self, events, images, mask, n_out: int):
        """A training window from a fresh state (ref
        MultiScaleEncoder.__call__ with T > 1, extractor.py:468-566):
        events [T, H, W, Ce], images [Ti, H, W, Ci], mask [T] bool with the
        supervised voxels. Per scale the event and image LSTMs are carried
        over their sequences; the super-state folds the events of every
        voxel and, where the mask is set, the image of slot cumsum(mask)-1.
        The heads run on the super-states of the first n_out supervised
        voxels. Returns fmap [n_out, H/4, W/4, 128] and imap
        [n_out, H/4, W/4, 384], channels-last."""
        m, slot, sup = window_slots(mask, images.shape[0], n_out)
        ev = events.permute(0, 3, 1, 2)
        im = images.permute(0, 3, 1, 2)
        ss_nchw = []
        for si in range(len(SCALES)):
            xe = self.ev_encoders[si].conv_1(ev)
            xi = self.im_encoders[si].conv_1(im)
            Hs, Ws = xe.shape[-2:]
            out_ev = lstm_scan(self.ev_encoders[si].convlstm,
                               xe.permute(0, 2, 3, 1))
            out_im = lstm_scan(self.im_encoders[si].convlstm,
                               xi.permute(0, 2, 3, 1))
            fold_ev = self.super_state_ev_encoder[si].fold_cl
            fold_im = self.super_state_im_encoders[si].fold_cl
            ss = torch.zeros_like(out_ev[0])
            saved = []
            for t in range(len(m)):
                ss = fold_ev(ss, out_ev[t])
                if m[t]:
                    ss = fold_im(ss, out_im[slot[t]])
                saved.append(ss)
            ss_nchw.append(torch.stack([saved[t] for t in sup]).permute(
                0, 3, 1, 2))
        fmap, imap = self.heads(ss_nchw)
        return fmap.permute(0, 2, 3, 1), imap.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# SingleScale
# ---------------------------------------------------------------------------

class PixelLSTM(nn.LSTM):
    """nn.LSTM applied independently to every pixel, one carried step at a
    time (ref extractor.py:211-212,239-243). The parameters keep the
    reference keys (weight_ih_l0, ...); gate order i, f, g, o."""

    def step(self, x, h, c):
        """x [..., C], h and c [..., hid] channels-last -> (h', c')."""
        return lstm_cell(self, x, h, c)


class SingleScaleEncoder(nn.Module):
    """MergerLSTMsceneEncoder (ref extractor.py:187-269), T == 1: carried
    pixel LSTMs, the shared super-state fold applied to each modality that
    is present (not all zero, extractor.py:253-258), two BasicEncoder4
    heads at 1/4 resolution."""

    def __init__(self, evs_ch: int = 5, img_ch: int = 3,
                 lstm_dim: int = SS_LSTM_DIM, output_dim_f: int = 128,
                 output_dim_i: int = 384):
        super().__init__()
        self.events_convlstm = PixelLSTM(evs_ch, lstm_dim)
        self.image_convlstm = PixelLSTM(img_ch, lstm_dim)
        self.superstate_encoder = nn.Conv2d(2 * lstm_dim, lstm_dim, 1)
        self.fmap_encoder = BasicEncoder4(output_dim_f, "instance", lstm_dim)
        self.imap_encoder = BasicEncoder4(output_dim_i, "none", lstm_dim)

    @staticmethod
    def init_state(H: int, W: int, lstm_dim: int = SS_LSTM_DIM,
                   dtype=torch.float32, device="cpu"):
        """Channels-last carry {"ev": (h, c), "im": (h, c), "ss"}, each
        [H, W, lstm_dim] (the JAX package's layout)."""
        z = lambda: torch.zeros((H, W, lstm_dim), dtype=dtype, device=device)
        return {"ev": (z(), z()), "im": (z(), z()), "ss": z()}

    def fold(self, ss, data):
        """The shared 1x1 fold conv on concat(ss, data), channels-last."""
        w = self.superstate_encoder.weight[:, :, 0, 0].to(ss.dtype)
        return (torch.cat([ss, data], dim=-1) @ w.t()
                + self.superstate_encoder.bias.to(ss.dtype))

    def heads(self, x):
        """fmap, imap (channels-last) of an NCHW super-state
        [1, lstm_dim, H, W]."""
        return (self.fmap_encoder(x).permute(0, 2, 3, 1),
                self.imap_encoder(x).permute(0, 2, 3, 1))

    def forward(self, events, images, state):
        """events [1, H, W, Ce], images [1, H, W, Ci], state from
        `init_state`. Returns fmap [1, H/4, W/4, 128], imap
        [1, H/4, W/4, 384] (channels-last) and the new state."""
        if events.shape[0] != 1:
            raise ValueError("the SingleScale encoder port takes T == 1")
        ev, im = events[0], images[0]
        h_ev, c_ev = self.events_convlstm.step(ev, *state["ev"])
        h_im, c_im = self.image_convlstm.step(im, *state["im"])
        ss = state["ss"].to(h_ev.dtype)
        # presence gates stay tensors: no host sync
        ss = torch.where(ev.ne(0).any(), self.fold(ss, h_ev), ss)
        ss = torch.where(im.ne(0).any(), self.fold(ss, h_im), ss)
        fmap, imap = self.heads(ss.permute(2, 0, 1)[None])
        return fmap, imap, {"ev": (h_ev, c_ev), "im": (h_im, c_im), "ss": ss}

    def encode_window(self, events, images, mask, n_out: int):
        """A training window from a fresh state (ref
        SingleScaleEncoder.__call__ with T > 1): events [T, H, W, Ce],
        images [Ti, H, W, Ci], mask [T] bool. The event and image LSTMs are
        carried over the window and every voxel folds each modality that
        is present. The reference zips events with images, so only Ti == T
        (one voxel per frame) is defined; Ti != T (voxels between frames,
        n_events_in_between > 0) raises NotImplementedError, as the
        reference does. The heads run on the super-states of the first
        n_out supervised voxels. Returns fmap [n_out, H/4, W/4, 128] and
        imap [n_out, H/4, W/4, 384], channels-last."""
        m, _, sup = window_slots(mask, images.shape[0], n_out)
        if images.shape[0] != len(m):
            raise NotImplementedError(
                "SingleScale window encoding needs one image per voxel "
                f"(got {images.shape[0]} images for {len(m)} voxels)")
        out_ev = lstm_scan(self.events_convlstm, events)
        out_im = lstm_scan(self.image_convlstm, images)
        ev_on = events.ne(0).flatten(1).any(1)
        im_on = images.ne(0).flatten(1).any(1)
        ss = torch.zeros_like(out_ev[0])
        saved = []
        for t in range(len(m)):
            ss = torch.where(ev_on[t], self.fold(ss, out_ev[t]), ss)
            ss = torch.where(im_on[t], self.fold(ss, out_im[t]), ss)
            saved.append(ss)
        x = torch.stack([saved[t] for t in sup]).permute(0, 3, 1, 2)
        return (self.fmap_encoder(x).permute(0, 2, 3, 1),
                self.imap_encoder(x).permute(0, 2, 3, 1))


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM cell (ref extractor.py:133-184, which defines it
    and never runs it; kept for the JAX package's API). x [H, W, Cin],
    state (h, c) each [H, W, hidden], channels-last as the JAX cell;
    returns (h', (h', c')). `Gates` is the reference's convolution over
    [x | h]; its gates split as i, f, o, g."""

    def __init__(self, input_size: int, hidden: int, kernel_size: int = 3):
        super().__init__()
        self.hidden = hidden
        self.Gates = nn.Conv2d(input_size + hidden, 4 * hidden, kernel_size,
                               padding=kernel_size // 2)

    def forward(self, x, state=None):
        H, W, _ = x.shape
        if state is None:
            z = x.new_zeros((H, W, self.hidden))
            state = (z, z)
        h, c = state
        xh = torch.cat([x, h], dim=-1).permute(2, 0, 1)[None]
        gates = self.Gates(xh)[0].permute(1, 2, 0)
        i, f, o, g = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)
