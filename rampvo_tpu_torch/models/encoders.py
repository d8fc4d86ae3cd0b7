"""RAMP MultiScale encoder (port of the MultiScale part of
rampvo_tpu/models/encoders.py; ref ramp/extractor.py:274-566).

This module is the plain reference chain: per scale, a zero-carry
single-step pixel LSTM for events and for the image, then the super-state
folds (events always, the image where the mask is set), then two pyramid
CNN heads. The VO runtime runs the same chain through the fused CUDA
kernel (ops/encoder_kernels.py); tests hold one against the other.

Layouts: inputs and outputs channels-last (events [T, H, W, Ce] with
T == 1, fmap [1, h, w, 128]) like the JAX package; convolutions run NCHW
inside. The carried super-states are channel-major [h_s, Hs*Ws] per
scale (the kernel's layout), see `multiscale_init_state`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

DIM = 32  # extractor.py:4
SCALES = (1, 2, 4)
LSTM_DIM = 16


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


class SuperStateEncoder(nn.Module):
    """Super-state fold: the conv on concat(ss, data), NCHW (ref
    extractor.py:393-412)."""

    def __init__(self, out_channels: int, kernel_size: int = 1):
        super().__init__()
        self.encoder = nn.Conv2d(2 * out_channels, out_channels, kernel_size,
                                 padding=(kernel_size - 1) // 2)

    def forward(self, ss, data):
        return self.encoder(torch.cat([ss, data], dim=1))


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
