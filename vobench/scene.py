"""The synthetic event-camera scene, made on the device (a torch copy of
rampvo_tpu_torch/data/synthetic.py's `render_sequence` and
`events_from_images`, and of the stack representation of
data/representations.py).

A smoothed random texture on a fronto-parallel plane, seen by a pinhole
camera on the "curve" (or "line") path; events are the pixels whose
intensity changed by more than a threshold between two frames, in
row-major order, and a frame's voxel stacks them into count bins (event k
of N to bin floor(bins k / N)) with polarity +-1. Arithmetic in float64,
as the numpy original, so the arrays agree with it
(vobench/tests/test_vobench_scene.py).
"""

from __future__ import annotations

import math

import torch


def make_texture(H: int, W: int, generator, device):
    """The texture [3H, 3W] in [0, 255], float64, box-smoothed (3x3,
    wrapping) as `render_sequence` smooths its own."""
    tex = torch.rand((3 * H, 3 * W), generator=generator, dtype=torch.float64,
                     device=device) * 255.0
    return smooth(tex)


def smooth(tex):
    """scipy's convolve2d(tex, ones((3, 3)) / 9, "same", "wrap")."""
    acc = torch.zeros_like(tex)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc += torch.roll(tex, (dy, dx), (0, 1))
    return acc / 9.0


def camera_xy(i: int, motion: str):
    """The camera's (x, y) at frame i (`render_sequence`'s paths)."""
    if motion == "curve":
        return (0.02 * i + 0.06 * math.sin(2 * math.pi * i / 12.0),
                0.06 * (1 - math.cos(2 * math.pi * i / 9.0)))
    if motion == "line":
        return 0.02 * i, 0.0
    raise ValueError(f"unknown motion {motion!r}")


def render(tex, H: int, W: int, fx: float, plane_z: float, i: int,
           motion: str):
    """Frame i [H, W] float64: the texture seen through the shift
    fx * camera / plane_z, bilinear, wrapping."""
    th, tw = tex.shape
    cx, cy = camera_xy(i, motion)
    dev = tex.device
    u = torch.remainder(torch.arange(W, dtype=torch.float64, device=dev)
                        + fx * cx / plane_z, tw)
    v = torch.remainder(torch.arange(H, dtype=torch.float64, device=dev)
                        + fx * cy / plane_z, th)
    u0, v0 = torch.floor(u), torch.floor(v)
    a, b = (u - u0)[None, :], (v - v0)[:, None]
    u0, v0 = u0.long(), v0.long()
    r0, r1 = v0 % th, (v0 + 1) % th
    c0, c1 = u0 % tw, (u0 + 1) % tw
    t00 = tex[r0][:, c0]
    t01 = tex[r0][:, c1]
    t10 = tex[r1][:, c0]
    t11 = tex[r1][:, c1]
    return (1 - b) * ((1 - a) * t00 + a * t01) + b * ((1 - a) * t10
                                                      + a * t11)


def stack_voxel(diff, thresh: float, bins: int):
    """The count-binned stack [H, W, bins] int8 of the events of one frame
    step with intensity change `diff` [H, W]: a pixel with |diff| >
    thresh is one event, polarity sign(diff) (0 counts as -1), event k of
    N in row-major order goes to bin floor(bins * k / N) (float32, as the
    numpy version)."""
    H, W = diff.shape
    on = (diff.abs() > thresh).reshape(-1)
    n = int(on.sum())
    out = torch.zeros((H * W, bins), dtype=torch.int8, device=diff.device)
    if n < 2:
        return out.reshape(H, W, bins)
    k = torch.cumsum(on.to(torch.int64), 0) - 1
    b = (bins * k.to(torch.float32) / n).to(torch.int64).clamp(max=bins - 1)
    pol = torch.where(diff.reshape(-1) > 0, 1, -1).to(torch.int8)
    idx = torch.nonzero(on).squeeze(1)
    out[idx, b[idx]] = pol[idx]
    return out.reshape(H, W, bins)


def normalize_image(img):
    """The loader's image: clipped to 8 bits (truncating), then
    2 * (x / 255) - 0.5, float16, three equal channels [H, W, 3]."""
    x = img.clamp(0, 255).to(torch.uint8).to(torch.float32)
    x = (2 * (x / 255.0) - 0.5).to(torch.float16)
    return x[..., None].expand(*x.shape, 3)


def make_pool(p: dict, H: int, W: int, seed: int, device):
    """The frames a VO cell plays: `pool_frames` frames along the path,
    played forward and back (a backward step's voxel is the negated
    voxel of the forward step it retraces). Returns (events [N, 1, H, W,
    bins] int8, images [N, 1, H, W, 3] float16, intrinsics [4] float32),
    N = 2 (pool_frames - 1) entries of one cycle; the texture is drawn
    from a generator on `device` seeded with `seed`."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    tex = make_texture(H, W, g, device)
    P, fx, z = int(p["pool_frames"]), float(p["fx"]), float(p["plane_z"])
    frames = [render(tex, H, W, fx, z, i, p["motion"]) for i in range(P)]
    fwd = [stack_voxel(frames[i] - frames[i - 1], p["event_thresh"],
                       p["bins"]) for i in range(1, P)]
    ims = [normalize_image(f) for f in frames]
    events = fwd + [-fwd[i] for i in range(P - 2, -1, -1)]
    images = ims[1:] + [ims[i] for i in range(P - 2, -1, -1)]
    intr = torch.tensor([fx, fx, W / 2.0, H / 2.0], dtype=torch.float32,
                        device=device)
    return (torch.stack(events)[:, None].contiguous(),
            torch.stack(images)[:, None].contiguous(), intr)
