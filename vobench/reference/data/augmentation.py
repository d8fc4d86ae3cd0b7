"""Training augmentation, numpy and cv2 (port of
rampvo_tpu/data/augmentation.py; ref ramp/data_readers/augmentation.py).

Color jitter and a random upscale (<= sqrt(2)) with a center crop, applied
alike to images, depths and intrinsics; nearest-neighbour resizing of the
event stacks. Channels-last arrays. cv2 is imported inside the functions.
"""

from __future__ import annotations

import numpy as np


def _jitter_colors(images, rng):
    """Brightness, contrast and saturation 0.4, hue ~0.064 (ref :12-17),
    grayscale p = 0.1, invert p = 0.1. images [N, H, W, 3] in [0, 255]."""
    import cv2

    x = images.astype(np.float32) / 255.0
    x = np.clip(x * rng.uniform(0.6, 1.4), 0, 1)
    c = rng.uniform(0.6, 1.4)
    mean = x.mean(axis=(1, 2, 3), keepdims=True)
    x = np.clip(mean + (x - mean) * c, 0, 1)
    s = rng.uniform(0.6, 1.4)
    gray = x.mean(axis=-1, keepdims=True)
    x = np.clip(gray + (x - gray) * s, 0, 1)
    h = rng.uniform(-0.2 / 3.14, 0.2 / 3.14)
    hsv = np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2HSV) for f in x])
    hsv[..., 0] = (hsv[..., 0] + h * 180.0) % 180.0
    x = np.stack([cv2.cvtColor(f, cv2.COLOR_HSV2RGB) for f in hsv])
    if rng.rand() < 0.1:
        x = np.repeat(x.mean(axis=-1, keepdims=True), 3, axis=-1)
    if rng.rand() < 0.1:
        x = 1.0 - x
    return np.clip(x * 255.0, 0, 255)


class EventRGBDAugmentor:
    """(ref augmentation.py:69-93)"""

    def __init__(self, crop_size=(480, 640), max_scale=0.5, seed=None):
        self.crop_size = tuple(crop_size)
        self.max_scale = max_scale
        self.rng = np.random.RandomState(seed)

    def __call__(self, events, images, poses, disps, intrinsics):
        """events [T, H, W, C], images [N, H, W, 3] (0..255), disps
        [N, H, W], intrinsics [N, 4]."""
        import cv2

        rng = self.rng
        if rng.rand() < 0.5:
            images = _jitter_colors(images, rng)
        ht, wd = images.shape[1:3]
        ch, cw = self.crop_size
        min_scale = np.log2(max((ch + 1) / ht, (cw + 1) / wd))
        scale = 1.0
        if rng.rand() < 0.8:
            scale = 2 ** rng.uniform(max(0.0, min_scale), self.max_scale)
        else:
            scale = max(scale, 2 ** max(0.0, min_scale))
        ht1, wd1 = int(scale * ht), int(scale * wd)
        intrinsics = intrinsics * scale

        def resize(stack, interp):
            return np.stack([cv2.resize(f, (wd1, ht1), interpolation=interp)
                             for f in stack])

        images = resize(images, cv2.INTER_CUBIC)
        disps = resize(disps, cv2.INTER_NEAREST)
        ev = resize(events.astype(np.float32), cv2.INTER_NEAREST)
        if ev.ndim == 3:  # cv2 drops a single channel
            ev = ev[..., None]
        y0 = (ht1 - ch) // 2
        x0 = (wd1 - cw) // 2
        intrinsics = intrinsics - np.array([0.0, 0.0, x0, y0])
        images = images[:, y0:y0 + ch, x0:x0 + cw]
        disps = disps[:, y0:y0 + ch, x0:x0 + cw]
        ev = ev[:, y0:y0 + ch, x0:x0 + cw]
        return ev, images, poses, disps, intrinsics


def set_random_sample_to_zero(events, images, rng, img_to_zero_perc=0.5,
                              datacouple_perc=0.2):
    """Per-window modality dropout (ref utils_data_readers.py:8-37): the
    frames with both modalities are split into image-dropped and
    event-dropped, then a random subset is restored."""
    T = images.shape[0]
    nz_img = {i for i in range(T) if np.any(images[i] != 0)}
    nz_ev = {i for i in range(min(T, events.shape[0]))
             if np.any(events[i] != 0)}
    common = sorted(nz_img & nz_ev)
    if not common:
        return events, images
    n_zero = int(len(common) * img_to_zero_perc)
    n_keep = int(len(common) * datacouple_perc)
    perm = rng.permutation(len(common))
    zero_images = {common[i] for i in perm[:n_zero]}
    zero_events = set(common) - zero_images
    keep = {common[i] for i in rng.permutation(len(common))[:n_keep]}
    events = events.copy()
    images = images.copy()
    for i in zero_images - keep:
        events[i] = 0  # (the reference's names are inverted too)
    for i in zero_events - keep:
        images[i] = 0
    return events, images


def set_random_sequence_to_zero(events, images, rng, perc_to_drop_img=0.4,
                                perc_to_drop_evs=0.4, perc_to_drop_none=0.2):
    """Whole-window modality dropout (ref utils_data_readers.py:40-69)."""
    if abs(perc_to_drop_img + perc_to_drop_evs + perc_to_drop_none - 1) > 1e-6:
        raise ValueError("drop probabilities must sum to 1")
    n_img = sum(1 for i in range(images.shape[0]) if np.any(images[i] != 0))
    n_ev = sum(1 for i in range(events.shape[0]) if np.any(events[i] != 0))
    if n_img != n_ev:
        return events, images
    u = rng.rand()
    if u < perc_to_drop_evs:
        return np.zeros_like(events), images
    if u < perc_to_drop_evs + perc_to_drop_img:
        return events, np.zeros_like(images)
    return events, images
