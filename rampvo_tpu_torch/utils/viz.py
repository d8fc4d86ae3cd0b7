"""Debug visualization helpers (port of rampvo_tpu/utils/viz.py; ref
utils/eval_utils.py:67-97, utils_data_readers.py:195-217). matplotlib is
imported inside `plot_trajectories` only: the card's machine has none."""

from __future__ import annotations

import numpy as np


def render_events_over_image(events, image):
    """Overlay an event stack on an image for alignment debugging.

    events [H, W, C] (signed stack) or [C, H, W]; image [H, W, 3] in
    [0, 255] or normalized. Returns an RGB uint8 array."""
    ev = np.asarray(events, np.float32)
    if ev.ndim == 3 and ev.shape[0] < ev.shape[-1]:
        ev = np.transpose(ev, (1, 2, 0))
    pol = ev.sum(axis=-1)
    img = np.asarray(image, np.float32)
    if img.max() <= 2.0:  # normalized [-0.5, 1.5] / [-1, 1]
        img = (img - img.min()) / max(img.max() - img.min(), 1e-6) * 255.0
    out = np.repeat(img.mean(axis=-1, keepdims=True), 3, axis=-1)
    out[pol > 0, 0] = 255
    out[pol < 0, 2] = 255
    return np.clip(out, 0, 255).astype(np.uint8)


def plot_trajectories(path, est_xyz, ref_xyz=None, title="trajectory"):
    """Save a top-down (x, y) trajectory comparison plot to `path` and
    return it; None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(6, 6))
    est_xyz = np.asarray(est_xyz)
    ax.plot(est_xyz[:, 0], est_xyz[:, 1], "-o", ms=2, label="estimate")
    if ref_xyz is not None:
        ref_xyz = np.asarray(ref_xyz)
        ax.plot(ref_xyz[:, 0], ref_xyz[:, 1], "-", label="ground truth")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
