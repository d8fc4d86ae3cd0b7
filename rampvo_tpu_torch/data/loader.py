"""Inference data loading (port of rampvo_tpu/data/loader.py; ref
evaluate.py:99-165, ramp/utils.py:400-429).

Chunks an event stream into fixed-size slices, associates each with the
nearest image frame by timestamp, and yields channels-last numpy arrays
with the events<->frame supervision mask. `device_prefetch` moves the
next frames to the card while the current one runs.
"""

from __future__ import annotations

import collections
import glob
import os.path as osp
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from .event_handle import H5EventHandle
from .representations import EventToStack, EventsToVoxelGrid


def normalize_image(images: np.ndarray, norm_img_to: str | None = None) -> np.ndarray:
    """(ref: ramp/utils.py:573-583)"""
    images = images.astype(np.float32)
    if norm_img_to == "-1_1":
        return 2 * (images / 255.0) - 1
    return 2 * (images / 255.0) - 0.5


def pad_or_resize(x: np.ndarray, ht: int = 480, wd: int = 640) -> np.ndarray:
    """Center-pad smaller inputs (the reference path hit in practice,
    evaluate.py:167-174 + utils.py:400-409); bilinear-resize larger ones.
    x: [..., H, W, C] channels-last."""
    H, W = x.shape[-3], x.shape[-2]
    if (H, W) == (ht, wd):
        return x
    if H <= ht and W <= wd:
        hp, wp = ht - H, wd - W
        pad = [(0, 0)] * (x.ndim - 3) + [
            (hp // 2, hp - hp // 2),
            (wp // 2, wp - wp // 2),
            (0, 0),
        ]
        return np.pad(x, pad)
    import cv2

    flat = x.reshape(-1, H, W, x.shape[-1])
    out = np.stack(
        [cv2.resize(f, (wd, ht), interpolation=cv2.INTER_LINEAR) for f in flat]
    )
    return out.reshape(x.shape[:-3] + (ht, wd, x.shape[-1]))


def resize_input(image: np.ndarray, events: np.ndarray, ht: int = 480,
                 wd: int = 640):
    """`pad_or_resize` of an image and an event tensor to ht x wd."""
    return pad_or_resize(image, ht, wd), pad_or_resize(events, ht, wd)


def make_representation(cfg: dict):
    kind = cfg.get("event_representation", "stack")
    bins = cfg["data_loader"]["train"]["args"]["num_event_bins"]
    if kind == "stack":
        return EventToStack(bins)
    if kind == "voxels":
        return EventsToVoxelGrid(bins, normalize=True)
    raise NotImplementedError(kind)


PREFETCH_DEPTH = 2


def device_prefetch(items, device="cuda"):
    """Double-buffered host->device prefetch: the next PREFETCH_DEPTH
    items' events and images are copied from pinned memory with
    `non_blocking` while the current one is consumed, in their compact
    dtypes (int8 event stacks, float16 images; the runtime promotes on the
    card). Other entries stay as they are: the mask stays on the host,
    where it routes each frame."""
    dev = resolve_device(device)

    def put(d):
        out = dict(d)
        for k in ("events", "image"):
            v = d.get(k)
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(v))
                if dev.type == "cuda":
                    t = t.pin_memory().to(dev, non_blocking=True)
                out[k] = t
        return out

    buf = collections.deque()
    it = iter(items)
    for d in it:
        buf.append(put(d))
        if len(buf) == PREFETCH_DEPTH:
            break
    while buf:
        out = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        yield out


def data_loader_all_events(
    config: dict,
    full_scene: str,
    downsample_fact: int = 1,
    norm_to: str | None = None,
    extension: str = ".png",
    intrinsics=(320.0, 320.0, 320.0, 240.0),
):
    """Build the per-scene eval stream (ref: evaluate.py:99-155).

    Returns a list of dicts {events [T=1, H, W, C], image [1, H, W, 3],
    intrinsics [4], mask [1] bool, frame_index} and the used frame
    indices. Events keep the representation's dtype (int8 stacks), images
    are float16, both padded or resized to 480x640.
    """
    train_cfg = config["data_loader"]["train"]["args"]
    n_events_selected = train_cfg["num_events_selected"]
    rep = make_representation(config)

    imfiles = sorted(glob.glob(osp.join(full_scene, "image_left", f"*{extension}")))
    evfile = osp.join(full_scene, "events.h5")
    timestamps = np.loadtxt(osp.join(full_scene, "timestamps.txt"))

    image_files = imfiles[1::downsample_fact]
    corresponding_timestamps = timestamps[1::downsample_fact]

    with H5EventHandle.from_path(Path(evfile)) as event:
        data_list, masks, frame_of_voxel = _voxels(
            event, rep, n_events_selected, image_files,
            corresponding_timestamps, norm_to, intrinsics)
    frame_indices = sorted(set(frame_of_voxel[np.asarray(masks)].tolist()))
    return data_list, frame_indices


def _read_png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def _voxels(event, rep, n_events_selected, image_files,
            corresponding_timestamps, norm_to, intrinsics,
            read_image=_read_png):
    """The loader's per-voxel loop over an open event stream; each entry
    of `image_files` is read by `read_image`."""
    n_events = len(event.t)
    n_voxels = n_events // n_events_selected
    corr_events_timestamps = np.asarray(event.t[0:n_events:n_events_selected][1:])

    vicinity = (
        np.subtract.outer(
            corr_events_timestamps.astype(np.float64),
            corresponding_timestamps.astype(np.float64),
        )
        ** 2
    )
    frame_of_voxel = np.argmin(vicinity, axis=1)
    voxel_of_frame = np.argmin(vicinity, axis=0)

    data_list = []
    masks = []
    i1 = 0
    for i in range(n_voxels):
        i0, i1 = i1, i1 + n_events_selected
        ev = rep(event.get_between_idx(i0, i1))  # [C, H, W]
        ev = np.transpose(ev, (1, 2, 0))[None]  # [1, H, W, C]

        frame_ind = frame_of_voxel[i]
        img = read_image(image_files[frame_ind])
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        img = normalize_image(img[..., :3], norm_to)[None].astype(np.float16)

        mask = bool(voxel_of_frame[frame_ind] == i)
        masks.append(mask)
        data_list.append(
            {
                "events": pad_or_resize(ev),
                "image": pad_or_resize(img),
                "intrinsics": np.asarray(intrinsics, np.float32),
                "mask": np.asarray([mask]),
                "frame_index": int(frame_ind),
            }
        )
    return data_list, masks, frame_of_voxel
