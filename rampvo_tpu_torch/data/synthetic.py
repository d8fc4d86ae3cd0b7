"""Synthetic TartanEvent-format scenes (port of tests/synthetic.py, the
JAX package's scene writer, numpy and scipy only).

A textured fronto-parallel plane seen by a translating pinhole camera,
with events from frame intensity differences: `render_sequence`,
`events_from_images`, and `write_scene`, which writes the scene directory
the dataset and the evaluation CLI read (h5py and PIL are imported
there). The arrays are bit for bit those of the JAX package's copy.

The same scene in memory, for a machine without h5py: `memory_scene` (at
any H x W), `MemoryDataset` (the training dataset's own index, frame
graph, sampling and normalization over it), `memory_eval_data` (what the
evaluation CLI reads back from the files) and `memory_reader` (an
`evaluate(read_scene=)` over it).
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from . import frame_graph
from .events import Events
from .loader import _voxels, make_representation
from .tartan import DEPTH_SCALE, TartanEventDataset

PLANE_Z = 2.0          # the plane's depth; write_scene stores Z x DEPTH_SCALE
INDEX_EVENTS = 600     # indices.txt's events per frame (write_scene)


def render_sequence(n_frames=10, H=60, W=80, fx=60.0, seed=0,
                    motion="line"):
    """Textured fronto-parallel plane, translating camera.

    motion "line": constant velocity in x (a damped-linear motion model
    free-rides on it); "curve": sinusoidal x/y so only real tracking keeps
    the trajectory. Returns images [n, H, W] in [0, 255], poses [n, 7]
    (camera-to-world, xyzw quat), intrinsics [4]."""
    from scipy.signal import convolve2d

    rng = np.random.RandomState(seed)
    tex_h, tex_w = H * 3, W * 3
    tex = rng.rand(tex_h, tex_w) * 255.0
    # smooth the texture a little so gradients are informative
    tex = convolve2d(tex, np.ones((3, 3)) / 9.0, mode="same",
                     boundary="wrap")

    images, poses = [], []
    for i in range(n_frames):
        if motion == "curve":
            cam_x = 0.02 * i + 0.06 * np.sin(2 * np.pi * i / 12.0)
            cam_y = 0.06 * (1 - np.cos(2 * np.pi * i / 9.0))
        else:
            cam_x, cam_y = 0.02 * i, 0.0
        # camera at (cam_x, cam_y, 0) looking down +z: pixel (u, v) sees
        # texture at (u + fx*cam_x/Z, v + fx*cam_y/Z)
        u = (np.arange(W) + fx * cam_x / PLANE_Z) % tex_w
        v = (np.arange(H) + fx * cam_y / PLANE_Z) % tex_h
        u0 = np.floor(u).astype(int)
        v0 = np.floor(v).astype(int)
        a = (u - u0)[None, :]
        b = (v - v0)[:, None]
        t00 = tex[np.ix_(v0 % tex_h, u0 % tex_w)]
        t01 = tex[np.ix_(v0 % tex_h, (u0 + 1) % tex_w)]
        t10 = tex[np.ix_((v0 + 1) % tex_h, u0 % tex_w)]
        t11 = tex[np.ix_((v0 + 1) % tex_h, (u0 + 1) % tex_w)]
        images.append((1 - b) * ((1 - a) * t00 + a * t01)
                      + b * ((1 - a) * t10 + a * t11))
        poses.append([cam_x, cam_y, 0, 0, 0, 0, 1])
    intr = np.array([fx, fx, W / 2.0, H / 2.0], np.float32)
    return np.stack(images), np.asarray(poses, np.float64), intr


def events_from_images(images, thresh=6.0, t_per_frame=1000):
    """Per-pixel intensity-difference events between consecutive frames,
    as (x uint16, y uint16, t int64, p int8) sorted by time; frame i's
    events fall in ((i - 1) * t_per_frame, i * t_per_frame]."""
    xs, ys, ts, ps = [], [], [], []
    for i in range(1, len(images)):
        d = images[i] - images[i - 1]
        y, x = np.nonzero(np.abs(d) > thresh)
        t = np.full(len(x), i * t_per_frame, np.int64)
        # spread event times inside the frame interval
        t += np.linspace(0, t_per_frame - 1, len(x), dtype=np.int64) \
            - t_per_frame
        xs.append(x)
        ys.append(y)
        ts.append(t)
        ps.append((d[y, x] > 0).astype(np.int8))
    x = np.concatenate(xs).astype(np.uint16)
    y = np.concatenate(ys).astype(np.uint16)
    t = np.concatenate(ts).astype(np.int64)
    p = np.concatenate(ps).astype(np.int8)
    order = np.argsort(t, kind="stable")
    return x[order], y[order], t[order], p[order]


def write_scene(root: str, n_frames=10, H=60, W=80, seed=0, motion="line"):
    """Write a TartanEvent-format scene directory; returns (root, intr)."""
    import h5py
    from PIL import Image

    from .tartan import precompute_event_indices

    images, poses, intr = render_sequence(n_frames, H, W, seed=seed,
                                          motion=motion)
    x, y, t, p = events_from_images(images)

    os.makedirs(osp.join(root, "image_left"), exist_ok=True)
    for i, img in enumerate(images):
        arr = np.clip(img, 0, 255).astype(np.uint8)
        Image.fromarray(np.stack([arr] * 3, -1)).save(
            osp.join(root, "image_left", f"{i:06d}.png"))

    with h5py.File(osp.join(root, "events.h5"), "w") as f:
        g = f.create_group("events")
        for k, v in (("x", x), ("y", y), ("t", t), ("p", p), ("height", H),
                     ("width", W)):
            g.create_dataset(k, data=v)

    # frame i's timestamp is i * 1000, as events_from_images spaces them
    np.savetxt(osp.join(root, "timestamps.txt"), np.arange(n_frames) * 1000.0)

    # pose_left.txt in TartanAir NED layout: the reader permutes with
    # NED_TO_XYZ_PERM and drops the first row, so store the inverse
    # permutation and a dummy first row
    ned = poses[:, [2, 0, 1, 5, 3, 4, 6]]
    np.savetxt(osp.join(root, "pose_left.txt"),
               np.concatenate([ned[:1], ned], axis=0), delimiter=" ")

    fx, fy, cx, cy = [float(v) for v in intr]
    with open(osp.join(root, "K.yaml"), "w") as f:
        f.write("cam0:\n"
                f"  intrinsics: [{fx}, {fy}, {cx}, {cy}]\n"
                f"  resolution: [{W}, {H}]\n")

    # depths: the plane, stored before DEPTH_SCALE as TartanAir's are
    os.makedirs(osp.join(root, "depth_left"), exist_ok=True)
    for i in range(n_frames):
        np.save(osp.join(root, "depth_left", f"{i:06d}_left_depth.npy"),
                np.full((H, W), PLANE_Z * DEPTH_SCALE, np.float32))

    precompute_event_indices(
        osp.join(root, "events.h5"), osp.join(root, "timestamps.txt"),
        num_events=INDEX_EVENTS, indices_file=osp.join(root, "indices.txt"))
    return root, intr


EVAL_CFG = {
    "event_representation": "stack",
    "data_loader": {
        "train": {
            "args": {
                "type": "test",
                "input_mode": "MultiScale",
                "event_bias": True,
                "num_events_selected": 600,
                "n_frames": 15,
                "num_event_bins": 5,
                "image_height": 60,
                "image_width": 80,
            }
        },
        "test": {"test_split": []},
    },
}


class MemoryEvents:
    """An event stream held in memory, read as an open H5EventHandle is
    (`t`, `get_between_idx`)."""

    def __init__(self, x, y, t, p, height, width):
        self.x, self.y, self.t, self.p = x, y, t, p
        self.height, self.width = height, width

    def get_between_idx(self, i0, i1):
        return Events(x=self.x[i0:i1], y=self.y[i0:i1], t=self.t[i0:i1],
                      p=self.p[i0:i1], height=self.height, width=self.width)

    def __len__(self):
        return len(self.t)


def memory_scene(n_frames, H, W, motion="curve", seed=0,
                 num_events=INDEX_EVENTS):
    """What `write_scene(root, n_frames, H, W, seed, motion)` writes and
    the readers read back, in memory: the 8-bit images (3 equal
    channels), camera-to-world poses, intrinsics, the event stream, frame
    timestamps and indices.txt's per-frame event ranges
    (`precompute_event_indices` with `num_events`)."""
    images, poses, intr = render_sequence(n_frames, H, W, seed=seed,
                                          motion=motion)
    x, y, t, p = events_from_images(images)
    images = np.repeat(np.clip(images, 0, 255).astype(np.uint8)[..., None],
                       3, -1)
    stamps = np.arange(n_frames) * 1000.0
    i1 = np.searchsorted(t, stamps, side="right")
    return {"images": images, "poses": poses, "intrinsics": intr,
            "stamps": stamps, "events": MemoryEvents(x, y, t, p, H, W),
            "i0": np.clip(i1 - num_events, 0, len(t) - 1), "i1": i1}


class MemoryDataset(TartanEventDataset):
    """TartanEventDataset over a `memory_scene` for the network config
    `config`: the dataset's own scene index, frame graph, window sampling
    and normalization, with images, depths (write_scene's, read as
    Z x DEPTH_SCALE / DEPTH_SCALE) and events read from memory. The
    keywords are TartanEventDataset's."""

    read_image = staticmethod(np.asarray)

    @staticmethod
    def read_depth(depth):
        return depth / DEPTH_SCALE

    def __init__(self, scene, config, step=0, seed=0, fmin=10.0, fmax=75.0):
        super().__init__(config, None, step=step, seed=seed, fmin=fmin,
                         fmax=fmax)
        n, H, W = scene["images"].shape[:3]
        poses = scene["poses"].copy()
        poses[:, :3] /= DEPTH_SCALE
        depths = [np.full((H, W), PLANE_Z * DEPTH_SCALE, np.float32)] * n
        intr = [self.calib_read()] * n
        self.scene_info = {"memory": {
            "images": list(scene["images"]), "depths": depths,
            "poses": poses, "intrinsics": intr,
            "graph": frame_graph.build_frame_graph(poses, depths, intr,
                                                   self.read_depth)}}
        self._build_dataset_index(False)
        self.i0, self.i1 = {"memory": scene["i0"]}, {"memory": scene["i1"]}
        self.events = scene["events"]

    def load_window(self, index):
        inds, scene_id = self.get_indices_to_load(index)
        return self._load_sampled(inds, self.scene_info[scene_id],
                                  self.events, self.i1[scene_id])


def memory_eval_data(scene, eval_cfg):
    """What `cli.evaluate.read_scene` reads from the scene's files for the
    evaluation config `eval_cfg`, from a `memory_scene`: (data list padded
    to 480x640, reference trajectory, timestamps of the frames the voxels
    use)."""
    from ..cli import eval_utils as eu

    train = eval_cfg["data_loader"]["train"]["args"]
    intr = tuple(float(v) for v in scene["intrinsics"])    # K.yaml's
    data_list, masks, frame_of_voxel = _voxels(
        scene["events"], make_representation(eval_cfg),
        train["num_events_selected"], list(scene["images"][1:]),
        scene["stamps"][1:], train.get("norm_to"), intr,
        read_image=np.asarray)
    frames = sorted(set(frame_of_voxel[np.asarray(masks)].tolist()))
    poses = scene["poses"]
    ref = eu.traj_from_xyzw(poses[:, :3], poses[:, 3:], scene["stamps"])
    return data_list, ref, scene["stamps"][1:][frames]


def memory_reader(scene):
    """A `read_scene` for `cli.evaluate.evaluate(read_scene=)` that gives
    the `memory_scene` whatever scene path it is asked for."""

    def read_scene(path, eval_cfg, downsample_fact=1):
        if downsample_fact != 1:
            raise ValueError("a memory scene is read at downsample_fact 1")
        data, ref, stamps = memory_eval_data(scene, eval_cfg)
        return data, ref, stamps, tuple(float(v)
                                        for v in scene["intrinsics"])

    return read_scene
