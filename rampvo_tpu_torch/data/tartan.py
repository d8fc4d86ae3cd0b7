"""TartanEvent training dataset (port of rampvo_tpu/data/tartan.py; ref
ramp/data_readers/TartanEvent.py, RGBDDataset.py).

Numpy host pipeline producing fixed-shape channels-last windows:
  events      [T_cap, H, W, bins]   (zero-padded past the real chunks)
  images      [n_frames, H, W, 3]
  poses       [n_frames, 7]         (world-to-camera applied by the trainer)
  disps       [n_frames, H, W]
  intrinsics  [n_frames, 4]
  mask        [T_cap] bool          (exactly n_frames true entries)

A window's host work opens spans (`utils.timing.span`, with tracing on):
`data.window` (the window read), inside it `data.events` (each event
stack), then `data.augment` and `data.normalize` (normalization, drop,
padding and the casts).
"""

from __future__ import annotations

import os.path as osp
import pickle
from pathlib import Path

import numpy as np

from .augmentation import (
    EventRGBDAugmentor,
    set_random_sample_to_zero,
    set_random_sequence_to_zero,
)
from ..utils.timing import span
from .event_handle import H5EventHandle
from .loader import normalize_image
from .representations import EventToStack, EventsToVoxelGrid

DEPTH_SCALE = 5.0  # ref: TartanEvent.py:23
NED_TO_XYZ_PERM = [1, 2, 0, 4, 5, 3, 6]


def depth_read(depth_file):
    """(ref: TartanEvent.py:156-161)"""
    depth = np.load(depth_file) / DEPTH_SCALE
    depth[np.isnan(depth)] = 1.0
    depth[np.isinf(depth)] = 1.0
    return depth


def image_read(image_file):
    import cv2

    img = cv2.imread(image_file)  # BGR like the reference
    if img is None:
        raise FileNotFoundError(image_file)
    return img


def normalize_depth_and_poses(poses, disps):
    """0.98-quantile scale normalization (ref: TartanEvent.py:187-192)."""
    s = 0.7 * np.quantile(disps, 0.98)
    disps = disps / s
    poses = poses.copy()
    poses[..., :3] *= s
    return poses, disps


class TartanEventDataset:
    """Loads pickled scene_info + per-scene events.h5/indices.txt and yields
    training windows (frame-graph flow sampling, ref: RGBDDataset.py:84-139)."""

    # how a scene's image and depth entries are read (a subclass that
    # holds a scene in memory replaces them)
    read_image = staticmethod(image_read)
    read_depth = staticmethod(depth_read)

    def __init__(self, config, path, step=0, crop_size=(480, 640),
                 just_validation=False, seed=0, fmin=10.0, fmax=75.0):
        train_cfg = config["data_loader"]["train"]["args"]
        self.fmin, self.fmax = fmin, fmax
        self.n_frames = train_cfg["n_frames"]
        self.sample = train_cfg.get("load_sampled_frames", True)
        self.num_events_selected = train_cfg["num_events_selected"]
        self.n_events_in_between = train_cfg.get("n_events_in_between", 0)
        self.num_event_bins = train_cfg["num_event_bins"]
        self.norm_img_to = train_cfg.get("norm_img_to")
        self.data_drop = train_cfg.get("data_drop", "no")
        self.data_drop_prob = train_cfg.get("data_drop_prob", [0.4, 0.4, 0.2])
        self.steps_until_finetune = train_cfg.get("steps_until_finetune", 1000)
        self.events_importing_mode = train_cfg.get("events_importing_mode")
        self.aug_enabled = train_cfg.get("augment_data", False)
        self.crop_size = tuple(crop_size)
        self.test_scenes = config["data_loader"]["test"]["test_split"]
        self.iter = step
        self.rng = np.random.RandomState(seed)

        rep = config.get("event_representation", "stack")
        if rep == "stack":
            self.representation = EventToStack(self.num_event_bins)
        elif rep == "voxels":
            self.representation = EventsToVoxelGrid(self.num_event_bins)
        else:
            raise NotImplementedError(rep)

        if self.aug_enabled:
            self.augmentor = EventRGBDAugmentor(self.crop_size, seed=seed)

        pickle_path = config.get("path_pickle_dataset")
        if pickle_path and osp.exists(pickle_path):
            # the reference's dataset index (a file of the dataset, not
            # something this program receives from elsewhere)
            with open(pickle_path, "rb") as f:
                self.scene_info = pickle.load(f)
        else:
            self.scene_info = self.scan_scenes(path) if path else {}

        self._build_dataset_index(just_validation)
        self._load_event_indices(just_validation)

    # ------------------------------------------------------------------
    @staticmethod
    def calib_read():
        return np.array([320.0, 320.0, 320.0, 240.0])

    def scan_scenes(self, root):
        """Directory scanner (ref: TartanEvent.py:125-154, fixed: the
        reference's version is shadowed by the pickle loader)."""
        import glob

        scene_info = {}
        scenes = sorted(glob.glob(osp.join(root, "*/*/*/*")))
        if not scenes:
            scenes = [root] if osp.isdir(osp.join(root, "image_left")) else []
        for scene in scenes:
            images = sorted(glob.glob(osp.join(scene, "image_left/*.png")))
            depths = sorted(glob.glob(osp.join(scene, "depth_left/*.npy")))
            if len(images) != len(depths) or not images:
                continue
            poses = np.loadtxt(osp.join(scene, "pose_left.txt"), delimiter=" ")
            if len(poses) == len(images) + 1:
                poses = poses[1:]  # leading row is the frame-0 duplicate
            poses = poses[:, NED_TO_XYZ_PERM]
            poses[:, :3] /= DEPTH_SCALE
            intrinsics = [self.calib_read()] * len(images)

            from .frame_graph import build_frame_graph

            graph = build_frame_graph(poses, depths, intrinsics,
                                      self.read_depth)
            scene_info[scene] = {
                "events": osp.join(scene, "events.h5"),
                "images": images,
                "depths": depths,
                "poses": poses,
                "intrinsics": intrinsics,
                "graph": graph,
            }
        return scene_info

    def _build_dataset_index(self, just_validation):
        """(ref: RGBDDataset.py:39-54)"""
        self.dataset_index = []
        self.validation_index = []
        for scene in self.scene_info:
            if any(t in scene for t in self.test_scenes):
                self.validation_index.append(scene)
            elif not just_validation:
                graph = self.scene_info[scene]["graph"]
                margin = 65 if len(graph) > 80 else max(len(graph) // 4, 2)
                for i in graph:
                    if i < len(graph) - margin:
                        self.dataset_index.append((scene, i))
        if not self.validation_index:
            self.validation_index = list(self.test_scenes)

    def _load_event_indices(self, just_validation):
        """Per-frame event index ranges from indices.txt
        (ref: TartanEvent.py:98-123)."""
        self.i0, self.i1 = {}, {}
        scenes = set(self.validation_index)
        if not just_validation:
            scenes |= {s for s, _ in self.dataset_index}
        for scene in scenes:
            f = Path(scene) / "indices.txt"
            if not f.exists():
                raise ValueError(f"indices file missing: {f}")
            i0, i1 = np.loadtxt(f, delimiter=",").astype(int)
            self.i0[scene], self.i1[scene] = i0, i1

    # ------------------------------------------------------------------
    def get_indices_to_load(self, index):
        """Frame-graph flow-threshold window sampling
        (ref: RGBDDataset.py:84-139)."""
        index = index % len(self.dataset_index)
        scene_id, frame_ix = self.dataset_index[index]
        graph = self.scene_info[scene_id]["graph"]
        n_images = len(self.scene_info[scene_id]["images"])
        i1 = self.i1[scene_id]
        n_events_between = np.diff(i1)

        inds = [frame_ix]
        guard = 0
        while len(inds) < self.n_frames and guard < 10 * self.n_frames:
            guard += 1
            nbrs, dist = graph[frame_ix]
            k = (dist > self.fmin) & (dist < self.fmax)
            frames = nbrs[k]
            fwd = frames[frames > frame_ix]
            if len(fwd):
                frame_ix = int(self.rng.choice(fwd))
            elif frame_ix + 1 < n_images:
                frame_ix = frame_ix + 1
            elif len(frames):
                frame_ix = int(self.rng.choice(frames))
            if frame_ix <= 0:
                continue
            if frame_ix - 1 < len(n_events_between) and \
                    n_events_between[frame_ix - 1] < 0:
                continue
            inds.append(frame_ix)
        while len(inds) < self.n_frames:  # degenerate tiny scenes
            inds.append(inds[-1])
        return inds, scene_id

    def _event_tensor(self, event, i_start, i_stop):
        with span("data.events"):
            blob = event.get_between_idx(int(i_start), int(i_stop))
            rep = self.representation(blob)  # [bins, H, W]
            return np.transpose(rep, (1, 2, 0)).astype(np.float32)

    def load_window(self, index):
        """(ref: TartanEvent.py:245-325; both importing modes)"""
        inds, scene_id = self.get_indices_to_load(index)
        info = self.scene_info[scene_id]
        i1 = self.i1[scene_id]
        with H5EventHandle.from_path(Path(info["events"])) as event:
            if self.events_importing_mode == "all_events_all_images":
                return self._load_all_events_all_images(inds, info, event, i1)
            return self._load_sampled(inds, info, event, i1)

    def _load_sampled(self, inds, info, event, i1):
        """The sampled frames' closing event chunk each, and up to
        n_events_in_between chunks before it (ref TartanEvent.py:291-325)."""
        images, depths, poses, intrinsics = [], [], [], []
        events, mask = [], []
        for j, index_f in enumerate(inds):
            stream = i1[index_f] - i1[index_f - 1] if index_f > 0 else 0
            if j > 0:
                chunks = max(stream // self.num_events_selected, 1)
                first = i1[index_f - 1] + stream % self.num_events_selected
                for c in range(chunks - 1):
                    if c >= self.n_events_in_between:
                        break
                    events.append(
                        self._event_tensor(event, first,
                                           first + self.num_events_selected)
                    )
                    mask.append(False)
                    first += self.num_events_selected
            events.append(
                self._event_tensor(
                    event, max(i1[index_f] - self.num_events_selected, 0),
                    i1[index_f],
                )
            )
            mask.append(True)

            img = self.read_image(info["images"][index_f])
            images.append(img.astype(np.float32))
            depths.append(self.read_depth(info["depths"][index_f]))
            poses.append(info["poses"][index_f])
            intrinsics.append(info["intrinsics"][index_f])

        images = np.stack(images)
        disps = 1.0 / np.stack(depths)
        poses = np.stack(poses).astype(np.float32)
        intrinsics = np.stack(intrinsics).astype(np.float32)
        events = np.stack(events)
        mask = np.asarray(mask, bool)
        return events, images, poses, disps, intrinsics, mask

    def _load_all_events_all_images(self, inds, info, event, i1):
        """Equal-split inter-frame event streams into n_events_in_between+1
        chunks, supervising the last of each (ref: TartanEvent.py:263-290)."""
        images, depths, poses, intrinsics = [], [], [], []
        events, mask = [], []
        n_loaded = 0
        for index_f in range(min(inds), max(inds) + 1):
            if index_f < 1:
                continue
            stream = i1[index_f] - i1[index_f - 1]
            seg = max(stream // (self.n_events_in_between + 1), 1)
            for c in range(self.n_events_in_between + 1):
                first = i1[index_f - 1] + seg * c
                events.append(self._event_tensor(event, first, first + seg))
                mask.append(c == self.n_events_in_between)
            images.append(
                self.read_image(info["images"][index_f]).astype(np.float32))
            depths.append(self.read_depth(info["depths"][index_f]))
            poses.append(info["poses"][index_f])
            intrinsics.append(info["intrinsics"][index_f])
            n_loaded += 1
            if n_loaded == self.n_frames:
                break
        while n_loaded < self.n_frames:  # degenerate tiny windows: repeat
            images.append(images[-1])
            depths.append(depths[-1])
            poses.append(poses[-1])
            intrinsics.append(intrinsics[-1])
            events.append(np.zeros_like(events[-1]))
            mask.append(True)
            n_loaded += 1

        return (
            np.stack(events), np.stack(images),
            np.stack(poses).astype(np.float32), 1.0 / np.stack(depths),
            np.stack(intrinsics).astype(np.float32), np.asarray(mask, bool),
        )

    def __len__(self):
        return max(len(self.dataset_index) - 1, 0)

    def __getitem__(self, idx):
        """(ref: TartanEvent.py:327-364). Returns a dict of fixed-shape
        numpy arrays; events/mask zero-padded to T_cap."""
        self.iter += 1
        with span("data.window"):
            events, images, poses, disps, intrinsics, mask = \
                self.load_window(idx)

        if self.aug_enabled:
            with span("data.augment"):
                events, images, poses, disps, intrinsics = self.augmentor(
                    events, images, poses, disps, intrinsics
                )

        with span("data.normalize"):
            return self._normalize(events, images, poses, disps, intrinsics,
                                   mask)

    def _normalize(self, events, images, poses, disps, intrinsics, mask):
        """Scale, image normalization, data drop, padding to T_cap and the
        casts of `__getitem__`'s window."""
        poses, disps = normalize_depth_and_poses(poses, disps)
        images = normalize_image(images, self.norm_img_to)

        if self.data_drop == "sample_drop":
            events, images = set_random_sample_to_zero(events, images, self.rng)
        elif self.data_drop == "sequence_drop" and \
                self.iter >= self.steps_until_finetune:
            events, images = set_random_sequence_to_zero(
                events, images, self.rng, *self.data_drop_prob
            )

        T_cap = self.n_frames * (self.n_events_in_between + 1)
        T = events.shape[0]
        if T < T_cap:
            padding = np.zeros((T_cap - T,) + events.shape[1:], events.dtype)
            events = np.concatenate([events, padding])
            mask = np.concatenate([mask, np.zeros(T_cap - T, bool)])
        else:
            events = events[:T_cap]
            mask = mask[:T_cap]

        return {
            "events": events.astype(np.float32),
            "images": images.astype(np.float32),
            "poses": poses.astype(np.float32),
            "disps": disps.astype(np.float32),
            "intrinsics": intrinsics.astype(np.float32),
            "mask": mask,
        }


def precompute_event_indices(event_path, timestamps_path, num_events,
                             indices_file):
    """Build indices.txt: per-image event index ranges
    (ref: ramp/utils.py:340-348)."""
    with H5EventHandle.from_path(Path(event_path)) as event:
        t = np.asarray(event.t[:])
    stamps = np.genfromtxt(timestamps_path)
    i1 = np.searchsorted(t, stamps, side="right")
    i0 = np.clip(i1 - num_events, 0, len(t) - 1)
    np.savetxt(indices_file, (i0, i1), delimiter=",")
