"""The training loader, plain (frozen copy of the port's
data/tartan.py::TartanEventDataset and data/synthetic.py::MemoryDataset
over a scene held in memory: the frame graph's window sampling, the
closing and in-between event chunks as count-binned stacks, the
augmentation, the normalization). Edits against the port's files: the
scene comes only from memory (no scene files, pickles or index files),
the stack is the numpy version (the port's native one is equal to it bit
for bit), and the two classes are one.
"""

from __future__ import annotations

import numpy as np

from . import frame_graph
from .augmentation import (
    EventRGBDAugmentor,
    set_random_sample_to_zero,
    set_random_sequence_to_zero,
)
from .events import Events

DEPTH_SCALE = 5.0  # ref: TartanEvent.py:23
PLANE_Z = 2.0


class MemoryEvents:
    """An event stream held in memory (`get_between_idx`)."""

    def __init__(self, x, y, t, p, height, width):
        self.x, self.y, self.t, self.p = x, y, t, p
        self.height, self.width = height, width

    def get_between_idx(self, i0, i1):
        return Events(x=self.x[i0:i1], y=self.y[i0:i1], t=self.t[i0:i1],
                      p=self.p[i0:i1], height=self.height, width=self.width)

    def __len__(self):
        return len(self.t)


def normalize_image(images: np.ndarray, norm_img_to: str | None = None) -> np.ndarray:
    """(ref: ramp/utils.py:573-583)"""
    images = images.astype(np.float32)
    if norm_img_to == "-1_1":
        return 2 * (images / 255.0) - 1
    return 2 * (images / 255.0) - 0.5


def stack_numpy(events: Events, num_bins: int) -> np.ndarray:
    """EventToStack's numpy version: [bins, H, W] int8."""
    grid = np.zeros((num_bins, events.height, events.width), np.float32)
    n = len(events)
    if n < 2:
        return grid.astype(np.int8)

    b = (num_bins * np.arange(n, dtype="float32") / n).astype("int32")
    x = events.x.astype(np.int64)
    y = events.y.astype(np.int64)
    ok = (x >= 0) & (y >= 0) & (x < events.width) & (y < events.height)
    np.add.at(grid, (b[ok], y[ok], x[ok]), events.p[ok].astype(np.float32))
    return grid.astype(np.int8)


def normalize_depth_and_poses(poses, disps):
    """0.98-quantile scale normalization (ref: TartanEvent.py:187-192)."""
    s = 0.7 * np.quantile(disps, 0.98)
    disps = disps / s
    poses = poses.copy()
    poses[..., :3] *= s
    return poses, disps


class MemoryDataset:
    """Training windows over a scene in memory (`memory_scene`'s dict)."""

    read_image = staticmethod(np.asarray)

    @staticmethod
    def read_depth(depth):
        return depth / DEPTH_SCALE

    def __init__(self, scene, config, step=0, seed=0, fmin=10.0, fmax=75.0):
        self._setup(config, None, step=step, seed=seed, fmin=fmin,
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

    def _setup(self, config, path, step=0, crop_size=(480, 640),
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
        if rep != "stack":
            raise NotImplementedError(rep)
        bins = self.num_event_bins
        self.representation = lambda ev: stack_numpy(ev, bins)

        if self.aug_enabled:
            self.augmentor = EventRGBDAugmentor(self.crop_size, seed=seed)


    @staticmethod
    def calib_read():
        return np.array([320.0, 320.0, 320.0, 240.0])

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
        blob = event.get_between_idx(int(i_start), int(i_stop))
        rep = self.representation(blob)  # [bins, H, W]
        return np.transpose(rep, (1, 2, 0)).astype(np.float32)

    def _event_tensor(self, event, i_start, i_stop):
        blob = event.get_between_idx(int(i_start), int(i_stop))
        rep = self.representation(blob)  # [bins, H, W]
        return np.transpose(rep, (1, 2, 0)).astype(np.float32)

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

    def __len__(self):
        return max(len(self.dataset_index) - 1, 0)

    def __getitem__(self, idx):
        """(ref: TartanEvent.py:327-364). Returns a dict of fixed-shape
        numpy arrays; events/mask zero-padded to T_cap."""
        self.iter += 1
        events, images, poses, disps, intrinsics, mask = self.load_window(idx)

        if self.aug_enabled:
            events, images, poses, disps, intrinsics = self.augmentor(
                events, images, poses, disps, intrinsics
            )

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
