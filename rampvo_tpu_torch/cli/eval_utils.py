"""Evaluation utilities: trajectory container, dataset-specific GT readers,
trajectory/COLMAP export (ref: utils/eval_utils.py, ramp/utils.py:633-656).

A light `Trajectory` (xyz + wxyz quats + stamps) replaces evo's
PoseTrajectory3D; scoring runs through this package's utils.metrics.
Port of rampvo_tpu/cli/eval_utils.py.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
from pathlib import Path

import numpy as np

NED_TO_XYZ_PERM = [1, 2, 0, 4, 5, 3, 6]  # eval_utils.py:140,152


@dataclasses.dataclass
class Trajectory:
    positions_xyz: np.ndarray     # [N, 3]
    quat_wxyz: np.ndarray         # [N, 4]
    timestamps: np.ndarray        # [N]

    @property
    def num_poses(self) -> int:
        return len(self.timestamps)

    def subset(self, idx) -> "Trajectory":
        return Trajectory(
            self.positions_xyz[idx], self.quat_wxyz[idx], self.timestamps[idx]
        )


def traj_from_xyzw(mat_xyz, quat_xyzw, stamps) -> Trajectory:
    return Trajectory(
        np.asarray(mat_xyz, float),
        np.roll(np.asarray(quat_xyzw, float), 1, axis=1),
        np.asarray(stamps, float),
    )


def read_eds_format_poses(traj_path) -> Trajectory:
    """stamped t x y z qx qy qz qw (ref: eval_utils.py:119-127)."""
    mat = np.loadtxt(traj_path).astype(float)
    return traj_from_xyzw(mat[:, 1:4], mat[:, 4:8], mat[:, 0])


def read_stereodavis_format_poses(traj_path, timestamps_path) -> Trajectory:
    """x y z qx qy qz qw + separate µs timestamps (ref: :129-137)."""
    mat = np.loadtxt(traj_path).astype(float)
    stamps = np.loadtxt(timestamps_path) / 1e6
    return traj_from_xyzw(mat[:, 0:3], mat[:, 3:7], stamps)


def read_tartan_format_poses(traj_path, timestamps_path) -> Trajectory:
    """TartanAir NED -> XYZ permutation, first row dropped because frame 0
    has no events (ref: :139-148, evaluate.py:110). Timestamps are aligned
    to the kept poses (the reference passes the full stamp array;
    intended behavior is the frame-1-onward alignment)."""
    traj = np.loadtxt(traj_path, delimiter=" ")[1:, NED_TO_XYZ_PERM]
    stamps = np.loadtxt(timestamps_path)
    if len(stamps) == len(traj) + 1:
        stamps = stamps[1:]
    stamps = stamps[: len(traj)]
    traj = traj[: len(stamps)]
    return traj_from_xyzw(traj[:, 0:3], traj[:, 3:7], stamps)


def read_moonlanding_format_poses(traj_path, timestamps_path) -> Trajectory:
    """Same layout as Tartan (ref: :150-159)."""
    return read_tartan_format_poses(traj_path, timestamps_path)


def select_scene_cut(data_list, traj_ref: Trajectory, scene_path: str):
    """StereoDavis indoor_flying warmup cuts (ref: eval_utils.py:101-117)."""
    cuts = {
        "indoor_flying4": 160,
        "indoor_flying3": 189,
        "indoor_flying2": 250,
        "indoor_flying1": 105,
    }
    for key, n in cuts.items():
        if key in scene_path:
            return data_list[n:], traj_ref.subset(slice(n, None))
    return data_list, traj_ref


def est_trajectory(poses_xyzw: np.ndarray, timestamps: np.ndarray) -> Trajectory:
    """SLAM output [N,7] (x y z qx qy qz qw) -> Trajectory
    (ref: evaluate.py:288-292)."""
    return traj_from_xyzw(poses_xyzw[:, :3], poses_xyzw[:, 3:7], timestamps)


def associate(ref: Trajectory, est: Trajectory, max_diff: float = 0.01):
    from ..utils.metrics import associate_trajectories

    ir, ie = associate_trajectories(ref.timestamps, est.timestamps, max_diff)
    return ref.subset(ir), est.subset(ie)


def score(ref: Trajectory, est: Trajectory):
    """(ate_rmse, rot_err_per_axis) with the reference's failure sentinel
    (ref: evaluate.py:294-310)."""
    from ..utils.metrics import ate_rmse, rot_error_per_axis

    try:
        r, e = associate(ref, est)
        if r.num_poses < 3:
            raise ValueError("too few associated poses")
        ate = ate_rmse(e.positions_xyz, r.positions_xyz)
        rot = rot_error_per_axis(
            np.roll(e.quat_wxyz, -1, axis=1), np.roll(r.quat_wxyz, -1, axis=1)
        )
        return float(ate), [float(x) for x in rot]
    except Exception:
        return 1000.0, [1000.0, 1000.0, 1000.0]


def save_stamped_trajectories(save_dir, traj_ref: Trajectory,
                              traj_est: Trajectory, time_scale=1e-9):
    """TUM-format stamped trajectories (ref: evaluate.py:73-96)."""
    os.makedirs(save_dir, exist_ok=True)
    for name, t in (("stamped_groundtruth.txt", traj_ref),
                    ("stamped_traj_estimate.txt", traj_est)):
        ts = (t.timestamps * time_scale)[..., None]
        np.savetxt(
            osp.join(save_dir, name),
            np.concatenate((ts, t.positions_xyz, t.quat_wxyz), axis=1),
        )


def save_output_for_colmap(name, traj: Trajectory, points, colors,
                           fx, fy, cx, cy, H=480, W=640, scale=10.0):
    """COLMAP-compatible sparse export (ref: ramp/utils.py:633-656)."""
    out = Path(name)
    out.mkdir(exist_ok=True, parents=True)

    lines = []
    for idx in range(traj.num_poses):
        x, y, z = traj.positions_xyz[idx] * scale
        qw, qx, qy, qz = traj.quat_wxyz[idx]
        lines.append(f"{idx + 1} {qw} {qx} {qy} {qz} {x} {y} {z} 1\n")
    (out / "images.txt").write_text("\n".join(lines))

    pts = []
    colors_u = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
    for i, (p, c) in enumerate(zip(np.asarray(points) * scale, colors_u), 1):
        pts.append(
            f"{i} " + " ".join(map(str, list(p) + list(c)))
            + " 0.0 0 0 0 0 0 0"
        )
    (out / "points3D.txt").write_text("\n".join(pts) + "\n")
    (out / "cameras.txt").write_text(f"1 PINHOLE {W} {H} {fx} {fy} {cx} {cy}")
