"""Evaluation CLI (port of rampvo_tpu/cli/evaluate.py; ref
evaluate.py:313-440).

Flag-compatible with the JAX CLI:
  python -m rampvo_tpu_torch.cli.evaluate --weights W.pth
      --config_VO config_vo/x.yaml --config_eval config_net/x.json
      [--trials N] [--downsample_fact N] [--results_path out.json]
      [--shard i:n] [--device cuda|cpu]

Consumes the same config_net/*.json and config_vo/*.yaml files and the
same scene directory layout, and writes the same outputs (per-trial
ATE/rotation JSON, stamped TUM trajectories, COLMAP export). Runs on the
card unless `--device cpu` is given. Not ported yet, and refused rather
than approximated: `--chunk` > 1 (CUDA-graph frame step), `--fleet`
(multi-GPU scene fleet) and `use_pose_pred: true` (pose prediction);
ROADMAP section 1 names each.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import traceback

import numpy as np

from .. import resolve_device
from ..ckpt.train_state import restore_checkpoint
from ..ckpt.weights import load_pth
from ..data.loader import data_loader_all_events, device_prefetch
from ..models.vonet import VONet
from ..vo import RampVO, VOConfig
from . import eval_utils as eu


def _unported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to rampvo_tpu_torch yet (ROADMAP section 1, "
        f"{item})")


def load_intrinsics(K_path=None):
    """(ref: evaluate.py:44-70)"""
    if K_path is None or not os.path.exists(K_path):
        print("Using default intrinsics", [320, 320, 320, 240])
        return (320.0, 320.0, 320.0, 240.0)
    import yaml

    with open(K_path) as f:
        data = yaml.safe_load(f)
    fx, fy, cx, cy = data["cam0"]["intrinsics"]
    print(f"Using intrinsics from {K_path}", (fx, fy, cx, cy))
    return (fx, fy, cx, cy)


def load_params(weights, input_mode: str) -> VONet:
    """A `VONet` for `input_mode` from a `VONet` (returned as it is), a
    path or a loaded dict. A path is a .pth file or a training checkpoint
    directory (its newest step). The two .pth formats are told apart by
    content: a training checkpoint ({"params", "opt", "step"}, written by
    `cli.train`) gives its "params"; anything else is a reference
    state_dict and goes through `load_pth`."""
    if isinstance(weights, VONet):
        if weights.input_mode != input_mode:
            raise ValueError(f"network is {weights.input_mode}, config "
                             f"{input_mode}")
        return weights
    if isinstance(weights, str):
        weights = restore_checkpoint(weights)
    if not isinstance(weights, dict):
        raise ValueError(f"unsupported weights: {weights!r}")
    net = VONet(input_mode)
    net.load_state_dict(weights["params"] if "params" in weights
                        else load_pth(weights, input_mode))
    return net


def run(config_VO: VOConfig, net: VONet, eval_cfg, data_list, seed: int = 0,
        device="cuda"):
    """Run the VO over a scene's data list, then the 12 terminal updates
    (ref: evaluate.py:232-260).

    Returns (poses [N, 7] xyz+xyzw camera-to-world, tstamps, points,
    colors)."""
    train_cfg = eval_cfg["data_loader"]["train"]["args"]
    dev = resolve_device(device)
    H, W = data_list[0]["image"].shape[1:3]
    slam = RampVO(config_VO, net, input_mode=train_cfg["input_mode"],
                  num_event_bins=train_cfg["num_event_bins"], ht=H, wd=W,
                  event_bias=train_cfg.get("event_bias", True), seed=seed,
                  device=dev)
    for t, d in enumerate(device_prefetch(data_list, dev)):
        slam(t, d["events"], d["image"], d["mask"], d["intrinsics"])
    slam.final_refinement(12)
    poses, tstamps = slam.terminate()
    points, colors = slam.point_cloud()
    return poses, tstamps, points, colors


def evaluate_sequence(config_VO, net, eval_cfg, data_list, traj_ref,
                      img_timestamps, seed: int = 0, device="cuda"):
    """(ref: evaluate.py:263-312; the pose-prediction mode is not
    ported)"""
    poses, tstamps, points, colors = run(
        config_VO, net, eval_cfg, data_list, seed=seed, device=device)
    used = img_timestamps[: len(poses)] if len(img_timestamps) >= len(poses) \
        else np.arange(len(poses), dtype=float)
    traj_est = eu.est_trajectory(poses, used)
    ate, rot = eu.score(traj_ref, traj_est)
    return ate, rot, traj_est, traj_ref, (points, colors)


def _scene_reference(scene: str, dataset_name: str):
    """(intrinsics, reference trajectory, image timestamps) of a scene
    directory for each supported dataset layout."""
    traj_ref_path = osp.join(scene, "pose_left.txt")
    timestamps_path = osp.join(scene, "timestamps.txt")
    img_timestamps = np.loadtxt(timestamps_path)
    intr = load_intrinsics(osp.join(scene, "K.yaml"))
    if "Tartan" in dataset_name or "Synthetic" in dataset_name:
        traj_ref = eu.read_tartan_format_poses(traj_ref_path, timestamps_path)
    elif "StereoDavis" in dataset_name:
        img_timestamps = img_timestamps / 1e6
        traj_ref = eu.read_stereodavis_format_poses(
            osp.join(scene, "poses.txt"),
            osp.join(scene, "timestamps_poses.txt"))
    elif "EDS" in dataset_name:
        img_timestamps = img_timestamps / 1e6
        traj_ref = eu.read_eds_format_poses(traj_ref_path)
    elif "MoonLanding" in dataset_name:
        traj_ref = eu.read_moonlanding_format_poses(traj_ref_path,
                                                    timestamps_path)
    else:
        raise NotImplementedError(f"dataset {dataset_name} not supported")
    return intr, traj_ref, img_timestamps


def evaluate(net, trials=1, downsample_fact=1, config_VO=None, eval_cfg=None,
             results_path=None, save_dir="trajectory_evaluation",
             colmap_dir=None, device="cuda"):
    """Per-scene evaluation loop (ref: evaluate.py:313-412). A crash inside
    one trial scores the ate=1000 sentinel instead of aborting the run
    (ref evaluate.py:308-310); options that are not ported raise first."""
    test_ = eval_cfg["data_loader"]["test"]
    train_ = eval_cfg["data_loader"]["train"]["args"]
    norm_to = train_.get("norm_to")
    input_mode = train_["input_mode"]
    if test_.get("use_pose_pred", False):
        _unported("use_pose_pred", "item 12, pose prediction")
    dev = resolve_device(device)

    if config_VO is None:
        config_VO = VOConfig()
    net = load_params(net, input_mode)

    results = {}
    for scene in test_["test_split"]:
        if not os.path.exists(scene):
            raise FileNotFoundError(f"scene {scene} not found")
        scene_name = os.path.basename(scene) if os.path.isdir(scene) else scene
        intr, traj_ref, img_timestamps = _scene_reference(
            scene, test_["dataset_name"])
        data_list, frame_indices = data_loader_all_events(
            config=eval_cfg, full_scene=scene,
            downsample_fact=downsample_fact, norm_to=norm_to, intrinsics=intr,
        )
        data_list, traj_ref = eu.select_scene_cut(data_list, traj_ref, scene)
        # frame_indices index the frame list the loader used
        # (imfiles[1::ds]); the timestamps are aligned the same way
        used_ts = img_timestamps[1::downsample_fact]

        results[scene] = {}
        for j in range(trials):
            try:
                ate, rot, traj_est, ref, (points, colors) = evaluate_sequence(
                    config_VO, net, eval_cfg, data_list, traj_ref,
                    used_ts[frame_indices] if len(frame_indices) else used_ts,
                    seed=j,  # trials differ through the stochastic pieces
                    device=dev,
                )
            except Exception as e:
                traceback.print_exc()
                print(f"\n {scene_name} trial {j} FAILED ({e}): ate=1000")
                results[scene][f"trial_{j}"] = {
                    "ate": 1000.0, "rot_err": [1000.0] * 3,
                }
                continue
            print(f"\n {scene_name} trial {j}: ate={ate:.4f} rot={rot}")
            eu.save_stamped_trajectories(
                osp.join(save_dir, "full_data", f"trial_{j}", scene_name),
                ref, traj_est,
            )
            if colmap_dir:
                fx, fy, cx, cy = intr
                eu.save_output_for_colmap(
                    colmap_dir, traj_est, points, colors, fx, fy, cx, cy,
                )
            results[scene][f"trial_{j}"] = {"ate": ate, "rot_err": list(rot)}

        if results_path is not None:
            with open(results_path, "w") as f:
                json.dump(results, f, indent=4)

    if results_path is not None:
        results["test_info"] = [
            {"config_VO": config_VO.__dict__}, train_, test_,
        ]
        with open(results_path, "w") as f:
            json.dump(results, f, indent=4)
    return results


def parse_shard(spec: str, scenes: list) -> list:
    """`--shard i:n` -> this worker's round-robin scene subset (a copy of
    rampvo_tpu/parallel/eval_fleet.py::parse_shard)."""
    i, n = (int(x) for x in spec.split(":"))
    if not 0 <= i < n:
        raise ValueError(f"bad shard spec {spec!r}")
    return scenes[i::n]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", default="RAMPVO_MultiScale.pth")
    parser.add_argument("--config_VO", default="config_vo/default.yaml")
    parser.add_argument("--config_eval", type=str,
                        default="config_net/MultiScale_TartanEvent.json")
    parser.add_argument("--trials", type=int, default=1)
    parser.add_argument("--downsample_fact", type=int, default=1)
    parser.add_argument("--chunk", type=int, default=1,
                        help="frames per dispatch; only 1 is ported")
    parser.add_argument("--results_path", type=str, default=None)
    parser.add_argument("--fleet", type=int, default=0,
                        help="scene-shard worker processes; not ported")
    parser.add_argument("--shard", type=str, default=None,
                        help="evaluate only shard i of n (format i:n)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)

    if args.fleet:
        _unported("--fleet", "item 16, multi-GPU")
    if args.chunk > 1:
        _unported("--chunk > 1", "item 15, CUDA graph")
    config_VO = VOConfig.from_yaml(args.config_VO)
    with open(args.config_eval) as f:
        eval_cfg = json.load(f)
    if args.shard:
        test_ = eval_cfg["data_loader"]["test"]
        test_["test_split"] = parse_shard(args.shard, test_["test_split"])
        if not test_["test_split"]:
            return  # empty shard: no scenes, no results file

    print("Running evaluation...")
    results = evaluate(
        net=args.weights, trials=args.trials,
        downsample_fact=args.downsample_fact, config_VO=config_VO,
        eval_cfg=eval_cfg, results_path=args.results_path,
        device=args.device,
    )
    for k in results:
        print(k, results[k])


if __name__ == "__main__":
    main()
