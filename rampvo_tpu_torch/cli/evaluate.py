"""Evaluation CLI (port of rampvo_tpu/cli/evaluate.py; ref
evaluate.py:313-440).

Flag-compatible with the JAX CLI:
  python -m rampvo_tpu_torch.cli.evaluate --weights W.pth
      --config_VO config_vo/x.yaml --config_eval config_net/x.json
      [--trials N] [--downsample_fact N] [--results_path out.json]
      [--chunk K] [--fleet N | --shard i:n] [--device cuda|cpu]

Consumes the same config_net/*.json and config_vo/*.yaml files and the
same scene directory layout, and writes the same outputs (per-trial
ATE/rotation JSON, stamped TUM trajectories, COLMAP export). Runs on the
card unless `--device cpu` is given. `--chunk K` runs the initialized
frames K at a time (`RampVO(chunk=K)`: one CUDA-graph replay per K frames
on the card, the same frames eagerly on the CPU). `--fleet N` runs N
worker processes of this CLI, each on a round-robin shard of the scenes
(`--shard i:N`, `parallel/eval_fleet.py`), and merges their results.
`use_pose_pred: true` in the eval config's test section scores the
pose-prediction mode (`run_pose_pred`).
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
from ..parallel.eval_fleet import parse_shard, run_fleet
from ..vo import RampVO, VOConfig
from . import eval_utils as eu


def load_intrinsics(K_path=None, resize_to=None):
    """(fx, fy, cx, cy) from a scene's K.yaml, or the defaults without one
    (ref: evaluate.py:44-70). `resize_to` (width, height) moves the
    principal point by half the padding from the camera's resolution to
    that size, as a centred pad does."""
    if K_path is None or not os.path.exists(K_path):
        print("Using default intrinsics", [320, 320, 320, 240])
        return (320.0, 320.0, 320.0, 240.0)
    import yaml

    with open(K_path) as f:
        data = yaml.safe_load(f)
    fx, fy, cx, cy = data["cam0"]["intrinsics"]
    if resize_to is not None:
        slack = np.array(resize_to) - np.array(data["cam0"]["resolution"])
        cx += slack[0] / 2
        cy += slack[1] / 2
    print(f"Using intrinsics from {K_path}", (fx, fy, cx, cy))
    return (fx, fy, cx, cy)


def load_params(weights, input_mode: str,
                num_event_bins: int = 5) -> VONet:
    """A `VONet` for `input_mode` and `num_event_bins` event channels from
    a `VONet` (returned as it is), a path or a loaded dict. A path is a
    .pth file or a training checkpoint directory (its newest step). The
    two .pth formats are told apart by content: a training checkpoint
    ({"params", "opt", "step"}, written by `cli.train`) gives its
    "params"; anything else is a reference state_dict and goes through
    `load_pth`."""
    if isinstance(weights, VONet):
        if (weights.input_mode, weights.evs_ch) != (input_mode,
                                                    num_event_bins):
            raise ValueError(
                f"network is {weights.input_mode} with {weights.evs_ch} "
                f"event bins, config {input_mode} with {num_event_bins}")
        return weights
    if isinstance(weights, str):
        weights = restore_checkpoint(weights)
    if not isinstance(weights, dict):
        raise ValueError(f"unsupported weights: {weights!r}")
    net = VONet(input_mode, evs_ch=num_event_bins)
    net.load_state_dict(weights["params"] if "params" in weights
                        else load_pth(weights, input_mode))
    return net


def run(config_VO: VOConfig, net: VONet, eval_cfg, data_list, seed: int = 0,
        device="cuda", chunk: int = 1):
    """Run the VO over a scene's data list, then the 12 terminal updates
    (ref: evaluate.py:232-260); `chunk` frames per flush (`RampVO`).

    Returns (poses [N, 7] xyz+xyzw camera-to-world, tstamps, points,
    colors)."""
    train_cfg = eval_cfg["data_loader"]["train"]["args"]
    dev = resolve_device(device)
    H, W = data_list[0]["image"].shape[1:3]
    slam = RampVO(config_VO, net, input_mode=train_cfg["input_mode"],
                  num_event_bins=train_cfg["num_event_bins"], ht=H, wd=W,
                  event_bias=train_cfg.get("event_bias", True), seed=seed,
                  device=dev, chunk=chunk)
    for t, d in enumerate(device_prefetch(data_list, dev)):
        slam(t, d["events"], d["image"], d["mask"], d["intrinsics"])
    slam.final_refinement(12)
    poses, tstamps = slam.terminate()
    points, colors = slam.point_cloud()
    return poses, tstamps, points, colors


def run_pose_pred(config_VO: VOConfig, net: VONet, eval_cfg, data_list,
                  t_horizon_to_pred: int, t_to_pred: int, deg_approx: int = 4,
                  seed: int = 0, device="cuda", chunk: int = 1):
    """Pose-prediction evaluation mode (ref: evaluate.py:184-229): run the
    VO up to frame t_to_pred, refine, then extrapolate each later frame up
    to t_to_pred + t_horizon_to_pred with the spline predictor
    (`RampVO.predict_future_pose`) instead of ingesting it; refine once
    more and return `terminate()`'s (poses, tstamps)."""
    train_cfg = eval_cfg["data_loader"]["train"]["args"]
    dev = resolve_device(device)
    H, W = data_list[0]["image"].shape[1:3]
    slam = RampVO(config_VO, net, input_mode=train_cfg["input_mode"],
                  num_event_bins=train_cfg["num_event_bins"], ht=H, wd=W,
                  event_bias=train_cfg.get("event_bias", True), seed=seed,
                  device=dev, chunk=chunk)
    last_kf = 0
    for t, d in enumerate(device_prefetch(data_list, dev)):
        if t < t_to_pred or t_to_pred < 0:
            slam(t, d["events"], d["image"], d["mask"], d["intrinsics"])
            last_kf = slam.state.n
        if t == t_to_pred and t_to_pred > 0:
            slam.final_refinement(12)
        if t >= t_to_pred and t_to_pred > 0:
            slam.predict_future_pose(
                sec_to_pred_future=t - t_to_pred, abs_time=t,
                last_keyframe_number=last_kf, deg=deg_approx)
        if t == t_to_pred + t_horizon_to_pred:
            break
    slam.final_refinement(12)
    return slam.terminate()


def evaluate_sequence(config_VO, net, eval_cfg, data_list, traj_ref,
                      img_timestamps, use_pose_pred: bool = False,
                      seed: int = 0, device="cuda", chunk: int = 1):
    """(ref: evaluate.py:263-312)"""
    if use_pose_pred:
        # predict the second half of the trajectory (ref evaluate.py:268-279)
        t_to_pred = traj_ref.num_poses // 2
        poses, tstamps = run_pose_pred(
            config_VO, net, eval_cfg, data_list,
            t_horizon_to_pred=traj_ref.num_poses - t_to_pred,
            t_to_pred=t_to_pred, seed=seed, device=device, chunk=chunk)
        points = np.zeros((len(poses), 3), np.float32)
        colors = np.zeros((len(poses), 3), np.float32)
    else:
        poses, tstamps, points, colors = run(
            config_VO, net, eval_cfg, data_list, seed=seed, device=device,
            chunk=chunk)
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
             colmap_dir=None, device="cuda", chunk: int = 1):
    """Per-scene evaluation loop (ref: evaluate.py:313-412). A crash inside
    one trial scores the ate=1000 sentinel instead of aborting the run
    (ref evaluate.py:308-310)."""
    test_ = eval_cfg["data_loader"]["test"]
    train_ = eval_cfg["data_loader"]["train"]["args"]
    norm_to = train_.get("norm_to")
    input_mode = train_["input_mode"]
    dev = resolve_device(device)

    if config_VO is None:
        config_VO = VOConfig()
    net = load_params(net, input_mode, train_["num_event_bins"])

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
                    use_pose_pred=test_.get("use_pose_pred", False),
                    seed=j,  # trials differ through the stochastic pieces
                    device=dev, chunk=chunk,
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


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", default="RAMPVO_MultiScale.pth")
    parser.add_argument("--config_VO", default="config_vo/default.yaml")
    parser.add_argument("--config_eval", type=str,
                        default="config_net/MultiScale_TartanEvent.json")
    parser.add_argument("--trials", type=int, default=1)
    parser.add_argument("--downsample_fact", type=int, default=1)
    parser.add_argument("--chunk", type=int, default=1,
                        help="frames per dispatch: the initialized frames "
                        "run K at a time, one CUDA-graph replay per K "
                        "frames on the card (1 = every frame eagerly)")
    parser.add_argument("--results_path", type=str, default=None)
    parser.add_argument("--fleet", type=int, default=0,
                        help="run N scene-shard worker processes and merge "
                        "their results")
    parser.add_argument("--shard", type=str, default=None,
                        help="evaluate only shard i of n (format i:n)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)

    if args.fleet:
        argv = ["--weights", args.weights, "--config_VO", args.config_VO,
                "--config_eval", args.config_eval, "--trials",
                str(args.trials), "--downsample_fact",
                str(args.downsample_fact), "--chunk", str(args.chunk),
                "--device", args.device]
        results = run_fleet(args.fleet, argv, args.results_path)
        for k in results:
            print(k, results[k])
        return
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
        device=args.device, chunk=args.chunk,
    )
    for k in results:
        print(k, results[k])


if __name__ == "__main__":
    main()
