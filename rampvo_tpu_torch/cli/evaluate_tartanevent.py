"""TartanEvent full-scene evaluation entry point (port of
rampvo_tpu/cli/evaluate_tartanevent.py).

The reference README advertises `evaluate_tartanevent.py` but its repo
omits it; this is the thin variant of cli.evaluate for full TartanEvent
scene directories:

  python -m rampvo_tpu_torch.cli.evaluate_tartanevent --weights W
      --config_VO config_vo/default.yaml
      --config_eval config_net/MultiScale_TartanEvent.json
      --dataset_path /path/to/TartanEvent [--scenes S1 S2 ...]
      [--device cuda|cpu]

Scenes: the given subdirectories of --dataset_path, else the config's
test_split under it, else every */*/* directory holding image_left.
"""

from __future__ import annotations

import argparse
import glob
import json
import os.path as osp

from ..vo import VOConfig
from .evaluate import evaluate


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", default="RAMPVO_MultiScale.pth")
    parser.add_argument("--config_VO", default="config_vo/default.yaml")
    parser.add_argument("--config_eval", type=str,
                        default="config_net/MultiScale_TartanEvent.json")
    parser.add_argument("--dataset_path", type=str, required=True)
    parser.add_argument("--scenes", nargs="*", default=None,
                        help="scene subdirs; defaults to the config's "
                        "test_split")
    parser.add_argument("--trials", type=int, default=1)
    parser.add_argument("--downsample_fact", type=int, default=1)
    parser.add_argument("--results_path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the plain versions)")
    args = parser.parse_args(argv)

    config_VO = VOConfig.from_yaml(args.config_VO)
    with open(args.config_eval) as f:
        eval_cfg = json.load(f)

    if args.scenes:
        scenes = [osp.join(args.dataset_path, s) for s in args.scenes]
    else:
        listed = eval_cfg["data_loader"]["test"]["test_split"]
        scenes = [osp.join(args.dataset_path, s) for s in listed]
        if not scenes:
            scenes = sorted(
                p for p in glob.glob(osp.join(args.dataset_path, "*/*/*"))
                if osp.isdir(osp.join(p, "image_left"))
            )
    eval_cfg["data_loader"]["test"]["test_split"] = scenes
    eval_cfg["data_loader"]["test"].setdefault(
        "dataset_name", "TartanEvent_competition"
    )

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
