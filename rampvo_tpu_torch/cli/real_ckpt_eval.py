"""ATE-parity harness for the published reference checkpoints (port of
scripts/real_ckpt_eval.py).

The accuracy bar is an ATE within 1% of the PyTorch reference's published
checkpoints (`RAMPVO_MultiScale.pth`, `RAMPVO_SingleScale.pth`) on the
five scenarios of `SCENARIOS`. Neither the checkpoints nor the datasets
are in the repository, so this harness waits for them as arguments:

  python -m rampvo_tpu_torch.cli.real_ckpt_eval \\
      --weights_dir DIR_WITH_RAMPVO_{Multi,Single}Scale.pth \\
      --data_root DIR_WITH_DATASETS [--ref_ate ref_ate.json] \\
      [--configs apollo eds ...] [--out ATE_PARITY.md] [--device cuda|cpu]

For each scenario it resolves the weights and the config_net/config_vo
pair (the files the reference CLI reads), roots the test_split scenes
under --data_root, runs the port's `cli.evaluate.evaluate` in-process and
writes a markdown ATE table (min over --trials). `--ref_ate` is a JSON
{config: {scene: ate}} of the reference's numbers; with it the table gains
delta and pass/fail columns against the 1% bar. Exit code 2 when nothing
ran.

  python -m rampvo_tpu_torch.cli.real_ckpt_eval --dryrun [--device cpu]

runs the same path (run_scenario -> evaluate -> emit_table) on a
synthetic 10-frame scene with seeded random weights written as a
reference-format .pth, all under --save_dir/dryrun: the harness's own
smoke test. The scene is data/synthetic.py's `write_scene`; writing and
reading it needs h5py.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys

import torch

from ..vo import VOConfig
from .evaluate import evaluate, read_scene as read_scene_files

# the five configurations of the published results -> runnable scenarios
SCENARIOS = {
    "apollo": dict(
        weights="RAMPVO_SingleScale.pth",
        config_net="config_net/SingleScale_Apollo.json",
        config_vo="config_vo/default.yaml",
        data_subdir="MoonLanding",
    ),
    "eds": dict(
        weights="RAMPVO_SingleScale.pth",
        config_net="config_net/SingleScale_EDS.json",
        config_vo="config_vo/default.yaml",
        data_subdir="EDS",
    ),
    "stereodavis": dict(
        weights="RAMPVO_MultiScale.pth",
        config_net="config_net/MultiScale_StereoDavis.json",
        config_vo="config_vo/default_StereoDavis.yaml",
        data_subdir="StereoDavis",
    ),
    "tartanevent": dict(
        weights="RAMPVO_MultiScale.pth",
        config_net="config_net/MultiScale_TartanEvent.json",
        config_vo="config_vo/default.yaml",
        data_subdir="TartanEvent",
        tartanevent=True,
    ),
    "competition": dict(
        weights="RAMPVO_MultiScale.pth",
        config_net="config_net/MultiScale_ECCV20Competition.json",
        config_vo="config_vo/default.yaml",
        data_subdir="ECCV20Competition",
    ),
}


def run_scenario(name, spec, args, read_scene=read_scene_files):
    """One scenario: {scene basename: min ATE over the trials}, or None
    (after a SKIP line) when a scene directory or the weights file is
    missing. `read_scene` is `evaluate`'s scene reader."""
    with open(spec["config_net"]) as f:
        eval_cfg = json.load(f)
    cfg_vo = VOConfig.from_yaml(spec["config_vo"])

    # scene paths: keep the config's basenames, root them under data_root
    test = eval_cfg["data_loader"]["test"]
    scenes = [osp.join(args.data_root, spec["data_subdir"], osp.basename(s))
              for s in test["test_split"]]
    missing = [s for s in scenes if not osp.isdir(s)]
    if missing:
        print(f"[{name}] SKIP — {len(missing)}/{len(scenes)} scene dirs "
              f"missing under {args.data_root} (first: {missing[0]})")
        return None
    test["test_split"] = scenes

    weights = osp.join(args.weights_dir, spec["weights"])
    if not osp.isfile(weights):
        print(f"[{name}] SKIP — weights not found: {weights}")
        return None

    results = evaluate(
        net=weights, trials=args.trials, config_VO=cfg_vo,
        eval_cfg=eval_cfg, chunk=args.chunk,
        save_dir=osp.join(args.save_dir, name),
        results_path=osp.join(args.save_dir, f"{name}_results.json"),
        device=args.device, read_scene=read_scene,
    )
    # (the JAX script also reads the "test_info" entry that a results_path
    # adds as a scene, and fails on it)
    return {osp.basename(scene): float(min(
                v["ate"] for k, v in trials.items() if k.startswith("trial_")))
            for scene, trials in results.items() if scene != "test_info"}


def emit_table(rows, ref_ate, out_path):
    """The markdown ATE table of `rows` {config: {scene: ate}} against
    `ref_ate`, written to `out_path` and printed."""
    lines = [
        "# ATE parity vs the published reference checkpoints",
        "",
        "ATE in the same units the eval CLI reports (evo APE rmse, "
        "Umeyama-aligned). `ref` from --ref_ate; bar = within 1%.",
        "",
        "| config | scene | ours | ref | delta | within 1% |",
        "|---|---|---|---|---|---|",
    ]
    for name, scenes in rows.items():
        for scene, ate in scenes.items():
            ref = (ref_ate.get(name, {}) or {}).get(scene)
            if ref is None:
                lines.append(f"| {name} | {scene} | {ate:.4f} | — | — | — |")
            else:
                d = (ate - ref) / max(abs(ref), 1e-12)
                ok = "YES" if abs(d) <= 0.01 else "NO"
                lines.append(
                    f"| {name} | {scene} | {ate:.4f} | {ref:.4f} "
                    f"| {d * 100:+.2f}% | {ok} |"
                )
    text = "\n".join(lines) + "\n"
    with open(out_path, "w") as f:
        f.write(text)
    print(text)
    print(f"wrote {out_path}")


def write_reference_pth(path: str, net) -> None:
    """`net`'s weights as a reference checkpoint: {"model_state_dict"}
    with the "module." prefix of the reference's DataParallel saves."""
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in
                                     net.state_dict().items()}}, path)


DRY_VO = dict(BUFFER_SIZE=64, MAX_FRAMES=64, MEM=16, PATCHES_PER_FRAME=8,
              REMOVAL_WINDOW=5, OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3,
              KEYFRAME_INDEX=2, MIXED_PRECISION=False, PROBE_THRESH=-1.0)


def dryrun(args):
    """The harness end to end on a synthetic scene: a 60x80 scene of 10
    frames, seeded random MultiScale weights written as a reference .pth,
    a small VO config, one trial through run_scenario and emit_table,
    all under args.save_dir/dryrun."""
    from ..data import synthetic
    from ..models.vonet import VONet, init_weights

    tmp = osp.join(args.save_dir, "dryrun")
    synthetic.write_scene(osp.join(tmp, "data", "Synthetic", "P000"))
    os.makedirs(tmp, exist_ok=True)
    eval_cfg = json.loads(json.dumps(synthetic.EVAL_CFG))
    eval_cfg["data_loader"]["test"] = {
        "test_split": ["P000"], "dataset_name": "Synthetic",
        "use_pose_pred": False}
    spec = dict(weights="RAMPVO_MultiScale.pth",
                config_net=osp.join(tmp, "eval.json"),
                config_vo=osp.join(tmp, "vo.yaml"), data_subdir="Synthetic")
    with open(spec["config_net"], "w") as f:
        json.dump(eval_cfg, f)
    with open(spec["config_vo"], "w") as f:
        f.writelines(f"{k}: {v}\n" for k, v in DRY_VO.items())
    os.makedirs(osp.join(tmp, "weights"), exist_ok=True)
    net = init_weights(VONet("MultiScale"), torch.Generator().manual_seed(0))
    write_reference_pth(osp.join(tmp, "weights", spec["weights"]), net)
    dry = argparse.Namespace(
        weights_dir=osp.join(tmp, "weights"), data_root=osp.join(tmp, "data"),
        trials=1, chunk=1, save_dir=osp.join(tmp, "runs"), device=args.device)
    rows = {"dryrun-synthetic": run_scenario("dryrun-synthetic", spec, dry)}
    emit_table(rows, {}, osp.join(tmp, "ATE_PARITY.md"))
    ate = rows["dryrun-synthetic"]["P000"]
    if ate == 1000.0:
        raise RuntimeError("dryrun hit the failure sentinel")
    print(f"dryrun OK (random-init ate={ate:.4f}; harness path exercised)")
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights_dir", default="checkpoints")
    ap.add_argument("--data_root", default="datasets")
    ap.add_argument("--ref_ate", default=None,
                    help="JSON {config: {scene: ref_ate}}")
    ap.add_argument("--configs", nargs="*", default=list(SCENARIOS))
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--save_dir", default="ate_parity_runs")
    ap.add_argument("--out", default="ATE_PARITY.md")
    ap.add_argument("--dryrun", action="store_true",
                    help="smoke the harness on a synthetic scene")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.dryrun:
        dryrun(args)
        return

    ref_ate = {}
    if args.ref_ate:
        with open(args.ref_ate) as f:
            ref_ate = json.load(f)

    rows = {}
    for name in args.configs:
        res = run_scenario(name, SCENARIOS[name], args)
        if res is not None:
            rows[name] = res
    if not rows:
        print("nothing ran — provide --weights_dir/--data_root with the "
              "published artifacts (see module docstring)")
        sys.exit(2)
    emit_table(rows, ref_ate, args.out)


if __name__ == "__main__":
    main()
