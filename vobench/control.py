"""The readings that set a cell's correctness limits: the program's and
the control's, seed by seed, at the cell's own size.

    python3 -m vobench.control --workload ms_eval --seeds 11,12,13
        [--seconds 4] [--out control_ms_eval.jsonl]

Each seed runs the cell as the benchmark does (set-up, a short window at
the cell's load, the comparison with the reference). On the first
`--control-seeds` seeds (all, by default) it then puts the control in the
program's place on the same followed steps: the reference computed one
precision below the configuration's (check_vo's `control_net`, float8 for
bf16; check_train's TF32 for float32), and, in the VO cells, the keyframe
fault (check_vo's `inverted`). One JSON line a seed: {"seed", "program":
{number: reading}, "control": {...}, "fault": {...}}. Needs the card, as
the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-seeds", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("vobench.control: no CUDA device", file=sys.stderr)
        return 2
    lines = []
    seeds = [int(s) for s in args.seeds.split(",")]
    n_ctl = len(seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(seeds):
        holder = {"with_control": i < n_ctl}
        out = run.run_cell(args.workload, seed, args.seconds, False,
                           control=holder)
        line = {"seed": seed, "correct": out["correct"],
                "program": holder["program"], **holder["readings"]}
        print(json.dumps(line), flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
