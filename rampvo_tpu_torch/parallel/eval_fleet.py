"""Scene-sharded evaluation fleet (port of rampvo_tpu/parallel/
eval_fleet.py).

The reference evaluates scenes one after another on one GPU
(evaluate.py:313-412). Each VO run is sequential, but scenes are
independent: the fleet runs one worker process per shard, scenes
round-robined across shards, and merges the per-shard result files.

Workers are separate processes, each with its own device; on a host with
several cards pass each worker's environment (e.g. `CUDA_VISIBLE_DEVICES`)
in `worker_env`.

Driven by `python -m rampvo_tpu_torch.cli.evaluate --fleet N ...`; each
worker runs the same CLI with `--shard i:N`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile


def shard_scenes(scenes: list, n_workers: int) -> list[list]:
    """Round-robin scene assignment."""
    return [scenes[i::n_workers] for i in range(n_workers)]


def parse_shard(spec: str, scenes: list) -> list:
    """`--shard i:n` -> this worker's scene subset."""
    i, n = (int(x) for x in spec.split(":"))
    if not 0 <= i < n:
        raise ValueError(f"bad shard spec {spec!r}")
    return shard_scenes(scenes, n)[i]


def run_fleet(n_workers: int, argv: list[str], results_path: str | None,
              worker_env: list[dict] | None = None,
              python: str = sys.executable) -> dict:
    """Run `n_workers` evaluation CLI workers, each on a scene shard, and
    merge their results.

    argv: the evaluate CLI's arguments WITHOUT --fleet/--shard/
    --results_path (each worker gets its --shard and a temporary
    --results_path). worker_env[i]: extra environment variables of worker
    i (device pinning on a host with several cards). Raises with the end
    of the failed workers' logs if any worker fails.
    """
    tmp = tempfile.mkdtemp(prefix="rampvo_fleet_")
    procs, shard_paths, logs = [], [], []
    try:
        for i in range(n_workers):
            shard_res = os.path.join(tmp, f"shard_{i}.json")
            shard_paths.append(shard_res)
            env = dict(os.environ)
            if worker_env and i < len(worker_env):
                env.update(worker_env[i])
            cmd = [python, "-m", "rampvo_tpu_torch.cli.evaluate", *argv,
                   "--shard", f"{i}:{n_workers}", "--results_path",
                   shard_res]
            logs.append(open(os.path.join(tmp, f"worker_{i}.log"), "w"))
            procs.append(subprocess.Popen(cmd, env=env, stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        failed = [i for i, p in enumerate(procs) if p.wait() != 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if failed:
        tails = []
        for i in failed:
            with open(os.path.join(tmp, f"worker_{i}.log")) as f:
                tails.append(f"--- worker {i} ---\n" + f.read()[-2000:])
        raise RuntimeError(f"fleet workers {failed} failed:\n"
                           + "\n".join(tails))

    merged: dict = {}
    for path in shard_paths:
        if not os.path.exists(path):
            continue  # empty shard (more workers than scenes)
        with open(path) as f:
            shard = json.load(f)
        info = shard.pop("test_info", None)
        merged.update(shard)
        if info is not None and "test_info" not in merged:
            merged["test_info"] = info
    if results_path is not None:
        with open(results_path, "w") as f:
            json.dump(merged, f, indent=4)
    return merged
