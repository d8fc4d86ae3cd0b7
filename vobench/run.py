"""Run one cell of the benchmark once.

    python3 -m vobench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell is found by name in BENCHMARK.json at the root of the checkout;
its configuration (vobench/configs/<config>.json), traffic mix
(vobench/traffic/<traffic>.json, whose "loop" names the module of
vobench/loops that plays it), the limits of its correctness check
(vobench/limits/<workload>.json) and each per-layer metric's reader
(vobench/metrics/<metric>.py) are files of their own, found by name, so a
cell or a metric is added with files and entries alone.

Set-up runs from the process's start to the window's opening and is
printed by part on an earlier line. With --trace 0 the result carries the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, the
traced slice's busy and window seconds and its breakdown. The last lines
of standard error, and the result's last key `checks`, give each number
that `correct` compares beside its limit. The last line of standard
output is the result, one JSON object.

Without a CUDA device, or with fewer than the cell asks for, the run
prints no result and exits 2. It exits 3 if the process holds JAX or the
JAX package once the window has closed.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on the `time.time()` clock (Linux /proc; the
    first line of this module elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rampvo_tpu")
CACHE = ROOT / ".vobench_cache"


def set_cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernel libraries live in rampvo_tpu_torch/_build)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"vobench: no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, kind: str, workload: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") that this cell
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(name: str, files: Path = HERE):
    """<files>/metrics/<name>.py's `read(trace)`."""
    path = files / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vobench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a loop gets: the cell's files, the run's arguments, the
    device, and the set-up clock (`part`, `open_window`)."""

    def __init__(self, workload, config, traffic, seed, seconds, trace,
                 device):
        import torch

        self.workload, self.config, self.traffic = workload, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        # the interpreter's start and the imports of torch and the harness
        self.parts: dict = {"interpreter and imports": time.time() - T_START}
        self.setup_s = None
        self.built = None
        # the control's (and faults') readings, by name, in control runs
        self.control_readings: dict = {}

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def now(self) -> float:
        return time.perf_counter()

    def sync(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def part(self, name: str):
        t = time.time()
        yield
        self.parts[name] = self.parts.get(name, 0.0) + time.time() - t

    def init_device(self):
        """CUDA's context on the device, as set-up's own part."""
        if self.cuda:
            import torch

            with self.part("cuda init"):
                torch.zeros(1, device=self.device)
                torch.cuda.synchronize(self.device)

    def build_kernels(self, names):
        """Build (or find built) the program's kernel libraries the cell
        runs, before anything launches them."""
        if not self.cuda:
            return
        from rampvo_tpu_torch.ops import build

        with self.part("kernel libraries"):
            started = {n: build.start_build(n) for n in names}
            self.built = sorted(n for n, s in started.items() if s is not None)
            for s in started.values():
                build.finish_build(s)

    def open_window(self) -> float:
        """Ends set-up: synchronizes, resets the peak memory reading and
        prints set-up by part."""
        self.sync()
        if self.cuda:
            import torch

            torch.cuda.reset_peak_memory_stats(self.device)
        self.setup_s = time.time() - T_START
        parts = dict(self.parts)
        parts["other"] = self.setup_s - sum(parts.values())
        print("setup_s {:.4f}: ".format(self.setup_s)
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
              + ("; kernel libraries built: " + ", ".join(self.built)
                 if self.built else "; kernel libraries: cache hit"
                 if self.built is not None else ""), flush=True)
        return self.now()

    def close_window(self):
        self.sync()

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        import torch

        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self):
        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT, overrides=None,
             control=None):
    """Run the cell; returns the result dict (the last line's object).
    The cell's files are read under `root` (BENCHMARK.json and vobench/),
    its loops' code is imported.
    `overrides` ({"config": {...}, "traffic": {...}}: keys replaced at the
    top level) lets the tests drive a cell at a small size on the CPU.
    `control`, a dict, asks the check for the control's readings too and
    receives them under "readings" ({"control": {number: value}, and
    "fault" where the check plants one}), with every number of the
    program's own under "program" (vobench/control.py); with its key
    "with_control" false, only the latter."""
    bench = load_json(root / "BENCHMARK.json")
    cell = cell_of(bench, workload)
    files = root / "vobench"
    config = load_json(files / "configs" / f"{cell['config']}.json")
    traffic = load_json(files / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(files / "limits" / f"{workload}.json")
    for what, d in (overrides or {}).items():
        {"config": config, "traffic": traffic, "limits": limits}[what].update(d)
    loop = importlib.import_module(f"vobench.loops.{traffic['loop']}")
    ctx = Context(workload, config, traffic, seed, seconds, trace, device)
    ctx.control = control is not None and control.get("with_control", True)
    res = loop.run(ctx)
    if control is not None:
        control["readings"] = ctx.control_readings
        control["program"] = dict(res["checks"])

    if trace:
        t = res["trace"]
        metrics = {}
        for m in metrics_of(bench, "per_layer", workload):
            v = load_reader(m["name"], files)(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {}
        for m in metrics_of(bench, "end_to_end", workload):
            v = (ctx.setup_s if m["name"] == "setup_s"
                 else res["metrics"][m["name"]])
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: {"value": res["checks"][k], "limit": lim}
              for k, lim in limits["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    import torch

    dev = {"platform": "gpu" if ctx.cuda else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.cuda
                    else "cpu"),
           "count": int(cell["chips"]),
           "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = t.busy_s()
        dev["window_s"] = t.window_s
        out["breakdown"] = t.breakdown()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    import torch

    bench = load_json(ROOT / "BENCHMARK.json")
    chips = int(cell_of(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vobench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available. Nothing is measured off the card.",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"vobench: the process holds {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
