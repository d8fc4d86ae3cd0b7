"""The port's benchmark entry point on the CPU:
`rampvo_tpu_torch.cli.bench.main` with `--device cpu` at 64x96, M=8, 40
warm frames and 4 timed ones, with chunks of 4 and frame by frame. Its
VOConfig is bench.py's with a small lattice swapped in (bench.py's own
lattice takes about 5 s a frame here). It must print one parseable JSON
line last, named by mode and size, from a run whose VO initialized (the
entry point raises otherwise)."""

import dataclasses
import json

import pytest

from rampvo_tpu_torch.cli import bench
from test_torch_slice import _torch_threads  # noqa: F401  (a fixture)

SMALL = dict(BUFFER_SIZE=64, MAX_FRAMES=64, REMOVAL_WINDOW=5,
             OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
             MIXED_PRECISION=False, MEM=16)


@pytest.mark.parametrize("input_mode, chunk", [("MultiScale", 4),
                                               ("SingleScale", 1)])
def test_bench_prints_one_json_line(monkeypatch, capsys, input_mode, chunk):
    real = bench.bench_config
    monkeypatch.setattr(bench, "bench_config", lambda *a: dataclasses.replace(
        real(*a), **SMALL))
    bench.main(["--device", "cpu", "--height", "64", "--width", "96",
                "--patches", "8", "--frames", "4", "--chunk", str(chunk),
                "--input_mode", input_mode])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == f"vo_fps_{input_mode.lower()}_64x96"
    assert line["unit"] == "frames/s" and line["device"] == "cpu"
    assert line["value"] > 0
