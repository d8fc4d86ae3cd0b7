"""The reduction of a traced slice: busy time from the union of device
intervals, idle gaps named by the host span around them, and each
per-layer reader on a slice of its kind (and nothing on another)."""

import pytest

from vobench import run
from vobench.trace import Trace
from vobench.tests.tiny import ROOT


def slice_of(kind: str) -> Trace:
    dev = [("corrwin::lattice_kernel<bf16>", 0.0, 10.0),
           ("Memcpy DtoD", 5.0, 15.0),
           ("lstm_fold_mma_kernel", 20.0, 30.0),
           ("corr_train_fwd_kernel", 32.0, 34.0),
           ("corr_train_bwd_kernel", 34.0, 36.0)]
    spans = [("vo.handoff", 14.0, 22.0), ("train.step", 29.0, 40.0)]
    t = Trace(dev, spans, (0.0, 40.0))
    if kind == "vo":
        t.work = {"kind": "vo", "mode": "MultiScale", "frames": 2, "H": 32,
                  "W": 48, "M": 4, "lattice": (3, 5, 4), "bins": 5,
                  "dtype_bytes": 2, "edges": [20.0, 24.0],
                  "target_slots": [3.0, 3.0], "host_slots": [2.0, 2.0]}
    else:
        t.work = {"kind": "train", "steps": 1, "H": 32, "W": 48, "M": 4,
                  "n_frames": 8, "E": 100, "unroll": 3, "bins": 5,
                  "voxels": 16, "created_at": [0] * 60 + [1] * 40,
                  "dtype_bytes": 4}
        t.counters = {"peak_bytes": 3 * 2 ** 30}
    return t


def test_busy_is_the_union_of_device_intervals():
    t = slice_of("vo")
    assert t.busy_s() == pytest.approx(29e-6)     # [0, 15] + [20, 30] + [32, 36]
    assert t.window_s == pytest.approx(40e-6)
    assert [k[0] for k in t.kernels()] == [
        "corrwin::lattice_kernel<bf16>", "lstm_fold_mma_kernel",
        "corr_train_fwd_kernel", "corr_train_bwd_kernel"]
    assert t.kernel_seconds(["lattice_kernel"]) == pytest.approx(10e-6)


def test_gaps_are_named_by_the_host_span():
    b = slice_of("vo").breakdown()
    # gaps [15, 20], [36, 40] and [30, 32], longest first
    assert b["idle_gaps"] == [["vo.handoff", pytest.approx(5e-6)],
                              ["train.step", pytest.approx(4e-6)],
                              ["train.step", pytest.approx(2e-6)]]
    assert [n for n, _ in b["device_ops"]][:1] == [
        "corrwin::lattice_kernel<bf16>"]


@pytest.mark.parametrize("kind", ["vo", "train"])
def test_readers_read_their_kind_only(kind):
    bench = run.load_json(ROOT / "BENCHMARK.json")
    vo_cells = {"ms_eval", "ss_eval"}
    for m in bench["per_layer"]:
        mine = bool(set(m["workloads"]) & vo_cells) == (kind == "vo")
        v = run.load_reader(m["name"])(slice_of(kind))
        if mine:
            assert v is not None and v > 0, m["name"]
        else:
            assert v is None, m["name"]
