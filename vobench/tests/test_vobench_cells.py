"""Each cell's plumbing, driven on the CPU at a small size through the
port's plain versions (the harness's look for a card is skipped): a
sound run comes out correct, the control and each fault a cell can have
come out not correct, and a cell declared by new files alone is found
by name."""

import json
import shutil

import pytest
import torch

from vobench import run
from vobench.tests.tiny import ROOT, damp_flow, overrides

SEED = 3000000007


def run_tiny(workload, root=ROOT, control=None, seconds=0.5,
             device="cpu"):
    return run.run_cell(workload, SEED, seconds, False, device=device,
                        root=root, overrides=overrides(workload),
                        control=control)


@pytest.mark.parametrize("workload", ["ms_eval", "ss_eval", "ms_train"])
def test_sound_run_is_correct(monkeypatch, workload):
    damp_flow(monkeypatch)
    out = run_tiny(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    names = {m["name"] for m in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["end_to_end"]
        if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) == names
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", ["ms_eval", "ms_train"])
def test_control_is_not_correct(monkeypatch, workload):
    """The control (the reference one precision below the configuration's,
    in the program's place) fails one of the cell's limits, and so does
    the VO cells' keyframe fault (the reference in the program's place
    with its eviction decision inverted)."""
    device = "cpu"
    if workload.endswith("train"):
        # the training control is TF32, which only the card has
        if not torch.cuda.is_available():
            pytest.skip("the training control (TF32) runs on the card only")
        device = "cuda"
    damp_flow(monkeypatch)
    got = {}
    run_tiny(workload, control=got, device=device)
    limits = json.loads((ROOT / "vobench" / "limits"
                         / f"{workload}.json").read_text())["limits"]
    for name, readings in got["readings"].items():
        assert any(readings[k] > lim for k, lim in limits.items()), name


def _broken(monkeypatch, fault):
    """The chunk returns its state unchanged; or every pose that BA
    produces is moved (the answer altered where it is produced); or the
    keyframe step decides the wrong way round (its flow mirrored about
    KEYFRAME_THRESH: it evicts the frames it should keep); or the chunk
    leaves a NaN in the hidden state."""
    from rampvo_tpu_torch.vo import graph, runtime

    if fault == "keyframe":
        flow = runtime._keyframe_flow

        def mirrored(cfg, state):
            return 2 * cfg.KEYFRAME_THRESH - flow(cfg, state)

        monkeypatch.setattr(runtime, "_keyframe_flow", mirrored)
        return
    if fault == "altered":
        ba = runtime.ba_infer

        def moved(*a, **kw):
            poses, disps = ba(*a, **kw)
            shift = torch.zeros_like(poses)
            shift[::2, 0] = 0.05          # every other frame of the window
            return poses + shift, disps

        monkeypatch.setattr(runtime, "ba_infer", moved)
        return
    make = graph.make_vo_frames_chunk

    def factory(cfg, vonet, K, *a, **kw):
        chunk = make(cfg, vonet, K, *a, **kw)
        if fault == "nan":
            def nan(state, *args, **kwargs):
                state = chunk(state, *args, **kwargs)
                state.net.view(-1)[:1] = float("nan")
                return state

            nan.captured = {}
            return nan

        def unchanged(state, *args, **kwargs):
            return state

        unchanged.captured = {}
        return unchanged

    monkeypatch.setattr(graph, "make_vo_frames_chunk", factory)


@pytest.mark.parametrize("fault", ["unchanged", "altered", "keyframe",
                                   "nan"])
def test_vo_fault_is_not_correct(monkeypatch, fault):
    damp_flow(monkeypatch)
    _broken(monkeypatch, fault)
    assert not run_tiny("ms_eval")["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_train_fault_is_not_correct(monkeypatch, fault):
    """A step that leaves the parameters unchanged; gradients altered where
    they are produced (the first half of the parameters' doubled before
    the optimizer clips them)."""
    from rampvo_tpu_torch.train import step as st

    apply = st.Trainer.apply

    def broken(self):
        if fault == "unchanged":
            self.count += 1
            return torch.zeros(())
        for p in self.params[:len(self.params) // 2]:
            p.grad.mul_(2.0)
        return apply(self)

    monkeypatch.setattr(st.Trainer, "apply", broken)
    damp_flow(monkeypatch)
    assert not run_tiny("ms_train")["correct"]


def test_cell_of_new_files_is_found(monkeypatch, tmp_path):
    """A cell added with files and entries alone: a traffic mix, a
    configuration and limits of its own, found by name."""
    damp_flow(monkeypatch)
    files = tmp_path / "vobench"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "vobench" / d, files / d)
    cfg = json.loads((files / "configs" / "ramp_multiscale.json").read_text())
    cfg["name"] = "ramp_ms_copy"
    (files / "configs" / "ramp_ms_copy.json").write_text(json.dumps(cfg))
    tr = json.loads((files / "traffic" / "eval_chunked.json").read_text())
    tr.update(overrides("ms_eval")["traffic"])
    (files / "traffic" / "eval_tiny.json").write_text(json.dumps(tr))
    shutil.copy(files / "limits" / "ms_eval.json",
                files / "limits" / "ms_tiny.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ms_tiny", "config": "ramp_ms_copy",
                               "traffic": "eval_tiny", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "ms_eval" in m["workloads"]:
            m["workloads"].append("ms_tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run.run_cell("ms_tiny", SEED, 0.5, False, device="cpu",
                       root=tmp_path,
                       overrides={"config": overrides("ms_eval")["config"]})
    assert out["correct"], out["checks"]
    assert "vo_frames_per_s" in out["metrics"]


@pytest.mark.parametrize("workload", ["ms_eval", "ms_train"])
def test_traced_run_reads_its_metrics(monkeypatch, workload):
    """The --trace 1 path, with the profiler (CUDA only) replaced by a
    slice of made-up device activity: every per-layer metric of the cell
    is read, with the device's busy and window seconds and a
    breakdown."""
    import contextlib

    from vobench.loops import train_step, vo_eval
    from vobench.trace import Trace

    @contextlib.contextmanager
    def fake(on):
        class Holder:
            trace = None

        h = Holder()
        yield h
        h.trace = Trace([("lattice_kernel", 0.0, 4.0),
                         ("lstm_fold_mma_kernel", 5.0, 6.0),
                         ("corr_train_fwd_kernel", 6.0, 7.0),
                         ("corr_train_bwd_kernel", 7.0, 8.0)],
                        [("vo.handoff", 0.0, 9.0)], (0.0, 10.0))

    for mod in (vo_eval, train_step):
        monkeypatch.setattr(mod, "profiled", fake)
    damp_flow(monkeypatch)
    out = run.run_cell(workload, SEED, 0.5, True, device="cpu",
                       overrides=overrides(workload))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer"]
            if workload in m["workloads"]}
    assert set(out["metrics"]) == want
    assert out["device"]["busy_s"] == pytest.approx(7e-6)
    assert out["device"]["window_s"] == pytest.approx(10e-6)
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]
