"""The evaluation fleet and the TartanEvent entry point of rampvo_tpu_torch
on the CPU: scene sharding against rampvo_tpu (exact), `evaluate --fleet
2 --device cpu` (two worker processes, one scene each, merged) against a
one-process run over both scenes (equal), and
`cli.evaluate_tartanevent`'s scene lists and configs against the JAX
entry point's (exact)."""

import json
import os
import sys

import numpy as np
import pytest

import synthetic
from rampvo_tpu.cli import evaluate_tartanevent as jte
from rampvo_tpu.parallel import eval_fleet as jfleet
from rampvo_tpu_torch.cli import evaluate as pev
from rampvo_tpu_torch.cli import evaluate_tartanevent as pte
from rampvo_tpu_torch.parallel import eval_fleet as pfleet
from rampvo_tpu_torch.vo import VOConfig
from test_torch_cli import SMALL_VO, _torch_threads, _write_pth  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sharding_matches_jax():
    """shard_scenes and parse_shard give the JAX package's shards (more
    workers than scenes included) and refuse the same bad specs; the
    CLI's parse_shard is the fleet's."""
    assert pev.parse_shard is pfleet.parse_shard
    for n_scenes in (0, 1, 5, 7):
        scenes = [f"s{i}" for i in range(n_scenes)]
        for n in (1, 2, 3, 8):
            assert pfleet.shard_scenes(scenes, n) == jfleet.shard_scenes(
                scenes, n)
            for i in range(n):
                spec = f"{i}:{n}"
                assert pfleet.parse_shard(spec, scenes) == \
                    jfleet.parse_shard(spec, scenes)
    for bad in ("2:2", "-1:3"):
        with pytest.raises(ValueError):
            jfleet.parse_shard(bad, ["a"])
        with pytest.raises(ValueError):
            pfleet.parse_shard(bad, ["a"])


def test_fleet_matches_one_process(tmp_path, monkeypatch):
    """`python -m rampvo_tpu_torch.cli.evaluate --fleet 2 --device cpu`
    (run in-process through `main`, which starts the two workers) over two
    6-frame synthetic scenes writes merged results holding both scenes,
    equal to `evaluate` over both scenes in one process, and the test
    info."""
    scenes = []
    for i, name in enumerate(("P000", "P001")):
        root = str(tmp_path / "scenes" / name)
        synthetic.write_scene(root, n_frames=6, H=60, W=80, seed=i)
        scenes.append(root)
    cfg = json.loads(json.dumps(synthetic.EVAL_CFG))
    cfg["data_loader"]["test"] = {"test_split": scenes,
                                  "dataset_name": "Synthetic",
                                  "use_pose_pred": False}
    (tmp_path / "eval.json").write_text(json.dumps(cfg))
    (tmp_path / "vo.yaml").write_text(
        "".join(f"{k}: {v}\n" for k, v in SMALL_VO.items()))
    weights = str(tmp_path / "w.pth")
    _write_pth(weights, "MultiScale", seed=6)
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.chdir(tmp_path)
    merged_path = str(tmp_path / "merged.json")
    pev.main(["--weights", weights, "--config_VO", str(tmp_path / "vo.yaml"),
              "--config_eval", str(tmp_path / "eval.json"), "--fleet", "2",
              "--results_path", merged_path, "--device", "cpu"])
    with open(merged_path) as f:
        merged = json.load(f)
    assert set(merged) == set(scenes) | {"test_info"}
    one = pev.evaluate(weights, config_VO=VOConfig(**SMALL_VO), eval_cfg=cfg,
                       save_dir=str(tmp_path / "one"), device="cpu")
    for scene in scenes:
        trial = merged[scene]["trial_0"]
        assert np.isfinite(trial["ate"]) and trial["ate"] != 1000.0
        assert trial == one[scene]["trial_0"], scene


def _captured_calls(monkeypatch, tmp_path, listed):
    """The (scene list, dataset name, trials, device) each entry point
    hands to `evaluate` for two scene choices: --scenes, and the config's
    test_split under --dataset_path (every */*/* directory holding
    image_left when that list is empty)."""
    root = tmp_path / "TartanEvent"
    for d in ("a/Easy/P000", "a/Hard/P001", "b/Easy/P002", "b/x/nodir"):
        os.makedirs(root / d, exist_ok=True)
    for d in ("a/Easy/P000", "a/Hard/P001", "b/Easy/P002"):
        os.makedirs(root / d / "image_left", exist_ok=True)
    cfg = json.loads(json.dumps(synthetic.EVAL_CFG))
    cfg["data_loader"]["test"] = {"test_split": listed}
    (tmp_path / "eval.json").write_text(json.dumps(cfg))
    (tmp_path / "vo.yaml").write_text("PATCHES_PER_FRAME: 8\n")
    seen = {"jax": [], "port": []}

    def spy(key):
        def evaluate(net, **kw):
            test_ = kw["eval_cfg"]["data_loader"]["test"]
            seen[key].append((test_["test_split"], test_["dataset_name"],
                              kw["trials"], kw.get("device")))
            return {}
        return evaluate

    monkeypatch.setattr(jte, "evaluate", spy("jax"))
    monkeypatch.setattr(pte, "evaluate", spy("port"))
    base = ["--config_VO", str(tmp_path / "vo.yaml"), "--config_eval",
            str(tmp_path / "eval.json"), "--dataset_path", str(root),
            "--trials", "2"]
    for extra in (["--scenes", "a/Easy/P000", "b/Easy/P002"], []):
        monkeypatch.setattr(sys, "argv", ["evaluate_tartanevent"] + base
                            + extra)
        jte.main()
        pte.main(base + extra + ["--device", "cpu"])
    return seen


@pytest.mark.parametrize("listed", [["a/Hard/P001"], []],
                         ids=["test_split", "glob"])
def test_evaluate_tartanevent_matches_jax(monkeypatch, tmp_path, listed):
    """The port's TartanEvent entry point hands `evaluate` the JAX entry
    point's scenes, dataset name and trials for --scenes and for the
    config's test_split (or, when it is empty, the scene directories
    found under --dataset_path), plus its --device."""
    seen = _captured_calls(monkeypatch, tmp_path, listed)
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for (sp, dp, tp, dev), (sj, dj, tj, _) in zip(seen["port"], seen["jax"]):
        assert (sp, dp, tp) == (sj, dj, tj) and dev == "cpu"
    root = tmp_path / "TartanEvent"
    assert seen["port"][0][0] == [str(root / "a/Easy/P000"),
                                  str(root / "b/Easy/P002")]
    assert seen["port"][1][0] == ([str(root / s) for s in listed] or [
        str(root / s) for s in ("a/Easy/P000", "a/Hard/P001",
                                "b/Easy/P002")])
