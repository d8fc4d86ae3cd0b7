"""The ATE-parity harness of rampvo_tpu_torch
(`cli/real_ckpt_eval.py`) against the JAX script scripts/real_ckpt_eval.py
(loaded by file path): the scenario table, the markdown table byte for
byte, the SKIP branches and the exit code when nothing ran; and the dry
run end to end on the CPU in a process where jax, flax and rampvo_tpu
cannot be imported.
"""

import importlib.util
import json
import os
import subprocess
import sys
from argparse import Namespace

import pytest

from rampvo_tpu_torch.cli import real_ckpt_eval as harness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jscript():
    """scripts/real_ckpt_eval.py as a module (its import puts "." and
    "tests" on sys.path; the path is restored)."""
    path = sys.path[:]
    spec = importlib.util.spec_from_file_location(
        "jax_real_ckpt_eval", os.path.join(REPO, "scripts",
                                           "real_ckpt_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


def test_scenarios_equal_jax(jscript):
    assert harness.SCENARIOS == jscript.SCENARIOS


def test_emit_table_bytes_equal_jax(jscript, tmp_path, capsys):
    """The same rows and reference ATEs give the same file and the same
    printed table, with a scene without a reference, one within 1% and
    one outside it."""
    rows = {"apollo": {"s1": 0.12345, "s2": 0.5},
            "eds": {"s3": 1.0 / 3.0}}
    ref = {"apollo": {"s2": 0.502}, "eds": {"s3": 0.3}}
    outs = []
    for name, mod in (("port", harness), ("jax", jscript)):
        path = tmp_path / f"{name}.md"
        mod.emit_table(rows, ref, str(path))
        printed = capsys.readouterr().out.replace(str(path), "OUT")
        outs.append((path.read_bytes(), printed))
    assert outs[0] == outs[1]
    text = outs[0][0].decode()
    assert "| apollo | s1 | 0.1235 | — |" in text
    assert "| YES |" in text and "| NO |" in text


def scenario_args(tmp_path):
    return Namespace(weights_dir=str(tmp_path / "w"),
                     data_root=str(tmp_path / "d"), trials=1, chunk=1,
                     save_dir=str(tmp_path / "runs"), device="cpu")


def apollo_spec(tmp_path, scenes):
    """SCENARIOS["apollo"] with its config_net's test_split set to
    `scenes` (absolute paths for the repository's config files)."""
    spec = {k: (os.path.join(REPO, v) if k.startswith("config") else v)
            for k, v in harness.SCENARIOS["apollo"].items()}
    with open(spec["config_net"]) as f:
        cfg = json.load(f)
    cfg["data_loader"]["test"]["test_split"] = scenes
    spec["config_net"] = str(tmp_path / "apollo.json")
    with open(spec["config_net"], "w") as f:
        json.dump(cfg, f)
    return spec


def test_skip_branches_match_jax(jscript, tmp_path, capsys):
    """A missing scene directory, then missing weights: both scripts
    print the same SKIP line and return None."""
    args = scenario_args(tmp_path)
    spec = apollo_spec(tmp_path, ["/somewhere/scene_a", "/else/scene_b"])
    os.makedirs(tmp_path / "d" / "MoonLanding" / "scene_a")
    said = []
    for mod in (harness, jscript):
        assert mod.run_scenario("apollo", spec, args) is None
        said.append(capsys.readouterr().out)
    assert said[0] == said[1] and "SKIP — 1/2 scene dirs missing" in said[0]
    os.makedirs(tmp_path / "d" / "MoonLanding" / "scene_b")
    for mod in (harness, jscript):
        assert mod.run_scenario("apollo", spec, args) is None
        said.append(capsys.readouterr().out)
    assert said[2] == said[3] and "SKIP — weights not found" in said[2]


def test_run_scenario_min_ate_past_test_info(jscript, tmp_path, monkeypatch):
    """With the scene and the weights there, run_scenario calls evaluate
    with the scenario's files and takes the min ATE over the trials of
    each scene. evaluate's results also hold "test_info" (it writes a
    results_path): the port skips it, the JAX script fails on it."""
    import rampvo_tpu.cli.evaluate as jev

    args = scenario_args(tmp_path)
    spec = apollo_spec(tmp_path, ["x/scene_a"])
    os.makedirs(tmp_path / "d" / "MoonLanding" / "scene_a")
    os.makedirs(tmp_path / "w")
    (tmp_path / "w" / "RAMPVO_SingleScale.pth").write_bytes(b"")
    seen = {}

    def fake(net, trials, config_VO, eval_cfg, **kw):
        seen.update(net=net, trials=trials, cfg=config_VO,
                    split=eval_cfg["data_loader"]["test"]["test_split"], **kw)
        scene = eval_cfg["data_loader"]["test"]["test_split"][0]
        return {scene: {"trial_0": {"ate": 0.3}, "trial_1": {"ate": 0.2}},
                "test_info": [{}, {}, {}]}

    monkeypatch.setattr(harness, "evaluate", fake)
    assert harness.run_scenario("apollo", spec, args) == {"scene_a": 0.2}
    assert seen["net"] == str(tmp_path / "w" / "RAMPVO_SingleScale.pth")
    assert seen["split"] == [str(tmp_path / "d" / "MoonLanding" / "scene_a")]
    assert seen["device"] == "cpu" and seen["chunk"] == 1
    assert seen["cfg"].PATCHES_PER_FRAME == 96
    monkeypatch.setattr(jev, "evaluate", fake)
    with pytest.raises(AttributeError):
        jscript.run_scenario("apollo", spec, args)


def test_nothing_ran_exits_2(tmp_path, monkeypatch, capsys):
    """The shipped configs list no test scenes and no weights are given:
    every scenario skips and main exits with code 2, as the JAX script;
    the flags are the JAX script's plus --device (cuda by default)."""
    monkeypatch.chdir(REPO)
    with pytest.raises(SystemExit) as e:
        harness.main(["--weights_dir", str(tmp_path), "--data_root",
                      str(tmp_path)])
    assert e.value.code == 2
    out = capsys.readouterr().out
    assert out.count("SKIP — weights not found") == 5
    assert "nothing ran" in out
    a = harness.parse_args([])
    assert (a.trials, a.chunk, a.out, a.device, a.configs) == (
        5, 8, "ATE_PARITY.md", "cuda", list(harness.SCENARIOS))


BLOCKED_RUN = (
    "import sys, runpy\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax',"
    " 'rampvo_tpu', 'synthetic'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n"
    "import importlib.util, os\n"
    "tests = os.path.join(os.path.dirname(os.path.dirname(importlib.util"
    ".find_spec('rampvo_tpu_torch').origin)), 'tests') + os.sep\n"
    "opened = []\n"
    "def audit(event, args):\n"
    "    if event == 'open' and isinstance(args[0], str) and"
    " os.path.abspath(args[0]).startswith(tests):\n"
    "        opened.append(args[0])\n"
    "sys.addaudithook(audit)\n"
    "sys.argv = ['real_ckpt_eval'] + sys.argv[1:]\n"
    "runpy.run_module('rampvo_tpu_torch.cli.real_ckpt_eval',"
    " run_name='__main__')\n"
    "assert not opened, opened\n"
)


def test_dryrun_cpu_without_jax(tmp_path):
    """`python -m rampvo_tpu_torch.cli.real_ckpt_eval --dryrun --device
    cpu` with jax, flax, rampvo_tpu and tests/synthetic.py (`synthetic`)
    blocked: writes the synthetic
    scene, the reference .pth and the configs under --save_dir/dryrun,
    runs the scenario through evaluate (10 frames padded to 480x640,
    ~45 s here) and writes a one-row table with a finite ATE, having
    opened no file under tests/."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", BLOCKED_RUN, "--dryrun",
                          "--device", "cpu", "--save_dir", str(tmp_path)],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=400)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "dryrun OK" in res.stdout
    table = (tmp_path / "dryrun" / "ATE_PARITY.md").read_text()
    (row,) = [ln for ln in table.splitlines()
              if ln.startswith("| dryrun-synthetic |")]
    ate = float(row.split("|")[3])
    assert 0 <= ate < 1000.0
