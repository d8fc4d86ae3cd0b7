"""The MultiScale VO slice under the other correlation layouts
(CORR_LAYOUT fused2 / fused4 / folded): the port's RampVO step against
rampvo_tpu's frame by frame from the same state (CPU, MIXED_PRECISION
False, 64x96, M=8), as tests/test_torch_slice_stepwise.py does for fused3;
the layout knob read from yaml; and the evaluation CLI with a yaml that
sets CORR_LAYOUT: folded. The JAX driver runs its exact flat-edge path on
the CPU whatever its layout, so it is the oracle of every port layout.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

import synthetic
from rampvo_tpu.vo import RampVO as JRampVO
from rampvo_tpu.vo import VOConfig as JVOConfig
from rampvo_tpu_torch.cli import evaluate as pev
from rampvo_tpu_torch.ops import corr_band_kernels as bk
from rampvo_tpu_torch.ops import corr_kernels as ck
from rampvo_tpu_torch.ops import corr_paired_kernels as pk
from rampvo_tpu_torch.vo import VOConfig
from rampvo_tpu_torch.vo import runtime as rt
from test_torch_cli import SMALL_VO, _write_pth, eval_cfg
from test_torch_slice import (  # noqa: F401  (weights is a fixture)
    INTR,
    KW,
    _torch_threads,
    assert_same_bookkeeping,
    frames,
    max_diff,
    port_state,
    rand_d,
    weights,
)

# the lattice correlation wrapper of each layout
WRAPPERS = {"fused3": (ck, "corr_lattice"),
            "fused4": (ck, "corr_lattice_cb"),
            "fused2": (pk, "corr_lattice_paired"),
            "folded": (bk, "corr_lattice_bands")}


@pytest.mark.parametrize("layout", ["fused2", "fused4", "folded"])
def test_slice_layout_teacher_forced(weights, layout, monkeypatch):
    """Frame by frame from the same state, 12 frames (the init burst at
    frame 7, then one update per frame with keyframe eviction): before each
    frame the port's state is set to the JAX state, one frame runs in
    both, and the results are compared at tests/test_torch_slice_stepwise
    .py's tolerances (bookkeeping identical, poses and eviction deltas
    within 1e-4, inverse depths within 5e-3). The layout's wrapper is the
    only lattice correlation called."""
    params, net = weights
    jcfg = JVOConfig(**KW, CORR_LAYOUT=layout)
    pcfg = VOConfig(**KW, CORR_LAYOUT=layout)
    calls = dict.fromkeys(WRAPPERS, 0)
    for k, (mod, name) in WRAPPERS.items():
        def counted(*a, _f=getattr(mod, name), _k=k, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
        if hasattr(rt, name):
            monkeypatch.setattr(rt, name, counted)
    jvo = JRampVO(jcfg, params, ht=64, wd=96)
    step = rt.make_vo_frame(pcfg, net, "cpu")
    M = KW["PATCHES_PER_FRAME"]
    for f, (ev, im) in enumerate(frames(12, seed=1)):
        ps = port_state(jvo.state, pcfg)
        rd = rand_d(jvo.state, M)
        jvo(f, jnp.asarray(ev), jnp.asarray(im), np.array([True]), INTR)
        ps = step(ps, ev, im, np.array([True]), INTR, rand_d=rd)
        assert_same_bookkeeping(jvo.state, ps, f)
        assert max_diff(jvo.state, ps, "poses") < 1e-4, f
        assert max_diff(jvo.state, ps, "pat_d") < 5e-3, f
        assert max_diff(jvo.state, ps, "delta_dP") < 1e-4, f
    # 12 init-burst updates + one per later frame, all through the layout
    assert calls[layout] == 12 + 4
    assert sum(calls.values()) == calls[layout]


def test_corr_layout_config(tmp_path):
    """CORR_LAYOUT is read from a config_vo yaml; fused3 is the default;
    an unknown layout raises (the reference silently runs its folded kernel
    with paired weights)."""
    p = tmp_path / "vo.yaml"
    p.write_text("PATCHES_PER_FRAME: 8\nCORR_LAYOUT: fused4\n")
    cfg = VOConfig.from_yaml(str(p))
    assert cfg.CORR_LAYOUT == "fused4" and cfg.M == 8
    assert VOConfig().CORR_LAYOUT == "fused3"
    assert [VOConfig(CORR_LAYOUT=k).corr_fc1_layout
            for k in ("fused3", "fused4", "fused2", "folded")] == [
        "reference", "reference", "paired", "folded"]
    p.write_text("CORR_LAYOUT: stacked\n")
    with pytest.raises(ValueError, match="stacked"):
        VOConfig.from_yaml(str(p))
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, CORR_LAYOUT="fused5")


def test_cli_folded_layout(tmp_path, monkeypatch):
    """cli.evaluate.main with --config_VO a yaml that sets CORR_LAYOUT:
    folded, --device cpu: the driver runs the folded layout, initializes,
    and the results JSON has a finite ATE."""
    made = []

    class Recorded(pev.RampVO):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(pev, "RampVO", Recorded)
    scene_dir = str(tmp_path / "P002")
    synthetic.write_scene(scene_dir, n_frames=10, H=60, W=80, seed=2)
    weights = str(tmp_path / "w.pth")
    _write_pth(weights, "MultiScale", seed=6)
    (tmp_path / "eval.json").write_text(json.dumps(eval_cfg(scene_dir)))
    (tmp_path / "vo.yaml").write_text("".join(
        f"{k}: {v}\n" for k, v in dict(SMALL_VO,
                                       CORR_LAYOUT="folded").items()))
    results = tmp_path / "out.json"
    launches = bk.corr_lattice_bands.launches
    monkeypatch.chdir(tmp_path)
    pev.main(["--weights", weights, "--config_VO", str(tmp_path / "vo.yaml"),
              "--config_eval", str(tmp_path / "eval.json"),
              "--results_path", str(results), "--device", "cpu"])
    assert len(made) == 1 and made[0].cfg.CORR_LAYOUT == "folded"
    assert made[0].state.initialized
    assert bk.corr_lattice_bands.launches == launches  # CPU: plain version
    ate = json.loads(results.read_text())[scene_dir]["trial_0"]["ate"]
    assert np.isfinite(ate) and ate != 1000.0
