"""The port's remaining host utilities against the JAX package on the CPU:
`ops.neighbors.lattice_neighbors`, `data.EventSequence`,
`utils.interpolate_poses`, `utils.seed_everything`, `utils.Timer` (host
clock on the CPU; the card's CUDA-event path runs in chip_smoke.py),
`cli.evaluate.load_intrinsics(resize_to=)` and `utils.viz`, plus the
subpackages' exports (the JAX package's names that the port has).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu import data as jdata
from rampvo_tpu import utils as jutils
from rampvo_tpu.cli import evaluate as jev
from rampvo_tpu.ops.neighbors import lattice_neighbors as j_lattice_neighbors
from rampvo_tpu.utils import viz as jviz
from rampvo_tpu_torch import data as pdata
from rampvo_tpu_torch import geometry, lie, ops
from rampvo_tpu_torch import utils as putils
from rampvo_tpu_torch.cli import evaluate as pev
from rampvo_tpu_torch.utils import viz as pviz


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lattice_neighbors_vs_jax(seed):
    """lattice_neighbors == JAX's on random lattice validity (NI=5, T=7,
    M=4), empty and full rows included: int32, -1 where no neighbour."""
    rng = np.random.RandomState(seed)
    valid = rng.rand(5, 7) < 0.6
    valid[0] = False
    valid[1] = True
    a = ops.lattice_neighbors(torch.tensor(valid), 5, 7, 4)
    b = j_lattice_neighbors(jnp.asarray(valid), 5, 7, 4)
    for x, y in zip(a, b):
        assert x.dtype == torch.int32 and x.shape == (5 * 7 * 4,)
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_event_sequence_vs_jax():
    """EventSequence: sorting, timestamp scaling, relative time, length,
    concatenation and the Events round trip == JAX's."""
    feats = np.array([[30.0, 1, 2, 1], [10.0, 3, 4, -1], [20.0, 5, 6, 1]])
    kw = dict(params={"height": 10, "width": 12}, timestamp_multiplier=2.0,
              convert_to_relative=True)
    a = pdata.EventSequence(features=feats.copy(), **kw)
    b = jdata.EventSequence(features=feats.copy(), **kw)
    np.testing.assert_array_equal(a.get_sequence_only(), b.features)
    assert a.is_sorted() and len(a) == len(b) == 3
    assert a.feature_names == b.feature_names
    np.testing.assert_array_equal((a + a).features, (b + b).features)
    ev = pdata.Events(x=np.array([1, 2]), y=np.array([3, 4]),
                      t=np.array([6, 5]), p=np.array([1, 0]), width=8,
                      height=8)
    jevs = jdata.Events(x=np.array([1, 2]), y=np.array([3, 4]),
                        t=np.array([6, 5]), p=np.array([1, 0]), width=8,
                        height=8)
    sa, sb = (pdata.EventSequence.from_events(ev),
              jdata.EventSequence.from_events(jevs))
    np.testing.assert_array_equal(sa.features, sb.features)
    ba, bb = sa.to_events(), sb.to_events()
    for k in ("x", "y", "t", "p"):
        np.testing.assert_array_equal(getattr(ba, k), getattr(bb, k))
        assert getattr(ba, k).dtype == getattr(bb, k).dtype
    assert (ba.height, ba.width) == (8, 8)


def test_interpolate_poses_vs_jax():
    """interpolate_poses == JAX's: inside the span (linear position, slerp
    rotation) and clamped outside it."""
    rng = np.random.RandomState(3)
    q = rng.randn(5, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    poses = np.concatenate([rng.randn(5, 3), q], axis=1)
    ot = np.array([0.0, 0.4, 1.0, 1.5, 2.5])
    tt = np.array([-1.0, 0.0, 0.2, 0.9, 1.5, 2.0, 9.0])
    np.testing.assert_allclose(putils.interpolate_poses(poses, tt, ot),
                               jutils.interpolate_poses(poses, tt, ot),
                               atol=1e-12)


def test_seed_everything():
    """seed_everything seeds random, numpy and torch, and returns a torch
    Generator seeded the same (the JAX one returns a PRNG key): the same
    draws after seeding again."""
    def draws():
        g = putils.seed_everything(7)
        return (random.random(), np.random.rand(), torch.rand(3),
                torch.rand(3, generator=g))

    a, b = draws(), draws()
    assert a[0] == b[0] and a[1] == b[1]
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    assert isinstance(putils.seed_everything(7), torch.Generator)


def test_timer_cpu(capsys):
    """Timer on the CPU: host-clock seconds appended to results[name] per
    section, a profiler span of the section's name, printed ms without a
    results dict, nothing when disabled."""
    res = {}
    with torch.profiler.profile() as prof:
        for _ in range(2):
            with putils.Timer("sec", results=res):
                torch.ones(100).sum()
    assert len(res["sec"]) == 2 and all(0 <= x < 10 for x in res["sec"])
    assert any(e.key == "sec" for e in prof.key_averages())
    with putils.Timer("printed"):
        pass
    assert "printed:" in capsys.readouterr().out
    with putils.Timer("off", enabled=False, results=res):
        pass
    assert "off" not in res


def test_load_intrinsics_resize_to(tmp_path):
    """load_intrinsics(K.yaml, resize_to=(640, 480)) == JAX's: the
    principal point moves by half the pad from the camera's resolution;
    defaults without a file."""
    k = tmp_path / "K.yaml"
    k.write_text("cam0:\n  intrinsics: [200.0, 210.0, 170.0, 130.0]\n"
                 "  resolution: [346, 260]\n")
    for rs in (None, (640, 480)):
        a = pev.load_intrinsics(str(k), resize_to=rs)
        b = jev.load_intrinsics(str(k), resize_to=rs)
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float))
    assert pev.load_intrinsics(str(k), (640, 480))[2] == 170.0 + 147.0
    assert pev.load_intrinsics(None) == jev.load_intrinsics(None)


def test_viz(tmp_path):
    """render_events_over_image == JAX's on a signed stack (channels last
    and first; normalized and 0-255 images); plot_trajectories writes a
    PNG."""
    rng = np.random.RandomState(4)
    ev = rng.randint(-2, 3, (12, 16, 5)).astype(np.float32)
    for img in (rng.rand(12, 16, 3), 255 * rng.rand(12, 16, 3)):
        for e in (ev, np.transpose(ev, (2, 0, 1))):
            a = pviz.render_events_over_image(e, img)
            assert a.dtype == np.uint8 and a.shape == (12, 16, 3)
            np.testing.assert_array_equal(a, jviz.render_events_over_image(
                e, img))
    path = tmp_path / "traj.png"
    xyz = np.cumsum(rng.randn(20, 3), axis=0)
    assert pviz.plot_trajectories(str(path), xyz, xyz + 0.1) == str(path)
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("pkg", ["lie", "geometry", "utils", "data", "ops"])
def test_package_exports(pkg):
    """Each subpackage exports the names of the JAX package's that the
    port has, each reachable under that name (ops: `corr` and `neighbors`
    are the port's submodules of those names, holding the functions)."""
    import importlib

    port = {"lie": lie, "geometry": geometry, "utils": putils,
            "data": pdata, "ops": ops}[pkg]
    jax_pkg = importlib.import_module(f"rampvo_tpu.{pkg}")
    missing = {"data": {"resize_input"},
               "ops": {"pyramidify", "corr_lattice2", "corr_lattice_fused2",
                       "segment_mean", "corr", "neighbors"}}.get(pkg, set())
    for name in jax_pkg.__all__:
        if name not in missing:
            assert name in port.__all__ and hasattr(port, name), name
    if pkg == "ops":
        assert callable(ops.corr.corr) and callable(ops.neighbors.neighbors)
