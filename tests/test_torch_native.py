"""The native event-tensor builders of rampvo_tpu_torch (data/native.py,
csrc/event_ops.cpp, built by g++ into rampvo_tpu_torch/_build/) on the
CPU: bit for bit equal to the port's numpy versions and to rampvo_tpu's
numpy builders, on a dense 48x64 stream (many events a pixel and bin) and
on the edge cases (no event, one event, one timestamp). rampvo_tpu's own
native voxel grid adds each event's two time weights one event at a time,
where numpy adds all lower-bin weights first, so it is held to 1e-6 (its
event stack, integer sums, exactly). Without a library the numpy versions
run and the reason is printed once."""

import numpy as np
import pytest

from rampvo_tpu.data import native as jnative
from rampvo_tpu.data import representations as jrep
from rampvo_tpu.data.events import Events as JEvents
from rampvo_tpu_torch.data import native
from rampvo_tpu_torch.data import representations as prep
from rampvo_tpu_torch.data.events import Events

H, W, BINS = 48, 64, 5


def stream(n, seed=0, same_t=False):
    rng = np.random.RandomState(seed)
    t = np.zeros(n, np.int64) if same_t else np.sort(
        rng.randint(0, 50_000, n))
    return dict(x=rng.randint(0, W, n), y=rng.randint(0, H, n), t=t,
                p=rng.randint(0, 2, n), width=W, height=H)


CASES = {"dense": stream(40_000), "empty": stream(0), "one": stream(1),
         "same_t": stream(500, seed=1, same_t=True)}


@pytest.fixture
def jax_numpy(monkeypatch):
    """rampvo_tpu's builders with its native library switched off."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)


def same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", list(CASES))
def test_native_matches_numpy(case, jax_numpy):
    """event_stack and voxel_grid (raw, and both classes, the voxel grid
    normalized) equal the port's numpy versions and rampvo_tpu's numpy
    builders bit for bit."""
    assert native.library() is not None
    ev, jev = Events(**CASES[case]), JEvents(**CASES[case])
    st = native.event_stack(ev, BINS)
    if len(ev) < 2:
        assert st is None           # numpy's zero stack stands
    else:
        assert same(st, prep.stack_numpy(ev, BINS))
    vg = native.voxel_grid(ev, BINS)
    assert same(vg, prep.voxel_numpy(ev, BINS))
    assert same(prep.EventToStack(BINS)(ev), jrep.EventToStack(BINS)(jev))
    for norm in (False, True):
        assert same(prep.EventsToVoxelGrid(BINS, norm)(ev),
                    jrep.EventsToVoxelGrid(BINS, norm)(jev))
    if case == "dense":
        assert np.abs(vg).max() > 2.0 and np.abs(st).max() > 2


def test_native_against_jax_native():
    """rampvo_tpu's native builders on the dense stream: the same stack,
    the voxel grid within 1e-6 (the summation order differs)."""
    ev, jev = Events(**CASES["dense"]), JEvents(**CASES["dense"])
    want = jnative.event_stack(jev, BINS)
    assert want is not None
    assert same(native.event_stack(ev, BINS), want)
    vg, jvg = native.voxel_grid(ev, BINS), jnative.voxel_grid(jev, BINS)
    np.testing.assert_allclose(vg, jvg, rtol=0, atol=1e-6)


def test_unbuildable_library_falls_back(tmp_path, monkeypatch, capsys):
    """A source g++ cannot compile: the builders return None, the classes
    run numpy, and the reason is printed once."""
    bad = tmp_path / "event_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(native, "_STATE", {})
    ev = Events(**CASES["dense"])
    assert native.event_stack(ev, BINS) is None
    assert native.voxel_grid(ev, BINS) is None
    assert same(prep.EventToStack(BINS)(ev), prep.stack_numpy(ev, BINS))
    err = capsys.readouterr().err
    assert err.count("numpy runs instead") == 1 and "g++ failed" in err
