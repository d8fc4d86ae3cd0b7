"""The port's synthetic scene (rampvo_tpu_torch/data/synthetic.py) against
the JAX package's copy (tests/synthetic.py): the renderers bit for
bit, `write_scene`'s files, and the in-memory scene against what the
dataset and the evaluation CLI read back from those files, at a size
other than the learned-weights recipe's 60x80."""

import json
import os

import numpy as np
import pytest

import synthetic as jsyn
from rampvo_tpu_torch.cli.evaluate import read_scene
from rampvo_tpu_torch.data import synthetic as psyn
from rampvo_tpu_torch.data.tartan import TartanEventDataset

H, W = 48, 64


@pytest.mark.parametrize("hw", [(60, 80), (48, 64)])
@pytest.mark.parametrize("motion", ["line", "curve"])
@pytest.mark.parametrize("seed", [0, 3])
def test_renderers_equal_jax_sides(hw, motion, seed):
    """render_sequence and events_from_images equal tests/synthetic.py's,
    array for array, dtype and bits."""
    a = psyn.render_sequence(9, *hw, seed=seed, motion=motion)
    b = jsyn.render_sequence(9, *hw, seed=seed, motion=motion)
    ev_a, ev_b = psyn.events_from_images(a[0]), jsyn.events_from_images(b[0])
    assert len(ev_a[0]) > 1000
    for x, y in zip(a + ev_a, b + ev_b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def scene_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_write_scene_equals_jax_sides(tmp_path):
    """write_scene writes the files tests/synthetic.write_scene writes:
    the same names, PNG pixels, text of the txt and yaml files, npy
    arrays, h5 datasets and indices.txt."""
    import h5py
    from PIL import Image

    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    _, intr_a = psyn.write_scene(a, n_frames=8, H=H, W=W, seed=2,
                                 motion="curve")
    _, intr_b = jsyn.write_scene(b, n_frames=8, H=H, W=W, seed=2,
                                 motion="curve")
    np.testing.assert_array_equal(intr_a, intr_b)
    names = scene_files(a)
    assert names == scene_files(b) and len(names) == 21
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".png"):
            x, y = np.asarray(Image.open(pa)), np.asarray(Image.open(pb))
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        elif name.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        elif name.endswith(".h5"):
            with h5py.File(pa) as fa, h5py.File(pb) as fb:
                ga, gb = fa["events"], fb["events"]
                assert sorted(ga) == sorted(gb)
                for k in ga:
                    x, y = ga[k][()], gb[k][()]
                    assert x.dtype == y.dtype and np.array_equal(x, y), k
        else:
            with open(pa) as fa, open(pb) as fb:
                assert fa.read() == fb.read(), name


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic") / "P000")
    psyn.write_scene(root, n_frames=16, H=H, W=W, seed=1, motion="curve")
    return root


def config(n_frames=8, events=600):
    cfg = json.loads(json.dumps(psyn.EVAL_CFG))
    cfg["data_loader"]["train"]["args"].update(
        n_frames=n_frames, num_events_selected=events, image_height=H,
        image_width=W)
    return cfg


@pytest.mark.parametrize("events", [600, 1500])
def test_memory_dataset_equals_files(scene, events):
    """MemoryDataset over memory_scene gives TartanEventDataset's windows
    over the files, with the same sampling draws, at num_events_selected
    600 (indices.txt's) and another."""
    cfg = config(events=events)
    mem = psyn.memory_scene(16, H, W, motion="curve", seed=1)
    a = TartanEventDataset(cfg, scene, seed=5, fmin=0.001, fmax=1000.0)
    b = psyn.MemoryDataset(mem, cfg, seed=5, fmin=0.001, fmax=1000.0)
    assert len(a) == len(b) > 4
    for idx in (1, 2, 4, len(a)):
        wa, wb = a[idx], b[idx]
        assert sorted(wa) == sorted(wb)
        for k in wa:
            assert wa[k].dtype == wb[k].dtype, k
            np.testing.assert_array_equal(wa[k], wb[k], err_msg=k)


@pytest.mark.parametrize("events", [600, 1500])
def test_memory_eval_data_equals_files(scene, events):
    """memory_eval_data and memory_reader give what cli.evaluate's
    read_scene reads from the files: the data list, the reference
    trajectory, the frames' timestamps and the intrinsics."""
    cfg = config(events=events)
    cfg["data_loader"]["test"] = {"test_split": [scene],
                                  "dataset_name": "Synthetic"}
    mem = psyn.memory_scene(16, H, W, motion="curve", seed=1)
    data_f, ref_f, ts_f, intr_f = read_scene(scene, cfg)
    data_m, ref_m, ts_m, intr_m = psyn.memory_reader(mem)("any", cfg)
    assert len(data_f) == len(data_m) > 8
    assert len(psyn.memory_eval_data(mem, cfg)[0]) == len(data_m)
    for x, y in zip(data_f, data_m):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    np.testing.assert_array_equal(ts_f, ts_m)
    assert intr_f == intr_m
    for f in ("positions_xyz", "quat_wxyz", "timestamps"):
        np.testing.assert_array_equal(getattr(ref_f, f), getattr(ref_m, f))
