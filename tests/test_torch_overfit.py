"""Learned-weights check of rampvo_tpu_torch, the port's twin of
tests/test_overfit_e2e.py: the tiny MultiScale model overfit on the
synthetic curved scene must train (the loss falls) and its checkpoint,
saved and loaded back through the evaluation CLI's loader, must track the
scene better than the random initialization (ATE below 0.75 of it).

The recipe is cli/overfit_synthetic.py's (the port of
scripts/overfit_synthetic.py), the scene data/synthetic.py's. The whole
twin is slow on the CPU (40 optimizer steps, then two 480x640
evaluations) and is marked so; chip_smoke.py's overfit phase runs the
recipe on the card through `cli.overfit_synthetic.run` (four trainings
there: the card's atomics make each a different draw of the recipe's
outcome) with the scene held in memory (`synthetic.memory_scene`,
`MemoryDataset`, `memory_eval_data`: the card's machine has no h5py),
which `test_memory_scene_matches_files` holds equal to the files. Both
start from the JAX test's own initial network (flax `VONet.init` with
PRNGKey(0)), kept in data/overfit_init_flax.npz so that the card, which
has no JAX, loads it through `from_flax_params` (`overfit_init`);
`test_overfit_init_is_jax_tests_network` holds the file equal to a fresh
flax init. Remake the file with `python tests/test_torch_overfit.py`.
Tier-1 keeps `test_overfit_loss_decreases`. The helpers need no JAX.
"""

import copy
import os

import numpy as np
import pytest
import torch

from rampvo_tpu_torch.ckpt import save_checkpoint
from rampvo_tpu_torch.cli.evaluate import evaluate, load_params
from rampvo_tpu_torch.cli.overfit_synthetic import (
    H, N_FRAMES, STEPS, W, eval_cfg, eval_config, overfit_trainer, to_batch,
    train_config, train_steps)
from rampvo_tpu_torch.data import synthetic
from rampvo_tpu_torch.data.tartan import TartanEventDataset
from rampvo_tpu_torch.models.vonet import VONet, init_weights
from rampvo_tpu_torch.train import TrainForward

INIT_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "overfit_init_flax.npz")


def dataset(root):
    """The JAX test's training dataset over the scene at `root`."""
    return TartanEventDataset(train_config(), root, fmin=0.001, fmax=1000.0)


def overfit_twin(ds, device, ckpt_dir):
    """The learned-weights recipe on `device`: 40 steps from the JAX
    test's initial network (`overfit_init`) over the items
    ds[1 + step % (len(ds) - 1)], the weights saved by save_checkpoint
    and loaded back by cli.evaluate.load_params (equal, tensor for
    tensor). Returns {losses, seconds (per step), initial, trained: the
    initial and the loaded network, on the CPU}."""
    net0 = overfit_init()
    net = copy.deepcopy(net0).to(device)
    losses, seconds = train_steps(
        net, lambda s: ds[1 + s % max(len(ds) - 1, 1)], device)
    path = save_checkpoint(ckpt_dir, STEPS, net.state_dict(), {})
    trained = load_params(path, "MultiScale")
    for a, b in zip(trained.state_dict().values(), net.state_dict().values()):
        if not torch.equal(a, b.cpu()):
            raise AssertionError("the checkpoint's weights differ")
    return {"losses": losses, "seconds": seconds, "initial": net0,
            "trained": trained}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("overfit") / "scene")
    synthetic.write_scene(root, n_frames=40, H=H, W=W, motion="curve")
    return root


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_overfit_loss_decreases(scene):
    """Four optimizer steps of the recipe's optimizer on one fixed window
    of the dataset with the same draws each time: the losses are finite
    and the window's loss after them, with those draws, is below the
    first. 8 patches and 5 unrolled steps (the recipe's 16 and 10 take
    ~20 s a step on the CPU, most of it the plain correlation's
    backward)."""
    ds = dataset(scene)
    net = init_weights(VONet("MultiScale"), torch.Generator().manual_seed(0))
    fwd = TrainForward(net, n_frames=N_FRAMES, M=8, steps=5)
    b = to_batch(ds[1], "cpu")
    draws = fwd.draw(torch.Generator().manual_seed(1), "cpu", H, W)
    run = lambda: fwd(b["events"], b["images"], b["poses"], b["disps"],
                      b["intrinsics"], b["mask"], draws=draws)
    tr = overfit_trainer(net)
    losses = [float(tr.step(run)[0]) for _ in range(4)]
    with torch.no_grad():
        after = float(run()[0])
    print(f"losses {losses}, after {after}")
    assert np.all(np.isfinite(losses + [after]))
    assert after < losses[0], (losses, after)


def flax_init_params():
    """The JAX test's initial network: flax VONet.init with PRNGKey(0) at
    60x80, as a flat {"a/b/c": array} dict."""
    import jax
    import jax.numpy as jnp

    from rampvo_tpu.models import VONet as JVONet

    params = jax.jit(JVONet(input_mode="MultiScale").init)(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 5)),
        jnp.zeros((1, H, W, 3)), jnp.asarray([True]))
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in leaves}


def overfit_init():
    """The port's VONet holding the JAX test's initial network, read from
    INIT_NPZ through from_flax_params (no JAX)."""
    from rampvo_tpu_torch.ckpt.weights import from_flax_params

    tree = {}
    with np.load(INIT_NPZ) as z:
        for name in z.files:
            *path, leaf = name.split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = z[name]
    net = VONet("MultiScale")
    net.load_state_dict(from_flax_params(tree))
    return net


def test_overfit_init_is_jax_tests_network():
    """INIT_NPZ is the JAX test's initial network, leaf for leaf, and
    `overfit_init` carries all of it into the port's VONet."""
    fresh = flax_init_params()
    with np.load(INIT_NPZ) as z:
        assert sorted(z.files) == sorted(fresh)
        for k, v in fresh.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    net = overfit_init()
    assert sum(p.numel() for p in net.parameters()) == \
        sum(v.size for v in fresh.values())


@pytest.mark.slow
def test_overfit_beats_random_init_ate(scene, tmp_path):
    """The whole twin on the scene's files: 40 steps over the dataset's
    items, a finite last loss below the first; the trained weights saved
    and loaded back (`overfit_twin`); both evaluated by
    cli.evaluate.evaluate: trained ATE < 0.75 x random-init ATE. The CPU
    run is deterministic, so one training decides, as in the JAX test."""
    ds = dataset(scene)
    assert len(ds) > 1

    def ate_of(net):
        res = evaluate(net, trials=1, config_VO=eval_config(),
                       eval_cfg=eval_cfg(scene),
                       save_dir=str(tmp_path / "eval"), device="cpu")
        return res[scene]["trial_0"]["ate"]

    r = overfit_twin(ds, "cpu", str(tmp_path / "ckpt"))
    losses = r["losses"]
    ate_random, ate_trained = ate_of(r["initial"]), ate_of(r["trained"])
    print(f"losses {losses}; ATE random {ate_random} trained {ate_trained} "
          f"(ratio {ate_trained / ate_random})")
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses
    assert np.isfinite(ate_trained)
    assert ate_trained < 0.75 * ate_random, (ate_trained, ate_random)


def test_memory_scene_matches_files(scene):
    """The in-memory scene the card's overfit phase uses is the scene's
    files: MemoryDataset's windows equal TartanEventDataset's (same
    sampling draws) and memory_eval_data equals what cli.evaluate reads
    (data list, reference trajectory, frame timestamps)."""
    from rampvo_tpu_torch.cli.evaluate import _scene_reference
    from rampvo_tpu_torch.data import data_loader_all_events

    mem = synthetic.memory_scene(40, H, W)
    a = dataset(scene)
    b = synthetic.MemoryDataset(mem, train_config(), fmin=0.001, fmax=1000.0)
    assert len(a) == len(b) > 1
    for idx in (1, 2, 7, len(a)):
        wa, wb = a[idx], b[idx]
        for k in wa:
            np.testing.assert_array_equal(wa[k], wb[k], err_msg=k)
    intr, ref, ts = _scene_reference(scene, "Synthetic")
    data_f, frames = data_loader_all_events(eval_cfg(scene), scene,
                                            intrinsics=intr)
    data_m, ref_m, ts_m = synthetic.memory_eval_data(mem, eval_cfg(scene))
    assert len(data_f) == len(data_m) > 30
    for x, y in zip(data_f, data_m):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    np.testing.assert_array_equal(ts[1:][frames], ts_m)
    for f in ("positions_xyz", "quat_wxyz", "timestamps"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(ref_m, f))


if __name__ == "__main__":
    os.makedirs(os.path.dirname(INIT_NPZ), exist_ok=True)
    np.savez_compressed(INIT_NPZ, **flax_init_params())
    print(f"wrote {INIT_NPZ}")
