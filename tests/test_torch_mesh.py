"""rampvo_tpu_torch.parallel.mesh against rampvo_tpu.parallel.mesh on the
CPU: the training step with no mesh on a batch of two windows against the
JAX `make_train_step(fwd, optimizer, mesh=None)` (the same weights,
inputs and random draws), and `shard_batch`'s blocks against the JAX
mesh's shards on the 8 virtual CPU devices (tests/conftest.py).

Size as tests/test_torch_train.py's (32x48, 9 frames, 4 patches per
frame, flow head scaled by 0.1 in both packages) but 2 unrolled steps:
the JAX step takes ~50 s to trace and compile here whatever the depth,
and the frame insertion at step 8 is held against JAX by that file.
(jax_disable_most_optimizations would save ~10 s of it, but the JAX
gradients of the fmap encoder's convolutions then differ from the
optimized program's by up to their own size: it is not used here.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu.cli.train import make_optimizer
from rampvo_tpu.models import VONet as JVONet
from rampvo_tpu.parallel import mesh as jmesh
from rampvo_tpu.train import forward as jfw
from rampvo_tpu_torch.ckpt.weights import from_flax_params
from rampvo_tpu_torch.models.vonet import VONet
from rampvo_tpu_torch.parallel import (eval_shard_scenes, make_mesh,
                                       make_train_step, shard_batch,
                                       shard_scenes)
from rampvo_tpu_torch.parallel.mesh import Mesh
from rampvo_tpu_torch.train import forward as pfw
from rampvo_tpu_torch.train.step import Trainer
from test_torch_train import (KEYS, M, NF, _torch_threads,  # noqa: F401
                              weights, window)

STEPS = 2
TRAIN_CFG = {"steps": 1000, "lr": 8e-5, "pct_start": 0.01, "clip": 0.1,
             "weight_decay": 1e-6}


def jax_draws(key, sched, nm, ablate=frozenset()):
    """tests/test_torch_train.py::jax_draws (event-biased selection) for
    any schedule and nm = frames x patches: what JAX's TrainForward draws
    from `key`, in its split order. Under the "corr" probe JAX splits no
    keys for the keep masks, so the draws after it follow that."""
    E, steps = sched.ii.shape[0], len(sched.insert)
    r, _ = jax.random.split(key)
    r, kd = jax.random.split(r)
    depth = np.asarray(jax.random.uniform(kd, (nm,)))
    drop = np.ones(steps, np.float32)
    keep = np.zeros((2, steps, E), bool)
    for s in range(steps):
        if sched.insert[s]:
            r, k1, _ = jax.random.split(r, 3)
            drop[s] = float(jax.random.uniform(k1))
        if "corr" not in ablate:
            r, c1, c2 = jax.random.split(r, 3)
            for i, c in enumerate((c1, c2)):
                keep[i, s] = np.asarray(jax.random.uniform(c, (E,)) < 0.2)
    return {"depth": torch.tensor(depth), "drop": torch.tensor(drop),
            "keep1": torch.tensor(keep[0]), "keep2": torch.tensor(keep[1])}


def batch2():
    """Two windows: test_torch_train's and its left-right mirror."""
    a = window("MultiScale")
    b = {k: (np.ascontiguousarray(v[:, :, ::-1]) if k in ("events", "images",
                                                         "disps") else v)
         for k, v in a.items()}
    return {k: np.stack([a[k], b[k]]) for k in KEYS + ("mask",)}


def test_train_step_no_mesh_vs_jax():
    """One step of the port's make_train_step with no mesh on a batch of
    two against the JAX step with mesh=None (optax: clip 0.1, AdamW with
    the one-cycle rate of make_optimizer; the port: Trainer), from the
    same weights, with sample b drawing what the JAX step's split key b
    draws. The loss within 1e-4 relative; the metrics within 1e-4 of
    max(1, value); the parameter changes within 2e-3 in relative L1 over
    all parameters (2.4e-4 measured) and each entry within 2 lr(0) and
    two float32 ulps of the entry (AdamW's first step moves an entry by
    lr(0) times the sign of its gradient, which is a rounding draw where
    the gradient is rounding noise)."""
    params = weights("MultiScale")
    b = batch2()
    fj = jfw.TrainForward(JVONet(input_mode="MultiScale"), n_frames=NF, M=M,
                          steps=STEPS, corr_impl="xla")
    opt = make_optimizer(TRAIN_CFG)
    key = jax.random.PRNGKey(5)
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)
    pj, _, lj, mj = jmesh.make_train_step(fj, opt, mesh=None)(
        copy(params), opt.init(params), {k: jnp.asarray(v) for k, v in
                                         b.items()}, key)

    net = VONet("MultiScale")
    net.load_state_dict(from_flax_params(params, "MultiScale"))
    p0 = {k: v.detach().clone() for k, v in net.named_parameters()}
    tr = Trainer(net, TRAIN_CFG)
    step = make_train_step(pfw.TrainForward(net, n_frames=NF, M=M,
                                            steps=STEPS), tr)
    draws = [jax_draws(k, fj.sched, NF * M) for k in jax.random.split(key, 2)]
    lp, mp = step({k: torch.as_tensor(v) for k, v in b.items()}, draws=draws)
    assert abs(float(lp) - float(lj)) <= 1e-4 * abs(float(lj)), (lp, lj)
    assert mp.keys() == mj.keys()
    for k in mj:
        a, c = float(mp[k]), float(mj[k])
        assert np.isfinite(a) and abs(a - c) <= 1e-4 * max(1.0, abs(c)), k
    want = from_flax_params(jax.tree_util.tree_map(np.asarray, pj),
                            "MultiScale")
    lr0 = tr.lr(0)
    num = den = 0.0
    for k, p in net.named_parameters():
        dw = want[k] - p0[k]
        dp = p.detach() - p0[k]
        assert ((dp - dw).abs() <= 2 * lr0 + 2.4e-7 * p0[k].abs()).all(), k
        num += float((dp - dw).abs().sum())
        den += float(dw.abs().sum())
    assert den > 0 and num <= 2e-3 * den, num / den


@pytest.mark.parametrize("world", [2, 8])
def test_shard_batch_blocks_match_jax(world):
    """Rank r's block of shard_batch == the shard that the JAX
    shard_batch (NamedSharding(mesh, P("batch"))) puts on device r, for
    every array of a batch of 8; a batch of 3 raises."""
    rng = np.random.RandomState(0)
    batch = {"events": rng.rand(8, 3, 2).astype(np.float32),
             "mask": rng.rand(8, 5) > 0.5}
    jm = jmesh.make_mesh(jax.devices()[:world])
    jb = jmesh.shard_batch(jm, batch)
    for r in range(world):
        mesh = Mesh(world, r, torch.device("cpu"))
        got = shard_batch(mesh, batch)
        for k, v in jb.items():
            (shard,) = [s for s in v.addressable_shards
                        if s.device == jm.devices[r]]
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(shard.data))
    with pytest.raises(ValueError, match="divide"):
        shard_batch(Mesh(2, 0, torch.device("cpu")),
                    {"events": np.zeros((3, 2))})


def test_mesh_names_and_one_member_mesh():
    """The package exports the JAX names; eval_shard_scenes is the
    fleet's shard_scenes and equals the JAX round robin; without a
    process group make_mesh is a one-member mesh on the given device, and
    shard_batch there moves the whole batch."""
    scenes = [f"s{i}" for i in range(7)]
    assert eval_shard_scenes is shard_scenes
    for n in (1, 3, 8):
        assert eval_shard_scenes(scenes, n) == jmesh.eval_shard_scenes(
            scenes, n)
    mesh = make_mesh("cpu")
    assert (mesh.world_size, mesh.rank, mesh.device, mesh.group) == (
        1, 0, torch.device("cpu"), None)
    x = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(shard_batch(mesh, [x])[0].numpy(), x)
