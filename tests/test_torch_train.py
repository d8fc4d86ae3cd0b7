"""The unrolled training forward of rampvo_tpu_torch against rampvo_tpu's
`TrainForward(corr_impl="xla")` on the CPU: loss, metrics and every
parameter's gradient, with the JAX run's random draws handed to the port.

Size: 32x48, 9 frames, 4 patches per frame, 9 unrolled steps (frame 8 is
inserted at step 8, so insertion, edge dropout and the median depth of new
patches run). Weights come from a seeded flax VONet.init with the flow
head (d_fc) scaled by 0.1 in both packages: 9 steps of BA on a random
network are otherwise chaotic, and a float32 rounding difference grows
into a different trajectory.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu.lie import ops as jl
from rampvo_tpu.models import VONet as JVONet
from rampvo_tpu.train import forward as jfw
from rampvo_tpu_torch.ckpt.weights import from_flax_params
from rampvo_tpu_torch.models.vonet import VONet
from rampvo_tpu_torch.train import forward as pfw

H, W, NF, M, STEPS = 32, 48, 9, 4, 9
KEYS = ("events", "images", "poses", "disps", "intrinsics")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def weights(mode):
    params = jax.jit(JVONet(input_mode=mode).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 5)),
        jnp.zeros((1, 16, 16, 3)), jnp.asarray([True]))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["update"]["d_fc"]["kernel"] = (
        0.1 * params["params"]["update"]["d_fc"]["kernel"])
    return params


def window(mode):
    """A numpy-seeded window. MultiScale takes the dataset's layout (one
    voxel between frames, T = 2 * NF with the last voxel padding);
    SingleScale, whose reference encoder zips events with images, one
    voxel per frame."""
    rng = np.random.RandomState(0)
    if mode == "MultiScale":
        mask = np.zeros(2 * NF, bool)
        mask[0] = True
        mask[2::2] = True
    else:
        mask = np.ones(NF, bool)
    return dict(
        events=rng.rand(mask.size, H, W, 5).astype(np.float32),
        images=rng.rand(NF, H, W, 3).astype(np.float32),
        poses=np.asarray(jl.se3_exp(jnp.asarray(0.05 * rng.randn(NF, 6),
                                                jnp.float32))),
        disps=(0.5 + 0.1 * rng.rand(NF, H, W)).astype(np.float32),
        intrinsics=np.tile(np.array([40.0, 40.0, W / 2, H / 2], np.float32),
                           (NF, 1)),
        mask=mask)


def jax_draws(key, sched):
    """The numbers JAX's TrainForward draws from `key`, in its split
    order: (k_sel, k_d) at the start, the depth init uniform(k_d); per
    insertion step (k1, k2) and the drop test uniform(k1); per step
    (k_c1, k_c2) and the per-level keep masks uniform(k, (E,)) < 0.2."""
    E = sched.ii.shape[0]
    r = key
    r, _ = jax.random.split(r)
    r, kd = jax.random.split(r)
    depth = np.asarray(jax.random.uniform(kd, (NF * M,)))
    drop = np.ones(STEPS, np.float32)
    keep1 = np.zeros((STEPS, E), bool)
    keep2 = np.zeros((STEPS, E), bool)
    for s in range(STEPS):
        if sched.insert[s]:
            r, k1, _ = jax.random.split(r, 3)
            drop[s] = float(jax.random.uniform(k1))
        r, c1, c2 = jax.random.split(r, 3)
        keep1[s] = np.asarray(jax.random.uniform(c1, (E,)) < 0.2)
        keep2[s] = np.asarray(jax.random.uniform(c2, (E,)) < 0.2)
    return {"depth": torch.tensor(depth), "drop": torch.tensor(drop),
            "keep1": torch.tensor(keep1), "keep2": torch.tensor(keep2)}


def check_vs_jax(mode, structure_only):
    """Loss within 1e-4 relative, the metrics (loss, px1, flow_e, ro, tr)
    within 1e-4 of max(1, value), and every parameter's gradient within
    1e-2 of max(its largest entry, 1e-3 of the largest entry of all
    gradients): the floor covers the biases ahead of instance norms, whose
    gradient is zero up to rounding (1e-10). Over all parameters the
    gradients differ by under 2e-3 in relative L1. The draws of the JAX
    run are handed to the port."""
    params = weights(mode)
    b = window(mode)
    fj = jfw.TrainForward(JVONet(input_mode=mode), n_frames=NF, M=M,
                          steps=STEPS, corr_impl="xla")
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        return fj(p, *(jnp.asarray(b[k]) for k in KEYS + ("mask",)), key,
                  structure_only=structure_only)

    (lj, mj), gj = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    net = VONet(mode)
    net.load_state_dict(from_flax_params(params, mode))
    fp = pfw.TrainForward(net, n_frames=NF, M=M, steps=STEPS)
    assert fp.E == fj.sched.ii.shape[0]
    lp, mp = fp(*(torch.tensor(b[k]) for k in KEYS), b["mask"],
                structure_only=structure_only,
                draws=jax_draws(key, fj.sched))
    lp.backward()
    lp = lp.detach()
    assert abs(float(lp) - float(lj)) <= 1e-4 * abs(float(lj)), (lp, lj)
    assert mp.keys() == mj.keys()
    for k in mj:
        a, c = float(mp[k].detach()), float(mj[k])
        assert np.isfinite(a) and abs(a - c) <= 1e-4 * max(1.0, abs(c)), k
    want = from_flax_params(jax.tree_util.tree_map(np.asarray, gj), mode)
    got = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
           for k, p in net.named_parameters()}
    assert want.keys() == got.keys()
    gmax = max(float(np.abs(v.numpy()).max()) for v in want.values())
    assert gmax > 0
    num = den = 0.0
    for k, w in want.items():
        w, g = w.numpy(), got[k].numpy()
        err = np.abs(g - w).max()
        assert err <= 1e-2 * max(np.abs(w).max(), 1e-3 * gmax), k
        num += np.abs(g - w).sum()
        den += np.abs(w).sum()
    assert num <= 2e-3 * den, num / den


@pytest.mark.parametrize("structure_only", [False, True])
def test_train_forward_vs_jax(structure_only):
    """MultiScale, with and without the structure-only warmup (poses held
    at the ground truth, no pose loss): see `check_vs_jax`."""
    check_vs_jax("MultiScale", structure_only)


def test_train_forward_generator_draws():
    """Without `draws`, TrainForward takes its random numbers from the
    generator: the same seed gives the same loss, another seed another
    one; a call with neither raises."""
    net = VONet()
    net.load_state_dict(from_flax_params(weights("MultiScale")))
    fp = pfw.TrainForward(net, n_frames=NF, M=M, steps=STEPS)
    b = window("MultiScale")
    args = [torch.tensor(b[k]) for k in KEYS] + [b["mask"]]
    with torch.no_grad():
        loss = [float(fp(*args, generator=torch.Generator().manual_seed(s))[0])
                for s in (1, 1, 2)]
        with pytest.raises(ValueError):
            fp(*args)
    assert np.isfinite(loss).all()
    assert loss[0] == loss[1] and loss[0] != loss[2]
