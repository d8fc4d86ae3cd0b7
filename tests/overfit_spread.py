"""How far the learned-weights recipe's outcome moves between runs, in
the JAX package on the CPU: tests/test_overfit_e2e.py's recipe (40 steps
of TrainForward(n_frames=8, M=16, steps=10), AdamW 1e-4, clip 0.1, from
flax VONet.init with PRNGKey(0)) with the training draws from
PRNGKey(k) for each given k (the test's own is k = 1), then both
networks through cli.evaluate with `--trials` evaluation trials. Prints
one JSON line per run: first and last loss, the ATE of every trial of
the initial and the trained network, and their ratio at trial 0 (the
test's criterion is that ratio < 0.75).

    JAX_PLATFORMS=cpu python tests/overfit_spread.py --keys 1 2 3 --trials 3
"""

import argparse
import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import synthetic  # noqa: E402
from rampvo_tpu.cli.evaluate import evaluate  # noqa: E402
from rampvo_tpu.data.tartan import TartanEventDataset  # noqa: E402
from rampvo_tpu.lie import ops as lops  # noqa: E402
from rampvo_tpu.models import VONet  # noqa: E402
from rampvo_tpu.train import TrainForward  # noqa: E402
from rampvo_tpu.vo import VOConfig  # noqa: E402

H, W = 60, 80


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, nargs="+", default=[1])
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args()

    root = tempfile.mkdtemp() + "/scene"
    synthetic.write_scene(root, n_frames=40, H=H, W=W, motion="curve")
    cfg = json.loads(json.dumps(synthetic.EVAL_CFG))
    cfg["data_loader"]["train"]["args"]["n_frames"] = 8
    ds = TartanEventDataset(cfg, root, fmin=0.001, fmax=1000.0)
    vonet = VONet(input_mode="MultiScale")
    params0 = vonet.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 5)),
                         jnp.zeros((1, H, W, 3)), jnp.asarray([True]))
    fwd = TrainForward(vonet, n_frames=8, M=16, steps=10)
    opt = optax.chain(optax.clip_by_global_norm(0.1), optax.adamw(1e-4))

    @jax.jit
    def train_step(params, opt_state, batch, rng):
        def loss_fn(p):
            return fwd(p, batch["events"], batch["images"], batch["poses"],
                       batch["disps"], batch["intrinsics"], batch["mask"],
                       rng)

        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    eval_cfg = json.loads(json.dumps(synthetic.EVAL_CFG))
    eval_cfg["data_loader"]["test"] = {
        "test_split": [root], "dataset_name": "Synthetic",
        "use_pose_pred": False}
    vocfg = VOConfig(
        BUFFER_SIZE=64, MAX_FRAMES=64, PATCHES_PER_FRAME=16,
        REMOVAL_WINDOW=8, OPTIMIZATION_WINDOW=6, PATCH_LIFETIME=5,
        KEYFRAME_INDEX=2, MIXED_PRECISION=False, PROBE_THRESH=-1.0, MEM=16)

    def ates(p):
        res = evaluate(net=p, trials=args.trials, config_VO=vocfg,
                       eval_cfg=eval_cfg, save_dir=tempfile.mkdtemp())
        return [float(res[root][f"trial_{t}"]["ate"])
                for t in range(args.trials)]

    random_ates = ates(params0)
    for key in args.keys:
        params, opt_state = params0, opt.init(params0)
        rng, losses = jax.random.PRNGKey(key), []
        for step in range(40):
            item = ds[1 + step % max(len(ds) - 1, 1)]
            w2c = np.asarray(lops.se3_inv(jnp.asarray(item["poses"])))
            batch = {k: jnp.asarray(item[k]) for k in
                     ("events", "images", "disps", "intrinsics", "mask")}
            batch["poses"] = jnp.asarray(w2c)
            rng, k = jax.random.split(rng)
            params, opt_state, loss = train_step(params, opt_state, batch, k)
            losses.append(float(loss))
        trained = ates(params)
        print(json.dumps({"key": key, "loss_first": losses[0],
                          "loss_last": losses[-1], "ate_random": random_ates,
                          "ate_trained": trained,
                          "ratio_trial0": trained[0] / random_ates[0]}),
              flush=True)


if __name__ == "__main__":
    main()
