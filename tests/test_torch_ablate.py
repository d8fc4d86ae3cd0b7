"""The training ablation probes (`TrainForward(ablate=)`) against
rampvo_tpu's on the CPU, and the training benchmark entry point
(`cli.bench --train`).

Each probe's loss and metrics against the JAX TrainForward(ablate=...,
corr_impl="xla") at tests/test_torch_train.py's size (32x48, 9 frames, 4
patches per frame, 9 unrolled steps, so frame 8's insertion draws its
edge drop after the probe has changed the key splits), with the JAX run's
draws handed to the port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu.models import VONet as JVONet
from rampvo_tpu.train import forward as jfw
from rampvo_tpu_torch.ckpt.weights import from_flax_params
from rampvo_tpu_torch.cli import bench
from rampvo_tpu_torch.models.vonet import VONet
from rampvo_tpu_torch.train import forward as pfw
from test_torch_mesh import jax_draws
from test_torch_train import (KEYS, M, NF, STEPS, _torch_threads,  # noqa: F401
                              weights, window)


@pytest.mark.parametrize("probe", ["corr", "encoder", "ba", "update"])
def test_ablate_probe_vs_jax(probe):
    """The loss within 1e-4 relative and the metrics (loss, px1, flow_e,
    ro, tr) within 1e-4 of max(1, value) of the JAX probe's, MultiScale.
    Under "corr" the JAX forward splits no keys for the keep masks, and
    the draws follow (`jax_draws(ablate=)`)."""
    ablate = frozenset({probe})
    params = weights("MultiScale")
    b = window("MultiScale")
    fj = jfw.TrainForward(JVONet(input_mode="MultiScale"), n_frames=NF, M=M,
                          steps=STEPS, corr_impl="xla", ablate=ablate)
    key = jax.random.PRNGKey(3)
    lj, mj = jax.jit(lambda p: fj(p, *(jnp.asarray(b[k]) for k in
                                       KEYS + ("mask",)), key))(params)
    net = VONet("MultiScale")
    net.load_state_dict(from_flax_params(params, "MultiScale"))
    fp = pfw.TrainForward(net, n_frames=NF, M=M, steps=STEPS, ablate=ablate)
    draws = jax_draws(key, fj.sched, NF * M, ablate)
    if probe == "corr":        # frame 8's drop draw moves with the splits
        assert draws["drop"][8] != jax_draws(key, fj.sched, NF * M)["drop"][8]
    with torch.no_grad():
        lp, mp = fp(*(torch.tensor(b[k]) for k in KEYS), b["mask"],
                    draws=draws)
    assert abs(float(lp) - float(lj)) <= 1e-4 * abs(float(lj)), (lp, lj)
    assert mp.keys() == mj.keys()
    for k in mj:
        a, c = float(mp[k]), float(mj[k])
        assert np.isfinite(a) and abs(a - c) <= 1e-4 * max(1.0, abs(c)), k


def test_ablate_rejects_unknown_probe():
    with pytest.raises(ValueError, match="ablate"):
        pfw.TrainForward(VONet(), n_frames=NF, M=M, steps=STEPS,
                         ablate={"corr", "bogus"})


def test_bench_train_prints_one_json_line(capsys, monkeypatch):
    """`bench.main(["--train", ...])` on the CPU at 32x48 (8 frames, 4
    patches, 2 unrolled steps), two variants: one line per variant and a
    parseable JSON last line in s/step with each variant's time; the
    first variant names the metric. --small runs at 240x320."""
    res = bench.main(["--train", "--device", "cpu", "--height", "32",
                      "--width", "48", "--n_frames", "8", "--patches", "4",
                      "--steps", "2", "--iters", "1", "--ablate",
                      "full,no_corr"])
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert line == res
    assert line["metric"] == "train_step_s_MultiScale_32x48"
    assert line["unit"] == "s/step" and line["device"] == "cpu"
    assert line["variants"].keys() == {"full", "no_corr"}
    assert all(v > 0 for v in line["variants"].values())
    assert line["value"] == line["variants"]["full"]
    assert sum("train step" in ln for ln in lines) == 2

    def size(n, ht, wd, dev):
        raise RuntimeError(f"{ht}x{wd}")

    monkeypatch.setattr(bench, "train_batch", size)
    with pytest.raises(RuntimeError, match="240x320"):
        bench.main(["--train", "--small", "--device", "cpu"])
