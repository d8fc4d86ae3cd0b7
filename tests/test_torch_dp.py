"""Data-parallel training of rampvo_tpu_torch over processes on the CPU:
two ranks under torch.distributed's gloo backend, spawned by the test,
against the same step in one process (`parallel/mesh.py`), the stub-model
mechanics of tests/test_misc.py::TestParallel at world size 2, and the
training CLI's loop over two ranks.

Every rank joins through a file in the test's tmp_path (no port to clash
with other tests), with a 60 s process-group timeout, and the test kills
and fails a rank that has not ended within its join limit. No JAX here:
the spawned ranks import this module.
"""

import multiprocessing as mp
import os
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rampvo_tpu_torch.cli import train as ptrain
from rampvo_tpu_torch.lie import ops as lops
from rampvo_tpu_torch.models.vonet import VONet, init_weights
from rampvo_tpu_torch.parallel import make_mesh, make_train_step, shard_batch
from rampvo_tpu_torch.train.forward import TrainForward
from rampvo_tpu_torch.train.step import Trainer

H, W, NF, M, STEPS = 32, 48, 8, 4, 3
KEYS = ("events", "images", "poses", "disps", "intrinsics", "mask")
TRAIN_CFG = {"steps": 1000, "lr": 8e-5, "clip": 0.1, "weight_decay": 1e-6,
             "pct_start": 0.01}
THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads, as each rank takes: the suite runs several
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def window(seed):
    """A numpy-seeded MultiScale window in the dataset's layout (one voxel
    between frames; camera-to-world poses)."""
    rng = np.random.RandomState(seed)
    mask = np.zeros(2 * NF, bool)
    mask[0] = True
    mask[2::2] = True
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        events=f32(rng.rand(2 * NF, H, W, 5)),
        images=f32(rng.rand(NF, H, W, 3)),
        poses=lops.se3_exp(torch.tensor(f32(0.05 * rng.randn(NF, 6)))).numpy(),
        disps=f32(0.5 + 0.1 * rng.rand(NF, H, W)),
        intrinsics=f32(np.tile([40.0, 40.0, W / 2, H / 2], (NF, 1))),
        mask=mask)


def batch_of(seeds):
    return {k: torch.as_tensor(np.stack([window(s)[k] for s in seeds]))
            for k in KEYS}


def join(rank, tmp, world=2):
    torch.set_num_threads(THREADS)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))


def spawn(target, tmp, world=2, limit=120.0):
    """Run target(rank, tmp) in `world` spawned processes; fail (after
    killing them) if any has not ended within `limit` seconds or exits
    non-zero."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + limit
    for p in procs:
        p.join(max(end - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} rank(s) hung"
    assert [p.exitcode for p in procs] == [0] * world


def net0():
    return init_weights(VONet("MultiScale"), torch.Generator().manual_seed(0))


def one_step(net, batch, draws, mesh=None):
    """One step of make_train_step on `net`; returns (loss, metrics,
    gradients after the clip, parameters after the step)."""
    fwd = TrainForward(net, n_frames=NF, M=M, steps=STEPS)
    tr = Trainer(net, TRAIN_CFG)
    loss, metrics = make_train_step(fwd, tr, mesh)(batch, draws=draws)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            [p.grad.clone() for p in tr.params],
            [p.detach().clone() for p in tr.params])


def _dp_rank(rank, tmp):
    inp = torch.load(f"{tmp}/in.pt")
    net = VONet("MultiScale")
    net.load_state_dict(inp["state"])
    mesh = make_mesh("cpu")
    shard = shard_batch(mesh, inp["batch"])
    out = one_step(net, shard, [inp["draws"][rank]], mesh)
    torch.save(out + (mesh.world_size, mesh.rank), f"{tmp}/rank{rank}.pt")


def _rank(rank, tmp):
    """A rank of the module's one spawn: the data-parallel step, the stub
    model's step and the training loop, in one process group."""
    join(rank, tmp)
    try:
        _dp_rank(rank, tmp)
        _stub_rank(rank, tmp)
        _loop_rank(rank, tmp)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the two ranks once for the module's tests: writes the
    one-process step's inputs, and returns (tmp, that step's results)."""
    tmp = tmp_path_factory.mktemp("dp")
    net = net0()
    probe = TrainForward(net, n_frames=NF, M=M, steps=STEPS)
    draws = [probe.draw(torch.Generator().manual_seed(10 + b), "cpu", H, W)
             for b in range(2)]
    batch = batch_of([1, 2])
    batch["poses"] = lops.se3_inv(batch["poses"])
    torch.save({"state": net.state_dict(), "batch": batch, "draws": draws},
               tmp / "in.pt")
    spawn(_rank, tmp)
    return tmp, one_step(net, batch, draws)


def test_two_ranks_match_one_process(ranks):
    """Two gloo ranks, one window each, against the same batch of two in
    one process, from the same weights and draws: the loss and metrics
    within 1e-6 relative, the gradients (after the clip) within 1e-3 in
    relative L1, and the parameters after the step bit for bit equal
    across the ranks and changed by it. The arithmetic is the same (each
    sample's backward starts from 1/2 in both, and g0 + g1 is summed once
    either way), but a BLAS kernel may round differently in another
    process (buffer alignment), and the unrolled BA steps grow a rounding
    difference: 0 and 3.3e-5 in two runs."""
    tmp, (loss, metrics, grads, _) = ranks
    out = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
    assert [r[4:] for r in out] == [(2, 0), (2, 1)]
    for r in out:
        assert abs(r[0] - loss) <= 1e-6 * abs(loss)
        for k, v in metrics.items():
            assert abs(r[1][k] - v) <= 1e-6 * max(1.0, abs(v)), k
        num = sum(float((g - w).abs().sum()) for g, w in zip(r[2], grads))
        den = sum(float(w.abs().sum()) for w in grads)
        assert den > 0 and num <= 1e-3 * den, num / den
    assert all(torch.equal(a, b) for a, b in zip(out[0][3], out[1][3]))
    assert any(not torch.equal(a, b) for a, b in
               zip(out[0][3], (p.detach() for p in net0().parameters())))


class Stub(torch.nn.Module):
    """tests/test_misc.py::TestParallel's model: loss = sum((events @ w -
    images)^2)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4, 4))

    def fwd(self, events, images, poses, disps, intrinsics, mask,
            structure_only=False, generator=None, draws=None):
        loss = ((events @ self.w - images) ** 2).sum()
        return loss, {"loss": loss}


def _stub_rank(rank, tmp):
    mesh = make_mesh("cpu")
    B = 8
    batch = shard_batch(mesh, {
        "events": torch.ones(B, 4, 4), "images": torch.zeros(B, 4, 4),
        "poses": torch.zeros(B, 1), "disps": torch.zeros(B, 1),
        "intrinsics": torch.zeros(B, 1),
        "mask": torch.ones(B, 1, dtype=torch.bool)})
    stub = Stub()
    tr = Trainer(stub, {"steps": 1000, "lr": 0.1, "clip": 1e9,
                        "weight_decay": 0.0})
    loss, _ = make_train_step(stub.fwd, tr, mesh)(batch)
    torch.save((batch["events"].shape[0], float(loss),
                stub.w.detach().clone()), f"{tmp}/stub{rank}.pt")


def test_stub_mechanics_two_ranks(ranks):
    """The stub model over two ranks (tests/test_misc.py::TestParallel at
    world size 2): each rank takes 4 of the 8 samples, the loss is
    finite, the gradient is applied, and the ranks end with the same
    weights."""
    tmp, _ = ranks
    (b0, l0, w0), (b1, l1, w1) = (torch.load(tmp / f"stub{r}.pt")
                                  for r in range(2))
    assert b0 == b1 == 4
    assert np.isfinite(l0) and l0 == l1 == 256.0
    assert not torch.allclose(w0, torch.ones(4, 4))
    assert torch.equal(w0, w1)


class Windows:
    """An in-memory dataset of seeded windows that logs the indices read."""

    def __init__(self, n=50):
        self.n, self.read = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        self.read.append(int(idx))
        return window(idx)


def loop_cfg():
    return {"data_loader": {"train": {"args": {
        "input_mode": "MultiScale", "num_event_bins": 5, "n_frames": NF,
        "batch_size": 1, "event_bias": True, "flow_weight": 0.1,
        "pose_weight": 10.0, "lr": 1e-4, "steps": 2, "steps_to_save_ckpt": 2,
        "clip": 10.0, "weight_decay": 1e-6, "pct_start": 0.01}}}}


def _loop_rank(rank, tmp):
    os.makedirs(f"{tmp}/{rank}")
    os.chdir(f"{tmp}/{rank}")
    sys.stdout = open("stdout.txt", "w")
    ds = Windows()
    args = ptrain.parse_args(["--config_path", "x", "--device", "cpu",
                              "--unroll_steps", str(STEPS), "--name", "dp",
                              "--print_every", "1"])
    loop = ptrain.TrainLoop(args, loop_cfg(), ds, M=M)
    loop.run()
    sys.stdout.flush()
    torch.save((ds.read, loop.mesh.world_size, loop.step_count,
                [p.detach().clone() for p in loop.net.parameters()],
                list(loop.history)), f"{tmp}/loop{rank}.pt")


def test_train_loop_two_ranks(ranks):
    """cli.train.TrainLoop in two ranks of a gloo group (set up by the
    caller, as torchrun's processes would join one): two steps each, the
    ranks read different windows (RandomState(seed + rank)), end with the
    same parameters and the same (averaged) metrics, and only rank 0
    prints and writes the step-2 checkpoint."""
    tmp, _ = ranks
    (r0, ws0, n0, p0, h0), (r1, ws1, n1, p1, h1) = (
        torch.load(tmp / f"loop{r}.pt") for r in range(2))
    assert ws0 == ws1 == 2 and n0 == n1 == 2
    assert len(r0) == len(r1) == 2 and r0 != r1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    for a, b in zip(h0, h1):
        assert {k: v for k, v in a.items() if k != "seconds"} == \
            {k: v for k, v in b.items() if k != "seconds"}
    assert os.path.isfile(tmp / "0" / "checkpoints" / "dp" / "step_2.pth")
    assert not os.path.exists(tmp / "1" / "checkpoints")
    out0 = (tmp / "0" / "stdout.txt").read_text()
    out1 = (tmp / "1" / "stdout.txt").read_text()
    assert out0.count("'loss':") == 2 and "'loss':" not in out1
