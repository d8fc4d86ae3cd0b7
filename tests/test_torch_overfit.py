"""Learned-weights check of rampvo_tpu_torch, the port's twin of
tests/test_overfit_e2e.py: the tiny MultiScale model overfit on the
synthetic curved scene must train (the loss falls) and its checkpoint,
saved and loaded back through the evaluation CLI's loader, must track the
scene better than the random initialization (ATE below 0.75 of it).

The whole twin is slow on the CPU (40 optimizer steps, then two 480x640
evaluations) and is marked so; chip_smoke.py's overfit phase runs it on
the card (`overfit_twin`, four trainings there: the card's atomics make
each a different draw of the recipe's outcome) with the scene held in
memory (`memory_scene`,
`MemoryDataset`, `memory_eval_data`: the card's machine has no h5py), which
`test_memory_scene_matches_files` holds equal to the files. Both start
from the JAX test's own initial network (flax `VONet.init` with
PRNGKey(0)), kept in data/overfit_init_flax.npz so that the card, which
has no JAX, loads it through `from_flax_params` (`overfit_init`);
`test_overfit_init_is_jax_tests_network` holds the file equal to a fresh
flax init. Remake the file with `python tests/test_torch_overfit.py`.
Tier-1 keeps `test_overfit_loss_decreases`. The helpers need no JAX.
"""

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

import synthetic
from rampvo_tpu_torch.ckpt import save_checkpoint
from rampvo_tpu_torch.cli import eval_utils as eu
from rampvo_tpu_torch.cli.evaluate import evaluate, load_params
from rampvo_tpu_torch.data import Events
from rampvo_tpu_torch.data.frame_graph import build_frame_graph
from rampvo_tpu_torch.data.loader import _voxels, make_representation
from rampvo_tpu_torch.data.tartan import DEPTH_SCALE, TartanEventDataset
from rampvo_tpu_torch.lie import ops as pl
from rampvo_tpu_torch.models.vonet import VONet, init_weights
from rampvo_tpu_torch.train import TrainForward
from rampvo_tpu_torch.train.step import Trainer
from rampvo_tpu_torch.vo import VOConfig

H, W = 60, 80
N_FRAMES, M, UNROLL = 8, 16, 10
STEPS = 40
INIT_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "overfit_init_flax.npz")
BATCH_KEYS = ("events", "images", "poses", "disps", "intrinsics", "mask")


def overfit_trainer(net):
    """The JAX test's optimizer, AdamW at 1e-4 (optax's default weight
    decay 1e-4) behind a global-norm clip of 0.1, as the port's Trainer:
    its one-cycle rate over 10**6 steps with no warm-up phase stays within
    4e-5 of the peak for the first 40 steps, the JAX test's constant
    rate."""
    return Trainer(net, {"steps": 10 ** 6, "lr": 1e-4, "clip": 0.1,
                         "weight_decay": 1e-4, "pct_start": 0.0})


def to_batch(item, device):
    """A dataset item as the forward's inputs on `device`, its
    camera-to-world poses inverted to world-to-camera as the JAX test
    does."""
    b = {k: torch.as_tensor(np.asarray(item[k])) for k in BATCH_KEYS}
    b["poses"] = pl.se3_inv(b["poses"].float())
    return {k: (v if k == "mask" else v.to(device)) for k, v in b.items()}


def train_steps(net, item_at, device, steps=STEPS, seed=1):
    """`steps` optimizer steps of TrainForward(n_frames=8, M=16, steps=10)
    on `net` (on `device`) over the items `item_at(step)`, draws from a
    CPU generator seeded with `seed`. Returns (losses, seconds of each
    step, host clock; reading the loss waits for the device)."""
    fwd = TrainForward(net, n_frames=N_FRAMES, M=M, steps=UNROLL)
    tr = overfit_trainer(net)
    g = torch.Generator().manual_seed(seed)
    losses, seconds = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        b = to_batch(item_at(step), device)
        draws = fwd.draw(g, device, H, W)
        loss, _, _ = tr.step(lambda: fwd(
            b["events"], b["images"], b["poses"], b["disps"],
            b["intrinsics"], b["mask"], draws=draws))
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
    return losses, seconds


def eval_config():
    """The JAX test's VOConfig for both evaluations."""
    return VOConfig(
        BUFFER_SIZE=64, MAX_FRAMES=64, PATCHES_PER_FRAME=16,
        REMOVAL_WINDOW=8, OPTIMIZATION_WINDOW=6, PATCH_LIFETIME=5,
        KEYFRAME_INDEX=2, MIXED_PRECISION=False, PROBE_THRESH=-1.0, MEM=16)


def train_config():
    cfg = json.loads(json.dumps(synthetic.EVAL_CFG))
    cfg["data_loader"]["train"]["args"]["n_frames"] = N_FRAMES
    return cfg


def eval_cfg(scene_path):
    cfg = json.loads(json.dumps(synthetic.EVAL_CFG))
    cfg["data_loader"]["test"] = {
        "test_split": [scene_path], "dataset_name": "Synthetic",
        "use_pose_pred": False}
    return cfg


def dataset(root):
    """The JAX test's training dataset over the scene at `root`."""
    return TartanEventDataset(train_config(), root, fmin=0.001, fmax=1000.0)


class MemoryEvents:
    """An event stream held in memory, read as an open H5EventHandle is
    (`t`, `get_between_idx`)."""

    def __init__(self, x, y, t, p, height, width):
        self.x, self.y, self.t, self.p = x, y, t, p
        self.height, self.width = height, width

    def get_between_idx(self, i0, i1):
        return Events(x=self.x[i0:i1], y=self.y[i0:i1], t=self.t[i0:i1],
                      p=self.p[i0:i1], height=self.height, width=self.width)

    def __len__(self):
        return len(self.t)


def memory_scene(n_frames=40):
    """What `synthetic.write_scene(root, n_frames, 60, 80,
    motion="curve")` writes and the readers read back, in memory: the
    8-bit images (3 equal channels), camera-to-world poses, intrinsics,
    the event stream, frame timestamps and indices.txt's per-frame event
    ends (`precompute_event_indices`, 600 events)."""
    images, poses, intr = synthetic.render_sequence(n_frames, H, W,
                                                    motion="curve")
    x, y, t, p = synthetic.events_from_images(images)
    stamps = np.arange(n_frames) * 1000.0
    i1 = np.searchsorted(t, stamps, side="right")
    return {"images": np.repeat(np.clip(images, 0, 255).astype(
                np.uint8)[..., None], 3, -1),
            "poses": poses, "intrinsics": intr, "stamps": stamps,
            "events": MemoryEvents(x, y, t, p, H, W),
            "i0": np.clip(i1 - 600, 0, len(t) - 1), "i1": i1}


class MemoryDataset(TartanEventDataset):
    """The JAX test's training dataset over `memory_scene`: the dataset's
    own scene index, frame graph, window sampling and normalization, with
    images, depths (write_scene's 10, read as 10 / DEPTH_SCALE) and events
    read from memory."""

    read_image = staticmethod(np.asarray)

    @staticmethod
    def read_depth(depth):
        return depth / DEPTH_SCALE

    def __init__(self, scene):
        super().__init__(train_config(), None, fmin=0.001, fmax=1000.0)
        n = len(scene["images"])
        poses = scene["poses"].copy()
        poses[:, :3] /= DEPTH_SCALE
        depths = [np.full((H, W), 2.0 * DEPTH_SCALE, np.float32)] * n
        intr = [self.calib_read()] * n
        self.scene_info = {"memory": {
            "images": list(scene["images"]), "depths": depths,
            "poses": poses, "intrinsics": intr,
            "graph": build_frame_graph(poses, depths, intr,
                                       self.read_depth)}}
        self._build_dataset_index(False)
        self.i0, self.i1 = {"memory": scene["i0"]}, {"memory": scene["i1"]}
        self.events = scene["events"]

    def load_window(self, index):
        inds, scene_id = self.get_indices_to_load(index)
        return self._load_sampled(inds, self.scene_info[scene_id],
                                  self.events, self.i1[scene_id])


def memory_eval_data(scene):
    """What `cli.evaluate.evaluate` reads from the scene's files, from
    `memory_scene`: (data list padded to 480x640, reference trajectory,
    timestamps of the frames the voxels use)."""
    intr = tuple(float(v) for v in scene["intrinsics"])    # K.yaml's
    data_list, masks, frame_of_voxel = _voxels(
        scene["events"], make_representation(synthetic.EVAL_CFG), 600,
        list(scene["images"][1:]), scene["stamps"][1:], None, intr,
        read_image=np.asarray)
    frames = sorted(set(frame_of_voxel[np.asarray(masks)].tolist()))
    poses = scene["poses"]
    ref = eu.traj_from_xyzw(poses[:, :3], poses[:, 3:], scene["stamps"])
    return data_list, ref, scene["stamps"][1:][frames]


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

    mem = memory_scene()
    a, b = dataset(scene), MemoryDataset(mem)
    assert len(a) == len(b) > 1
    for idx in (1, 2, 7, len(a)):
        wa, wb = a[idx], b[idx]
        for k in wa:
            np.testing.assert_array_equal(wa[k], wb[k], err_msg=k)
    intr, ref, ts = _scene_reference(scene, "Synthetic")
    data_f, frames = data_loader_all_events(eval_cfg(scene), scene,
                                            intrinsics=intr)
    data_m, ref_m, ts_m = memory_eval_data(mem)
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
