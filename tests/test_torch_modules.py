"""rampvo_tpu_torch modules against their rampvo_tpu counterparts on the CPU.

Inputs are made with numpy from fixed seeds and go through both packages;
network weights come from a seeded flax VONet.init carried over by
`from_flax_params`. Tolerances are float32 summation-order bounds unless a
test says otherwise.
"""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu.ckpt.torch_import import map_state_dict
from rampvo_tpu.geometry import projective as jproj
from rampvo_tpu.lie import ops as jl
from rampvo_tpu.lie import quaternion as jq
from rampvo_tpu.models import VONet as JVONet
from rampvo_tpu.models import vonet as jvn
from rampvo_tpu.models.encoders import MultiScaleEncoder as JMSEncoder
from rampvo_tpu.ops.neighbors import neighbors as j_neighbors
from rampvo_tpu.ops.scatter import compact_ids as j_compact_ids
from rampvo_tpu.ops.scatter import segment_softmax as j_segment_softmax
from rampvo_tpu.ops.scatter import segment_sum as j_segment_sum
from rampvo_tpu.vo.config import VOConfig as JVOConfig
from rampvo_tpu_torch.ckpt.weights import from_flax_params
from rampvo_tpu_torch.geometry import projective as pproj
from rampvo_tpu_torch.lie import ops as pl
from rampvo_tpu_torch.models import vonet as pvn
from rampvo_tpu_torch.models.encoders import multiscale_init_state
from rampvo_tpu_torch.ops import neighbors as pnb
from rampvo_tpu_torch.ops import scatter as psc
from rampvo_tpu_torch.vo.config import VOConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and torch's default (one thread per core, spinning) oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.tensor(np.asarray(x))


def npy(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def nets():
    """(flax params, port VONet) with the same seeded weights. Parameter
    shapes do not depend on the input size, so init runs at 16x16."""
    params = jax.jit(JVONet().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 5)),
        jnp.zeros((1, 16, 16, 3)), jnp.asarray([True]))
    net = pvn.VONet()
    net.load_state_dict(
        from_flax_params(jax.tree_util.tree_map(np.asarray, params)))
    return params, net.eval()


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(REPO, "config_vo", "*.yaml"))),
    ids=os.path.basename)
def test_config_yaml(path):
    a = JVOConfig.from_yaml(path)
    b = VOConfig.from_yaml(path)
    import dataclasses

    for f in dataclasses.fields(b):
        assert getattr(b, f.name) == getattr(a, f.name), f.name
    for prop in ("M", "NI", "T", "EDGE_CAPACITY", "POSE_WINDOW",
                 "FEATURE_WINDOW", "PATCH_WINDOW"):
        assert getattr(b, prop) == getattr(a, prop), prop


# ---------------------------------------------------------------------------
# lie / geometry
# ---------------------------------------------------------------------------

def _se3(rng, n, scale):
    xi = (scale * rng.randn(n, 6)).astype(np.float32)
    xi[:4] *= 1e-5                       # small-angle Taylor branches
    return xi, np.asarray(jl.se3_exp(jnp.asarray(xi)))


def test_se3_ops():
    """Every SE3 op of the port == lie/ops.py element-wise (atol 2e-5 on
    unit-scale values, small angles included)."""
    rng = np.random.RandomState(0)
    xi, g = _se3(rng, 64, 0.7)
    _, h = _se3(rng, 64, 0.7)
    p3 = rng.randn(64, 3).astype(np.float32)
    p4 = rng.randn(64, 4).astype(np.float32)
    x6 = rng.randn(64, 6).astype(np.float32)
    pairs = [
        (jl.se3_exp(jnp.asarray(xi)), pl.se3_exp(t(xi))),
        (jl.se3_log(jnp.asarray(g)), pl.se3_log(t(g))),
        (jl.se3_inv(jnp.asarray(g)), pl.se3_inv(t(g))),
        (jl.se3_mul(jnp.asarray(g), jnp.asarray(h)), pl.se3_mul(t(g), t(h))),
        (jl.se3_act(jnp.asarray(g), jnp.asarray(p3)), pl.se3_act(t(g), t(p3))),
        (jl.se3_act4(jnp.asarray(g), jnp.asarray(p4)),
         pl.se3_act4(t(g), t(p4))),
        (jl.se3_adj(jnp.asarray(g), jnp.asarray(x6)), pl.se3_adj(t(g), t(x6))),
        (jl.se3_adjT(jnp.asarray(g), jnp.asarray(x6)),
         pl.se3_adjT(t(g), t(x6))),
        (jl.se3_retr(jnp.asarray(g), jnp.asarray(x6 * 0.1)),
         pl.se3_retr(t(g), t(x6 * 0.1))),
        (jq.quat_to_matrix(jnp.asarray(g[:, 3:])),
         pl.quat_to_matrix(t(g[:, 3:]))),
        (jl.hat_so3(jnp.asarray(p3)), pl.hat_so3(t(p3))),
    ]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(npy(b), npy(a), atol=2e-5, err_msg=str(i))


def test_projective():
    """iproj, proj, transform_edges and flow_mag_edges == geometry/
    projective.py (rtol 1e-5 on pixel coordinates)."""
    rng = np.random.RandomState(1)
    E, P = 40, 3
    _, gi = _se3(rng, E, 0.1)
    _, gj = _se3(rng, E, 0.1)
    patches = np.concatenate([
        rng.uniform(0, 96, (E, 2, P, P)), rng.uniform(0.2, 2.0, (E, 1, P, P))
    ], 1).astype(np.float32)
    intr = np.array([60.0, 62.0, 48.0, 32.0], np.float32)
    intr_e = np.broadcast_to(intr, (1, E, 4)).copy()
    X0 = jproj.iproj(jnp.asarray(patches[None]), jnp.asarray(intr_e))
    X0p = pproj.iproj(t(patches[None]), t(intr_e))
    np.testing.assert_allclose(npy(X0p), npy(X0), rtol=1e-5, atol=1e-6)
    for depth in (False, True):
        np.testing.assert_allclose(
            npy(pproj.proj(X0p, t(intr_e), depth)),
            npy(jproj.proj(X0, jnp.asarray(intr_e), depth)),
            rtol=1e-5, atol=1e-4)
    args_j = (jnp.asarray(gi), jnp.asarray(gj), jnp.asarray(patches),
              jnp.asarray(intr))
    args_p = (t(gi), t(gj), t(patches), t(intr))
    np.testing.assert_allclose(npy(pproj.transform_edges(*args_p)),
                               npy(jproj.transform_edges(*args_j)),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(npy(pproj.flow_mag_edges(*args_p)),
                               npy(jproj.flow_mag_edges(*args_j)),
                               rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# scatter / neighbours
# ---------------------------------------------------------------------------

def test_neighbors_and_segments():
    """neighbors() is exact (stable-sort tie order); segment softmax/sum
    match to 1e-6."""
    rng = np.random.RandomState(2)
    E = 200
    kk = rng.randint(0, 12, E).astype(np.int32)
    jj = rng.randint(0, 6, E).astype(np.int32)       # ties in jj
    valid = rng.rand(E) < 0.8
    for v in (None, valid):
        a = j_neighbors(jnp.asarray(kk), jnp.asarray(jj),
                          None if v is None else jnp.asarray(v))
        b = pnb.neighbors(t(kk), t(jj), None if v is None else t(v))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(npy(y), npy(x))
    x = rng.randn(E, 5).astype(np.float32)
    seg = rng.randint(0, 30, E).astype(np.int32)
    np.testing.assert_allclose(
        npy(psc.segment_softmax(t(x), t(seg), 40, t(valid))),
        npy(j_segment_softmax(jnp.asarray(x), jnp.asarray(seg), 40,
                                jnp.asarray(valid))), atol=1e-6)
    np.testing.assert_allclose(
        npy(psc.segment_sum(t(x), t(seg), 40, t(valid))),
        npy(j_segment_sum(jnp.asarray(x), jnp.asarray(seg), 40,
                            jnp.asarray(valid))), atol=1e-5)
    np.testing.assert_array_equal(
        npy(psc.compact_ids(t(seg * 7))),
        npy(j_compact_ids(jnp.asarray(seg * 7), E)))


# ---------------------------------------------------------------------------
# update operator
# ---------------------------------------------------------------------------

def _lattice_problem(rng, NI=4, T=5, M=8, holes=True):
    """Lattice edge set whose valid cells are a contiguous t-range per row
    (the runtime's invariant)."""
    lo = rng.randint(0, T, NI)
    hi = np.minimum(T - 1, lo + rng.randint(0, T, NI))
    tt = np.arange(T)[None, :]
    cv = (tt >= lo[:, None]) & (tt <= hi[:, None])
    if not holes:
        cv[:] = True
    r = (T + 1) // 2
    ii = np.broadcast_to((10 + np.arange(NI))[:, None, None], (NI, T, M))
    jj = ii + (np.arange(T)[None, :, None] - (r - 1))
    kk = ii * M + np.arange(M)[None, None, :]
    valid = np.broadcast_to(cv[:, :, None], (NI, T, M))
    flat = lambda a: np.ascontiguousarray(a).reshape(-1).astype(np.int32)
    return flat(ii), flat(jj), flat(kk), valid.reshape(-1).copy()


@pytest.mark.parametrize("mode", ["flat", "lattice"])
def test_update_operator(nets, mode):
    """Update (flat and lattice_contig) == flax update_op; net, delta and
    weight within 2e-4 (384-wide f32 layers, LayerNorm variance formulas
    differ)."""
    params, net = nets
    rng = np.random.RandomState(3)
    NI, T, M = 4, 5, 8
    E = NI * T * M
    ii, jj, kk, valid = _lattice_problem(rng, NI, T, M)
    h = rng.randn(E, 384).astype(np.float32)
    corr = rng.randn(E, 882).astype(np.float32)
    if mode == "flat":
        inp = rng.randn(E, 384).astype(np.float32)
        lat = None
    else:
        inp = rng.randn(NI * M, 384).astype(np.float32)   # t-compressed
        lat = (NI, T, M)
    out_j = jvn.VONet().apply(
        params, jnp.asarray(h), jnp.asarray(inp), jnp.asarray(corr),
        jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(kk), jnp.asarray(valid),
        lat, lattice_contig=True, method=JVONet.update_op)
    with torch.no_grad():
        out_p = net.update(t(h), t(inp), t(corr), t(ii).long(), t(jj).long(),
                           t(kk).long(), t(valid), lat, lattice_contig=True)
    (nj, (dj, wj)), (np_, (dp, wp)) = out_j, out_p
    for a, b in ((nj, np_), (dj, dp), (wj, wp)):
        np.testing.assert_allclose(npy(b)[valid], npy(a)[valid], atol=2e-4)


def test_layernorm1d():
    """LayerNorm1D over the channel dim of [B, C, L] == blocks.py's (atol
    1e-5)."""
    from rampvo_tpu.models.blocks import LayerNorm1D as JLN
    from rampvo_tpu_torch.models.blocks import LayerNorm1D

    rng = np.random.RandomState(7)
    x = rng.randn(2, 12, 9).astype(np.float32)
    p = JLN(12).init(jax.random.PRNGKey(0), jnp.asarray(x))
    ln = p["params"]["LayerNorm_0"]
    scale = (1 + 0.1 * rng.randn(12)).astype(np.float32)
    bias = (0.1 * rng.randn(12)).astype(np.float32)
    p = {"params": {"LayerNorm_0": {"scale": jnp.asarray(scale),
                                    "bias": jnp.asarray(bias)}}}
    assert set(ln) == {"scale", "bias"}
    m = LayerNorm1D(12)
    with torch.no_grad():
        m.norm.weight.copy_(t(scale))
        m.norm.bias.copy_(t(bias))
        got = m(t(x))
    np.testing.assert_allclose(npy(got), npy(JLN(12).apply(p, jnp.asarray(x))),
                               atol=1e-5)


def test_plain_encoder(nets):
    """The plain MultiScaleEncoder == VONet.encode over 2 carried frames,
    the second with mask False (fmap/imap atol 1e-4 on O(1) maps, carried
    super-states atol 1e-5)."""
    params, net = nets
    H, W = 32, 48
    rng = np.random.RandomState(4)
    sj = JMSEncoder.init_state(H, W)
    sp = multiscale_init_state(H, W)
    for m in (True, False):
        ev = rng.rand(1, H, W, 5).astype(np.float32)
        im = rng.rand(1, H, W, 3).astype(np.float32)
        fj, ij, sj = JVONet().apply(params, jnp.asarray(ev), jnp.asarray(im),
                                    jnp.asarray([m]), sj, 1,
                                    method=JVONet.encode)
        with torch.no_grad():
            fp, ip, sp = net.patchify.encoder(t(ev), t(im), np.array([m]), sp)
        np.testing.assert_allclose(npy(fp) / 4, npy(fj), atol=1e-4)
        np.testing.assert_allclose(npy(ip) / 4, npy(ij), atol=1e-4)
        for a, b in zip(sj["ss"], sp["ss"]):
            a = npy(a)
            np.testing.assert_allclose(npy(b), a.reshape(-1, a.shape[-1]).T,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# patch selection / extraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [1.0, 0.02])
def test_patch_selection_and_extraction(density):
    """Event-biased coords are identical, including sparse frames whose
    NMS map is mostly zero ties; gmap/imap/patches/colors match."""
    rng = np.random.RandomState(5)
    H, W, M = 64, 96, 16
    ev = (rng.rand(1, H, W, 5) * (rng.rand(1, H, W, 1) < density)).astype(
        np.float32)
    cj = jvn.select_coords_event_bias(jnp.asarray(ev), M, nms_rad=11)
    cp = pvn.select_coords_event_bias(t(ev), M, nms_rad=11)
    np.testing.assert_array_equal(npy(cp), npy(cj))
    h, w = H // 4, W // 4
    fmap = rng.randn(1, h, w, 128).astype(np.float32)
    imap = rng.randn(1, h, w, 384).astype(np.float32)
    img = rng.rand(1, H, W, 3).astype(np.float32)
    disps = rng.rand(1, h, w).astype(np.float32)
    a = jvn.extract_patches(jnp.asarray(fmap), jnp.asarray(imap),
                            jnp.asarray(img), jnp.asarray(disps), cj, P=3)
    b = pvn.extract_patches(t(fmap), t(imap), t(img), t(disps), cp, P=3)
    for x, y in zip(a, b):
        np.testing.assert_allclose(npy(y), npy(x), atol=1e-6)
    tgt = rng.uniform(-5, 30, (20, 2)).astype(np.float32)
    wgt = rng.rand(20, 2).astype(np.float32)
    np.testing.assert_array_equal(
        npy(pvn.filter_features(t(wgt), t(tgt), (h, w))),
        npy(jvn.filter_features(jnp.asarray(wgt), jnp.asarray(tgt), (h, w))))


# ---------------------------------------------------------------------------
# weights and package hygiene
# ---------------------------------------------------------------------------

def test_state_dict_roundtrip(nets):
    """port state_dict -> map_state_dict -> the same flax tree, no key
    unmapped or left over."""
    params, net = nets
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    back, skipped = map_state_dict(sd, "MultiScale")
    assert skipped == []
    a = dict(jax.tree_util.tree_leaves_with_path(params))
    b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke, with jax, flax
    and rampvo_tpu blocked succeeds; so does it with the host file
    libraries h5py, hdf5plugin, PIL, cv2 and yaml, the training loggers'
    tensorboard and wandb, and matplotlib blocked (the card's machine has
    none of some of them), which the port imports only inside the
    functions that use them. The walk reaches the training and layout
    slices' modules, the probes, pose prediction, the evaluation fleet,
    the TartanEvent entry point, the native event builders, the Lie
    groups, the event sequence, the seeding, timing and viz utilities,
    the data-parallel mesh, the benchmark and the ATE-parity harness (its
    dry run runs with them blocked in tests/test_torch_harness.py), and
    the stage split's probe frames and breakdown."""
    code = (
        "import sys, importlib, pkgutil\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'rampvo_tpu', 'h5py', 'hdf5plugin', 'PIL', 'cv2', 'yaml',"
        " 'tensorboard', 'wandb', 'matplotlib'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import rampvo_tpu_torch\n"
        "for m in pkgutil.walk_packages(rampvo_tpu_torch.__path__,"
        " 'rampvo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    print(m.name)\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    lines = res.stdout.split()
    assert res.returncode == 0 and lines[-1:] == ["ok"], res.stderr
    for mod in ("ops.corr_train_kernels", "train.forward", "train.loss",
                "train.step", "ckpt.train_state", "cli.train", "data.tartan",
                "data.augmentation", "data.frame_graph", "utils.logger",
                "ops.corr_perms", "ops.corr_paired_kernels",
                "ops.corr_band_kernels", "probes.dynlane",
                "probes.grid_overhead", "vo.pose_prediction",
                "parallel.eval_fleet", "cli.evaluate_tartanevent",
                "data.native", "lie.groups", "lie.quaternion",
                "data.event_sequence", "utils.seeding", "utils.timing",
                "utils.viz", "parallel.mesh", "cli.bench",
                "cli.real_ckpt_eval", "probes.frame", "probes.breakdown"):
        assert "rampvo_tpu_torch." + mod in lines, mod
