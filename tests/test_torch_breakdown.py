"""The VO frame split by stage on the CPU: the probe frames of
rampvo_tpu_torch/probes/frame.py, the run of probes/breakdown.py behind
`cli.bench --breakdown`, and `utils.timing.queued_ms`, at
tests/test_torch_slice.py's size (64x96, M=8, float32).

The weights are the JAX tests' MultiScale network (flax PRNGKey(0), read
from tests/data/overfit_init_flax.npz) with the update head's flow output
(d_fc) scaled by 0.1 in both packages, as the slice tests scale it (ROADMAP
§1: random networks make Gauss-Newton chaotic). Every frame starts from
one state, warmed by the port for 12 frames (initialized at 8, past NI = 8
so the lattice rows wrap, never evicting) and carried into a JAX state.

- The probe frame with no stage removed (`all`) equals the production
  branchless frame (`make_vo_frame(...).frame_init`) bit for bit.
- all, no_kf, oracle, zero_corr, no_encoder and oracle_ba0 against the
  same variants built from rampvo_tpu.vo.runtime's internals as
  scripts/probe_frame_ablate.py:142-196 builds them (`jax_frame`: one jit
  whose stage choices are traced switches, so JAX compiles once). The
  JAX side runs its CPU path (flat edge list, exact XLA correlation,
  flax encoder), the port its lattice path, as in
  tests/test_torch_slice_stepwise.py, whose tolerances these are:
  bookkeeping identical, poses within 1e-4, inverse depths within 5e-3;
  the live cells' hidden state and weights within 1e-4 (one update from
  the same state: float32 reassociation only).
- A removed stage is never called (the CPU's counterpart of the card's
  launch counts), no variant reads a tensor on the host, the commit
  variants run, bad flag combinations raise, and the CLI prints its JSON
  line last.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu.models import VONet as JVONet
from rampvo_tpu.models.vonet import extract_patches as jextract_patches
from rampvo_tpu.models.vonet import select_coords_event_bias as jselect
from rampvo_tpu.ops.corr_pallas import RING_PAD
from rampvo_tpu.vo import VOConfig as JVOConfig
from rampvo_tpu.vo import runtime as jrt
from rampvo_tpu.vo.state import init_state as jinit_state
from rampvo_tpu_torch.ba.core import ba_infer
from rampvo_tpu_torch.ckpt.weights import from_flax_params
from rampvo_tpu_torch.cli import bench
from rampvo_tpu_torch.models.vonet import VONet, init_weights
from rampvo_tpu_torch.ops import encoder_kernels as ek
from rampvo_tpu_torch.probes import breakdown as bd
from rampvo_tpu_torch.probes.frame import VARIANTS, make_probe_frame
from rampvo_tpu_torch.utils import timing
from rampvo_tpu_torch.vo import VOConfig
from rampvo_tpu_torch.vo import runtime as rt
from rampvo_tpu_torch.vo.graph import copy_state, state_tensors
from rampvo_tpu_torch.vo.state import init_state
from test_torch_chunk import HostReads
from test_torch_slice import (  # noqa: F401  (_torch_threads is a fixture)
    INTR,
    KW,
    H,
    W,
    _torch_threads,
    assert_same_bookkeeping,
    frames,
    max_diff,
)

ONE = np.ones(1, dtype=bool)
CFG_KW = dict(KW, KEYFRAME_THRESH=0.0)      # never evicting, as the probes
INIT_NPZ = os.path.join(os.path.dirname(__file__), "data",
                        "overfit_init_flax.npz")
JAX_VARIANTS = {          # name -> (encoder, keyframe, update branch)
    "all": (True, True, 0),
    "no_kf": (True, False, 0),
    "oracle": (True, True, 2),
    "zero_corr": (True, True, 1),
    "no_encoder": (False, True, 0),
    "oracle_ba0": (True, True, 3),
}


@pytest.fixture(scope="module")
def weights():
    """(flax params, port VONet): the JAX tests' MultiScale network with
    d_fc scaled by 0.1."""
    params = {}
    with np.load(INIT_NPZ) as z:
        for name in z.files:
            *path, leaf = name.split("/")
            node = params
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = z[name]
    d_fc = params["params"]["update"]["d_fc"]
    d_fc["kernel"] = 0.1 * d_fc["kernel"]
    net = VONet("MultiScale")
    net.load_state_dict(from_flax_params(params))
    return params, net


def warm_state(cfg, net, input_mode="MultiScale", n=12):
    """A port state after n host-driven frames of frames(n, seed=3)."""
    st = init_state(cfg, rt.make_enc_state(cfg, input_mode, H, W, "cpu"),
                    H, W, device="cpu")
    step = rt.make_vo_frame(cfg, net, "cpu")
    for ev, im in frames(n, seed=3):
        step(st, ev, im, ONE, INTR)
    assert st.initialized and st.n == n > cfg.NI
    return st


def view(st):
    """A copy of `st` whose n and counter are 0-d tensors (frame_init's)."""
    return dataclasses.replace(copy_state(st), n=torch.tensor(st.n),
                               counter=torch.tensor(st.counter))


def host(v):
    """`v` with host n and counter again."""
    return dataclasses.replace(v, n=int(v.n), counter=int(v.counter))


def jax_state(ps, jcfg):
    """The JAX VOState holding the port state's values (rings padded,
    super-states channels-last): the inverse of test_torch_slice's
    port_state."""
    js = jinit_state(jcfg, jrt.make_enc_state(jcfg, "MultiScale", H, W), H,
                     W)
    a = lambda x, dt=None: jnp.asarray(x.numpy(), dt)
    h, w = H // 4, W // 4
    fields = {k: a(getattr(ps, k)) for k in (
        "poses", "pat_x", "pat_y", "pat_d", "pat_cx", "pat_cy", "colors",
        "delta_dP", "imap_r", "gmap_r", "cell_valid", "net", "last_weight",
        "slot_free", "intrinsics")}
    fields.update({k: a(getattr(ps, k), jnp.int32)
                   for k in ("delta_parent", "l2g", "slotmap")})
    P = RING_PAD
    fields["fmap1_r"] = js.fmap1_r.at[:, P:P + h, P:P + w].set(
        a(ps.fmap1_r))
    fields["fmap2_r"] = js.fmap2_r.at[:, P:P + h // 4, P:P + w // 4].set(
        a(ps.fmap2_r))
    fields["enc"] = {"ss": [jnp.asarray(p.numpy().T.reshape(j.shape))
                            for p, j in zip(ps.enc["ss"], js.enc["ss"])]}
    return js.replace(n=jnp.int32(ps.n), counter=jnp.int32(ps.counter),
                      initialized=jnp.asarray(True), **fields)


def jax_frame(jcfg):
    """One jitted JAX frame whose stages are switched by traced flags:
    (params, state, events, images, intrinsics, encoder, keyframe,
    update) -> state, update 0 the network, 1 the network on a zero
    correlation (probe_frame_ablate.py:135-140), 2 the oracle of :179-183
    with BA_ITERS iterations, 3 that oracle with BA_ITERS=0 (:195-196).
    Built from rampvo_tpu.vo.runtime's internals as the script's `frame`
    (:142-167)."""
    vonet = JVONet()
    encode_fn = jrt.make_vo_frame(jcfg, vonet, jit_wrap=False).encode_fn
    cfg0 = dataclasses.replace(jcfg, BA_ITERS=0)
    mask = jnp.asarray([True])

    def update_fn(p, net, ctx, corr_in, ii, jj, kk, valid, lattice=None):
        return vonet.apply(p, net, ctx, corr_in, ii, jj, kk, valid, lattice,
                           lattice_contig=True, method=JVONet.update_op)

    def update_zero_corr(p, net, ctx, corr_in, *a):
        return update_fn(p, net, ctx, jnp.zeros_like(corr_in), *a)

    def oracle(st, ii, jj, kk, coords):
        d = jnp.zeros((ii.shape[0], 2), jnp.float32)
        return d, jnp.ones_like(d)

    def frame(p, st, ev, im, intr, do_enc, do_kf, upd):
        def enc(st):
            return encode_fn(p, ev, im, mask, st.enc)

        def no_enc(st):
            h4, w4 = st.hw4
            return (jnp.zeros((1, h4, w4, 128), jnp.float32),
                    jnp.zeros((1, h4, w4, 384), jnp.float32), st.enc)

        fmap, imap, enc2 = jax.lax.cond(do_enc, enc, no_enc, st)
        st = st.replace(enc=enc2)
        coords = jselect(ev[:1], jcfg.M, nms_rad=11)
        disps = jnp.ones((1, fmap.shape[1], fmap.shape[2]), jnp.float32)
        gmap, ictx, patches_new, clr = jextract_patches(
            fmap, imap, im[:1], disps, coords, P=3)
        st = jrt._commit(jcfg, st, fmap, gmap, ictx, patches_new, clr, intr)
        st = jrt._append_edges(jcfg, st.replace(n=st.n + 1))
        st = jax.lax.switch(upd, [
            lambda s: jrt._update(jcfg, update_fn, p, s, None),
            lambda s: jrt._update(jcfg, update_zero_corr, p, s, None),
            lambda s: jrt._update(jcfg, update_fn, p, s, oracle),
            lambda s: jrt._update(cfg0, update_fn, p, s, oracle)], st)
        return jax.lax.cond(do_kf, lambda s: jrt._keyframe(jcfg, s),
                            lambda s: s, st)

    return jax.jit(frame)


@pytest.fixture(scope="module")
def runs(weights):
    """(port state before, next frame, {variant: JAX state after one
    frame})."""
    params, net = weights
    ps = warm_state(VOConfig(**CFG_KW), net)
    jcfg = JVOConfig(**CFG_KW)
    js = jax_state(ps, jcfg)
    ev, im = frames(1, seed=4)[0]
    f = jax_frame(jcfg)
    out = {v: f(params, js, jnp.asarray(ev), jnp.asarray(im),
                jnp.asarray(INTR), *flags)
           for v, flags in JAX_VARIANTS.items()}
    return ps, (ev, im), out


def port_frame(step, ps, fr):
    v = view(ps)
    step.frame_init(v, *(torch.tensor(x) for x in fr), torch.tensor(INTR))
    return host(v)


@pytest.mark.parametrize("variant", list(JAX_VARIANTS))
def test_variant_matches_jax(weights, runs, variant):
    """One frame of the variant from the same state in both packages:
    bookkeeping identical (so no_kf and the others age out the same cells
    and n advances alike); poses within 1e-4 and inverse depths within
    5e-3 (tests/test_torch_slice_stepwise.py's); the hidden state `net`
    and `last_weight` of the live cells within 1e-4 (a dead cell's hidden
    state is never read: a cell is zeroed when it comes alive; the flat
    and lattice paths leave different values there). Under no_encoder
    the encoder carry is untouched."""
    _, net = weights
    ps, fr, out = runs
    js = out[variant]
    got = port_frame(make_probe_frame(VOConfig(**CFG_KW), net, "cpu",
                                      **VARIANTS[variant]), ps, fr)
    assert_same_bookkeeping(js, got, variant)
    assert max_diff(js, got, "poses") < 1e-4
    assert max_diff(js, got, "pat_d") < 5e-3
    live = got.cell_valid.numpy()
    for name in ("net", "last_weight"):
        d = np.abs(np.asarray(getattr(js, name))
                   - getattr(got, name).numpy())[live].max()
        assert d < 1e-4, (name, d)
    if variant == "no_encoder":
        for a, b in zip(got.enc["ss"], ps.enc["ss"]):
            assert torch.equal(a, b)


def test_oracle_ba0_keeps_poses_and_depths(weights, runs):
    """`ba_infer(iterations=0)` is defined: it returns its poses and
    depths as they are, so oracle_ba0 writes the window back unchanged
    (the JAX package's BA_ITERS=0 does the same: its fori_loop of zero
    steps), and the frame's BA leaves poses and depths where the commit
    put them, in both packages."""
    _, net = weights
    ps, fr, out = runs
    g = torch.Generator().manual_seed(0)
    poses, cwin = torch.rand(6, 7, generator=g), torch.rand(20, 3,
                                                            generator=g)
    e = torch.zeros(4, dtype=torch.long)
    p2, d2 = ba_infer(poses, cwin, torch.ones(4), torch.zeros(4, 2),
                      torch.ones(4, 2), 1e-4, e, e, e, 1, 3, N=2, M=20,
                      iterations=0)
    assert torch.equal(p2, poses) and torch.equal(d2, cwin[:, 2])
    got = port_frame(make_probe_frame(VOConfig(**CFG_KW), net, "cpu",
                                      **VARIANTS["oracle_ba0"]), ps, fr)
    no_upd = port_frame(make_probe_frame(VOConfig(**CFG_KW), net, "cpu",
                                         update=False, keyframe=True), ps, fr)
    c = got.counter
    assert torch.equal(got.poses[:c], no_upd.poses[:c])
    assert torch.equal(got.pat_d[:c], no_upd.pat_d[:c])
    np.testing.assert_array_equal(np.asarray(out["oracle_ba0"].pat_d)[:c],
                                  got.pat_d[:c].numpy())


@pytest.mark.parametrize("input_mode", ["MultiScale", "SingleScale"])
def test_all_is_the_production_frame(weights, runs, input_mode):
    """`all` against make_vo_frame(...).frame_init from one warmed state
    (SingleScale: seeded port weights, 9 warm frames): every tensor of the
    state (encoder carry included) equal bit for bit, through two
    frames."""
    cfg = VOConfig(**CFG_KW)
    if input_mode == "MultiScale":
        net, ps = weights[1], runs[0]
    else:
        net = init_weights(VONet(input_mode),
                           torch.Generator().manual_seed(0))
        ps = warm_state(cfg, net, input_mode, n=9)
    prod = rt.make_vo_frame(cfg, net, "cpu")
    probe = make_probe_frame(cfg, net, "cpu")
    a, b = view(ps), view(ps)
    intr = torch.tensor(INTR)
    for ev, im in frames(2, seed=5):
        ev, im = torch.tensor(ev), torch.tensor(im)
        prod.frame_init(a, ev, im, intr)
        probe.frame_init(b, ev, im, intr)
        assert (int(a.n), int(a.counter)) == (int(b.n), int(b.counter))
        for x, y in zip(state_tensors(a), state_tensors(b)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_removed_stages_are_not_called(monkeypatch, weights, runs,
                                       variant):
    """One frame of each variant with the correlation kernel's wrapper
    (`corr_lattice`) and the encoder chain's (`lstm_fold_cm`) counted:
    they are called as `probes.breakdown.expected_launches` says the card
    launches them (K1 once, 0 without the update's correlation; K2 three
    times, 0 without the encoder), the frame reads nothing on the host
    (HostReads: a CUDA graph could not hold it), and the state it leaves
    is finite. Counters advance by one frame; without the commit the
    frame is not committed."""
    cfg, net, ps = VOConfig(**CFG_KW), weights[1], runs[0]
    calls = {"corr_lattice": 0, "lstm_fold_cm": 0}

    def counted(name, fn):
        def wrap(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrap

    monkeypatch.setattr(rt, "corr_lattice",
                        counted("corr_lattice", rt.corr_lattice))
    monkeypatch.setattr(ek, "lstm_fold_cm",
                        counted("lstm_fold_cm", ek.lstm_fold_cm))
    step = make_probe_frame(cfg, net, "cpu", **VARIANTS[variant])
    v = view(ps)
    ev, im = (torch.tensor(x) for x in frames(1, seed=6)[0])
    intr = torch.tensor(INTR)
    with HostReads() as reads:
        step.frame_init(v, ev, im, intr)
    assert reads.seen == []
    want = bd.expected_launches("MultiScale", "fused3", VARIANTS[variant])
    assert {k: c for k, c in calls.items() if c} == want
    assert bd.finite(v)
    assert int(v.n) == ps.n + 1
    committed = VARIANTS[variant].get("commit", True)
    assert int(v.counter) == ps.counter + committed
    assert step.oracle is None and step.event_bias


@pytest.mark.parametrize("flags", [
    dict(extract=False), dict(select=False, commit=False),
    dict(update=False, corr=False), dict(update=False, ba_iters=1),
    dict(ba_iters=-1), dict(ba_iters=1.5)])
def test_bad_flags_raise(weights, flags):
    with pytest.raises(ValueError):
        make_probe_frame(VOConfig(**CFG_KW), weights[1], "cpu", **flags)


def test_stage_table_names_known_variants():
    """Every stage of the table is a combination of known variants whose
    coefficients cancel (a difference of frame times), but commit/select,
    the residual of a frame time (probe_frame_ablate.py:208); the
    quartiles interpolate linearly."""
    for stage, (coef, _) in bd.STAGES.items():
        assert set(coef) <= set(VARIANTS), stage
        assert sum(coef.values()) == (stage == "commit/select"), stage
    assert bd.quartiles([4.0, 1.0, 3.0, 2.0, 5.0]) == (2.0, 3.0, 4.0)


def test_bench_breakdown_prints_one_json_line(capsys):
    """`cli.bench --breakdown --device cpu --small --variants all,no_kf`
    prints one line for each variant and stage, and a parseable JSON line
    last; its checks hold (all == production, finite states)."""
    res = bench.main(["--breakdown", "--device", "cpu", "--small",
                      "--variants", "all,no_kf", "--warm", "10",
                      "--chunk", "2", "--turns", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last["metric"] == "vo_frame_breakdown_multiscale_64x96"
    assert last["unit"] == "ms/frame" and last["device"] == "cpu"
    assert last["value"] > 0 and set(last["variants"]) == {"all", "no_kf"}
    assert set(last["stages"]) == {"keyframe"}
    assert last["checks"]["all_equals_production"] is True
    assert all(last["checks"]["finite"].values())
    assert last["alone"]["BA synthetic: solve (Schur)"] > 0
    assert any(ln.lstrip().startswith("[no_kf]") for ln in lines)
    assert res["value"] == last["value"]


def test_queued_ms_contract(monkeypatch):
    """`queued_ms` times the card: without CUDA it raises before calling
    the function, unless the CPU is asked for, where it times n calls
    after one warm-up on the host clock."""
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.queued_ms(lambda: seen.append(1))
    assert seen == []
    ms = timing.queued_ms(lambda: seen.append(1), n=3, device="cpu")
    assert ms >= 0 and len(seen) == 4
