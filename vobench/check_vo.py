"""Whether a VO run is correct: the plain reference (vobench/reference)
follows what the program did and the two states are compared.

A random network makes the trajectory chaotic, so the reference cannot
run a whole sequence beside the program and agree. It follows the
program step by step instead:

- sampled chunks of the window: `check.chunks` of them, those that run
  at as many times drawn from the seed over the window's first
  `check.window_share`, and `check.early_chunks` drawn from the seed
  among its first `check.early_range` (the early chunks). From the
  program's own state before the chunk, the reference runs the chunk's
  K frames (the branchless frame of the plain copy) on the same inputs,
  and its state after them is compared with the program's;
- the stage that the window skips, the eager warm-up frames (the
  host-driven frame, with its update, BA and keyframe step): from the
  program's state before each of `check.warm_frames`, the reference runs
  that one frame;
- the start of the run: from the empty state, the reference runs the
  first `check.start_frames` frames (before initialization) and its
  state is compared with the program's then.

Each followed step gives these readings (`compare`); `SUMMARY` makes the
numbers compared of them: the worst over the start, the warm-up frames
and the chunks for encoder, features, discrete and keyframe_margin; the
worst over the warm-up frames, a step of one frame, for frame_reproj_p50
and frame_hidden; the median over the early chunks, eight frames each,
for chunk_reproj_p50 and chunk_hidden. Eight frames of a random network
amplify rounding; later in the window some runs drift into a regime where
they amplify it as far as the control's (PERF.md), so the continuous gaps
of the update and BA over a chunk are read early, and the numbers that
stay steady (encoder, features, discrete, keyframe_margin) everywhere.

- encoder: the largest gap of the encoder carry, over the carry's
  largest magnitude;
- features: the same for the feature rings (fmap and its pool, the patch
  features and contexts);
- discrete: how many entries of the integer and boolean state (frame and
  slot maps, the lattice's live cells, n and counter, the selected patch
  coordinates) differ, and how many of the float state are finite on one
  side only (`nonfinite`; where both sides hold a non-finite entry, as a
  random network's state can, the gaps below leave it out);
- keyframe_margin: the keyframe step's decision. The reference is told
  the program's eviction decisions (which frames the step evicted, read
  from the trajectory parents it set), so that both sides keep the same
  lattice; where its own flow would have decided otherwise, the reading
  is how far that flow lies from KEYFRAME_THRESH, in pixels (0 where
  they agree). It is read at the decisions that the reference makes
  from the program's own state, one frame on: each warm-up frame's and
  each chunk's first. A chunk's later decisions come after frames in
  which the two sides' states have drifted apart (a random network's
  mean patch flow swings by tens of pixels there), so their reading,
  keyframe_margin_later, is printed and not compared;
- reproj_p50: the median gap, in pixels at 1/4 resolution, between the
  patch centres of the live lattice edges reprojected through the
  program's poses and depths and through the reference's (the median:
  the chaotic dynamics of a random network put single edges far apart
  after a few frames, for any rounding);
- hidden: the gap of the live edges' hidden state, as a share of the
  reference's (Frobenius norms).

Also printed, not compared: the largest reprojection gap and the poses'
largest translation gap, which the same chaos dominates.

A random network's state can go non-finite: on one seed in some sixty
the hidden state of ~7000 edges turns NaN early in the window, and the
reference, run from the program's state before that chunk, does so in the
same frame, in as many entries (PERF.md). Entries non-finite on both
sides are left out of the gaps, and those non-finite on one side only
count in `discrete`. A sampled chunk that starts from a state already
holding non-finite values is void: printed, and left out of the numbers,
since the two sides' handling of NaN diverges from there. The start and
the warm-up frames are never void (their non-finite entries count in
`discrete`), and at least one early chunk has to be compared: where every
early chunk is void, the first one's non-finite entries count in
`discrete`.

`limits/<workload>.json` names the numbers compared and their limits;
the others are printed for the record. The reference computes in
float32 with TF32 off; the program in the configuration's bf16. The
control (`control_net`) is the reference with its weights and the inputs
of its convolutions and linears rounded to float8 (e4m3, one scale a
tensor), the precision below the configuration's bf16. The keyframe
fault (`inverted`) is the reference in the program's place with its
eviction decision inverted: it keeps the frames it should evict and
evicts those it should keep.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import statistics

import torch
import torch.nn as nn


def ref_network(sd: dict, mode: str, bins: int, device):
    """The reference's VONet holding the benchmark's weights `sd`."""
    from .reference.models.vonet import VONet

    with torch.device("meta"):
        net = VONet(mode, evs_ch=bins)
    net = net.to_empty(device=device)
    net.load_state_dict(sd)
    return net


def fp8(x):
    """x rounded to float8 e4m3 with one scale for the tensor."""
    amax = x.detach().abs().amax().float()
    if amax == 0:
        return x
    s = amax / 448.0
    return ((x.float() / s).to(torch.float8_e4m3fn).float() * s).to(x.dtype)


def control_net(net: nn.Module) -> nn.Module:
    """A copy of `net` computed in float8: its parameters rounded, and the
    input of each convolution and linear rounded as it runs."""
    net = copy.deepcopy(net)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(fp8(p))
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.register_forward_pre_hook(_round_input)
    return net


def _round_input(mod, args):
    return (fp8(args[0]),) + tuple(args[1:])


def ref_config(cfg):
    """The reference's VOConfig: the program's, computed in float32."""
    from .reference.vo.config import VOConfig

    return VOConfig(**dict(dataclasses.asdict(cfg), MIXED_PRECISION=False))


def to_ref_state(snap: dict):
    """A reference VOState holding float32 copies of a snapshot's tensors
    (the program keeps its feature rings and encoder carry in bf16)."""
    from .reference.vo.state import VOState

    def clone(x):
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(clone(v) for v in x)
        if not isinstance(x, torch.Tensor):
            return x
        return (x.to(torch.float32, copy=True) if x.is_floating_point()
                else x.clone())

    return VOState(**{k: clone(v) for k, v in snap.items()})


def _forcing(step, evicted):
    """A `decide` hook that evicts exactly the frames of `evicted` (global
    ids) and records, for each decision in turn, where the reference's own
    flow decided otherwise its distance from the threshold (else 0) in
    `step.margins`."""
    thresh = step.cfg.KEYFRAME_THRESH
    step.margins = []

    def decide(t1g, flow, evict):
        forced = int(t1g) in evicted
        step.margins.append(abs(float(flow) - thresh)
                            if forced != bool(evict) else 0.0)
        return torch.tensor(forced, device=evict.device)

    return decide


def inverted(t1g, flow, evict):
    """The keyframe fault's `decide` hook: the decision turned round."""
    return torch.logical_not(torch.as_tensor(evict))


def follow_chunk(step, snap, events, images, intr, f0: int, K: int,
                 decide=None):
    """The reference's state after the K frames from `f0` on, run from
    the snapshot `snap` by `step` (a reference `make_vo_frame`) as the
    program's chunk runs them: branchless frames on device scalars.
    `decide` replaces the keyframe step's decision (`_forcing`,
    `inverted`)."""
    step.frame_init.decide = decide
    st = to_ref_state(snap)
    dev = st.poses.device
    n = torch.tensor(st.n, dtype=torch.int64, device=dev)
    c = torch.tensor(st.counter, dtype=torch.int64, device=dev)
    view = dataclasses.replace(st, n=n, counter=c)
    ncyc = events.shape[0]
    for k in range(K):
        f = (f0 + k) % ncyc
        step.frame_init(view, events[f].float(), images[f].float(),
                        intr.float())
    st.n, st.counter = int(n), int(c)
    step.frame_init.decide = None
    return st


def follow_frame(step, snap, events, images, intr, f: int, decide=None):
    """The reference's state after frame f, the host-driven frame (as the
    program runs its warm-up), from the snapshot `snap`."""
    step.decide = decide
    st = to_ref_state(snap)
    ncyc = events.shape[0]
    step(st, events[f % ncyc], images[f % ncyc], [True], intr)
    step.decide = None
    return st


def evictions(pre: dict, post) -> set:
    """Global ids of the frames that a step evicted: those whose
    trajectory parent it set."""
    post = post["delta_parent"] if isinstance(post, dict) else post.delta_parent
    return set(torch.nonzero(post != pre["delta_parent"]).reshape(-1)
               .tolist())


def follow_start(step, cfg_r, mode, H, W, events, images, intr, n: int):
    """The reference's state after the run's first n frames from the empty
    state (the host-driven frame)."""
    from .reference.vo.runtime import make_enc_state
    from .reference.vo.state import init_state

    dev = intr.device
    st = init_state(cfg_r, make_enc_state(cfg_r, mode, H, W, dev), H, W,
                    device=dev)
    ncyc = events.shape[0]
    for i in range(n):
        step(st, events[i % ncyc], images[i % ncyc], [True], intr)
    return st


def _rel(a, b) -> float:
    """max |a - b| over max |b|, over the entries finite on both sides
    (`_one_sided` counts the others)."""
    a, b = a.float(), b.float()
    ok = torch.isfinite(a) & torch.isfinite(b)
    zero = torch.zeros((), device=a.device)
    scale = torch.where(ok, b, zero).abs().max().item()
    gap = torch.where(ok, a - b, zero).abs().max().item()
    return gap / scale if scale > 0 else gap


def _pairs(a, b):
    """The tensors of two states' field values, side by side."""
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            yield from _pairs(x, y)
    elif isinstance(a, torch.Tensor):
        yield a, b


def _nonfinite(state) -> int:
    """How many entries of a state's (or a snapshot's) floats are not
    finite."""
    items = (state.values() if isinstance(state, dict) else
             [getattr(state, f.name) for f in dataclasses.fields(state)])
    return sum(int((~torch.isfinite(a)).sum()) for v in items
               for a, _ in _pairs(v, v) if a.is_floating_point())


def _one_sided(prog, ref) -> int:
    """How many entries of the float state are finite on one side only."""
    bad = 0
    for f in dataclasses.fields(ref):
        for a, b in _pairs(getattr(prog, f.name), getattr(ref, f.name)):
            if a.is_floating_point():
                bad += int((torch.isfinite(a) != torch.isfinite(b)).sum())
    return bad


def _enc_tensors(enc, mode: str):
    """The encoder carry's tensors that hold state: every super-state
    (MultiScale); SingleScale's carry without its padding rows."""
    if mode == "MultiScale":
        return list(enc["ss"])
    from .reference.vo.runtime import padded_dim
    from .reference.models.encoders import SS_LSTM_DIM

    h, hp = SS_LSTM_DIM, padded_dim(SS_LSTM_DIM)
    hc = enc["hc"].reshape(4, hp, -1)[:, :h]
    return [hc, enc["ss"][:h]]


DISCRETE = ("l2g", "slotmap", "slot_free", "cell_valid", "delta_parent",
            "pat_x", "pat_y", "pat_cx", "pat_cy")
RINGS = ("fmap1_r", "fmap2_r", "gmap_r", "imap_r")


def compare(prog, ref, cfg_r, mode: str) -> dict:
    """The numbers of the module docstring for the program's state `prog`
    (a reference VOState made from its snapshot) against `ref`."""
    from .reference.vo.runtime import _reproject_lattice_planar
    from .reference.vo.state import edge_table

    out = {"encoder": max(_rel(a, b) for a, b in zip(
        _enc_tensors(prog.enc, mode), _enc_tensors(ref.enc, mode)))}
    out["features"] = max(_rel(getattr(prog, k), getattr(ref, k))
                          for k in RINGS)
    bad = int(prog.n != ref.n) + int(prog.counter != ref.counter)
    for k in DISCRETE:
        bad += int((getattr(prog, k) != getattr(ref, k)).sum())
    out["nonfinite"] = _one_sided(prog, ref)
    bad += out["nonfinite"]
    out["discrete"] = bad
    if bad:
        # the lattices differ, so the edges below are not the same edges:
        # the gaps are out of reach (JSON has no infinity)
        out["reproj_p50"] = out["hidden"] = 1e30
        return out
    _, _, _, valid = edge_table(cfg_r, ref.n, ref.cell_valid)
    NI, T, M = cfg_r.NI, cfg_r.T, cfg_r.M
    _, _, ucp, vcp = _reproject_lattice_planar(cfg_r, prog)
    _, _, ucr, vcr = _reproject_lattice_planar(cfg_r, ref)
    v = valid.reshape(NI * T, M)
    # below, entries that are not finite on either side (the same on both:
    # `_one_sided` read 0) are left out
    gap = torch.hypot(ucp - ucr, vcp - vcr)[v]
    gap = gap[torch.isfinite(gap)]
    out["reproj_p50"] = gap.median().item() if gap.numel() else 0.0
    out["reproj_max"] = gap.max().item() if gap.numel() else 0.0
    dt = (prog.poses[:, :3] - ref.poses[:, :3]).norm(dim=-1)
    out["pose_t"] = dt[torch.isfinite(dt)].max().item() if bool(
        torch.isfinite(dt).any()) else 0.0
    hp = prog.net.reshape(-1, prog.net.shape[-1])[valid]
    hr = ref.net.reshape(-1, ref.net.shape[-1])[valid]
    ok = torch.isfinite(hp).all(-1) & torch.isfinite(hr).all(-1)
    out["nonfinite_edges"] = int((~ok).sum())
    hp, hr = hp[ok], hr[ok]
    nr = torch.linalg.vector_norm(hr).item()
    out["hidden"] = (torch.linalg.vector_norm(hp - hr).item() / nr
                     if nr > 0 else 0.0)
    return out


def readings(cfg, sd, snaps, events, images, intr, K, mode, bins, H, W,
             seed, net_fn=None, fault=None):
    """The comparison's numbers for the start, each followed warm-up
    frame and each followed chunk: [(what, numbers)], `what` being
    "start", "frame<i>" or "chunk<i>". `net_fn` turns the reference's
    network into the one that plays the program (the control); `fault`,
    a `decide` hook, makes the reference that plays the program decide
    its evictions so (the keyframe fault); with neither, the program's own
    snapshots are compared."""
    from .reference.vo.runtime import make_vo_frame

    dev = intr.device
    cfg_r = ref_config(cfg)
    net = ref_network(sd, mode, bins, dev)
    step = make_vo_frame(cfg_r, net, dev, seed)
    other = None
    if net_fn is not None or fault is not None:
        other = make_vo_frame(cfg_r, net if net_fn is None else net_fn(net),
                              dev, seed)
    out = []
    if "start" in snaps:
        n = snaps["start_frames"]
        ref = follow_start(step, cfg_r, mode, H, W, events, images, intr, n)
        prog = (to_ref_state(snaps["start"]) if other is None else
                follow_start(other, cfg_r, mode, H, W, events, images, intr,
                             n))
        r = compare(prog, ref, cfg_r, mode)
        r["keyframe_margin"] = 0.0      # no keyframe step before init
        out.append(("start", r))
        del ref, prog
    early = snaps.get("early", set())
    for key in sorted(k for k in snaps if k.startswith(("pre", "fpre"))):
        chunk = key.startswith("pre")
        i0, pre = snaps[key]
        post = snaps.get(key.replace("pre", "post"))
        if post is None:
            continue
        if chunk:
            prog = (to_ref_state(post) if other is None else
                    follow_chunk(other, pre, events, images, intr, i0, K,
                                 fault))
            ref = follow_chunk(step, pre, events, images, intr, i0, K,
                               _forcing(step, evictions(pre, prog)))
        else:
            prog = (to_ref_state(post) if other is None else
                    follow_frame(other, pre, events, images, intr, i0,
                                 fault))
            ref = follow_frame(step, pre, events, images, intr, i0,
                               _forcing(step, evictions(pre, prog)))
        margins = step.margins
        r = compare(prog, ref, cfg_r, mode)
        # the first decision is made from the program's own state, one
        # frame on; a chunk's later ones after the two sides have drifted
        r["keyframe_margin"] = margins[0] if margins else 0.0
        if chunk:
            r["keyframe_margin_later"] = max(margins[1:], default=0.0)
            r["early"] = int(int(key[3:]) in early)
        bad = _nonfinite(pre)
        if bad and chunk:
            r["void"] = bad
        elif bad:
            r["discrete"] += bad
        out.append((("chunk" if chunk else "frame") + key.split("pre")[1],
                    r))
        del ref, prog
    return out


@contextlib.contextmanager
def exact_f32():
    """Float32 matrix products and convolutions without TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


SUMMARY = {
    # number: (the reading it is made of, the steps whose readings
    # combine, how)
    "encoder": ("encoder", ("start", "frame", "chunk"), max),
    "features": ("features", ("start", "frame", "chunk"), max),
    "discrete": ("discrete", ("start", "frame", "chunk"), max),
    "keyframe_margin": ("keyframe_margin", ("frame", "chunk"), max),
    "keyframe_margin_later": ("keyframe_margin_later", ("chunk",), max),
    "frame_hidden": ("hidden", ("frame",), max),
    # the median over the steps followed: a random network's BA amplifies
    # rounding in some frames (in one warm-up frame in ten the median
    # edge reads twice the others) and, after the eight frames of a
    # chunk, in some chunks as far as the control's (PERF.md); a fault of
    # the program moves every step; each step's readings are printed
    "frame_reproj_p50": ("reproj_p50", ("frame",), statistics.median),
    "chunk_reproj_p50": ("reproj_p50", ("early",), statistics.median),
    "chunk_hidden": ("hidden", ("early",), statistics.median),
}


def _steps(got, kinds):
    """The readings of the steps of these kinds ("early": the early
    chunks), the void ones left out."""
    for what, r in got:
        if r.get("void"):
            continue
        if what.startswith(kinds) or ("early" in kinds and r.get("early")):
            yield r


def summary(got) -> dict:
    """{number: its readings combined as SUMMARY says}."""
    out = {}
    for name, (base, kinds, how) in SUMMARY.items():
        # a reading that is not a number counts as out of reach
        vals = [r[base] if r[base] == r[base] else 1e30
                for r in _steps(got, kinds) if base in r]
        out[name] = how(vals) if vals else 0.0
    return out


def check(ctx, cfg, sd, snaps, events, images, intr, K) -> dict:
    """The numbers that `correct` compares, the worst over what was
    followed: {name: value}; every reading is printed. With
    `ctx.control` set the control's readings are made and printed too
    (the control's runs; the benchmark's own runs do not make them)."""
    snaps["start_frames"] = ctx.traffic["check"]["start_frames"]
    args = (cfg, sd, snaps, events, images, intr, K,
            ctx.config["input_mode"], ctx.config["num_event_bins"],
            ctx.traffic["height"], ctx.traffic["width"], ctx.seed)
    with exact_f32():
        got = readings(*args)
    for what, r in got:
        print(f"check {what}: " + ", ".join(f"{k} {v:.6g}"
                                            for k, v in r.items()),
              flush=True)
    kinds = {what.rstrip("0123456789") for what, _ in got}
    if not {"start", "frame", "chunk"} <= kinds:
        raise RuntimeError(f"the check followed only {sorted(kinds)}")
    void = [what for what, r in got if r.get("void")]
    if void:
        print("check: void (a non-finite state): " + " ".join(void),
              flush=True)
    if getattr(ctx, "control", False):
        for name, kw in (("control", {"net_fn": control_net}),
                         ("fault", {"fault": inverted})):
            with exact_f32():
                got_x = readings(*args, **kw)
            for what, r in got_x:
                print(f"{name} {what}: " + ", ".join(
                    f"{k} {v:.6g}" for k, v in r.items()), flush=True)
            ctx.control_readings[name] = _early_guard(got_x, summary(got_x))
    return _early_guard(got, summary(got))


def _early_guard(got, out: dict) -> dict:
    """`out` with the first early chunk's non-finite entries added to
    `discrete` where every early chunk followed is void."""
    early = [r for _, r in got if r.get("early")]
    if early and all(r.get("void") for r in early):
        out["discrete"] += early[0]["void"]
    return out
