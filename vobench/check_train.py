"""Whether a training run is correct: the plain reference (vobench/reference)
repeats the loop's first steps from the same weights, scene and seed, in
float32 with TF32 off, and the two are compared.

The loop that the window times is the object that ran those steps: set-up
drives it through them with the window's own calls (its loader, then its
step) and keeps what the comparison needs. The reference rebuilds the
loader's windows itself (a frozen copy of the loader and augmentation,
on the same random streams) and runs the same steps with the same random
draws (the forward's generator, seeded as the loop seeds its own).

The numbers:

- loader: how many entries of the windows the program's loader gave
  differ from the reference's (an exact comparison);
- loss1: the gap of the first step's loss, over the reference's; loss:
  the largest over the steps;
- grad: the first gradient as the optimizer got it (the program's, from
  AdamW's first moment after one step; the reference's, clipped), by the
  worst parameter: the gap between the two norms of a parameter, over the
  larger of the reference's norm of it and its median parameter's;
- update: the same for the parameters' change over the steps, by the
  worst parameter; update_med: by the median parameter.

On some windows the later steps are a draw: the unrolled BA of a random
network amplifies the card's summation order, so that two runs of the
reference itself, on the same seed and windows, read a second step's loss
13% apart and a parameter's change 16% apart (PERF.md). The limits hold
loss1, grad and update_med; loss and update are printed.

Parameters whose reference gradient is below a thousandth of the median
parameter's (gradients of rounding size, such as biases ahead of a
normalization) are left out of grad and update, by that rule.

The control (`control=True`) is the reference with TF32 on, the precision
below the configuration's float32 with TF32 off.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

TINY = 1e-3


@contextlib.contextmanager
def tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def ref_scene(scene: dict) -> dict:
    """The scene for the reference's loader: the same arrays, its own
    event stream."""
    from .reference.data.tartan import MemoryEvents

    ev = scene["events"]
    return dict(scene, events=MemoryEvents(ev.x, ev.y, ev.t, ev.p,
                                           ev.height, ev.width))


def ref_batches(config, args, scene, n: int, patches: int):
    """The first n windows of the reference's loader, as the loop draws
    them (cli/train.py::TrainLoop.make_batch, batch 1)."""
    from .reference.data.tartan import MemoryDataset

    data = MemoryDataset(ref_scene(scene), config, step=0, seed=args.seed,
                         fmin=args.fmin, fmax=args.fmax)
    rng = np.random.RandomState(args.seed)
    out = []
    for _ in range(n):
        s = data[int(rng.randint(1, max(len(data), 2)))]
        out.append({k: np.stack([v]) for k, v in s.items()})
    return out


def ref_steps(config, args, sd, batches, patches, device):
    """The reference's steps on `batches`: (losses, first clipped
    gradient {name: tensor}, parameters after them {name: tensor})."""
    from .reference.lie import ops as lops
    from .reference.models.vonet import VONet
    from .reference.train.forward import TrainForward
    from .reference.train.step import Trainer, clip_by_global_norm

    cfg = config["data_loader"]["train"]["args"]
    with torch.device("meta"):
        net = VONet(cfg["input_mode"], evs_ch=cfg["num_event_bins"])
    net = net.to_empty(device=device)
    net.load_state_dict(sd)
    fwd = TrainForward(net, n_frames=cfg["n_frames"], M=patches,
                       steps=args.unroll_steps,
                       flow_weight=cfg["flow_weight"],
                       pose_weight=cfg["pose_weight"],
                       event_bias=cfg.get("event_bias", True),
                       gradient_bias=cfg.get("gradient_bias", False))
    trainer = Trainer(net, cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    names = [k for k, _ in net.named_parameters()]
    losses, grad1 = [], None
    for s, b in enumerate(batches):
        t = {k: torch.as_tensor(b[k]) for k in b}
        t = {k: v if k == "mask" else v.to(device).float()
             for k, v in t.items()}
        t["poses"] = lops.se3_inv(t["poses"])
        trainer.opt.zero_grad(set_to_none=False)
        loss, _ = fwd(t["events"][0], t["images"][0], t["poses"][0],
                      t["disps"][0], t["intrinsics"][0], t["mask"][0].cpu(),
                      structure_only=False, generator=gen)
        loss.backward()
        for p in trainer.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        losses.append(float(loss))
        # Trainer.apply, with the clipped gradient kept after step one
        clip_by_global_norm(trainer.params, trainer.clip)
        if s == 0:
            grad1 = {k: p.grad.detach().clone() for k, p in
                     zip(names, net.parameters())}
        for g in trainer.opt.param_groups:
            g["lr"] = trainer.lr(trainer.count)
        trainer.opt.step()
        trainer.count += 1
    return losses, grad1, {k: p.detach().clone()
                           for k, p in net.named_parameters()}


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """{parameter: |norm(prog) - norm(ref)| over the larger of norm(ref)
    and the median parameter's norm(ref)} over the kept parameters."""
    n_ref = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in keep}
    med = float(np.median(list(n_ref.values())))
    return {k: abs(float(torch.linalg.vector_norm(prog[k].float()))
                   - n_ref[k]) / max(n_ref[k], med) for k in keep}


def numbers(prog_losses, prog_g1, prog_p0, prog_p3, losses, g1, p3) -> dict:
    n_g = {k: float(torch.linalg.vector_norm(v)) for k, v in g1.items()}
    med = float(np.median(list(n_g.values())))
    keep = [k for k, v in n_g.items() if v >= TINY * med]
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog_losses, losses)]
    upd = leaf_gaps({k: prog_p3[k] - prog_p0[k] for k in keep},
                    {k: p3[k] - prog_p0[k] for k in keep}, keep)
    return {
        "loss1": gaps[0],
        "loss": max(gaps),
        "grad": max(leaf_gaps(prog_g1, g1, keep).values()),
        "update_med": float(np.median(list(upd.values()))),
        "update": max(upd.values()),
        "left_out": len(n_g) - len(keep),
    }


def check(ctx, config, args, scene, sd, batches, losses, kept) -> dict:
    """The numbers that `correct` compares; every reading is printed.
    With `ctx.control` the control's readings are made and printed too."""
    dev = ctx.device
    M = ctx.traffic["patches"]
    mine = ref_batches(config, args, scene, len(batches), M)
    bad = sum(int(np.sum(np.asarray(a[k]) != np.asarray(b[k])))
              for a, b in zip(batches, mine) for k in b)
    with tf32(False):
        ref = ref_steps(config, args, sd, mine, M, dev)
    out = numbers(losses, kept["grad1"], kept["params0"], kept["params3"],
                  *ref)
    out["loader"] = bad
    n_g = {k: float(torch.linalg.vector_norm(v)) for k, v in ref[1].items()}
    keep = [k for k, v in n_g.items()
            if v >= TINY * float(np.median(list(n_g.values())))]
    for what, gaps in (
            ("grad", leaf_gaps(kept["grad1"], ref[1], keep)),
            ("update", leaf_gaps(
                {k: kept["params3"][k] - kept["params0"][k] for k in keep},
                {k: ref[2][k] - kept["params0"][k] for k in keep}, keep))):
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:2]
        print(f"check {what}: worst " + ", ".join(
            f"{k} {v:.4g} (|g| {n_g[k]:.3g})" for k, v in top), flush=True)
    print("check: " + ", ".join(f"{k} {v:.6g}" for k, v in out.items())
          + "; losses program " + " ".join(f"{v:.7g}" for v in losses)
          + ", reference " + " ".join(f"{v:.7g}" for v in ref[0]),
          flush=True)
    if getattr(ctx, "control", False):
        with tf32(True):
            ctl = ref_steps(config, args, sd, mine, M, dev)
        c = numbers(ctl[0], ctl[1], kept["params0"], ctl[2], *ref)
        c["loader"] = 0
        print("control: " + ", ".join(f"{k} {v:.6g}" for k, v in c.items()),
              flush=True)
        ctx.control_readings["control"] = c
    return out
