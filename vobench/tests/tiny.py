"""Small sizes at which the tests drive the cells on the CPU, through the
port's plain versions: the cells' own files with their sizes cut."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMALL_VO = dict(PATCHES_PER_FRAME=8, REMOVAL_WINDOW=5, OPTIMIZATION_WINDOW=4,
                PATCH_LIFETIME=3, KEYFRAME_INDEX=2, MIXED_PRECISION=False,
                MEM=16, KEYFRAME_THRESH=15.0, MOTION_MODEL="DAMPED_LINEAR",
                MOTION_DAMPING=0.5, GRADIENT_BIAS=False, CORR_LAYOUT="fused3")
SCENE = {"pool_frames": 12, "fx": 60.0, "plane_z": 2.0, "motion": "curve",
         "event_thresh": 6.0, "bins": 5}

VO = {"config": {},
      "traffic": {"height": 64, "width": 96, "chunk": 4,
                  "vo_preset": SMALL_VO, "scene": SCENE,
                  "vo_capacity": {"MAX_FRAMES": 512, "BUFFER_SIZE": 512},
                  "warm_frames": 12, "warm_chunks": 1,
                  "check": {"chunks": 2, "window_share": 0.3,
                            "early_chunks": 2, "early_range": 2,
                            "start_frames": 5, "warm_frames": [9, 10]},
                  "trace": {"start_chunk": 1, "chunks": 1}}}


def train_overrides() -> dict:
    with open(ROOT / "vobench" / "traffic" / "train_recipe.json") as f:
        rec = json.load(f)["recipe"]
    rec = dict(rec, n_frames=8, augment_data=False, num_events_selected=2000,
               image_height=64, image_width=96)
    return {"traffic": {"height": 64, "width": 96, "recipe": rec,
                        "patches": 8, "unroll_steps": 10,
                        "scene": dict(SCENE, pool_frames=24),
                        "check": {"steps": 3}, "warm_steps": 0,
                        "trace": {"start_step": 0, "steps": 1}}}


def overrides(workload: str) -> dict:
    return train_overrides() if workload.endswith("train") else VO


def damp_flow(monkeypatch):
    """Scale the update's flow head by 0.1 in the weights the benchmark
    makes (program and reference alike): at these sizes eight frames of BA
    on a random network amplify rounding without bound otherwise (the
    port's own slice tests damp it so)."""
    from vobench.loops import train_step, vo_eval

    make = vo_eval.make_weights

    def damped(net, seed, device):
        sd = make(net, seed, device)
        sd["update.d.1.weight"] = sd["update.d.1.weight"] * 0.1
        return sd

    for mod in (vo_eval, train_step):
        monkeypatch.setattr(mod, "make_weights", damped)
