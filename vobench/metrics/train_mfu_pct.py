"""train_mfu_pct: model FLOPs of the traced slice's optimizer steps
(vobench/work.py's `train_step_flops`: three times the forward, which is
the window's encoder and, for each unrolled step, the correlation, the
update and two BA iterations over that step's valid edges) at the slice's
step rate, over 67 TFLOP/s, the H100's float32 peak outside the tensor
cores (the recipe runs float32 with TF32 off). Moves train_s_per_step."""

from vobench import work


def read(trace):
    w = trace.work
    if w.get("kind") != "train" or not w["steps"]:
        return None
    enc = work.train_window_encoder_flops(w["H"], w["W"], w["bins"],
                                          w["voxels"], w["n_frames"])
    valid = [sum(1 for c in w["created_at"] if c <= s)
             for s in range(w["unroll"])]
    flops = work.train_step_flops(enc, valid, w["M"], w["n_frames"])
    return 100.0 * flops * w["steps"] / trace.window_s / work.PEAK["f32"]
