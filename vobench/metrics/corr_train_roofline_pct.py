"""corr_train_roofline_pct: K7 (the training correlation's forward) and K8
(its backward) against their roofline in the traced slice of a training
cell: the least time of every unrolled step's forward and backward
(vobench/work.py's `corr_train_work`: bytes once, or the dot products at
the float32 peak) summed, over the device time of the kernels named in
KERNELS (the wrapper's zero fills of K8's outputs are not among them).
Moves train_s_per_step."""

from vobench import work

KERNELS = ("corr_train_fwd_kernel", "corr_train_bwd_kernel")


def read(trace):
    w = trace.work
    if w.get("kind") != "train" or not w["steps"]:
        return None
    busy = trace.kernel_seconds(KERNELS)
    if busy <= 0:
        return None
    fwd, bwd = work.corr_train_work(w["E"], w["n_frames"], w["M"],
                                    w["H"] // 4, w["W"] // 4,
                                    w["dtype_bytes"])
    least = (work.least_s(*fwd, "f32") + work.least_s(*bwd, "f32")) \
        * w["unroll"] * w["steps"]
    return 100.0 * least / busy
