"""encoder_lstm_roofline_pct: the encoder's recurrent fold against its
roofline in the traced slice of a VO cell, K2 (MultiScale) or K3
(SingleScale) by the input mode: the least time of each traced frame's
fold (vobench/work.py: the larger of its bytes, its products at the
type's peak and its transcendental functions at the SFU rate) summed,
over the device time of the mode's kernels in KERNELS. Moves
vo_frames_per_s."""

from vobench import work

KERNELS = {"MultiScale": ("lstm_fold_mma_kernel", "lstm_fold_f32_kernel"),
           "SingleScale": ("lstm_carry_fold_mma_kernel",
                           "lstm_carry_fold_f32_kernel")}


def read(trace):
    w = trace.work
    if w.get("kind") != "vo" or not w["frames"]:
        return None
    busy = trace.kernel_seconds(KERNELS[w["mode"]])
    if busy <= 0:
        return None
    es = w["dtype_bytes"]
    fn = (work.lstm_fold_work if w["mode"] == "MultiScale"
          else work.lstm_carry_fold_work)
    nbytes, flops, sfu = fn(w["H"], w["W"], w["bins"] + 3, es)
    least = work.least_s(nbytes, flops, "bf16" if es == 2 else "f32", sfu)
    return 100.0 * least * w["frames"] / busy
