"""corr_roofline_pct: K1 (the fused3 lattice correlation) against its
roofline in the traced slice of a VO cell: the least time of each traced
frame's correlation (vobench/work.py: bytes once for the lattice's output
and the live edges' inputs, or its dot products at the bf16 peak) summed,
over the device time of the kernels named in KERNELS. Moves
vo_frames_per_s."""

from vobench import work

KERNELS = ("lattice_kernel",)     # csrc/corr_window.cuh, K1's launch


def read(trace):
    w = trace.work
    if w.get("kind") != "vo":
        return None
    busy = trace.kernel_seconds(KERNELS)
    if busy <= 0:
        return None
    NI, T, M = w["lattice"]
    es = w["dtype_bytes"]
    least = sum(work.least_s(
        work.corr_lattice_bytes(NI * T, M, e, ts, hs, w["H"] // 4,
                                w["W"] // 4, es),
        work.corr_flops(e), "bf16" if es == 2 else "f32")
        for e, ts, hs in zip(w["edges"], w["target_slots"],
                             w["host_slots"]))
    return 100.0 * least / busy
