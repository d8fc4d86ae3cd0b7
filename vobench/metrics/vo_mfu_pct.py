"""vo_mfu_pct: model FLOPs of the traced slice's frames (vobench/work.py's
counts: the encoder, and the correlation, the update and BA over each
frame's live edges) at the slice's frame rate, over 989 TFLOP/s, the
H100's dense bf16 peak (the configuration runs bf16). Moves
vo_frames_per_s."""

from vobench import work


def read(trace):
    w = trace.work
    if w.get("kind") != "vo" or not w["frames"]:
        return None
    enc = work.encoder_flops(w["mode"], w["H"], w["W"], w["bins"])
    NI = w["lattice"][0]
    flops = sum(enc + work.corr_flops(e) + work.update_flops(e, w["M"], NI)
                + work.ba_flops(e) for e in w["edges"])
    return 100.0 * flops / trace.window_s / work.PEAK["bf16"]
