"""device_idle_pct.eval: the share of the traced slice of a VO cell (a
fixed number of graph chunks, their hand-overs and pose read-outs) in
which no device activity runs, from the union of the profiler's device
intervals. Moves vo_frames_per_s."""


def read(trace):
    if trace.work.get("kind") != "vo":
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
