"""device_idle_pct.train: the share of the traced slice of a training cell
(a fixed number of optimizer steps, loader calls included) in which no
device activity runs, from the union of the profiler's device intervals.
Moves train_s_per_step."""


def read(trace):
    if trace.work.get("kind") != "train":
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
