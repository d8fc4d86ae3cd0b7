"""kernels_per_step: every kernel the profiler saw in the traced slice of a
training cell (copies and fills are not kernels), over the slice's
optimizer steps. Moves train_s_per_step."""


def read(trace):
    if trace.work.get("kind") != "train" or not trace.work["steps"]:
        return None
    return len(trace.kernels()) / trace.work["steps"]
