"""kernels_per_frame: every kernel the profiler saw in the traced slice of
a VO cell (graph replays; copies and fills are not kernels), over the
slice's frames. Moves vo_frames_per_s."""


def read(trace):
    if trace.work.get("kind") != "vo" or not trace.work["frames"]:
        return None
    return len(trace.kernels()) / trace.work["frames"]
