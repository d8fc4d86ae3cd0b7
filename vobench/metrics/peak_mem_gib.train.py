"""peak_mem_gib.train: the allocator's peak (torch.cuda.max_memory_allocated)
over the window of a training cell's traced run, in GiB. Moves
train_s_per_step."""


def read(trace):
    if trace.work.get("kind") != "train":
        return None
    return trace.counters["peak_bytes"] / 2 ** 30
