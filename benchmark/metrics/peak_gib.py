"""peak_gib: ``torch.cuda.max_memory_allocated()`` over the window, GiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30
