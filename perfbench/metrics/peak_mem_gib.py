"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and the
window (the CUDA graph's private pool included), in GiB: it decides the
batch one card can take."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx["peak_bytes"] else None
