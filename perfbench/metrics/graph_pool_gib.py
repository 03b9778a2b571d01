"""graph_pool_gib: the bytes the captured CUDA graph's private pool holds
(StepGraph.report["pool_bytes"], the program's counter), in GiB."""


def read(ctx):
    g = ctx.get("graph")
    if not g or g.get("pool_bytes") is None:
        return None
    return g["pool_bytes"] / 2 ** 30
