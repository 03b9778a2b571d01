"""capture_s: the seconds the train step's CUDA graph capture took
(StepGraph.report["capture_s"], the program's counter)."""


def read(ctx):
    g = ctx.get("graph")
    return None if not g else g.get("capture_s")
