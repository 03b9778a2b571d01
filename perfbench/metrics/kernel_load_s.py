"""kernel_load_s: the seconds cmx_torch.ops._build spent building and loading
the port's kernel libraries during the first eager step
(StepGraph.report["kernel_load_s"], the program's counter); None where the
report has no such counter."""


def read(ctx):
    g = ctx.get("graph")
    return None if not g else g.get("kernel_load_s")
