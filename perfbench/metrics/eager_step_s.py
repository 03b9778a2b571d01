"""eager_step_s: the first eager step of the run (lazy caches, cuDNN's lookups,
the kernel libraries loaded or built), ended on a device synchronise
(StepGraph.report["eager_s"], the program's counter); None where the report
has no such counter."""


def read(ctx):
    g = ctx.get("graph")
    return None if not g else g.get("eager_s")
