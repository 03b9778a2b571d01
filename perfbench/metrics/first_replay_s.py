"""first_replay_s: the first replay of the captured graph, ended on a device
synchronise (StepGraph.report["first_replay_s"], the program's counter);
None where the report has no such counter."""


def read(ctx):
    g = ctx.get("graph")
    return None if not g else g.get("first_replay_s")
