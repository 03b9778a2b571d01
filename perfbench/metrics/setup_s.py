"""setup_s: seconds from the process's start to the first timed step:
imports, the kernels' builds (first run in a checkout only), weights and
corpus, the first eager step, the graph's capture and the warm steps."""


def read(ctx):
    return ctx["setup_s"]
