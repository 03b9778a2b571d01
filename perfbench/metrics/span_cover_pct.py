"""span_cover_pct: the share of a profiled step's kernel time (the span
markers left out) that ran inside some span of the program; the rest is
the host's work between replays (the metrics row); perfbench/spans.py."""

from perfbench import spans


def read(ctx):
    return spans.cover_pct(ctx)
