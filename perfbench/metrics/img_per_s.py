"""img_per_s: every image the window trained over the window's seconds,
the window opened and closed on a device synchronise (host clock)."""


def read(ctx):
    return ctx["steps"] * ctx["batch"] / ctx["window_s"]
