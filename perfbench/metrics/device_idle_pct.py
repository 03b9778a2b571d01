"""device_idle_pct: the share of the traced window in which no kernel,
memcpy or memset ran on the device (the union of their intervals, so
overlapping kernels count once; never above 100)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s
