"""The device's idle share of the traced mapping chunk: 1 - the union of
device operation spans over the traced window's wall, edges included."""


def read(ctx):
    tp = ctx.get("trace") or {}
    if not tp.get("window_s"):
        return None
    return 100.0 * (1.0 - tp["busy_s"] / tp["window_s"])
