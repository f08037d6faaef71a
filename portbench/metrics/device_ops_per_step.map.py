"""Device operations (kernels, copies, fills) per mapping step in the
traced chunk of steps."""


def read(ctx):
    tp = ctx.get("trace") or {}
    if not tp.get("n_device_ops") or not ctx.get("traced_steps"):
        return None
    return tp["n_device_ops"] / ctx["traced_steps"]
