"""The backward pair walk's share of its roofline: the least time for one
view's backward walk (``peaks.bwd_walk_bound_s``, from the work the
reference counts on the traced scene's keyframe views, their mean) over
the traced mean time of a ``bwd_pairwalk_kernel`` launch."""
from portbench import peaks

KERNEL = "bwd_pairwalk_kernel"


def read(ctx):
    tp, work = ctx.get("trace") or {}, ctx.get("work")
    n = (tp.get("kernel_launches") or {}).get(KERNEL)
    if not n or not work:
        return None
    W, H = ctx["image"]
    bound = peaks.bwd_walk_bound_s(work, ctx["channels"], W, H, ctx["tile"])
    return 100.0 * bound / (tp["kernel_s"][KERNEL] / n)
