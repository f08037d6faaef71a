"""The forward pair walk's share of its roofline: the least time the card
could take for one view's walk (``peaks.fwd_walk_bound_s``, from the work
the reference counts on the traced scene's keyframe views, their mean)
over the traced mean time of a ``fwd_pairwalk_kernel`` launch."""
from portbench import peaks

KERNEL = "fwd_pairwalk_kernel"


def read(ctx):
    tp, work = ctx.get("trace") or {}, ctx.get("work")
    n = (tp.get("kernel_launches") or {}).get(KERNEL)
    if not n or not work:
        return None
    W, H = ctx["image"]
    bound = peaks.fwd_walk_bound_s(work, ctx["channels"], W, H, ctx["tile"])
    return 100.0 * bound / (tp["kernel_s"][KERNEL] / n)
