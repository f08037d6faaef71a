"""Mean over the window's queries of the Localizer's synchronised frustum
and decode stage walls (``last_stages``)."""


def read(ctx):
    st = [s for s in ctx.get("stages", []) if "decode" in s]
    if not st:
        return None
    return 1e3 * sum(s["frustum"] + s["decode"] for s in st) / len(st)
