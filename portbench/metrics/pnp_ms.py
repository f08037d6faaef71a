"""Mean over the window's queries of the Localizer's synchronised
``pnp`` stage wall (``last_stages``)."""


def read(ctx):
    st = [s["pnp"] for s in ctx.get("stages", []) if "pnp" in s]
    if not st:
        return None
    return 1e3 * sum(st) / len(st)
