"""Mean over the window's queries of the Localizer's synchronised
``match`` stage wall (``last_stages``)."""


def read(ctx):
    st = [s["match"] for s in ctx.get("stages", []) if "match" in s]
    if not st:
        return None
    return 1e3 * sum(st) / len(st)
