"""Host syncs per mapping step over the traced run's window: the card's
synchronisation warnings (torch.cuda.set_sync_debug_mode) counted around
``MappingTrainer.map``, divided by the steps."""


def read(ctx):
    if "host_syncs" not in ctx or not ctx.get("steps"):
        return None
    return ctx["host_syncs"] / ctx["steps"]
