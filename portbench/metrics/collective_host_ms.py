"""Host ms a step inside the counted collectives on rank 0 (under NCCL
the enqueue), over the traced run's window."""


def read(ctx):
    calls = sum(c for c, _ in ctx.window["collectives"].values())
    secs = sum(s for _, s in ctx.window["collectives"].values())
    return 1e3 * secs / ctx.window["steps"] if calls else None
