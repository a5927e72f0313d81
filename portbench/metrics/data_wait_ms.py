"""Host ms a step waits on the Trainer's batch iterator (the native
prefetcher or numpy), timed by the harness around each ``next()``; the
mean over the traced run's window on rank 0."""


def read(ctx):
    waits = ctx.window["data_wait_s"]
    return 1e3 * sum(waits) / len(waits) if waits else None
