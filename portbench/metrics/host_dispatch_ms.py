"""Host ms from a step's start to the return of the Trainer's step call
(the pinned copies and ``train_step``), with no synchronise: the mean
over the traced run's window on rank 0. Near the step interval, the host
paces the step."""


def read(ctx):
    laps = ctx.window["dispatch_s"]
    return 1e3 * sum(laps) / len(laps) if laps else None
