"""All-reduces a step on rank 0 (``parallel/dist.py``'s counted
``all_reduce``: the batch-norm statistics, the fused-IR column sums, the
gradients' flat buffers), over the traced run's window."""


def read(ctx):
    calls, _ = ctx.window["collectives"].get("all_reduce", (0, 0.0))
    return calls / ctx.window["steps"] if calls else None
