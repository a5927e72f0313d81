"""Share of the traced steps' wall time in which the card runs no
kernel, copy or fill (the union of the profiler's device events), the
mean over the cell's cards."""


def read(ctx):
    ranks = ctx.traced["ranks"]
    idle = [1.0 - r["busy_us"] * 1e-6 / r["seconds"] for r in ranks
            if r["seconds"] > 0]
    return 100.0 * sum(idle) / len(idle) if idle else None
