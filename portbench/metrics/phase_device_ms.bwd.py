"""Device ms a step in the backward (launched by the autograd engine)
over the traced steps, rank 0."""


def read(ctx):
    us = ctx.traced["host_summary"]["phase_us"].get("bwd")
    return us / 1e3 / ctx.traced["steps"] if us else None
