"""Device ms a step in the forward (the ``tpunet_fwd_bwd`` range outside
the autograd engine's backward) over the traced steps, rank 0."""


def read(ctx):
    us = ctx.traced["host_summary"]["phase_us"].get("fwd")
    return us / 1e3 / ctx.traced["steps"] if us else None
