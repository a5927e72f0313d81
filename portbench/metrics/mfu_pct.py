"""The whole step's share of the card's dense bf16 peak: the traced run's
window samples/s a chip times the configuration's training FLOPs a
sample, over the peak. It bounds a kernel's gain even once a later
change takes that kernel off the path."""


def read(ctx):
    if ctx.peaks is None or not ctx.flops_per_sample:
        return None
    rate = ctx.window["samples_per_sec_per_chip"]
    return 100.0 * rate * ctx.flops_per_sample / ctx.peaks["bf16"]
