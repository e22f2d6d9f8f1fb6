"""The device's idle share of a step: 1 - (busy time a step, the union of
the profiled calls' device operations, read as a step of the timed call)
/ (the unprofiled step wall of the timed window), in %."""


def read(ctx):
    if not ctx.per_step.long.ops:
        return None
    busy_s = ctx.per_step(lambda t: t.busy_us) / 1e6
    return 100.0 * (1.0 - busy_s / ctx.wall_s_per_step)
