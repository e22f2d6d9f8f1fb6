"""Device operations (kernels, copies, fills) a step of the timed call,
from the profiled calls: the host's dispatch work a step."""


def read(ctx):
    if not ctx.per_step.long.ops:
        return None
    return ctx.per_step(lambda t: t.launches())
