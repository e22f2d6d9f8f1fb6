"""The whole step's share of the f32 peak: the FLOPs of one step as the
plain reference counts them (matrix products and convolutions, forward
and backward, `portbench.flops`) over the unprofiled step wall times
67 TFLOP/s, in %."""

from portbench.peaks import F32_FLOPS_PER_S


def read(ctx):
    flops = ctx.runner.step_flops()
    if not flops:
        return None
    return 100.0 * flops / (ctx.wall_s_per_step * F32_FLOPS_PER_S)
