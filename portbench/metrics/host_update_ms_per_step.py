"""Host ms a step in the program's update: the `lemo.step.update` span
around the gradient mask, the freeze flag and the optimizer's step in
`fitting/adam.py:run_adam`, over an unprofiled stretch of timed calls
(`portbench.program_spans`)."""

from portbench import program_spans


def read(ctx):
    return program_spans.read(ctx, "lemo.step.update")
