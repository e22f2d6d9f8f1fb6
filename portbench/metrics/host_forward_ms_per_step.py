"""Host ms a step in the program's loss: the `lemo.step.forward` span
around `loss_fn` in `fitting/adam.py:run_adam`, over an unprofiled
stretch of timed calls (`portbench.program_spans`)."""

from portbench import program_spans


def read(ctx):
    return program_spans.read(ctx, "lemo.step.forward")
