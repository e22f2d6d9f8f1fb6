"""Host ms a step in the program's backward: the `lemo.step.backward`
span around `torch.autograd.grad` in `fitting/adam.py:run_adam` (the
main thread waits there while the autograd engine dispatches the
backward), over an unprofiled stretch of timed calls
(`portbench.program_spans`)."""

from portbench import program_spans


def read(ctx):
    return program_spans.read(ctx, "lemo.step.backward")
