"""Host ms a step in the smoothness prior: the `lemo.term.smooth_prior`
span in the Stage-2 fold's loss (`fitting/amass_temp.py`), over an
unprofiled stretch of timed calls (`portbench.program_spans`): the host
side of `prior_conv_ms_per_step`."""

from portbench import program_spans


def read(ctx):
    return program_spans.read(ctx, "lemo.term.smooth_prior")
