"""Device ms a step of the motion priors' convolutions, forward and
data-gradient (cuDNN's kernels), matched by name in the profiled calls
and read as a step of the timed call."""

# parts of the names of the kernels cuDNN runs for a convolution
CONV_NAMES = ("conv", "fprop", "dgrad", "wgrad", "fft", "winograd",
              "cudnn", "flip_filter", "im2col")


def is_conv(name: str) -> bool:
    low = name.lower()
    return any(n in low for n in CONV_NAMES)


def conv_us(trace) -> float:
    return sum(us for name, us in trace.us_by_name().items()
               if is_conv(name))


def read(ctx):
    if conv_us(ctx.per_step.long) <= 0:
        return None
    return ctx.per_step(conv_us) / 1e3
