"""The device memory the timed window allocated at its peak, GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes > 0 else None
