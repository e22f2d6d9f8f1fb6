"""The body-model kernels' share of their roofline (csrc/chain.cu,
csrc/vertex.cu): the sum over the launches of each entry point's bound
time (`work.body_kernel_work` at the launch's frames, the
larger of operations at 67 TFLOP/s and bytes at 3.35 TB/s) over the
device time of the kernels of those files, matched by name, both read as
a step of the timed call from the profiled calls, in %."""

from portbench.work import body_kernel_work, bound_s

# the kernels of csrc/vertex.cu and csrc/chain.cu, by a part of their names
NAMES = ("vertex_", "splitk_gemm_kernel", "sum_slices_kernel", "chain_")
ENTRIES = ("chain_fwd", "chain_bwd", "vertex_fwd", "vertex_bwd")


def read(ctx):
    work = body_kernel_work(*ctx.runner.body_kernel_shape())
    bound = ctx.per_step(lambda t: sum(
        t.counters.get(k, 0) * bound_s(*work[k])[0] for k in ENTRIES))
    device_s = ctx.per_step(lambda t: sum(
        us for name, us in t.us_by_name().items()
        if any(n in name for n in NAMES))) / 1e6
    if bound <= 0 or device_s <= 0:
        return None
    return 100.0 * bound / device_s
