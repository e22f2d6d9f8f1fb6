"""One step of a fit captured once as a CUDA graph and replayed.

The host's dispatch of an Adam step of the Stage-2 clip fold (the loss,
`torch.autograd.grad` and the update: ~2,400 kernel launches) takes
longer than the card's work. `StepGraphs`, a fitter's cache that it
hands to `fitting.adam.run_adam(graph=...)`, captures the step once per
shape as a `torch.cuda.CUDAGraph` and runs each later step as a replay:
the same kernels in the same order, launched as one graph.

A captured step (`_Step`) reads and writes static buffers that it owns:
the parameters (the autograd leaves), Adam's moments, the freeze flag,
the loss history and the `StepTable` of the per-step scalars with its
step index. The loss closure reads the fit's inputs from static buffers
that `StepGraphs.bind` owns and fills before each fit. A fit copies its
start into the buffers, zeroes the moments, the flag and the index, runs
its steps, and returns clones: no output aliases a buffer that the next
fit overwrites.

The first fit at a shape runs its first `WARMUP_STEPS` steps eagerly
(`adam.take_step`, on a side stream, as a capture wants), captures the
step after them and replays it for the rest; later fits replay every
step. So every step of every fit is a step of the fit, and the launch
counters (`launch_counters`) count launches that ran: the eager steps
bump them through the kernels' wrappers, a replay skips the wrappers
and adds each counter's change over the capture, and the capture's own
change is undone, since a capture launches nothing.

A step is replayed only while what it captured is what the fit is
handed: the loss closure and the update (`type(spec).step`) by
identity, the other arguments by identity or value, and the dispatch
state that picks the kernels (`dispatch_state`). Otherwise it is
captured again.
"""

from __future__ import annotations

import torch

from lemo_tpu_torch.fitting.adam import AdamSpec, StepTable, take_step
from lemo_tpu_torch.utils import routing
from lemo_tpu_torch.utils.profiling import annotate

# eager steps of a fit before its capture (cuBLAS and cuDNN handles,
# autograd's device thread, the allocator's blocks)
WARMUP_STEPS = 3


def launch_counters() -> list[dict]:
    """The program's launch counters, bumped by the kernels' wrappers."""
    from lemo_tpu_torch.body_model import chain_cuda, vertex_cuda
    from lemo_tpu_torch.ops import chamfer_cuda, intersection_cuda

    return [chain_cuda.launches, vertex_cuda.launches,
            vertex_cuda.stage_launches, chamfer_cuda.launches,
            intersection_cuda.launches]


def counts(counters: list[dict]) -> list[dict]:
    return [dict(c) for c in counters]


def changes(counters: list[dict], before: list[dict]) -> list[dict]:
    """Each counter's change since `before` (a `counts`)."""
    return [{k: n - b.get(k, 0) for k, n in c.items() if n != b.get(k, 0)}
            for c, b in zip(counters, before)]


def add(counters: list[dict], deltas: list[dict], times: int = 1) -> None:
    for c, d in zip(counters, deltas):
        for k, n in d.items():
            c[k] = c.get(k, 0) + times * n


def capture_counts(counters: list[dict], capture) -> list[dict]:
    """Run `capture()`, leave the counters as they were before it (a
    capture launches nothing), and return their changes over it: one
    step's launches, which each replay adds."""
    before = counts(counters)
    capture()
    deltas = changes(counters, before)
    add(counters, deltas, -1)
    return deltas


def dispatch_state() -> tuple:
    """What picks the step's kernels besides its code: the deterministic
    and TF32 switches, and the kernels' routing (`utils.routing`: the
    card's checks route them to their plain twins)."""
    return (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            routing.version())


class CudaGraph:
    """A step body run eagerly on a side stream until it is captured as
    a CUDA graph, then replayed."""

    @staticmethod
    def engages(device: torch.device) -> bool:
        return device.type == "cuda"

    def __init__(self):
        self.graph = None
        self.side = torch.cuda.Stream()

    def eager(self, body) -> None:
        self.side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.side):
            body()
        torch.cuda.current_stream().wait_stream(self.side)

    def capture(self, body, counters: list[dict]) -> None:
        self.graph = torch.cuda.CUDAGraph()

        def run():
            with torch.cuda.graph(self.graph):
                body()
        self.deltas = capture_counts(counters, run)

    def replay(self, counters: list[dict]) -> None:
        self.graph.replay()
        add(counters, self.deltas)


class EagerStep:
    """The step body run eagerly at each replay too, on any device: the
    CPU's stand-in for `CudaGraph` in tests of the buffers, the tables
    and the cache. Its capture runs nothing, as a CUDA graph's."""

    @staticmethod
    def engages(device: torch.device) -> bool:
        return True

    def __init__(self):
        self.graph = None

    def eager(self, body) -> None:
        body()

    def capture(self, body, counters: list[dict]) -> None:
        self.graph = body

    def replay(self, counters: list[dict]) -> None:
        self.graph()


class _Step:
    """One step of a fit at one shape over static buffers, run eagerly
    for the first fit's first `WARMUP_STEPS` steps, then captured and
    replayed (`replayer`)."""

    def __init__(self, fns, values, init_params, num_steps, per_clip,
                 replayer):
        self.fns, self.values = fns, values
        spec, lrs, _ = values
        self.spec, self.per_clip = spec, per_clip
        self.keys = list(init_params)
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in init_params.items()}
        self.state = spec.init(self.params)
        self.mu, self.nu = dict(self.state.mu), dict(self.state.nu)
        first = self.params[self.keys[0]]
        dev = first.device
        shape = (first.shape[0],) if per_clip else ()
        self.dead = torch.zeros(shape, dtype=torch.bool, device=dev)
        self.losses = torch.empty((num_steps,) + shape, dtype=torch.float32,
                                  device=dev)
        self.table = StepTable(lrs, spec.b1, spec.b2, dev)
        self.replayer = replayer()
        self.warm = 0         # eager steps run before the capture

    def same(self, fns, values) -> bool:
        return all(a is b for a, b in zip(fns, self.fns)) and \
            values == self.values

    def body(self) -> None:
        """One step on the buffers (`take_step`), written back into them,
        and the step index advanced."""
        loss_fn, _, grad_mask, reduce_dead = self.fns
        keys = self.keys
        new, watched, _, dead = take_step(
            loss_fn, self.params, self.state, self.spec, self.table,
            self.dead, grad_mask=grad_mask, reduce_dead=reduce_dead,
            per_clip=self.per_clip)
        self.table.record(self.losses, watched)
        with torch.no_grad():
            torch._foreach_copy_(
                [self.params[k] for k in keys] + [self.mu[k] for k in keys]
                + [self.nu[k] for k in keys],
                [new[k] for k in keys] + [self.state.mu[k] for k in keys]
                + [self.state.nu[k] for k in keys])
            self.dead.copy_(dead)
        self.state.mu, self.state.nu = dict(self.mu), dict(self.nu)
        self.table.advance()

    def run(self, init_params, num_steps: int):
        """A fit of `num_steps` from `init_params`: (the final parameters,
        the losses [num_steps] or [C, num_steps]), clones."""
        with torch.no_grad():
            for k in self.keys:
                self.params[k].copy_(init_params[k])
            for buf in list(self.mu.values()) + list(self.nu.values()):
                buf.zero_()
            self.dead.zero_()
            self.table.at.zero_()
        counters = launch_counters()
        eager = 0 if self.replayer.graph is not None else \
            min(num_steps, WARMUP_STEPS - self.warm)
        with annotate("fit", steps=num_steps, replayed=num_steps - eager):
            for i in range(num_steps):
                if i < eager:
                    self.replayer.eager(self.body)
                    self.warm += 1
                    continue
                if self.replayer.graph is None:
                    self.replayer.capture(self.body, counters)
                with annotate("step.replay"):
                    self.replayer.replay(counters)
        final = {k: v.detach().clone() for k, v in self.params.items()}
        losses = self.losses.clone()
        return final, (losses.T if self.per_clip else losses)


class StepGraphs:
    """A fitter's captured steps, one a shape of its parameters (a new
    shape, such as a last smaller batch, captures its own), for
    `run_adam(graph=...)`, and the static buffers of its inputs
    (`bind`). `replayer` is `CudaGraph`; the tests set `EagerStep`, which
    runs the same buffers and tables eagerly."""

    replayer = CudaGraph

    def __init__(self):
        self.steps: dict = {}
        self.inputs: dict = {}

    def engages(self, device: torch.device, spec) -> bool:
        return isinstance(spec, AdamSpec) and self.replayer.engages(device)

    def bind(self, make_loss, *inputs: torch.Tensor):
        """The loss closure `make_loss(*inputs)` for `run_adam`. Where a
        capture engages (the inputs' device) it is built once a shape of
        the inputs over static buffers, which are filled with `inputs`
        now: a captured step reads each fit's inputs there, and
        `run_adam` is handed the closure it captured."""
        if not self.replayer.engages(inputs[0].device):
            return make_loss(*inputs)
        key = tuple((tuple(x.shape), x.dtype) for x in inputs)
        if key not in self.inputs:
            bufs = tuple(torch.empty_like(x) for x in inputs)
            self.inputs[key] = bufs, make_loss(*bufs)
        bufs, loss = self.inputs[key]
        for buf, x in zip(bufs, inputs):
            buf.copy_(x)
        return loss

    def fit(self, loss_fn, init_params, num_steps, lr_table, *,
            grad_mask=None, per_clip=False, spec=AdamSpec(),
            reduce_dead=None):
        """`run_adam`'s fit on the step captured for these arguments
        (made now where there is none)."""
        key = (tuple((k, tuple(v.shape), v.dtype)
                     for k, v in init_params.items()), num_steps, per_clip)
        fns = (loss_fn, type(spec).step, grad_mask, reduce_dead)
        values = (spec, tuple(lr_table[:num_steps]), dispatch_state())
        step = self.steps.get(key)
        if step is None or not step.same(fns, values):
            self.steps.pop(key, None)        # its graph's pool goes first
            step = _Step(fns, values, init_params, num_steps, per_clip,
                         self.replayer)
            self.steps[key] = step
        return step.run(init_params, num_steps)
