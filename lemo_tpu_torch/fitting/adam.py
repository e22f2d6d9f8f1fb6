"""The fitting engine: Adam over a dict of tensors (port of
`lemo_tpu/fitting/adam.py`), and beside it the rest of the gradient
family that `lemo_tpu/fitting/lbfgs.py:create_optimizer` serves, SGD and
RMSprop, with optax's updates.

`lemo_tpu` runs the whole fit as one `lax.scan`; here it is a Python
loop of eager steps with no host synchronisation inside it: the
learning rate and bias corrections are host floats, the NaN/Inf freeze
is a device-side `torch.where`, and the per-step losses are written into
a device tensor. With `per_clip`, C independent problems share the loop
(the clip-folded Stage 2, `lemo_tpu/fitting/amass_temp.py:271-305`):
each has its own freeze, all share the step count.

`run_adam(spec=...)` runs the same loop with another member of the
family (`AdamSpec`, the default, `SgdSpec`, `RmspropSpec`); a spec holds
the update's constants, and `run_adam`'s `lr_table` each step's
learning rate.

`run_adam` opens the spans (`utils.profiling.annotate`) `lemo.fit` around
the loop (count: steps; a replayed fit adds `replayed`, its steps run
as replays of a captured step, and an eager fit, whose count is 0, leaves
it out) and, each step, `lemo.step.forward` (the loss),
`lemo.step.backward` (`torch.autograd.grad`, during which the main thread
waits on the autograd engine's dispatch of the backward) and
`lemo.step.update` (the gradient mask, the freeze flag and the update).

With `graph` (a `fitting.step_graph.StepGraphs`, which the clip fold
passes) on a CUDA device, the fit's first steps run eagerly, then the
step is captured as a CUDA graph and each further step is a replay of it
(`lemo.step.replay`): the learning rate and the bias corrections are
then read on the device from a `StepTable`. An eager step and a captured
one are the same `take_step`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from lemo_tpu_torch.utils.profiling import annotate


def piecewise_lr(boundaries_values: list[tuple[int, float]],
                 num_steps: int) -> list[float]:
    """Per-step learning rates from [(start_step, lr), ...] segments."""
    lrs = [0.0] * num_steps
    for start, lr in boundaries_values:
        for i in range(max(start, 0), num_steps):
            lrs[i] = lr
    return lrs


class AdamState:
    """Adam's first and second moments, one tensor a parameter, and the
    step count, carried from one `adam_step` to the next (optax's
    `ScaleByAdamState`)."""

    def __init__(self, params: dict[str, torch.Tensor]):
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0


def bias_corrections(count: int, b1: float, b2: float) -> tuple[float,
                                                                  float]:
    """Adam's bias corrections 1 - b**t at step `count` in f32, as optax
    computes them (1 - 0.999**t differs from its f64 value by ~1e-5
    relative at t=1), as host floats."""
    t = np.float32(count)
    return (float(np.float32(1) - np.float32(b1) ** t),
            float(np.float32(1) - np.float32(b2) ** t))


class StepTable:
    """A fit's per-step scalars on the device, for a step that is
    captured once and replayed: row i of `table` [n, 3] holds step i's
    -lr and the reciprocals of Adam's bias corrections (b1, b2), and
    `at` [1] the index of the step being taken, which the step itself
    advances.

    The reciprocals are what ATen's CUDA kernels multiply by when a
    tensor is divided by a host scalar (`BinaryDivTrueKernel.cu`: a * (1
    / b), the reciprocal in f32), so that `m * (1 / bc)` here is `m / bc`
    of the eager step bit for bit on the card."""

    def __init__(self, lr_table, b1: float, b2: float, device):
        rows = []
        for i, lr in enumerate(lr_table):
            bc1, bc2 = bias_corrections(i + 1, b1, b2)
            rows.append((np.float32(-lr), np.float32(1) / np.float32(bc1),
                         np.float32(1) / np.float32(bc2)))
        self.betas = (b1, b2)
        self.table = torch.tensor(np.array(rows, np.float32).reshape(-1, 3),
                                  device=device)
        self.at = torch.zeros(1, dtype=torch.long, device=device)

    def scalars(self, b1: float, b2: float):
        """(-lr, 1 / bc1, 1 / bc2) of the step at `at`, 0-dim device
        tensors (one gather, the rest views)."""
        if (b1, b2) != self.betas:
            raise ValueError(f"StepTable of betas {self.betas}, step of "
                             f"{(b1, b2)}")
        row = self.table.index_select(0, self.at)[0]
        return row[0], row[1], row[2]

    def record(self, history: torch.Tensor, value: torch.Tensor) -> None:
        """history[at] = value."""
        history.index_copy_(0, self.at, value[None])

    def advance(self) -> None:
        self.at.add_(1)


def adam_step(params: dict[str, torch.Tensor],
              grads: dict[str, torch.Tensor], state: AdamState,
              lr: float | StepTable,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              dead: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """One Adam update (optax's: bias-corrected moments, `p - lr * m_hat /
    (sqrt(v_hat) + eps)`). Returns the new parameters (detached) and
    advances `state`. With `dead`, a bool tensor of the parameters'
    leading shape (a scalar, or [C] for C folded problems), the entries
    where it is set keep their parameters and moments. `lr` is a host
    float, or in a captured step a `StepTable`, which gives the learning
    rate and the bias corrections on the device."""
    state.count += 1
    if isinstance(lr, StepTable):
        neg_lr, inv1, inv2 = lr.scalars(b1, b2)

        def corrected(m, v):
            return m * inv1, v * inv2
    else:
        neg_lr = -lr
        bc1, bc2 = bias_corrections(state.count, b1, b2)

        def corrected(m, v):
            return m / bc1, v / bc2
    out = {}
    with torch.no_grad():
        for k, g in grads.items():
            p = params[k].detach()
            m = (1.0 - b1) * g + b1 * state.mu[k]
            v = (1.0 - b2) * (g * g) + b2 * state.nu[k]
            m_hat, v_hat = corrected(m, v)
            upd = m_hat / (torch.sqrt(v_hat) + eps)
            if dead is None:
                out[k], state.mu[k], state.nu[k] = p + neg_lr * upd, m, v
                continue
            frozen = dead.reshape(dead.shape + (1,) * (p.dim() - dead.dim()))
            out[k] = torch.where(frozen, p, p + neg_lr * upd)
            state.mu[k] = torch.where(frozen, state.mu[k], m)
            state.nu[k] = torch.where(frozen, state.nu[k], v)
    return out


def _frozen(dead: torch.Tensor | None, p: torch.Tensor):
    """`dead` broadcast over a parameter's trailing axes (None: nothing
    frozen)."""
    if dead is None:
        return None
    return dead.reshape(dead.shape + (1,) * (p.dim() - dead.dim()))


def _keep(frozen, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    return new if frozen is None else torch.where(frozen, old, new)


class TraceState:
    """optax's `TraceState`: the momentum trace, one tensor a parameter."""

    def __init__(self, params: dict[str, torch.Tensor]):
        self.trace = {k: torch.zeros_like(v) for k, v in params.items()}


class RmsState(TraceState):
    """optax's `ScaleByRmsState` (nu, from zeros: `initial_scale` 0) and
    the trace that `optax.rmsprop` chains after it."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__(params)
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}


def sgd_step(params, grads, state: TraceState, lr: float,
             momentum: float = 0.9, nesterov: bool = True,
             dead: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """One step of `optax.sgd(lr, momentum, nesterov)`: the trace
    t = g + momentum * t, the update g + momentum * t with Nesterov (t
    without), scaled by -lr and added. `dead` as in `adam_step`."""
    out = {}
    with torch.no_grad():
        for k, g in grads.items():
            p = params[k].detach()
            t = g + momentum * state.trace[k]
            upd = g + momentum * t if nesterov else t
            frozen = _frozen(dead, p)
            out[k] = _keep(frozen, p, p + (-lr) * upd)
            state.trace[k] = _keep(frozen, state.trace[k], t)
    return out


def rmsprop_step(params, grads, state: RmsState, lr: float,
                 decay: float = 0.99, eps: float = 1e-8,
                 momentum: float = 0.0,
                 dead: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """One step of `optax.rmsprop(lr, decay, eps, momentum=momentum)`:
    nu = (1 - decay) * g**2 + decay * nu, the update g * rsqrt(nu + eps)
    (eps inside the root), scaled by -lr, then the trace of decay
    `momentum` that optax chains after it (at 0.0 it adds 0 * t, which
    is the identity on finite values; kept so that a non-finite trace
    acts as in lemo_tpu). `dead` as in `adam_step`."""
    out = {}
    with torch.no_grad():
        for k, g in grads.items():
            p = params[k].detach()
            nu = (1.0 - decay) * (g * g) + decay * state.nu[k]
            upd = (-lr) * (torch.rsqrt(nu + eps) * g)
            t = upd + momentum * state.trace[k]
            frozen = _frozen(dead, p)
            out[k] = _keep(frozen, p, p + t)
            state.nu[k] = _keep(frozen, state.nu[k], nu)
            state.trace[k] = _keep(frozen, state.trace[k], t)
    return out


@dataclasses.dataclass(frozen=True)
class AdamSpec:
    """`optax.adam`'s update (b1, b2, eps) for `run_adam(spec=...)`; the
    learning rate is `run_adam`'s `lr_table`."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params):
        return AdamState(params)

    def step(self, params, grads, state, lr, dead=None):
        return adam_step(params, grads, state, lr, self.b1, self.b2,
                         self.eps, dead=dead)


@dataclasses.dataclass(frozen=True)
class SgdSpec:
    """`optax.sgd`'s update (momentum, nesterov) for
    `run_adam(spec=...)`."""

    momentum: float = 0.9
    nesterov: bool = True

    def init(self, params):
        return TraceState(params)

    def step(self, params, grads, state, lr, dead=None):
        return sgd_step(params, grads, state, lr, self.momentum,
                        self.nesterov, dead=dead)


@dataclasses.dataclass(frozen=True)
class RmspropSpec:
    """`optax.rmsprop`'s update (decay, eps, momentum) for
    `run_adam(spec=...)`."""

    decay: float = 0.99
    eps: float = 1e-8
    momentum: float = 0.0

    def init(self, params):
        return RmsState(params)

    def step(self, params, grads, state, lr, dead=None):
        return rmsprop_step(params, grads, state, lr, self.decay, self.eps,
                            self.momentum, dead=dead)


def take_step(loss_fn, params: dict[str, torch.Tensor], state, spec,
              lr: float | StepTable, dead: torch.Tensor, *,
              grad_mask=None, reduce_dead=None, per_clip: bool = False,
              has_aux: bool = False):
    """One step of `run_adam`'s fit, eager or captured (`lr` a host float,
    or the `StepTable` of a captured step): the loss (`lemo.step.forward`),
    its gradient (`lemo.step.backward`), then the gradient mask, the
    freeze flag and the update of `spec` (`lemo.step.update`). Returns
    (the new parameters, the watched loss (detached; [C] with
    `per_clip`), the aux dict (`has_aux`, else None), the freeze flag)."""
    keys = list(params)
    aux = None
    with annotate("step.forward"):
        leaves = [params[k].requires_grad_(True) for k in keys]
        loss = loss_fn(params)
        if per_clip:
            loss, watched = loss
        elif has_aux:
            loss, aux = loss
        if not per_clip:
            watched = loss
    with annotate("step.backward"):
        grads = dict(zip(keys, torch.autograd.grad(loss, leaves)))
    with annotate("step.update"):
        if grad_mask is not None:
            grads = {k: grad_mask(k, g) for k, g in grads.items()}
        watched = watched.detach()
        dead = dead | ~torch.isfinite(watched)
        if reduce_dead is not None:
            dead = reduce_dead(dead)
        params = spec.step(params, grads, state, lr, dead=dead)
    return params, watched, aux, dead


def run_adam(loss_fn: Callable[[dict], torch.Tensor],
             init_params: dict[str, torch.Tensor],
             num_steps: int,
             lr_table: list[float],
             grad_mask: Callable[[str, torch.Tensor], torch.Tensor]
             | None = None,
             has_aux: bool = False, per_clip: bool = False,
             spec: AdamSpec | SgdSpec | RmspropSpec = AdamSpec(),
             reduce_dead: Callable[[torch.Tensor], torch.Tensor]
             | None = None, graph=None):
    """`num_steps` of the update `spec` at the learning rates of
    `lr_table` on a dict of tensors: by default Adam (optax's update:
    bias-corrected moments, `m_hat / (sqrt(v_hat) + eps)`), or another
    member of `fitting.lbfgs.create_optimizer`'s gradient family.

    Returns (final params, per-step losses [num_steps]). A NaN/Inf loss
    freezes the parameters and moments from that step on (the
    reference's early stop), decided on the device.

    `grad_mask(name, grad) -> grad` transforms each gradient before the
    update (the sliding window's overlap freeze). With `has_aux`,
    `loss_fn` returns (loss, {name: scalar tensor}) and a third value is
    returned: {name: [num_steps] tensor}, the per-step history, kept on
    the device until the caller reads it.

    With `per_clip`, `loss_fn` returns (loss, per-clip losses [C]), every
    parameter has the clip axis C first, and the losses returned are
    [C, num_steps]. A clip whose loss is NaN/Inf freezes its own
    parameters and moments (a [C] mask); the others go on, and all share
    the step count, hence the bias corrections.

    `reduce_dead(flag) -> flag` combines the freeze flag with the other
    shards' of one fit each step, before the update (a sharded fit whose
    loss is a sum over ranks: `parallel.sharding.frame_sharded_fit`
    passes an OR over its ranks, so that a NaN/Inf on any rank freezes
    every rank at that step, as the unsharded fit freezes).

    `graph`, a `fitting.step_graph.StepGraphs` (the caller's cache of
    captured steps), runs the fit on a captured step where it engages (a
    CUDA device, `AdamSpec`'s update): the first fit's first steps eager,
    the rest replays of the same `take_step`, the same kernels in the
    same order, so the same bits. The captured step is reused while
    `loss_fn`, the update (`type(spec).step`) and the other arguments are
    the ones it captured, and captured again otherwise.
    """
    if per_clip and has_aux:
        raise ValueError("run_adam: per_clip and has_aux exclude each other")
    if graph is not None and not has_aux and num_steps > 0 and \
            graph.engages(next(iter(init_params.values())).device, spec):
        return graph.fit(loss_fn, init_params, num_steps, lr_table,
                         grad_mask=grad_mask, per_clip=per_clip, spec=spec,
                         reduce_dead=reduce_dead)
    params = {k: v.detach().clone() for k, v in init_params.items()}
    state = spec.init(params)
    dev = next(iter(params.values())).device
    n_clips = next(iter(params.values())).shape[0] if per_clip else None
    shape = () if n_clips is None else (n_clips,)
    dead = torch.zeros(shape, dtype=torch.bool, device=dev)
    losses = torch.empty((num_steps,) + shape, dtype=torch.float32,
                         device=dev)
    aux_keys, aux_rows = None, []
    with annotate("fit", steps=num_steps):
        for i in range(num_steps):
            params, watched, aux, dead = take_step(
                loss_fn, params, state, spec, lr_table[i], dead,
                grad_mask=grad_mask, reduce_dead=reduce_dead,
                per_clip=per_clip, has_aux=has_aux)
            losses[i] = watched
            if has_aux:
                if aux_keys is None:
                    aux_keys = list(aux)
                aux_rows.append(torch.stack([
                    torch.as_tensor(aux[k], dtype=torch.float32,
                                    device=dev).detach().reshape(())
                    for k in aux_keys]))
    final = {k: v.detach() for k, v in params.items()}
    if per_clip:
        return final, losses.T
    if not has_aux:
        return final, losses
    hist = torch.stack(aux_rows) if aux_rows else None
    return final, losses, {k: hist[:, j] for j, k in enumerate(aux_keys or [])}


def _flatten(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def adam_init(params: dict) -> AdamState:
    """The Adam state of a (nested) parameter dict, for `adam_minimize`."""
    return AdamState(dict(_flatten(params)))


def adam_minimize(loss_fn: Callable, params: dict, state: AdamState,
                  lr: float, *args):
    """One Adam step on `loss_fn(params, *args) -> (loss, {name: scalar})`
    over a (nested) dict of tensors, the trainers' step (optax's
    `value_and_grad` then `update`). Returns (new params, metrics with
    'total', the loss), the metrics still on the device."""
    flat = {k: v.detach().requires_grad_(True)
            for k, v in _flatten(params)}
    loss, metrics = loss_fn(_unflatten(flat), *args)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    new = adam_step(flat, grads, state, lr)
    return _unflatten(new), {**{k: v.detach() for k, v in metrics.items()},
                             "total": loss.detach()}
