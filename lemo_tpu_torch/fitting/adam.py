"""The fitting engine: Adam over a dict of tensors (port of
`lemo_tpu/fitting/adam.py`).

`lemo_tpu` runs the whole fit as one `lax.scan`; here it is a Python
loop of eager steps with no host synchronisation inside it: the
learning rate and bias corrections are host floats, the NaN/Inf freeze
is a device-side `torch.where`, and the per-step losses are written into
a device tensor. With `per_clip`, C independent problems share the loop
(the clip-folded Stage 2, `lemo_tpu/fitting/amass_temp.py:271-305`):
each has its own freeze, all share the step count.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


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


def adam_step(params: dict[str, torch.Tensor],
              grads: dict[str, torch.Tensor], state: AdamState, lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
              dead: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """One Adam update (optax's: bias-corrected moments, `p - lr * m_hat /
    (sqrt(v_hat) + eps)`). Returns the new parameters (detached) and
    advances `state`. With `dead`, a bool tensor of the parameters'
    leading shape (a scalar, or [C] for C folded problems), the entries
    where it is set keep their parameters and moments."""
    state.count += 1
    # bias corrections in f32, as optax computes them (1 - 0.999**t
    # differs from its f64 value by ~1e-5 relative at t=1)
    t = np.float32(state.count)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    out = {}
    with torch.no_grad():
        for k, g in grads.items():
            p = params[k].detach()
            m = (1.0 - b1) * g + b1 * state.mu[k]
            v = (1.0 - b2) * (g * g) + b2 * state.nu[k]
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if dead is None:
                out[k], state.mu[k], state.nu[k] = p + (-lr) * upd, m, v
                continue
            frozen = dead.reshape(dead.shape + (1,) * (p.dim() - dead.dim()))
            out[k] = torch.where(frozen, p, p + (-lr) * upd)
            state.mu[k] = torch.where(frozen, state.mu[k], m)
            state.nu[k] = torch.where(frozen, state.nu[k], v)
    return out


def run_adam(loss_fn: Callable[[dict], torch.Tensor],
             init_params: dict[str, torch.Tensor],
             num_steps: int,
             lr_table: list[float],
             b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
             grad_mask: Callable[[str, torch.Tensor], torch.Tensor]
             | None = None,
             has_aux: bool = False, per_clip: bool = False):
    """`num_steps` of Adam (optax's update: bias-corrected moments,
    `m_hat / (sqrt(v_hat) + eps)`) on a dict of tensors.

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
    """
    if per_clip and has_aux:
        raise ValueError("run_adam: per_clip and has_aux exclude each other")
    params = {k: v.detach().clone() for k, v in init_params.items()}
    state = AdamState(params)
    dev = next(iter(params.values())).device
    n_clips = next(iter(params.values())).shape[0] if per_clip else None
    shape = () if n_clips is None else (n_clips,)
    dead = torch.zeros(shape, dtype=torch.bool, device=dev)
    losses = torch.empty((num_steps,) + shape, dtype=torch.float32,
                         device=dev)
    keys = list(params)
    aux_keys, aux_rows = None, []
    for i in range(num_steps):
        leaves = [params[k].requires_grad_(True) for k in keys]
        loss = loss_fn(params)
        if per_clip:
            loss, watched = loss
        elif has_aux:
            loss, aux = loss
            if aux_keys is None:
                aux_keys = list(aux)
            aux_rows.append(torch.stack([
                torch.as_tensor(aux[k], dtype=torch.float32,
                                device=dev).detach().reshape(())
                for k in aux_keys]))
        if not per_clip:
            watched = loss
        grads = dict(zip(keys, torch.autograd.grad(loss, leaves)))
        if grad_mask is not None:
            grads = {k: grad_mask(k, g) for k, g in grads.items()}
        losses[i] = watched.detach()
        dead = dead | ~torch.isfinite(watched.detach())
        params = adam_step(params, grads, state, lr_table[i], b1, b2, eps,
                           dead=dead)
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
