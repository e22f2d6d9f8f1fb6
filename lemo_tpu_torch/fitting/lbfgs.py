"""L-BFGS with a strong-Wolfe line search, and the optimizer factory (port
of `lemo_tpu/fitting/lbfgs.py`; temp_prox/optimizers/{optim_factory.py,
lbfgs_ls.py}).

`create_optimizer` serves adam / sgd / rmsprop as specs for
`fitting.adam.run_adam(spec=...)` and returns None for lbfgs / lbfgsls,
which run on `make_lbfgs_stepper`.

`lemo_tpu` runs each L-BFGS step inside one `lax.scan`, the line search
as a `lax.while_loop` decided on the device. Here the step is eager and
its decisions are taken on the host in float32, exactly as `lemo_tpu`
takes them: each line-search trial reads its loss and directional
derivative back (one host sync a trial), and each step reads its
descent test and its curvature pair's s.y. Its quirks are kept, since
the evaluation count is what the checks compare: an exhausted search
moves to its next, untried t; the step evaluates at x_new for g_new and
the next step evaluates at the same point again; `tol_grad` stops
nothing.

The flat vector orders a dict's leaves by sorted key and ravels each row
major (`jax.flatten_util.ravel_pytree`'s order), so every dot product
sums in `lemo_tpu`'s order of entries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from lemo_tpu_torch.fitting.adam import AdamSpec, RmspropSpec, SgdSpec

_F32 = np.float32


def create_optimizer(optim_type: str = "adam", **kw):
    """The reference's optimizer factory (optim_factory.py:27-65) for the
    gradient-descent family; 'lbfgs'/'lbfgsls' use `make_lbfgs_stepper`
    (signalled by returning None here). A spec holds the update's
    constants; the learning rate is `run_adam`'s `lr_table`, where
    `lemo_tpu` passes it here."""
    if optim_type == "adam":
        return AdamSpec(b1=kw.get("beta1", 0.9), b2=kw.get("beta2", 0.999))
    if optim_type == "sgd":
        return SgdSpec(momentum=kw.get("momentum", 0.9),
                       nesterov=kw.get("nesterov", True))
    if optim_type == "rmsprop":
        return RmspropSpec(decay=kw.get("alpha", 0.99),
                           momentum=kw.get("momentum", 0.0))
    if optim_type in ("lbfgs", "lbfgsls"):
        return None
    raise ValueError(f"Optimizer {optim_type} not supported!")


def _leaves(tree, path=()):
    """(path, tensor) pairs in `ravel_pytree`'s order: dict keys sorted,
    depth first."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def ravel(params):
    """(flat f32 vector, unravel) of a tensor or a (nested) dict of
    tensors, in `jax.flatten_util.ravel_pytree`'s order. `unravel(x)`
    splits x into views, so a gradient taken through it comes back
    flat."""
    leaves = list(_leaves(params))
    paths = [p for p, _ in leaves]
    shapes = [tuple(v.shape) for _, v in leaves]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([v.detach().reshape(-1).to(torch.float32)
                      for _, v in leaves])

    def unravel(x: torch.Tensor):
        parts = [c.view(s) for c, s in zip(torch.split(x, sizes), shapes)]
        if paths == [()]:
            return parts[0]
        out: dict = {}
        for path, leaf in zip(paths, parts):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return out

    return flat, unravel


def strong_wolfe(f_and_dirderiv: Callable, f0, g0, t0=1.0,
                 c1: float = 1e-4, c2: float = 0.9, max_iter: int = 20):
    """Strong-Wolfe step length by bisection with Armijo bracketing
    (`lemo_tpu`'s bounded variant of the reference `_strong_Wolfe`,
    lbfgs_ls.py:39+, whose cubic interpolation it replaces).

    `f_and_dirderiv(t) -> (f, f')` evaluates along the search ray; its
    values are read to the host. Every decision is taken in float32 as
    `lemo_tpu`'s loop takes it, NaN comparisons false: a NaN trial fails
    Armijo and halves t. Returns (t, f_t): when the search runs out after
    `max_iter` trials, t is the next trial, never evaluated, and f_t the
    last evaluated one's."""
    f0, g0 = _F32(f0), _F32(g0)
    lo, hi, t = _F32(0.0), _F32(np.inf), _F32(t0)
    f_t = f0
    with np.errstate(all="ignore"):
        for _ in range(max_iter):
            f_t, g_t = (_F32(v) for v in f_and_dirderiv(t))
            armijo = f_t <= f0 + _F32(c1) * t * g0
            curv = abs(g_t) <= _F32(-c2) * g0
            if armijo and curv:
                break
            if not armijo:
                hi = t
            elif g_t < 0:
                lo = t
            elif g_t >= 0:
                hi = t
            t = t * _F32(2.0) if np.isinf(hi) else _F32(0.5) * (lo + hi)
    return t, f_t


@dataclasses.dataclass
class LbfgsState:
    """The L-BFGS state carried across chunks: the iterate x [n], the
    curvature ring S, Y [m, n] and rho [m] on the device, the count of
    stored pairs k and the NaN freeze on the host; and what the steps
    so far did: each step's line-search trial count and the largest |t|
    and |x| that a trial reached."""

    x: torch.Tensor
    S: torch.Tensor
    Y: torch.Tensor
    rho: torch.Tensor
    k: int = 0
    dead: bool = False
    trials: tuple = ()
    max_t: float = 0.0
    max_abs_x: float = 0.0


def _two_loop(g, S, Y, rho, k: int, m: int):
    """The two-loop recursion over the k (<= m) stored pairs, newest
    first, then oldest first. `lemo_tpu` runs all m rounds and masks the
    invalid ones; those add 0 times a ring row that is still zero, so
    skipping them gives the same bits."""
    q = g
    alphas = {}
    for i in range(min(k, m)):
        idx = (k - 1 - i) % m
        a = rho[idx] * torch.dot(S[idx], q)
        q = q - a * Y[idx]
        alphas[idx] = a
    if k > 0:
        newest = (k - 1) % m
        gamma = torch.dot(S[newest], Y[newest]) / torch.clamp(
            torch.dot(Y[newest], Y[newest]), min=1e-10)
        r = gamma * q
    else:
        r = q
    for i in range(min(k, m)):
        idx = (i + max(k - m, 0)) % m
        beta = rho[idx] * torch.dot(Y[idx], r)
        r = r + (alphas[idx] - beta) * S[idx]
    return r


def make_lbfgs_stepper(loss_fn: Callable, example_params,
                       history_size: int = 10, lr: float = 1.0,
                       use_line_search: bool = True,
                       tol_grad: float = 1e-7, has_aux: bool = False):
    """Chunked L-BFGS: returns ``(init_state, run_chunk, unravel)``.

    ``init_state(params)`` builds an `LbfgsState`; ``run_chunk(state,
    num_steps, *extra)`` advances it and returns ``(state, losses
    [num_steps], aux_history)``. The state, curvature ring included, is
    carried across chunks, so chunks give what one long run gives.
    ``loss_fn(params, *extra)`` returns the loss, or (loss, {name:
    scalar}) with ``has_aux``, whose per-step values (taken at x, the
    step's first evaluation) make aux_history {name: [num_steps]};
    without it aux_history is None.

    A step evaluates the loss and gradient at x, k line-search trials
    (k <= 20, `strong_wolfe`) and x_new: 2 + k evaluations, each one
    forward and one backward. Its direction is the two-loop recursion's,
    or -g when that is not a descent direction (g.d >= 0); a pair is
    stored only when s.y > 1e-10. The NaN freeze (the reference's
    FittingMonitor keeps the last good parameters) fires on a non-finite
    loss at x or a non-finite x_new; every later step still evaluates
    and changes nothing. `tol_grad` is accepted and stops nothing, as in
    `lemo_tpu` (its convergence test selects x_new either way).
    """
    del tol_grad
    _, unravel = ravel(example_params)
    m = history_size

    def flat_vg(x, extra):
        xw = x.detach().requires_grad_(True)
        out = loss_fn(unravel(xw), *extra)
        v, aux = out if has_aux else (out, None)
        g, = torch.autograd.grad(v, xw)
        return v.detach(), aux, g

    def init_state(params) -> LbfgsState:
        flat0, _ = ravel(params)
        n = flat0.shape[0]
        return LbfgsState(x=flat0, S=flat0.new_zeros((m, n)),
                          Y=flat0.new_zeros((m, n)), rho=flat0.new_zeros(m))

    def run_chunk(state: LbfgsState, num_steps: int, *extra):
        x, k, dead = state.x, state.k, state.dead
        S, Y, rho = state.S.clone(), state.Y.clone(), state.rho.clone()
        trials = list(state.trials)
        max_t, max_abs_x = state.max_t, state.max_abs_x
        dev = x.device
        losses = torch.empty(num_steps, dtype=torch.float32, device=dev)
        aux_keys, aux_rows = None, []
        for i in range(num_steps):
            f, aux, g = flat_vg(x, extra)
            losses[i] = f
            if has_aux:
                if aux_keys is None:
                    aux_keys = list(aux)
                aux_rows.append(torch.stack([
                    torch.as_tensor(aux[n], dtype=torch.float32,
                                    device=dev).detach().reshape(())
                    for n in aux_keys]))
            d = -_two_loop(g, S, Y, rho, k, m)
            f_h, gd, gg = (_F32(v) for v in torch.stack(
                [f, torch.dot(g, d), torch.dot(g, g)]).tolist())
            if gd >= 0:          # not a descent direction: steepest descent
                d, gd = -g, -gg
            n_trials = 0
            if use_line_search:
                def f_dir(t):
                    nonlocal n_trials, max_t, max_abs_x
                    n_trials += 1
                    xt = x + float(t) * d
                    v, _, gt = flat_vg(xt, extra)
                    f_t, g_t, amax = torch.stack(
                        [v, torch.dot(gt, d), xt.abs().max()]).tolist()
                    max_t = max(max_t, abs(float(t)))
                    max_abs_x = max(max_abs_x, amax)
                    return f_t, g_t

                t, _ = strong_wolfe(f_dir, f_h, gd, t0=lr)
            else:
                t = _F32(lr)
            trials.append(n_trials)
            x_new = x + float(t) * d
            _, _, g_new = flat_vg(x_new, extra)
            s = x_new - x
            y = g_new - g
            sy_t = torch.dot(s, y)
            sy, finite = torch.stack(
                [sy_t, torch.isfinite(x_new).all().to(sy_t.dtype)]).tolist()
            dead = dead or not np.isfinite(f_h) or not finite
            if dead:
                continue
            if _F32(sy) > _F32(1e-10):
                idx = k % m
                S[idx] = s
                Y[idx] = y
                rho[idx] = 1.0 / torch.clamp(sy_t, min=1e-10)
                k += 1
            x = x_new
        hist = None
        if has_aux:
            rows = torch.stack(aux_rows)
            hist = {n: rows[:, j] for j, n in enumerate(aux_keys)}
        return LbfgsState(x=x, S=S, Y=Y, rho=rho, k=k, dead=dead,
                          trials=tuple(trials), max_t=max_t,
                          max_abs_x=max_abs_x), losses, hist

    return init_state, run_chunk, unravel


def lbfgs_minimize(loss_fn: Callable, init_params, max_iter: int = 100,
                   history_size: int = 10, lr: float = 1.0,
                   use_line_search: bool = True, tol_grad: float = 1e-7):
    """Minimize loss_fn over a tensor or a dict of tensors. Returns
    (params, per-iteration losses [max_iter])."""
    init_state, run_chunk, unravel = make_lbfgs_stepper(
        loss_fn, init_params, history_size=history_size, lr=lr,
        use_line_search=use_line_search, tol_grad=tol_grad)
    state, losses, _ = run_chunk(init_state(init_params), max_iter)
    return unravel(state.x), losses
