"""The optimizer family in the port vs lemo_tpu: `strong_wolfe` and
`lbfgs_minimize` on the quadratic and Rosenbrock problems of
tests/test_lbfgs.py (the same line-search trial count at every step,
iterates within rtol 1e-5, the minimum reached), the `create_optimizer`
surface, and the SGD and RMSprop updates against optax's over 5 steps
(rtol 1e-6), with the per-clip NaN freeze of the fold.

The trial counts are held against lemo_tpu run op by op
(`jax.disable_jit`): its compiled CPU code contracts a*b + c into one
FMA (the Rosenbrock loss at the start point is 24.200010 compiled and
24.200005 op by op, in numpy and in torch), and once a fit reaches the
f32 floor its line search decides on such last-bit differences. The
final iterates are held against both of lemo_tpu's runs.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lemo_tpu.fitting import lbfgs as j_lbfgs
from lemo_tpu_torch.fitting import adam as t_adam
from lemo_tpu_torch.fitting import lbfgs as t_lbfgs

torch.set_num_threads(2)


@contextlib.contextmanager
def jax_trial_counts(counts: list):
    """Count lemo_tpu's line-search trials a step: its `strong_wolfe` is
    wrapped so that each step appends a 0 and each trial adds 1, through
    ordered debug callbacks that run inside the compiled loop."""
    real = j_lbfgs.strong_wolfe

    def new_step():
        counts.append(0)

    def one_trial():
        counts[-1] += 1

    def counting(f_dir, f0, g0, **kw):
        def f_counted(t):
            jax.debug.callback(one_trial, ordered=True)
            return f_dir(t)

        jax.debug.callback(new_step, ordered=True)
        return real(f_counted, f0, g0, **kw)

    j_lbfgs.strong_wolfe = counting
    try:
        yield
    finally:
        j_lbfgs.strong_wolfe = real


RAYS = {
    # f(t) = (t - a)^2 / 2 - a^2 / 2 along the ray: the first trial passes
    "accepts_t0": lambda t: (0.5 * (t - 1.2) ** 2 - 0.72, t - 1.2),
    # a shallow bowl far along the ray: t doubles, then bisects
    "doubles": lambda t: (0.5 * (t - 9.0) ** 2 / 9.0 - 4.5,
                          (t - 9.0) / 9.0),
    # a steep bowl close to 0: Armijo fails and t halves
    "halves": lambda t: (0.5 * (t - 0.01) ** 2 / 0.01 - 0.005,
                         (t - 0.01) / 0.01),
    # never curved enough: 20 trials, ends on the untried next t
    "exhausts": lambda t: (-t, -1.0 + 0.0 * t),
    # NaN past t = 0.3: NaN trials fail Armijo
    "nan_beyond": lambda t: (jnp.where(t > 0.3, jnp.nan, 0.5 * (t - 0.2) ** 2
                                       - 0.02),
                             jnp.where(t > 0.3, jnp.nan, t - 0.2)),
}


@pytest.mark.parametrize("ray", sorted(RAYS))
def test_strong_wolfe_matches_jax(ray):
    fn = RAYS[ray]
    f0, g0 = (float(v) for v in fn(jnp.float32(0.0)))
    calls = []

    def j_dir(t):
        jax.debug.callback(lambda: calls.append(1), ordered=True)
        f, g = fn(t)
        return jnp.asarray(f, jnp.float32), jnp.asarray(g, jnp.float32)

    jt, jf = jax.jit(lambda: j_lbfgs.strong_wolfe(
        j_dir, jnp.float32(f0), jnp.float32(g0)))()
    jax.effects_barrier()
    t_calls = []

    def t_dir(t):
        t_calls.append(float(t))
        f, g = fn(jnp.float32(t))
        return float(f), float(g)

    tt, tf = t_lbfgs.strong_wolfe(t_dir, f0, g0)
    assert len(t_calls) == len(calls)
    assert float(tt) == float(jt)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-6)
    if ray == "exhausts":
        assert len(t_calls) == 20 and float(tt) == 2.0 ** 20
        assert float(tt) not in t_calls      # the untried next point
        assert float(tf) == -t_calls[-1]


def _quadratic_problem():
    A = np.diag([1.0, 10.0, 100.0]).astype(np.float32)
    b = np.asarray([1.0, -2.0, 3.0], np.float32)
    return A, b


def _jax_minimize(loss, x0, max_iter):
    """lemo_tpu's lbfgs_minimize compiled, and op by op with its trial
    counts: (compiled params, op-by-op params, op-by-op losses, counts)."""
    jp, _ = j_lbfgs.lbfgs_minimize(loss, x0, max_iter=max_iter)
    counts: list = []
    with jax.disable_jit(), jax_trial_counts(counts):
        ep, el = j_lbfgs.lbfgs_minimize(loss, x0, max_iter=max_iter)
    return jp, ep, np.asarray(el), counts


def test_lbfgs_minimize_quadratic_matches_jax():
    A, b = _quadratic_problem()
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    jx, ex, el, counts = _jax_minimize(lambda x: 0.5 * x @ Aj @ x - bj @ x,
                                       jnp.zeros(3), 30)
    init, run, unravel = t_lbfgs.make_lbfgs_stepper(
        lambda x: 0.5 * x @ At @ x - bt @ x, torch.zeros(3))
    state, tl, _ = run(init(torch.zeros(3)), 30)
    assert len(counts) == 30 and list(state.trials) == counts
    np.testing.assert_allclose(tl.numpy(), el, rtol=1e-5, atol=1e-7)
    for ref in (jx, ex):
        np.testing.assert_allclose(unravel(state.x).numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-7)
    x_star = np.linalg.solve(A, b)
    np.testing.assert_allclose(unravel(state.x).numpy(), x_star, atol=1e-3)
    assert float(tl[-1]) < float(tl[0])


def test_lbfgs_minimize_rosenbrock_pytree_matches_jax():
    def loss(p):
        x, y = p["x"], p["y"]
        return (1 - x) ** 2 + 100.0 * (y - x ** 2) ** 2

    jp, ep, _, counts = _jax_minimize(
        loss, {"x": jnp.asarray(-1.2), "y": jnp.asarray(1.0)}, 80)
    p0 = {"x": torch.tensor(-1.2), "y": torch.tensor(1.0)}
    init, run, unravel = t_lbfgs.make_lbfgs_stepper(loss, p0)
    state, tl, _ = run(init(p0), 80)
    assert len(counts) == 80 and list(state.trials) == counts
    tp = unravel(state.x)
    for ref in (jp, ep):
        for k in ("x", "y"):
            np.testing.assert_allclose(float(tp[k]), float(ref[k]),
                                       rtol=1e-5)
    assert float(loss(tp)) < 1e-3
    # lbfgs_minimize is the stepper in one chunk
    tp2, tl2 = t_lbfgs.lbfgs_minimize(loss, p0, max_iter=80)
    assert torch.equal(tl2, tl) and float(tp2["x"]) == float(tp["x"])


def test_chunks_carry_the_state():
    """Two chunks of 10 steps are one run of 20, bit for bit."""
    A, b = _quadratic_problem()
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    init, run, _ = t_lbfgs.make_lbfgs_stepper(
        lambda x: 0.5 * x @ At @ x - bt @ x, torch.zeros(3))
    whole, l_whole, _ = run(init(torch.zeros(3)), 20)
    half, l1, _ = run(init(torch.zeros(3)), 10)
    both, l2, _ = run(half, 10)
    assert torch.equal(both.x, whole.x) and both.trials == whole.trials
    assert torch.equal(torch.cat([l1, l2]), l_whole)


def test_nan_freezes_the_iterate():
    """A non-finite loss at x freezes x; every later step still
    evaluates 2 + k times."""
    A, b = _quadratic_problem()
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    n = {"calls": 0, "poison_at": None}

    def loss(x):
        n["calls"] += 1
        v = 0.5 * x @ At @ x - bt @ x
        return v * float("nan") if n["calls"] == n["poison_at"] else v

    init, run, _ = t_lbfgs.make_lbfgs_stepper(loss, torch.zeros(3))
    clean, _, _ = run(init(torch.zeros(3)), 2)
    n["calls"], n["poison_at"] = 0, 3 + clean.trials[0]   # step 2's x
    state, losses, _ = run(init(torch.zeros(3)), 5)
    assert state.dead and np.isnan(float(losses[1]))
    first, _, _ = run(init(torch.zeros(3)), 1)
    assert torch.equal(state.x, first.x)
    assert n["calls"] == sum(2 + k for k in state.trials) + 2 + \
        first.trials[0]


@pytest.mark.parametrize("name", ["adamw", "newton", "LBFGS", ""])
def test_unknown_optimizers_raise(name):
    with pytest.raises(ValueError, match="not supported"):
        t_lbfgs.create_optimizer(name)
    with pytest.raises(ValueError, match="not supported"):
        j_lbfgs.create_optimizer(name, 0.01)


def test_create_optimizer_surface():
    assert t_lbfgs.create_optimizer("adam") == t_adam.AdamSpec(
        b1=0.9, b2=0.999, eps=1e-8)
    assert t_lbfgs.create_optimizer("sgd") == t_adam.SgdSpec(
        momentum=0.9, nesterov=True)
    assert t_lbfgs.create_optimizer("rmsprop") == t_adam.RmspropSpec(
        decay=0.99, eps=1e-8, momentum=0.0)
    assert t_lbfgs.create_optimizer("sgd", momentum=0.5, nesterov=False) \
        == t_adam.SgdSpec(momentum=0.5, nesterov=False)
    for name in ("lbfgs", "lbfgsls"):
        assert t_lbfgs.create_optimizer(name) is None
        assert j_lbfgs.create_optimizer(name, 0.01) is None


def _random_tree(rng):
    return {"a": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(7).astype(np.float32)}


@pytest.mark.parametrize("name", ["sgd", "rmsprop"])
def test_updates_match_optax(name):
    """Five steps on a random dict with fresh random gradients each step,
    and five steps of `run_adam(spec=...)` on a quartic, against optax."""
    rng = np.random.RandomState(3)
    lr = 0.03
    p0 = _random_tree(rng)
    grads = [_random_tree(rng) for _ in range(5)]
    opt = j_lbfgs.create_optimizer(name, lr)
    spec = t_lbfgs.create_optimizer(name)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = opt.init(jp)
    tp = {k: torch.as_tensor(v) for k, v in p0.items()}
    ts = spec.init(tp)
    for g in grads:
        u, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        tp = spec.step(tp, {k: torch.as_tensor(v) for k, v in g.items()},
                       ts, lr)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)

    def jloss(p):
        return sum(((v - 0.5) ** 4).sum() for v in p.values())

    jq = {k: jnp.asarray(v) for k, v in p0.items()}
    js = opt.init(jq)
    j_losses = []
    for _ in range(5):
        v, g = jax.value_and_grad(jloss)(jq)
        j_losses.append(float(v))
        u, js = opt.update(g, js, jq)
        jq = optax.apply_updates(jq, u)
    tq, tl = t_adam.run_adam(
        lambda p: sum(((v - 0.5) ** 4).sum() for v in p.values()),
        {k: torch.as_tensor(v) for k, v in p0.items()}, 5, [lr] * 5,
        spec=spec)
    np.testing.assert_allclose(tl.numpy(), j_losses, rtol=1e-6)
    for k in p0:
        np.testing.assert_allclose(tq[k].numpy(), np.asarray(jq[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["sgd", "rmsprop"])
def test_per_clip_freeze(name):
    """The fold's per-clip run of SGD or RMSprop over C disjoint problems
    is C single runs bit for bit; a NaN clip freezes alone."""
    rng = np.random.RandomState(5)
    a = torch.as_tensor(rng.uniform(0.5, 2.0, (3, 6)).astype(np.float32))
    x0 = torch.as_tensor(rng.randn(3, 6).astype(np.float32))
    spec = t_lbfgs.create_optimizer(name)
    poison = {"on": False}

    def per_clip(p):
        per = (0.5 * a * p["x"] ** 2 - p["x"]).sum(-1)
        if poison["on"]:
            per = per * torch.tensor([1.0, float("nan"), 1.0])
        return per.sum(), per

    xs, ls = t_adam.run_adam(per_clip, {"x": x0}, 8, [0.02] * 8,
                             per_clip=True, spec=spec)
    for c in range(3):
        xc, lc = t_adam.run_adam(
            lambda p, c=c: (0.5 * a[c] * p["x"] ** 2 - p["x"]).sum(),
            {"x": x0[c]}, 8, [0.02] * 8, spec=spec)
        assert torch.equal(xs["x"][c], xc["x"]) and torch.equal(ls[c], lc)
    poison["on"] = True
    xp, lp = t_adam.run_adam(per_clip, {"x": x0}, 8, [0.02] * 8,
                             per_clip=True, spec=spec)
    assert torch.equal(xp["x"][1], x0[1]) and torch.isnan(lp[1]).all()
    assert torch.equal(xp["x"][[0, 2]], xs["x"][[0, 2]])
