"""The port's prior trainers against lemo_tpu's on the CPU: the new conv
and VPoser pieces, each train step from carried-across parameters on the
same batch, mask and eps (the first-step loss and gradients, then five
Adam steps), the batch order for a seed, the random and PROX masks, and
the too-few-images error.

lemo_tpu's gradients are read by running its jitted train step with a
stand-in for `optax.adam` whose state keeps the last gradients. The
first-step gradients are held in f64, where the two packages compute the
same function to 1e-9, and the port's f32 gradients against that exact
gradient within 1e-5 of its largest magnitude: the two f32 gradients
differ by up to 1.66e-5 of it for VPoser, where lemo_tpu's own f32
rounding is 1.52e-5 off the f64 gradient and the port's 3.0e-6."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load_model
from lemo_tpu.body_model import make_forward_fn as j_make_forward_fn
from lemo_tpu.body_model import vposer as j_vp
from lemo_tpu.priors import conv_ae as j_ae
from lemo_tpu.testing.synthetic import synthetic_smplx_npz
from lemo_tpu.train import infill as j_ti
from lemo_tpu.train import smooth as j_ts
from lemo_tpu.train import vposer as j_tv
from lemo_tpu_torch.body_model import load_model, make_forward_fn
from lemo_tpu_torch.body_model import vposer as vp
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.fitting.adam import (AdamState, adam_init, adam_minimize,
                                         adam_step, piecewise_lr, run_adam)
from lemo_tpu_torch.priors import conv_ae as ae
from lemo_tpu_torch.train import infill as ti
from lemo_tpu_torch.train import smooth as ts
from lemo_tpu_torch.train import vposer as tv

torch.set_num_threads(2)
STEPS = 5


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _grab_grads():
    """An optax transformation that leaves the parameters and keeps the
    gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.fixture
def jax_grads(monkeypatch):
    """Make lemo_tpu's trainers build their optimizer from `_grab_grads`."""
    for mod in (j_ts, j_ti, j_tv):
        monkeypatch.setattr(mod, "optax", types.SimpleNamespace(
            adam=lambda lr: _grab_grads(),
            apply_updates=optax.apply_updates,
            sigmoid_binary_cross_entropy=optax.sigmoid_binary_cross_entropy))


def _port_grads(loss_fn, params, *args):
    flat = {}

    def leaf(tree, path=()):
        return {k: leaf(v, path + (k,)) if isinstance(v, dict) else
                flat.setdefault(path + (k,), v.clone().requires_grad_(True))
                for k, v in tree.items()}

    loss, _ = loss_fn(leaf(params), *args)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return float(loss), dict(zip(flat, grads))


def _jax_flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jax_flat(v, path + (k,)))
        else:
            out[path + (k,)] = np.asarray(v)
    return out


def _f64(tree):
    """A numpy tree with its floating leaves in f64."""
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def _torch64(tree):
    return {k: _torch64(v) if isinstance(v, dict) else v.double()
            for k, v in tree.items()}


def _check_first_step(j_make, params, j_args, t_make, t_args,
                      t_args64=None):
    """lemo_tpu's step (`j_make(x64) -> (step, opt)`, built with
    `_grab_grads`) against the port's loss (`t_make(x64) -> loss_fn`) on
    the same inputs: the f32 loss within rel 1e-5; both packages' f64
    gradients within 1e-9 of their largest magnitude; the port's f32
    gradients within 1e-5 of it from the port's f64 gradient on the same
    inputs. `t_args64`: the inputs of the f64 comparison where they are
    not `t_args` in f64 (lemo_tpu's f64 draws)."""
    j_step, j_opt = j_make(False)
    _, j_grads, j_m = j_step(params, j_opt.init(params), *j_args)
    with jax.enable_x64(True):
        p64 = _f64(params)
        j_step, j_opt = j_make(True)
        _, j64, _ = j_step(p64, j_opt.init(p64),
                           *[_f64(a) if isinstance(a, np.ndarray) else a
                             for a in j_args])
        j64 = _jax_flat(j64)
    p = from_numpy_tree(params, "cpu")
    loss, grads = _port_grads(t_make(False), p, *t_args)
    own64 = [a.double() for a in t_args]
    _, g64 = _port_grads(t_make(True), _torch64(p), *(t_args64 or own64))
    _, exact = (_port_grads(t_make(True), _torch64(p), *own64) if t_args64
                else (None, g64))
    j_loss = float(j_m["total"])
    assert abs(loss - j_loss) <= 1e-5 * abs(j_loss), (loss, j_loss)
    assert set(grads) == set(_jax_flat(j_grads)) == set(j64)
    scale = max(float(np.abs(g).max()) for g in j64.values())
    for k, g in grads.items():
        assert j64[k].dtype == np.float64
        err64 = float(np.abs(g64[k].numpy() - j64[k]).max())
        assert err64 <= 1e-9 * scale, (k, err64, scale)
        err = float(np.abs(g.double().numpy() - exact[k].numpy()).max())
        assert err <= 1e-5 * scale, (k, err, scale)


def _check_losses(losses, j_losses):
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    assert np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# the Adam step the trainers take
# ---------------------------------------------------------------------------

def _quartic(p):
    return ((p["a"] ** 2 - 0.3) ** 2).sum() + (p["b"].sin() * p["a"][0]).sum()


def test_adam_steps_are_run_adams_bits():
    """run_adam is a loop of adam_step, and adam_minimize takes the same
    steps on a nested dict."""
    init = {"a": _t(np.linspace(-1, 1, 6)), "b": _t(np.arange(4.0))}
    lrs = piecewise_lr([(0, 0.05), (4, 0.01)], 7)
    final, losses = run_adam(_quartic, init, 7, lrs)
    p, state = dict(init), AdamState(init)
    nested, nstate = {"x": dict(init)}, adam_init({"x": init})
    for i, lr in enumerate(lrs):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = _quartic(leaves)
        assert torch.equal(loss.detach(), losses[i])
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        p = adam_step(leaves, grads, state, lr)
        nested, m = adam_minimize(lambda q: (_quartic(q["x"]), {}), nested,
                                  nstate, lr)
        assert torch.equal(m["total"], losses[i])
    assert state.count == nstate.count == 7
    for k in init:
        assert torch.equal(p[k], final[k]) and torch.equal(nested["x"][k],
                                                           final[k])


# ---------------------------------------------------------------------------
# conv prior and VPoser pieces
# ---------------------------------------------------------------------------

def _torch_default_bound(name, w):
    """kaiming_uniform(a=sqrt(5)) weights and the bias bound, both
    1/sqrt(fan_in): a Conv2d's fan_in is size(1)*k*k of [O, I, k, k], a
    ConvTranspose2d's size(1)*k*k of [I, O, k, k]."""
    return 1.0 / np.sqrt(w.shape[1] * w.shape[2] * w.shape[3])


@pytest.mark.parametrize("which", ["infill", "smooth_dec"])
def test_init_shapes_and_torch_default_bounds(which):
    gen = torch.Generator().manual_seed(0)
    if which == "infill":
        p, ref = ae.init_infill_ae(gen), j_ae.init_infill_ae(
            jax.random.PRNGKey(0))
    else:
        p, ref = ae.init_smooth_dec(gen), j_ae.init_smooth_dec(
            jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    for k, w in p.items():
        if not k.endswith(".weight"):
            continue
        bound = _torch_default_bound(k, w)
        for t in (w, p[k[:-len("weight")] + "bias"]):
            assert t.dtype == torch.float32
            m = float(t.abs().max())
            assert m <= bound, (k, m, bound)
            # uniform draws fill their range: the largest magnitude of
            # n >= 32 draws lies in the top quarter but for 0.5**n
            assert t.numel() < 32 or m > 0.75 * bound, (k, m, bound)


@pytest.mark.parametrize("downsample", [False, True])
def test_smooth_dec_forward_matches_jax(downsample):
    rng = np.random.RandomState(0)
    enc = j_ae.init_smooth_enc(jax.random.PRNGKey(1))
    dec = j_ae.init_smooth_dec(jax.random.PRNGKey(2))
    x = rng.randn(2, 1, 14, 27).astype(np.float32)
    z, sizes = j_ae.smooth_enc_forward(enc, jnp.asarray(x),
                                       downsample=downsample)
    ref = np.asarray(j_ae.smooth_dec_forward(dec, z, sizes,
                                             downsample=downsample))
    sizes_t = tuple(tuple(int(n) for n in s) for s in sizes)
    out = ae.smooth_dec_forward(from_numpy_tree(dec, "cpu"), _t(z), sizes_t,
                                downsample=downsample)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_encode_with_batchnorm_matches_jax():
    rng = np.random.RandomState(1)
    params = dict(j_vp.init_vposer(jax.random.PRNGKey(3)))
    for bn, dim in (("bodyprior_enc_bn1", 189), ("bodyprior_enc_bn2", 512)):
        params[f"{bn}.running_mean"] = rng.randn(dim).astype(np.float32)
        params[f"{bn}.running_var"] = rng.uniform(0.5, 2, dim).astype(
            np.float32)
        params[f"{bn}.weight"] = rng.uniform(0.5, 1.5, dim).astype(
            np.float32)
        params[f"{bn}.bias"] = (0.1 * rng.randn(dim)).astype(np.float32)
    x = rng.randn(6, 189).astype(np.float32)
    mu_r, sigma_r = j_vp.encode(params, jnp.asarray(x))
    mu, sigma = vp.encode(from_numpy_tree(params, "cpu"), _t(x))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r), atol=1e-5)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_r), atol=1e-5)
    assert (sigma > 0).all()
    bn = vp._batchnorm(from_numpy_tree(params, "cpu"), "bodyprior_enc_bn1",
                       _t(x))
    np.testing.assert_allclose(
        bn.numpy(), np.asarray(j_vp._batchnorm(params, "bodyprior_enc_bn1",
                                               jnp.asarray(x))), atol=1e-5)


def test_save_state_dict_round_trips_both_ways(tmp_path):
    port = ae.init_smooth_dec(torch.Generator().manual_seed(4))
    ae.save_state_dict(port, str(tmp_path / "port.npz"))
    got = j_ae.load_state_dict_npz(str(tmp_path / "port.npz"))
    assert set(got) == set(port)
    for k, v in port.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v.numpy())
    back = ae.load_state_dict_npz(str(tmp_path / "port.npz"), "cpu")
    assert all(torch.equal(back[k], v) for k, v in port.items())

    ref = j_ae.init_smooth_dec(jax.random.PRNGKey(5))
    j_ae.save_state_dict(ref, str(tmp_path / "jax.npz"))
    got = ae.load_state_dict_npz(str(tmp_path / "jax.npz"), "cpu")
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


# ---------------------------------------------------------------------------
# train steps against lemo_tpu's
# ---------------------------------------------------------------------------

def _smooth_setup():
    rng = np.random.RandomState(6)
    images = (rng.randn(4, 16, 30) * 0.3).astype(np.float32)   # [N, T, d]
    cfg_kw = dict(batch_size=2, lr=1e-3)
    params = j_ts.init_params(jax.random.PRNGKey(7),
                              j_ts.SmoothTrainConfig(**cfg_kw))
    batches = [images[[0, 2]], images[[3, 1]], images[[1, 0]],
               images[[2, 3]], images[[0, 3]]]
    return cfg_kw, params, [b.swapaxes(1, 2)[:, None] for b in batches]


def test_smooth_train_step_matches_jax(jax_grads):
    cfg_kw, params, batches = _smooth_setup()
    j_cfg, t_cfg = (j_ts.SmoothTrainConfig(**cfg_kw),
                    ts.SmoothTrainConfig(**cfg_kw))
    _check_first_step(lambda x64: j_ts.make_train_step(j_cfg)[::2], params,
                      [batches[0]],
                      lambda x64: ts.make_train_step(t_cfg)[0].loss_fn,
                      [_t(batches[0])])


def test_smooth_train_steps_match_jax():
    cfg_kw, params, batches = _smooth_setup()
    j_step, j_eval, j_opt = j_ts.make_train_step(
        j_ts.SmoothTrainConfig(**cfg_kw))
    step, eval_step = ts.make_train_step(ts.SmoothTrainConfig(**cfg_kw))
    p = from_numpy_tree(params, "cpu")
    st, j_state = adam_init(p), j_opt.init(params)
    losses, j_losses = [], []
    for b in batches:
        params, j_state, j_m = j_step(params, j_state, jnp.asarray(b))
        p, m = step(p, st, _t(b))
        j_losses.append(float(j_m["total"]))
        losses.append(float(m["total"]))
    _check_losses(losses, j_losses)
    # the reconstruction term (the z-smoothness term, ~1e-7 here, is
    # cancellation in z[t+1] - z[t]; it is held inside the totals above)
    ev, j_ev = eval_step(p, _t(batches[0])), j_eval(params,
                                                    jnp.asarray(batches[0]))
    assert set(ev) == set(j_ev)
    np.testing.assert_allclose(float(ev["loss_rec_v"]),
                               float(j_ev["loss_rec_v"]), rtol=1e-4)


def _infill_setup():
    rng = np.random.RandomState(8)
    clip = (rng.randn(5, 3, 4, 208, 12) * 0.3).astype(np.float32)
    clip[:, :, 0, -4:] = rng.rand(5, 3, 4, 12) > 0.5      # contact labels
    cfg_kw = dict(batch_size=3, lr=1e-3)
    params = j_ae.init_infill_ae(jax.random.PRNGKey(9))
    key = jax.random.PRNGKey(10)
    masks = [np.asarray(j_ti.random_marker_mask(k, 3, 208, 12))
             for k in jax.random.split(key, STEPS)]
    return cfg_kw, params, clip, masks


def test_infill_train_step_matches_jax(jax_grads):
    cfg_kw, params, clip, masks = _infill_setup()
    j_cfg, t_cfg = (j_ti.InfillTrainConfig(**cfg_kw),
                    ti.InfillTrainConfig(**cfg_kw))
    _check_first_step(lambda x64: j_ti.make_train_step(j_cfg)[::2], params,
                      [clip[0], masks[0]],
                      lambda x64: ti.make_train_step(t_cfg)[0].loss_fn,
                      [_t(clip[0]), _t(masks[0])])


def test_infill_train_steps_match_jax():
    cfg_kw, params, clip, masks = _infill_setup()
    j_step, _, j_opt = j_ti.make_train_step(j_ti.InfillTrainConfig(**cfg_kw))
    step, _ = ti.make_train_step(ti.InfillTrainConfig(**cfg_kw))
    p = from_numpy_tree(params, "cpu")
    st, j_state = adam_init(p), j_opt.init(params)
    losses, j_losses = [], []
    for b, m in zip(clip, masks):
        params, j_state, j_m = j_step(params, j_state, jnp.asarray(b),
                                      jnp.asarray(m))
        p, mt = step(p, st, _t(b), _t(m))
        j_losses.append(float(j_m["total"]))
        losses.append(float(mt["total"]))
    _check_losses(losses, j_losses)


@pytest.fixture(scope="module")
def vposer_body():
    """A small use_pca=False model with 10 betas and 10 expressions in
    both packages (the mesh loss's body)."""
    npz = synthetic_smplx_npz(num_verts=300, seed=11)
    jm = j_load_model(npz, use_pca=False)
    tm = load_model(npz, use_pca=False, device="cpu")
    return (j_make_forward_fn(jm), jm.consts), (make_forward_fn(tm),
                                                tm.consts)


def _vposer_setup():
    """lr 1e-4, not the config's 1e-3: Adam's first step moves each weight
    by +-lr whatever its gradient's size, and some of bodyprior_dec_fc2's
    262,144 weights have gradients within rounding of zero, so at 1e-3
    the two packages' free runs part by 6.6e-4 in loss by step 5 (30
    weights flipped at step 1); at 1e-4 by 5.4e-7."""
    rng = np.random.RandomState(12)
    poses = (rng.randn(STEPS, 8, 63) * 0.3).astype(np.float32)
    cfg_kw = dict(batch_size=8, lr=1e-4)
    params = j_vp.init_vposer(jax.random.PRNGKey(13))
    keys = jax.random.split(jax.random.PRNGKey(14), STEPS)
    eps = [np.asarray(jax.random.normal(k, (8, 32))) for k in keys]
    return cfg_kw, params, poses, keys, eps


@pytest.mark.parametrize("mesh", [False, True])
def test_vposer_train_step_matches_jax(jax_grads, vposer_body, mesh):
    cfg_kw, params, poses, keys, eps = _vposer_setup()
    (jf, jc), (tf, tc) = vposer_body if mesh else ((None, None),
                                                   (None, None))
    j_cfg, t_cfg = (j_tv.VPoserTrainConfig(**cfg_kw),
                    tv.VPoserTrainConfig(**cfg_kw))

    def j_make(x64):
        consts = jc if jc is None or not x64 else jax.tree_util.tree_map(
            lambda a: jnp.asarray(_f64(np.asarray(a))), jc)
        return j_tv.make_train_step(j_cfg, jf, consts)

    def t_make(x64):
        consts = tc if tc is None or not x64 else {
            k: v.double() if v.is_floating_point() else v
            for k, v in tc.items()}
        return tv.make_train_step(t_cfg, tf, consts).loss_fn

    with jax.enable_x64(True):
        eps64 = np.asarray(jax.random.normal(keys[0], (8, 32)))
    _check_first_step(j_make, params, [poses[0], keys[0]], t_make,
                      [_t(poses[0]), _t(eps[0])],
                      [_t(poses[0]).double(), torch.as_tensor(eps64)])


@pytest.mark.parametrize("mesh", [False, True])
def test_vposer_train_steps_match_jax(vposer_body, mesh):
    cfg_kw, params, poses, keys, eps = _vposer_setup()
    (jf, jc), (tf, tc) = vposer_body if mesh else ((None, None),
                                                   (None, None))
    j_step, j_opt = j_tv.make_train_step(j_tv.VPoserTrainConfig(**cfg_kw),
                                         jf, jc)
    step = tv.make_train_step(tv.VPoserTrainConfig(**cfg_kw), tf, tc)
    p = from_numpy_tree(params, "cpu")
    st, j_state = adam_init(p), j_opt.init(params)
    losses, j_losses = [], []
    for x, k, e in zip(poses, keys, eps):
        params, j_state, j_m = j_step(params, j_state, jnp.asarray(x), k)
        p, m = step(p, st, _t(x), _t(e))
        j_losses.append([float(j_m[n]) for n in ("total", "kl", "rec")])
        losses.append([float(m[n]) for n in ("total", "kl", "rec")])
    _check_losses(np.array(losses), np.array(j_losses))


# ---------------------------------------------------------------------------
# batch order, masks, too few images
# ---------------------------------------------------------------------------

def test_smooth_batches_match_jax():
    images = np.random.RandomState(15).randn(11, 6, 5).astype(np.float32)
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(3):   # epochs
        ref = [np.asarray(b) for b in j_ts.batches(images, 4, r1)]
        out = [b.numpy() for b in ts.batches(images, 4, r2)]
        assert len(out) == len(ref) == 2
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)


def _recording_step(calls, jax_side):
    """A stand-in for make_train_step whose steps record their batch (by
    image index) and mask and change nothing."""
    def done(params, state):
        if jax_side:
            return params, state, {"total": jnp.zeros(())}
        return params, {"total": torch.zeros(())}

    def make(cfg):
        def step(params, state, batch, mask):
            calls.append(("prox", np.asarray(batch)[:, 0, 0, 0].tolist(),
                          float(np.asarray(mask).sum())))
            return done(params, state)

        def indexed(params, state, images_dev, idx, key):
            calls.append(("random", np.asarray(idx).tolist()))
            return done(params, state)

        step.indexed = indexed
        return (step, None, optax.adam(cfg.lr)) if jax_side else (step, None)
    return make


def test_infill_batch_order_matches_jax(monkeypatch):
    """The curriculum's index sequence and its PROX-mask picks: random
    masks while epoch <= random_mask_epochs, then PROX masks."""
    images = np.arange(10, dtype=np.float32)[:, None, None, None] * \
        np.ones((10, 4, 12, 208), np.float32)
    prox = (np.random.RandomState(16).rand(6, 120, 201) > 0.3).astype(
        np.float32)
    cfg_kw = dict(batch_size=3, random_mask_epochs=1)
    calls_j, calls_t = [], []
    monkeypatch.setattr(j_ti, "make_train_step",
                        _recording_step(calls_j, True))
    monkeypatch.setattr(ti, "make_train_step",
                        _recording_step(calls_t, False))
    j_ti.train(images, j_ti.InfillTrainConfig(**cfg_kw), 13,
               prox_masks=prox, seed=4, log_every=100)
    ti.train(images, ti.InfillTrainConfig(**cfg_kw), 13, prox_masks=prox,
             seed=4, log_every=100, device="cpu")
    assert [c[0] for c in calls_t].count("prox") == 13 - 6
    assert calls_t == calls_j


def test_vposer_batch_order_matches_jax(monkeypatch):
    poses = np.random.RandomState(17).randn(40, 63).astype(np.float32)
    seen_j, seen_t = [], []

    def rec_j(cfg, *a):
        def step(params, state, x, key):
            seen_j.append(np.asarray(x))
            return params, state, {"total": jnp.zeros(())}
        return step, optax.adam(cfg.lr)

    def rec_t(cfg, *a):
        def step(params, state, x, eps):
            seen_t.append(x.numpy())
            return params, {"total": torch.zeros(())}
        return step

    monkeypatch.setattr(j_tv, "make_train_step", rec_j)
    monkeypatch.setattr(tv, "make_train_step", rec_t)
    cfg_kw = dict(batch_size=7)
    j_tv.train(poses, j_tv.VPoserTrainConfig(**cfg_kw), 4, seed=2)
    tv.train(poses, tv.VPoserTrainConfig(**cfg_kw), 4, seed=2, device="cpu")
    assert len(seen_t) == 4
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, b)


def test_random_marker_mask_equals_jax_given_its_draws():
    key = jax.random.PRNGKey(18)
    ref = np.asarray(j_ti.random_marker_mask(key, 64, 208, 7))
    k1, k2 = jax.random.split(key)
    scores = jax.random.uniform(k1, (64, 67))
    n = jax.random.randint(k2, (64, 1), 1, 7)
    out = ti.marker_mask(_t(scores), torch.as_tensor(np.asarray(n)), 208, 7)
    np.testing.assert_array_equal(out.numpy(), ref)
    # feet masked in some samples: the contact rows are exercised
    assert (ref[:, -4:] == 0).any()


def test_random_marker_mask_shapes():
    m = ti.random_marker_mask(torch.Generator().manual_seed(0), 4, 208,
                              40).numpy()
    assert m.shape == (4, 208, 40)
    assert (m[:, :3] == 1).all()
    assert (m[:, 3:204] == 0).any()


def test_random_marker_mask_distribution():
    """tests/test_trainers.py's count test on the port's own draws: the
    masked-marker count uniform over 1..6 distinct markers."""
    m = ti.random_marker_mask(torch.Generator().manual_seed(3), 3000, 208,
                              4).numpy()
    marker_rows = m[:, 3:204, 0].reshape(-1, 67, 3)
    counts = (marker_rows == 0).all(-1).sum(-1)
    assert counts.min() >= 1 and counts.max() <= 6
    assert abs(counts.mean() - 3.5) < 0.15
    freq = np.bincount(counts, minlength=7)[1:7] / len(counts)
    assert (np.abs(freq - 1 / 6) < 0.04).all(), freq


def test_prox_mask_to_image_mask_exact():
    prox = (np.random.RandomState(19).rand(5, 50, 201) > 0.2).astype(
        np.float32)
    prox[0, :, 16 * 3:16 * 3 + 3] = 0
    out = ti.prox_mask_to_image_mask(prox, 208, 40)
    ref = j_ti.prox_mask_to_image_mask(prox, 208, 40)
    assert out.dtype == ref.dtype and out.shape == (5, 208, 40)
    np.testing.assert_array_equal(out, ref)
    assert (out[0, -4] == 0).all()


def test_too_few_images_raise():
    with pytest.raises(ValueError, match="fewer than a batch"):
        ts.train(np.zeros((3, 10, 6), np.float32), None,
                 ts.SmoothTrainConfig(batch_size=4), 2, device="cpu")
    with pytest.raises(ValueError, match="fewer than a batch"):
        ti.train(np.zeros((2, 4, 10, 208), np.float32),
                 ti.InfillTrainConfig(batch_size=3), 2, device="cpu")
