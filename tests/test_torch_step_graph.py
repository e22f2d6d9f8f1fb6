"""The captured Adam step of the Stage-2 clip fold
(`fitting/step_graph.py`): the step body over static buffers and device
tables against `run_adam`'s eager loop, the fitter's buffers and its
cache of captured steps, the launch counters' bookkeeping over a capture
and its replays, and the frame-0 normalizer made without a host copy. On
the CPU the body runs eagerly at each replay (`EagerStep`); the tests
marked `cuda` replay the CUDA graph on the card."""

import numpy as np
import pytest
import torch

from lemo_tpu_torch.body_model import load_model
from lemo_tpu_torch.body_model.vposer import init_vposer
from lemo_tpu_torch.data import markers, segments
from lemo_tpu_torch.data.repr import frame0_normalizer
from lemo_tpu_torch.data.stats import GlobalStats
from lemo_tpu_torch.fitting import adam
from lemo_tpu_torch.fitting import amass_temp as s2
from lemo_tpu_torch.fitting import step_graph as sg
from lemo_tpu_torch.priors.conv_ae import init_smooth_enc
from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz
from lemo_tpu_torch.utils import profiling as P

C, T, S = 2, 10, 5          # S > WARMUP_STEPS: the first fit captures
LRS = [0.01] * 12 + [0.005] * 8


class CountingStep(sg.EagerStep):
    """`EagerStep` that keeps each one made (`made`, one a captured step
    of the cache) and the step it runs (`step`)."""

    made: list = []

    def __init__(self):
        super().__init__()
        self.step = None
        self.made.append(self)

    def eager(self, body):
        self.step = body.__self__
        super().eager(body)

    def capture(self, body, counters):
        self.step = body.__self__
        super().capture(body, counters)


@pytest.fixture
def eager_graphs(monkeypatch):
    """Every `StepGraphs` replays with `CountingStep`; yields the class."""
    monkeypatch.setattr(CountingStep, "made", [])
    monkeypatch.setattr(sg.StepGraphs, "replayer", CountingStep)
    return CountingStep


def _quadratic(per_clip):
    g = torch.Generator().manual_seed(3)
    target = torch.randn((3, 5, 4), generator=g)
    init = {"x": torch.zeros(3, 5, 4), "y": torch.ones(3, 2)}

    def loss(p):
        per = ((p["x"] - target) ** 2).mean(dim=(1, 2)) + \
            0.1 * (p["y"] ** 2).sum(dim=1)
        return (per.sum(), per) if per_clip else per.sum()
    return loss, init


@pytest.mark.parametrize("per_clip", [True, False])
def test_captured_body_matches_the_eager_loop(eager_graphs, per_clip):
    """The first fit runs WARMUP_STEPS eager steps and replays the rest,
    the second replays every step; both are `run_adam`'s eager loop."""
    loss, init = _quadratic(per_clip)
    fe, le = adam.run_adam(loss, init, 20, LRS, per_clip=per_clip)
    graphs = sg.StepGraphs()
    for replayed in (20 - sg.WARMUP_STEPS, 20):
        with P.record_spans() as log:
            fg, lg = adam.run_adam(loss, init, 20, LRS, per_clip=per_clip,
                                   graph=graphs)
        assert lg.shape == le.shape == ((3, 20) if per_clip else (20,))
        torch.testing.assert_close(lg, le, rtol=1e-6, atol=0)
        for k in fe:
            torch.testing.assert_close(fg[k], fe[k], rtol=1e-6, atol=1e-9)
        fits = [r for r in log if r[0] == "lemo.fit"]
        assert [r[4] for r in fits] == [{"steps": 20, "replayed": replayed}]
        assert sum(r[0] == "lemo.step.replay" for r in log) == replayed
        assert sum(r[0] == "lemo.step.forward" for r in log) == 20
    assert len(eager_graphs.made) == 1


def test_step_table_reads_the_eager_scalars():
    table = adam.StepTable(LRS, 0.9, 0.999, "cpu")
    for i, lr in enumerate(LRS):
        neg_lr, inv1, inv2 = table.scalars(0.9, 0.999)
        bc1, bc2 = adam.bias_corrections(i + 1, 0.9, 0.999)
        assert float(neg_lr) == np.float32(-lr)
        assert float(inv1) == np.float32(1) / np.float32(bc1)
        assert float(inv2) == np.float32(1) / np.float32(bc2)
        table.advance()
    with pytest.raises(ValueError, match="betas"):
        table.scalars(0.8, 0.999)


@pytest.fixture(scope="module")
def stage2():
    """The Stage-2 fold's factory on the 400-vertex model (CPU), and two
    batches of inputs."""
    md = synthetic_smplx_npz(num_verts=400, seed=4)
    model = load_model(md, use_pca=True, num_pca_comps=12, device="cpu")
    vpp = init_vposer(torch.Generator().manual_seed(0))
    enc = init_smooth_enc(torch.Generator().manual_seed(1))
    stats = GlobalStats(Xmean=torch.zeros((1, 1, 243)), Xstd=torch.ones(243))

    def make():
        return s2.make_temporal_fitter_batched(
            model, vpp, enc, stats,
            markers.marker_indices(False, num_verts=400),
            markers.marker_indices(True, num_verts=400),
            segments.foot_vertex_ids(num_verts=400), num_steps=S,
            device="cpu")

    rng = np.random.RandomState(7)
    batches = [(torch.as_tensor(rng.randn(n, T, 67, 3).astype(np.float32)
                                * 0.2),
                torch.as_tensor((rng.rand(n, T, 4) > 0.5)
                                .astype(np.float32)),
                torch.as_tensor(rng.randn(n, T, 72).astype(np.float32) * 0.1))
               for n in (C, C, 1)]
    return make, batches


def test_cpu_fold_keeps_the_eager_loop(stage2):
    """On the CPU no capture engages: the fold runs `run_adam`'s eager
    loop over its inputs themselves, and holds no static buffer."""
    make, (a, _, _) = stage2
    fit = make()
    with P.record_spans() as log:
        fit(*a)
    assert [r[4] for r in log if r[0] == "lemo.fit"] == [{"steps": S}]
    assert not any(r[0] == "lemo.step.replay" for r in log)
    graphs = next(c.cell_contents for c in fit.__closure__
                  if isinstance(c.cell_contents, sg.StepGraphs))
    assert graphs.steps == {} and graphs.inputs == {}


def test_fold_outputs_are_fresh_and_calls_independent(stage2, eager_graphs):
    make, (a, b, _) = stage2
    fit = make()
    xa, la = fit(*a)
    xb, lb = fit(*b)
    graphs = next(c.cell_contents for c in fit.__closure__
                  if isinstance(c.cell_contents, sg.StepGraphs))
    ((inputs, _),) = graphs.inputs.values()
    (made,) = eager_graphs.made
    step = made.step
    buffers = [*step.params.values(), *step.mu.values(), *step.nu.values(),
               step.dead, step.losses, *inputs]
    for out in (xa, la, xb, lb):
        assert not any(out.untyped_storage().data_ptr()
                       == buf.untyped_storage().data_ptr() for buf in buffers)
    xa2, la2 = make()(*a)
    xb2, lb2 = make()(*b)
    assert torch.equal(xa, xa2) and torch.equal(la, la2)
    assert torch.equal(xb, xb2) and torch.equal(lb, lb2)
    assert len(eager_graphs.made) == 3


@pytest.mark.parametrize("change", ["none", "shape", "loss", "update",
                                    "routing"])
def test_cache_captures_again_when_the_step_changes(stage2, eager_graphs,
                                                    monkeypatch, change):
    make, (a, b, small) = stage2
    fit = make()
    fit(*a)
    assert len(eager_graphs.made) == 1
    if change == "shape":
        fit(*small)
    elif change == "loss":
        real = s2.run_adam
        monkeypatch.setattr(s2, "run_adam", lambda loss_fn, *x, **kw: real(
            lambda v: loss_fn(v), *x, **kw))
        fit(*b)
    elif change == "update":
        monkeypatch.setattr(adam.AdamSpec, "step",
                            lambda self, params, grads, state, lr,
                            dead=None: {k: v.detach()
                                        for k, v in params.items()})
        x, _ = fit(*b)
        start = s2._x72(s2._init_vars(b[2]), b[2][..., 6:16])
        assert torch.equal(x, start)
    elif change == "routing":
        from lemo_tpu_torch.body_model import chain_cuda as cc
        monkeypatch.setattr(cc, "chain_fwd_kernel", cc.chain_fwd_kernel)
        fit(*b)
    else:
        fit(*b)
    assert len(eager_graphs.made) == (1 if change == "none" else 2)


def test_routing_counts_assignments_from_outside():
    from lemo_tpu_torch.body_model import vertex_cuda as vc
    from lemo_tpu_torch.utils import routing

    v0 = routing.version()
    vc.launches["vertex_fwd"] += 0            # a counter: no routing
    assert routing.version() == v0
    fn = vc.vertex_fwd_kernel
    vc.vertex_fwd_kernel = vc.vertex_plain_fwd
    vc.vertex_fwd_kernel = fn
    assert routing.version() == v0 + 2


def test_counters_capture_undone_and_replays_added():
    stub = [{"fwd": 5, "bwd": 2}, {"other": 1}]

    def step():
        stub[0]["fwd"] += 2
        stub[0]["bwd"] += 1

    for _ in range(sg.WARMUP_STEPS):          # eager steps: they count
        step()
    deltas = sg.capture_counts(stub, step)
    assert deltas == [{"fwd": 2, "bwd": 1}, {}]
    assert stub == [{"fwd": 11, "bwd": 5}, {"other": 1}]
    for _ in range(3):
        sg.add(stub, deltas)
    assert stub == [{"fwd": 17, "bwd": 8}, {"other": 1}]


def _frame0_before(joints_frame0):
    """`frame0_normalizer` as it was, its +z copied from the host."""
    x_axis = joints_frame0[..., 2, :] - joints_frame0[..., 1, :]
    x_axis = torch.cat([x_axis[..., :2], torch.zeros_like(x_axis[..., 2:])],
                       dim=-1)
    x_axis = x_axis / torch.linalg.norm(x_axis, dim=-1, keepdim=True)
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=joints_frame0.dtype,
                          device=joints_frame0.device).expand_as(x_axis)
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
    y_axis = y_axis / torch.linalg.norm(y_axis, dim=-1, keepdim=True)
    R = torch.stack([x_axis, y_axis, z_axis], dim=-1)
    return R, joints_frame0[..., 0, :]


@pytest.mark.parametrize("shape", [(25, 3), (6, 25, 3)])
def test_frame0_normalizer_keeps_its_bits(shape):
    j = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    for got, want in zip(frame0_normalizer(j), _frame0_before(j)):
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---- on the card ----------------------------------------------------

CC = 4          # clips of the card's fold
CS = 10         # its steps


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_fold():
    """The fold's factory on the card (impl as asked, 400-vertex model)
    and CC clips of inputs there."""
    dev = _card()
    md = synthetic_smplx_npz(num_verts=400, seed=4)
    model = load_model(md, use_pca=True, num_pca_comps=12, device=dev)
    vpp = {k: v.to(dev) for k, v in
           init_vposer(torch.Generator().manual_seed(0)).items()}
    enc = {k: v.to(dev) for k, v in
           init_smooth_enc(torch.Generator().manual_seed(1)).items()}
    stats = GlobalStats(Xmean=torch.zeros((1, 1, 243)),
                        Xstd=torch.ones(243)).to(dev)

    def make(impl="fold"):
        return s2.make_temporal_fitter_batched(
            model, vpp, enc, stats,
            markers.marker_indices(False, num_verts=400),
            markers.marker_indices(True, num_verts=400),
            segments.foot_vertex_ids(num_verts=400), num_steps=CS,
            impl=impl, device=dev)

    rng = np.random.RandomState(11)
    data = (torch.as_tensor(rng.randn(CC, T, 67, 3).astype(np.float32) * 0.2,
                            device=dev),
            torch.as_tensor((rng.rand(CC, T, 4) > 0.5).astype(np.float32),
                            device=dev),
            torch.as_tensor(rng.randn(CC, T, 72).astype(np.float32) * 0.1,
                            device=dev))
    return make, data


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_card_fold_replays_keep_the_eager_bits(card_fold, deterministic,
                                               monkeypatch):
    """The replayed fold is the eager fold bit for bit, and its x72 each
    clip's own single-clip fit's (`impl="vmap"`); the losses of the two
    forms sum each clip's terms in another order, and agree within
    lemo_tpu's tolerance (tests/test_fitting_stage2.py:165-170)."""
    make, data = card_fold
    fold = make()
    replayed = [fold(*data), fold(*data)]     # the second replays only
    xv, lv = make("vmap")(*data)
    monkeypatch.setattr(sg.StepGraphs, "engages",
                        lambda self, device, spec: False)
    xe, le = make()(*data)
    for x, losses in replayed:
        assert torch.equal(x, xe) and torch.equal(losses, le)
        assert torch.equal(x, xv)
        torch.testing.assert_close(losses, lv, rtol=2e-3, atol=2e-5)


@pytest.mark.cuda
def test_card_nan_clip_leaves_the_others_bits(card_fold, deterministic):
    make, (target, contact, init72) = card_fold
    fold = make()
    bad = target.clone()
    bad[0] = float("nan")
    xb, lb = fold(bad, contact, init72)
    xg, lg = fold(target, contact, init72)
    assert torch.isnan(lb[0]).all() and torch.isfinite(lb[1:]).all()
    assert torch.equal(xb[1:], xg[1:]) and torch.equal(lb[1:], lg[1:])
    start = s2._x72(s2._init_vars(init72), init72[..., 6:16])
    assert torch.equal(xb[0], start[0])


def _counted(fit, data):
    counters = sg.launch_counters()
    before = sg.counts(counters)
    fit(*data)
    torch.cuda.synchronize()
    return sg.changes(counters, before)


@pytest.mark.cuda
def test_card_replays_count_the_eager_launches(card_fold, monkeypatch):
    make, data = card_fold
    fold = make()
    captured = _counted(fold, data)           # warm-up, capture, replays
    replayed = _counted(fold, data)
    monkeypatch.setattr(sg.StepGraphs, "engages",
                        lambda self, device, spec: False)
    eager = _counted(make(), data)
    assert captured == replayed == eager
    assert replayed[0] == {"chain_fwd": CS, "chain_bwd": CS}


@pytest.mark.cuda
def test_card_replayed_fit_never_syncs_the_host(card_fold, monkeypatch):
    """No synchronizing CUDA call from the loading of the buffers to the
    clones of the outputs (`run_adam` of a captured step)."""
    make, data = card_fold
    fold = make()
    fold(*data)                               # captures
    torch.cuda.synchronize()
    real = s2.run_adam

    def watched(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(s2, "run_adam", watched)
    x, losses = fold(*data)
    assert torch.isfinite(losses).all()
