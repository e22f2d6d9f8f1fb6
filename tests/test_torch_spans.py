"""The port's spans (`utils/profiling.py`): off by default at the cost of
two flag checks, rows of an in-memory log inside `record_spans()`,
regions of a `torch.profiler` trace, and where the fitters open them:
`run_adam`'s fit and step spans and the Stage-2 fold's loss terms, with
the fit's results the same bits whether recorded or not."""

import json
import threading

import numpy as np
import pytest
import torch

from lemo_tpu_torch.body_model import load_model
from lemo_tpu_torch.body_model.vposer import init_vposer
from lemo_tpu_torch.data import markers, segments
from lemo_tpu_torch.data.stats import GlobalStats
from lemo_tpu_torch.fitting import amass_temp as s2
from lemo_tpu_torch.fitting.adam import run_adam
from lemo_tpu_torch.priors.conv_ae import init_smooth_enc
from lemo_tpu_torch.testing.synthetic import synthetic_smplx_npz
from lemo_tpu_torch.utils import profiling as P

C, T, S = 2, 10, 3
STEP_SPANS = ("lemo.step.forward", "lemo.step.backward", "lemo.step.update")
TERM_SPANS = ("lemo.term.vposer_decode", "lemo.term.body_model",
              "lemo.term.markers", "lemo.term.smooth_prior",
              "lemo.term.friction")


def test_off_records_nothing_and_opens_no_region(monkeypatch):
    opened = []
    monkeypatch.setattr(P, "_region", lambda name: opened.append(name))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: opened.append(a))
    span = P.annotate("step.forward", steps=3)
    assert span is P._OFF
    with span:
        pass
    with P.annotate("fit"):
        with P.annotate("step.update"):
            pass
    assert opened == []


def test_recorded_spans_nest_with_their_counts():
    with P.record_spans() as log:
        with P.annotate("fit", steps=2):
            for _ in range(2):
                with P.annotate("step.forward"):
                    with P.annotate("term.markers"):
                        pass
        with pytest.raises(ValueError):
            with P.annotate("step.update"):
                raise ValueError("closed all the same")
    assert [r[0] for r in log] == ["lemo.fit", "lemo.step.forward",
                                   "lemo.term.markers", "lemo.step.forward",
                                   "lemo.term.markers", "lemo.step.update"]
    assert [r[3] for r in log] == [None, 0, 1, 0, 3, None]
    assert log[0][4] == {"steps": 2}
    assert all(r[4] == {} for r in log[1:])
    assert all(r[1] <= r[2] for r in log)
    assert log[0][1] <= log[1][1] and log[4][2] <= log[0][2]
    assert log.open == []
    with P.annotate("fit"):
        pass
    assert len(log) == 6                        # closed: no more rows


def test_timed_gives_its_seconds_recorded_or_not():
    with P.timed("prox.fit") as off:
        pass
    with P.record_spans() as log:
        with P.timed("prox.fit") as on:
            pass
    assert off.seconds >= 0 and on.seconds >= 0
    assert [(r[0], r[4]) for r in log] == [("lemo.prox.fit", {})]
    assert on.seconds == (log[0][2] - log[0][1]) / 1e9


def test_a_thread_records_only_into_its_own_log():
    with P.record_spans() as log:
        t = threading.Thread(target=lambda: P.annotate("fit").__enter__())
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        with P.annotate("step.forward"):
            pass
    assert [r[0] for r in log] == ["lemo.step.forward"]


def _quadratic_fit(steps=4):
    target = torch.arange(12.0).reshape(3, 4)
    return run_adam(lambda p: ((p["x"] - target) ** 2).sum(),
                    {"x": torch.zeros(3, 4)}, steps, [0.1] * steps)


def test_the_profiler_trace_names_the_spans(tmp_path):
    with P.profile_trace(str(tmp_path)):
        _quadratic_fit()
    with open(tmp_path / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"lemo.fit", *STEP_SPANS} <= names


def test_run_adam_spans_each_step():
    with P.record_spans() as log:
        _quadratic_fit(steps=4)
    fits = [r for r in log if r[0] == "lemo.fit"]
    assert len(fits) == 1 and fits[0][4] == {"steps": 4}
    for name in STEP_SPANS:
        rows = [r for r in log if r[0] == name]
        assert len(rows) == 4 and all(r[3] == 0 for r in rows)


@pytest.fixture(scope="module")
def stage2():
    """The Stage-2 fold on the 400-vertex model, its inputs."""
    md = synthetic_smplx_npz(num_verts=400, seed=4)
    model = load_model(md, use_pca=True, num_pca_comps=12, device="cpu")
    vpp = init_vposer(torch.Generator().manual_seed(0))
    enc = init_smooth_enc(torch.Generator().manual_seed(1))
    stats = GlobalStats(Xmean=torch.zeros((1, 1, 243)), Xstd=torch.ones(243))
    fit = s2.make_temporal_fitter_batched(
        model, vpp, enc, stats, markers.marker_indices(False, num_verts=400),
        markers.marker_indices(True, num_verts=400),
        segments.foot_vertex_ids(num_verts=400), num_steps=S, device="cpu")
    rng = np.random.RandomState(7)
    data = (torch.as_tensor(rng.randn(C, T, 67, 3).astype(np.float32) * 0.2),
            torch.as_tensor((rng.rand(C, T, 4) > 0.5).astype(np.float32)),
            torch.as_tensor(rng.randn(C, T, 72).astype(np.float32) * 0.1))
    return fit, data


def test_the_stage2_fold_spans_its_steps_and_terms(stage2):
    fit, data = stage2
    x_off, l_off = fit(*data)
    with P.record_spans() as log:
        x_on, l_on = fit(*data)
    np.testing.assert_array_equal(x_on.numpy(), x_off.numpy())
    np.testing.assert_array_equal(l_on.numpy(), l_off.numpy())
    fits = [i for i, r in enumerate(log) if r[0] == "lemo.fit"]
    assert len(fits) == 1
    assert log[fits[0]][4] == {"steps": S}
    for name in STEP_SPANS:
        assert sum(r[0] == name for r in log) == S
    forwards = [i for i, r in enumerate(log) if r[0] == "lemo.step.forward"]
    for name in TERM_SPANS:
        rows = [r for r in log if r[0] == name]
        assert len(rows) == S and all(r[3] in forwards for r in rows)
