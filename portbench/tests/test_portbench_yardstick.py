"""The benchmark's frozen arithmetic against the originals it was copied
from, at tiny sizes on the CPU: the body kernels' and the cone-energy
kernel's operation and byte counts (`chip_smoke.py`), the profiler
reduction (`scripts/profile_torch_s2.py`'s union) and the FLOP count."""

import numpy as np
import pytest
import torch

import chip_smoke
from portbench import flops, trace, work


@pytest.mark.parametrize("B,V,J,D", [(1, 10, 3, 5), (119, 10475, 55, 507),
                                     (1904, 10475, 55, 507)])
def test_body_kernel_work_is_chip_smokes(B, V, J, D):
    assert work.body_kernel_work(B, V, J, D) == \
        chip_smoke.body_kernel_work(B, V, J, D)


def test_isect_constants_are_chip_smokes():
    assert work.ISECT_OPS == chip_smoke.ISECT_OPS
    assert work.ISECT_BOUND_RUN == chip_smoke.ISECT_BOUND_RUN
    assert work.ISECT_FACE_BYTES == chip_smoke.ISECT_FACE_BYTES
    from lemo_tpu_torch.ops.intersection_cuda import PACK
    assert work.ISECT_PACK == PACK


def _random_pack(T, K, Kp, seed):
    g = torch.Generator().manual_seed(seed)
    pack = torch.zeros((T, Kp, work.ISECT_PACK))
    c = torch.rand((T, K, 3), generator=g) * 0.3
    n = torch.nn.functional.normalize(torch.randn((T, K, 3), generator=g),
                                      dim=-1)
    tri = c[..., None, :] + 0.03 * torch.randn((T, K, 3, 3), generator=g)
    pack[:, :K, 0:3] = c
    pack[:, :K, 3:6] = n
    pack[:, :K, 6] = (n * c).sum(-1)
    pack[:, :K, 7] = 0.04
    pack[:, :K, 8] = 0.0016
    pack[:, :K, 9] = 1.0
    pack[:, :K, 10:19] = tri.reshape(T, K, 9)
    ipack = torch.full((1, Kp, 4), -1, dtype=torch.int32)
    ipack[0, :K, 0:3] = torch.randint(0, 3 * K, (K, 3), generator=g,
                                      dtype=torch.int32)
    ipack[0, :K, 3] = torch.randint(0, 4, (K,), generator=g,
                                    dtype=torch.int32)
    return pack, ipack


@pytest.mark.parametrize("seed", [0, 1])
def test_gate_counts_are_chip_smokes(seed):
    pack, ipack = _random_pack(2, 90, 128, seed)
    ign = torch.zeros((4, 4), dtype=torch.bool)
    ign[1, 2] = ign[2, 1] = True
    got = work.gate_counts(pack, ipack, ign)
    want = chip_smoke._gate_counts(pack, ipack, ign)
    assert got == want
    assert got[0] > got[1] > 0 and got[2] >= got[3] >= got[4]
    nbytes, ops = work.isect_work(pack, ipack, ign)
    assert nbytes == work.ISECT_FACE_BYTES * 2 * 90
    assert ops == sum(o * n for o, n in zip(work.ISECT_OPS, want))


def test_bound_picks_the_larger_time():
    t, which = work.bound_s(3.35e12, 1.0)
    assert which == "bytes" and t == pytest.approx(1.0)
    t, which = work.bound_s(1.0, 67e12)
    assert which == "operations" and t == pytest.approx(1.0)


@pytest.mark.parametrize("ivs,want", [
    ([], 0.0), ([(0, 1)], 1.0), ([(0, 2), (1, 3)], 3.0),
    ([(0, 5), (1, 2), (6, 7)], 6.0), ([(3, 4), (0, 1), (0.5, 1.5)], 2.5)])
def test_union_is_profile_scripts(ivs, want):
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "profile_torch_s2", os.path.join(os.path.dirname(
            chip_smoke.__file__), "scripts", "profile_torch_s2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert trace.union_us(ivs) == pytest.approx(want)
    assert trace.union_us(ivs) == pytest.approx(mod._union_us(ivs))


def test_idle_gaps_take_the_innermost_span():
    t = trace.DeviceTrace(
        wall_us=100.0, steps=2,
        ops=[("k1", 0.0, 10.0), ("k2", 15.0, 32.0), ("k1", 40.0, 50.0)],
        spans=[("portbench.fit_call", 0.0, 30.0),
               ("portbench.data_prep", 12.0, 14.0),
               ("portbench.sync", 30.0, 60.0)])
    assert t.busy_us == 37.0
    assert t.launches() == 3
    assert t.idle_gaps() == [("portbench.fit_call", 5.0),
                             ("portbench.sync", 8.0)]
    b = t.breakdown()
    assert b["device_ops"] == [["k1", 20e-6], ["k2", 17e-6]]
    assert b["idle_gaps"] == [["portbench.sync", 8e-6],
                              ["portbench.fit_call", 5e-6]]


def _call(steps, per_call_ops=3):
    """A stretch of `steps` steps of two 10-us kernels each, 5 us apart,
    after `per_call_ops` 2-us fills, with one launch counter a step."""
    ops = [("fill", 2.0 * i, 2.0 * i + 1.0) for i in range(per_call_ops)]
    t = 10.0
    for _ in range(steps):
        ops += [("k1", t, t + 10.0), ("k2", t + 15.0, t + 25.0)]
        t += 30.0
    return trace.DeviceTrace(wall_us=t, ops=ops, spans=[], steps=steps,
                             counters={"vertex_fwd": steps})


def test_per_step_reads_a_step_of_the_timed_call():
    got = trace.PerStep(_call(5), _call(10), steps=100)
    want = _call(100)
    assert got(lambda t: t.launches()) == pytest.approx(
        want.launches() / 100)
    assert got(lambda t: t.busy_us) == pytest.approx(want.busy_us / 100)
    assert got(lambda t: t.counters["vertex_fwd"]) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        trace.PerStep(_call(10), _call(5), steps=100)


def test_each_per_layer_metric_has_its_reader():
    """Every per-layer metric of BENCHMARK.json is found by its name,
    `metrics/<name>.py`."""
    import importlib
    import json
    import os

    from portbench import run

    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for m in bench["per_layer"]:
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert callable(mod.read), m["name"]


def test_flops_count_products_and_convolutions():
    a = flops.to_meta(torch.zeros(8, 16))
    b = flops.to_meta(torch.zeros(16, 4))
    assert flops.count_flops(torch.matmul, a, b) == 2 * 8 * 16 * 4
    x = torch.empty((2, 3, 10, 12), device="meta", requires_grad=True)
    w = torch.empty((5, 3, 3, 3), device="meta")

    def conv_and_grad():
        y = torch.nn.functional.conv2d(x, w, padding=1)
        torch.autograd.grad(y.sum(), [x])

    fwd = 2 * 2 * 5 * 3 * 9 * 10 * 12
    # forward and the data gradient, no weight gradient
    assert flops.count_flops(conv_and_grad) == 2 * fwd


def test_chip_smokes_trainer_count_is_the_same_rule():
    """`flops.count_flops` on meta tensors is chip_smoke's `_step_flops`
    rule: one train step of a linear model."""
    from lemo_tpu_torch.fitting.adam import adam_minimize

    def loss(p, x):
        y = x @ p["w"]
        return (y ** 2).mean(), {}

    params = {"w": torch.zeros(6, 3)}
    x = torch.zeros(4, 6)
    want = chip_smoke._step_flops(
        lambda p, st, x: adam_minimize(loss, p, st, 1e-3, x), params, x)
    meta = flops.to_meta(params)

    def step():
        from lemo_tpu_torch.fitting.adam import adam_init
        adam_minimize(loss, meta, adam_init(meta), 1e-3,
                      torch.empty_like(x, device="meta"))
    assert flops.count_flops(step) == want == 2 * (2 * 4 * 6 * 3)
    assert np.isfinite(want)
