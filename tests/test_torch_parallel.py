"""Scale-out (`lemo_tpu_torch.parallel`) on the CPU: the mesh helpers in
one process, and on two spawned gloo ranks (a file store in a temporary
directory) the collectives, the pod mesh, the data-parallel smoothness
step, the frame-sharded Stage 1 and the clip-sharded Stage 2 against
`lemo_tpu`'s unsharded runs at tests/test_parallel.py's and
tests/test_torch_stage2_batched.py's tolerances, and `dryrun_multichip(2)`.
The two-rank parts run in one spawn (`ranks` fixture)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model as j_load
from lemo_tpu.body_model import vposer as j_vp
from lemo_tpu.data import markers as j_markers
from lemo_tpu.data import segments as j_segments
from lemo_tpu.data.stats import GlobalStats as JStats
from lemo_tpu.fitting import amass_perframe as j_s1
from lemo_tpu.fitting import amass_temp as j_s2
from lemo_tpu.priors.conv_ae import init_smooth_enc
from lemo_tpu.testing.synthetic import synthetic_smplx_npz
from lemo_tpu.train import smooth as j_ts
from lemo_tpu_torch import parallel
from lemo_tpu_torch.body_model import load_model as t_load
from lemo_tpu_torch.convert import from_numpy_tree
from lemo_tpu_torch.fitting import amass_temp as t_s2
from lemo_tpu_torch.parallel import dryrun, sharding
from lemo_tpu_torch.train import smooth as t_ts

torch.set_num_threads(2)

# Stage 2 as tests/test_torch_stage2_batched.py, with 4 clips, 2 a rank
C, T2, S2 = 4, 12, 5
X_RTOL, X_ATOL = 6e-2, 2e-3
L_RTOL, L_ATOL = 2e-3, 2e-5
# Stage 1 and the DP step as tests/test_parallel.py
T1, S1 = 8, 5


def test_exports_keep_lemo_tpus_signatures():
    import inspect

    import lemo_tpu.parallel as j_parallel

    names = ("make_mesh", "initialize_multihost", "make_pod_mesh",
             "data_parallel_step", "clip_sharded_fit", "shard_frames")
    for name in names:
        j_args = list(inspect.signature(getattr(j_parallel, name)).parameters)
        t_args = list(inspect.signature(getattr(parallel, name)).parameters)
        assert t_args[:len(j_args)] == j_args, name


@pytest.mark.parametrize("n,size", [(4, 2), (5, 2), (7, 3), (2, 2), (3, 4)])
def test_shares_are_tensor_splits(n, size):
    parts = torch.tensor_split(torch.arange(n), size)
    for r in range(size):
        lo, hi = sharding.shard_bounds(n, size, r)
        assert parts[r].tolist() == list(range(lo, hi))
        for i in range(lo, hi):
            assert sharding.shard_owner(n, size, i) == r


def test_backend_follows_the_device():
    assert sharding.default_backend("cuda") == "nccl"
    assert sharding.default_backend("cpu") == "gloo"


@pytest.mark.parametrize("device,backend,cards,want", [
    (None, None, 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ("cuda", "nccl", 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    (None, "gloo", 1, ["cuda:0"] * 4),
    ("cuda:1", "gloo", 4, ["cuda:1"] * 4),
    ("cpu", None, 0, ["cpu"] * 4),
])
def test_one_card_a_rank(monkeypatch, device, backend, cards, want):
    """`spawn_ranks`' placement: rank r on card r % cards, a card shared
    only under gloo (checked by the placement alone, without a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    got = dryrun.rank_devices(4, device, backend)
    assert [str(d) for d in got] == want


@pytest.mark.parametrize("device,cards", [(None, 1), ("cuda", 2),
                                          ("cuda:0", 4)])
def test_nccl_refuses_a_shared_card(monkeypatch, device, cards):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(ValueError, match="backend='gloo'"):
        dryrun.rank_devices(4, device, None)


def test_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.initialize_multihost() == 0      # a no-op
    assert not torch.distributed.is_initialized()
    mesh = parallel.make_mesh(device="cpu")
    assert (mesh.group, mesh.size, mesh.rank) == (None, 1, 0)
    pod = parallel.make_pod_mesh()
    assert pod.shape == (1, 1) and pod.axis_names == ("dp", "win")
    with pytest.raises(ValueError):
        parallel.make_pod_mesh(dp=3)
    with pytest.raises(ValueError):
        parallel.make_mesh(2)
    x = torch.arange(6.0).reshape(3, 2)
    assert sharding.gather_rows(mesh, x, 3) is x
    assert torch.equal(parallel.shard_frames(mesh, x), x)
    fit = parallel.clip_sharded_fit(lambda a: (a * 2, a.sum(1)), mesh)
    out = fit(x)
    assert torch.equal(out[0], x * 2) and torch.equal(out[1], x.sum(1))


@pytest.fixture(scope="module")
def stage2_setup():
    md = synthetic_smplx_npz(num_verts=400, seed=4)
    vpp = {k: np.asarray(v) for k, v in
           j_vp.init_vposer(jax.random.PRNGKey(0)).items()}
    enc = {k: np.asarray(v) for k, v in
           init_smooth_enc(jax.random.PRNGKey(1)).items()}
    stats = JStats(Xmean=np.zeros((1, 1, 243)), Xstd=np.ones(243))
    ids = (j_markers.marker_indices(False, num_verts=400),
           j_markers.marker_indices(True, num_verts=400),
           j_segments.foot_vertex_ids(num_verts=400))
    rng = np.random.RandomState(7)
    data = (rng.randn(C, T2, 67, 3).astype(np.float32) * 0.2,
            (rng.rand(C, T2, 4) > 0.5).astype(np.float32),
            rng.randn(C, T2, 72).astype(np.float32) * 0.1)
    fold = j_s2.make_temporal_fitter_batched(j_load(md, use_pca=True,
                                                    num_pca_comps=12),
                                             vpp, enc, stats, *ids,
                                             num_steps=S2, impl="fold")
    x_ref, l_ref = fold(*(jnp.asarray(a) for a in data))
    model = t_load(md, use_pca=True, num_pca_comps=12, device="cpu")
    args = (model, *(from_numpy_tree(p, "cpu") for p in (vpp, enc, stats)),
            *ids)
    return args, data, (np.array(x_ref), np.array(l_ref))


@pytest.fixture(scope="module")
def stage1_setup():
    md = synthetic_smplx_npz(num_verts=128)
    vpp = {k: np.asarray(v) for k, v in
           j_vp.init_vposer(jax.random.PRNGKey(1)).items()}
    ids = j_markers.marker_indices(False, num_verts=128)
    target = (np.random.RandomState(1).randn(T1, 67, 3) * 0.2).astype(
        np.float32)
    fit = j_s1.make_stage1_fitter(j_load(md, use_pca=True, num_pca_comps=12),
                                  vpp, ids, num_steps=S1)
    x_ref, l_ref = fit(jnp.asarray(target), jnp.zeros(10))
    model = t_load(md, use_pca=True, num_pca_comps=12, device="cpu")
    return ((model, from_numpy_tree(vpp, "cpu"), ids), target,
            (np.array(x_ref), np.array(l_ref)))


@pytest.fixture(scope="module")
def dp_setup():
    cfg = j_ts.SmoothTrainConfig(batch_size=8, lr=1e-3)
    params = j_ts.init_params(jax.random.PRNGKey(0), cfg)
    train_step, _, opt = j_ts.make_train_step(cfg)
    batch = np.random.RandomState(0).randn(8, 1, 24, 16).astype(np.float32)
    p1, _, m1 = train_step(params, opt.init(params), jnp.asarray(batch))
    p_np = jax.tree_util.tree_map(np.asarray, params)
    return (t_ts.SmoothTrainConfig(batch_size=8, lr=1e-3),
            from_numpy_tree(p_np, "cpu"), batch,
            (jax.tree_util.tree_map(np.asarray, p1), float(m1["total"])))


@pytest.fixture(scope="module")
def ranks(stage1_setup, stage2_setup, dp_setup):
    """One spawn of two gloo ranks running every two-rank part."""
    s1_args, target, _ = stage1_setup
    s2_args, data, _ = stage2_setup
    cfg, params, batch, _ = dp_setup
    jobs = [
        (dryrun.job_mesh_checks, {}),
        (dryrun.job_dp_step, {"cfg": cfg, "params": params,
                              "batch": torch.as_tensor(batch)}),
        (dryrun.job_stage1, {"fitter_args": s1_args,
                             "fitter_kw": {"num_steps": S1,
                                           "device": "cpu"},
                             "target": torch.as_tensor(target),
                             "beta": torch.zeros(10)}),
        (dryrun.job_stage2, {"fitter_args": s2_args,
                             "fitter_kw": {"num_steps": S2,
                                           "device": "cpu"},
                             "inputs": tuple(torch.as_tensor(a)
                                             for a in data)}),
    ]
    return dryrun.spawn_ranks(2, dryrun.job_sequence, {"jobs": jobs},
                              device="cpu", threads=2, timeout=600)


def test_collectives_and_pod_mesh(ranks):
    seen = [r[0] for r in ranks]
    assert [s["rank"] for s in seen] == [0, 1]
    assert [s["rows"] for s in seen] == [[0, 1, 2], [3, 4]]
    want = torch.arange(5.0)[:, None].expand(5, 3).clone()
    want[0, 0], want[0, 1] = -0.0, float("nan")
    for s in seen:
        g = s["gathered"]
        # the gather keeps each row's bits: -0.0 stays negative, NaN NaN
        assert torch.equal(torch.nan_to_num(g["x"], nan=7.0),
                           torch.nan_to_num(want, nan=7.0))
        assert torch.signbit(g["x"][0, 0]) and torch.isnan(g["x"][0, 1])
        assert g["i"].tolist() == list(range(5))
        assert g["b"].dtype == torch.bool
        assert g["b"].tolist() == [i % 2 == 0 for i in range(5)]
        assert s["broadcast"].tolist() == [1.0, 1.0]
        assert s["pods"][1]["shape"] == (1, 2)
        assert s["pods"][2]["shape"] == (2, 1)
        assert s["pods"][1]["axis_names"] == ("dp", "win")
        # each axis's group: "win" spans both ranks of a (1, 2) mesh
        assert s["pods"][1]["sums"] == {"dp": 1.0, "win": 2.0}
        assert s["pods"][2]["sums"] == {"dp": 2.0, "win": 1.0}
        assert "3" in s["bad_pod"]
        # 7 frames in blocks of 3 on 2 ranks: blocks {0, 1} and {2}
        n_seen, doubled, losses = s["blocked"]
        frames = torch.arange(14.0).reshape(7, 2)
        assert torch.equal(doubled, frames * 2)
        torch.testing.assert_close(losses, frames.sum(0) / 7, rtol=1e-6,
                                   atol=0)
    assert [s["blocked"][0] for s in seen] == [6, 1]
    # make_mesh(1): rank 0's group; rank 1 is not a member
    assert [s["first"] for s in seen] == [(1, 0, 1.0), (1, -1, None)]


def test_data_parallel_step_matches_lemo_tpu(ranks, dp_setup):
    _, _, _, (p_ref, total_ref) = dp_setup
    outs = [r[1] for r in ranks]
    for out in outs:
        np.testing.assert_allclose(out["metrics"][0]["total"], total_ref,
                                   rtol=1e-5)
        for k, v in p_ref["enc"].items():
            np.testing.assert_allclose(out["params"]["enc"][k].numpy(), v,
                                       atol=1e-6, err_msg=k)
    # the replicas hold the same parameters after the step
    for k, v in outs[0]["params"]["dec"].items():
        assert torch.equal(v, outs[1]["params"]["dec"][k])


def test_frame_sharded_stage1_matches_lemo_tpu(ranks, stage1_setup):
    _, _, (x_ref, l_ref) = stage1_setup
    for r in ranks:
        out = r[2]
        assert out["x72"].shape == (T1, 72)
        np.testing.assert_allclose(out["losses"].numpy(), l_ref, rtol=1e-4)
        np.testing.assert_allclose(out["x72"].numpy(), x_ref, atol=1e-4)


def test_clip_sharded_stage2_matches(ranks, stage2_setup):
    """Against lemo_tpu's fold and the port's one-process fold (on the
    CPU the decode and the prior run as one batch, so a 2-clip shard
    rounds apart from the 4-clip fold; lemo_tpu's fold tolerances)."""
    args, data, (x_ref, l_ref) = stage2_setup
    x1, l1 = t_s2.make_temporal_fitter_batched(
        *args, num_steps=S2, device="cpu")(*data)
    for r in ranks:
        out = r[3]
        assert out["x72"].shape == (C, T2, 72)
        assert out["losses"].shape == (C, S2)
        for x, lo in ((x_ref, l_ref), (x1.numpy(), l1.numpy())):
            np.testing.assert_allclose(out["losses"].numpy(), lo,
                                       rtol=L_RTOL, atol=L_ATOL)
            np.testing.assert_allclose(out["x72"].numpy(), x, rtol=X_RTOL,
                                       atol=X_ATOL)
    assert torch.equal(ranks[0][3]["x72"], ranks[1][3]["x72"])


def test_dryrun_multichip_two_ranks():
    out = dryrun.dryrun_multichip(2, device="cpu")
    assert out["windows"] == 2
    assert all(np.isfinite(v) for v in out.values())


def test_a_failing_rank_fails_the_run(stage2_setup):
    """One clip on two ranks: each rank's clip_sharded_fit raises, and
    so does the spawn."""
    args, data, _ = stage2_setup
    with pytest.raises(Exception, match="1 clips on 2 ranks"):
        dryrun.spawn_ranks(2, dryrun.job_stage2, {
            "fitter_args": args, "fitter_kw": {"num_steps": 1,
                                               "device": "cpu"},
            "inputs": tuple(torch.as_tensor(a[:1]) for a in data)},
            device="cpu", threads=1, timeout=120)
