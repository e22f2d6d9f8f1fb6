"""The port's self-intersection term (`lemo_tpu_torch.ops.intersection`)
against `lemo_tpu`'s on the CPU, where the port runs the kernel's plain
version and the JAX package its dense XLA sweep (or, for the kernel
itself, the Pallas kernel in interpret mode, as tests/
test_intersection_pallas.py runs it). Bodies are the small smooth-surface
synthetic model (536 vertices, 544 faces) in mild and strong contact.

Tolerances, as in tests/test_intersection_pallas.py:
- the plain version against `_cone_energy_call` on the same f32 face
  data: energy rel 1e-6, gradients 1e-6 of their scale (same inputs, so
  the gates decide alike and only summation order differs);
- the public API against the dense sweep: rel 3e-4, which admits a few
  borderline gate flips (the two packages round the face geometry
  differently: XLA's CPU backend contracts the cross product into FMAs);
- a candidate subset that covers the firing set against the full sweep
  of the same package: rel 1e-6.
The synthetic model and part segmentation must be bit-identical."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.body_model import load_model, make_forward_fn
from lemo_tpu.ops import intersection as xi
from lemo_tpu.ops import intersection_pallas as ip
from lemo_tpu.testing import synthetic as j_syn
from lemo_tpu_torch.ops import intersection as ti
from lemo_tpu_torch.ops import intersection_cuda
from lemo_tpu_torch.testing import synthetic as t_syn

torch.set_num_threads(2)

GATE_RTOL = 3e-4


@pytest.fixture(scope="module")
def bodies():
    """Three posed frames [3, V, 3] of the smooth-surface model and its
    faces; frame 0 is the mild-contact pose."""
    md = j_syn.synthetic_smplx_npz(smooth_surface=True)
    model = load_model(md, use_pca=True, num_pca_comps=12)
    fwd = jax.jit(make_forward_fn(model))
    p = dict(model.zero_params(3))
    rng = np.random.RandomState(3)
    pose = rng.randn(3, 63) * np.array([[0.35], [0.7], [0.9]])
    p["body_pose"] = jnp.asarray(pose, jnp.float32)
    verts = np.asarray(fwd(p, model.consts)["vertices"])
    return verts, md["f"].astype(np.int64), md


def _face_inputs(v, f):
    """The JAX package's per-face kernel inputs for one recentred body."""
    vj = jnp.asarray(v) - jnp.asarray(v).mean(axis=0)
    c, n, r = xi.face_geometry(vj, jnp.asarray(f, jnp.int32))
    return dict(s=(c * n).sum(-1), n=n, tri=vj[f], c=c, r=r,
                rad2=(0.5 * r) ** 2)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _part_bits(seg, tab):
    weights = (tab.astype(np.int64) * (1 << np.arange(tab.shape[0]))).sum(1)
    return weights[seg]


@pytest.mark.parametrize("full_size", [False, True])
def test_smooth_surface_model_is_bit_identical(full_size):
    ref = j_syn.synthetic_smplx_npz(smooth_surface=True, full_size=full_size)
    out = t_syn.synthetic_smplx_npz(smooth_surface=True, full_size=full_size)
    assert out.keys() == ref.keys() and "face_parts" in out
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_part_table_and_segm_pkl_are_bit_identical(bodies):
    for a, b in zip(t_syn.compact_part_table(), j_syn.compact_part_table()):
        np.testing.assert_array_equal(a, b)
    _, f, _ = bodies
    d = tempfile.mkdtemp()
    out = t_syn.write_part_segm_pkl(os.path.join(d, "t.pkl"), f, 27)
    ref = j_syn.write_part_segm_pkl(os.path.join(d, "j.pkl"), f, 27)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])
    with open(os.path.join(d, "t.pkl"), "rb") as fh:
        a = fh.read()
    with open(os.path.join(d, "j.pkl"), "rb") as fh:
        assert fh.read() == a


def test_face_geometry_matches_jax(bodies):
    """Centroids, unit normals and radii to two or three f32 ulps: the
    port rounds every product and sum on its own, in the kernel's order,
    where XLA contracts the cross product into FMAs and sums the mean in
    its own order, so equality to the bit is not to be had (measured:
    at most 2.4e-7)."""
    verts, f, _ = bodies
    for t in range(3):
        ref = xi.face_geometry(jnp.asarray(verts[t]),
                               jnp.asarray(f, jnp.int32))
        out = ti.face_geometry(_t(verts[t]), _t(f))
        for name, a, b in zip("cnr", out, ref):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 3e-7, name
    # batched over frames, shared and per-frame faces give the same
    out_b = ti.face_geometry(_t(verts), _t(f))
    out_p = ti.face_geometry(_t(verts), _t(f)[None].expand(3, -1, -1))
    for a, b, c in zip(out, out_b, out_p):
        np.testing.assert_array_equal(a.numpy(), b[2].numpy())
        np.testing.assert_array_equal(b.numpy(), c.numpy())


@pytest.mark.parametrize("parents", [False, True])
def test_build_face_filter_matches_jax(bodies, parents):
    _, f, md = bodies
    seg = md["face_parts"] % 30
    par = (seg + 1) % 30 if parents else None
    pairs = ["9,16", "9,17", "6,16", "1,2", "12,22", "40,1"]
    ref = xi.build_face_filter(f, seg, pairs, par)
    out = ti.build_face_filter(f, seg, pairs, par)
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(out[k], ref[k])


@pytest.mark.parametrize("parts", [False, True])
def test_plain_matches_pallas_kernel(bodies, parts):
    """(E, ds, dn, dtri) of the plain version against the Pallas kernel
    (interpret mode) on the same f32 face data, with and without the part
    bits."""
    verts, f, _ = bodies
    d = _face_inputs(verts[1], f)
    F = f.shape[0]
    seg = np.zeros(F, np.int32)
    bits = np.zeros(F, np.int32)
    tab = None
    if parts:
        seg = np.random.RandomState(0).randint(0, 27, size=F).astype(np.int32)
        tab = np.zeros((27, 27), bool)
        for a, b in [(3, 7), (7, 3), (1, 1), (20, 25), (25, 20)]:
            tab[a, b] = True
        bits = _part_bits(seg, tab).astype(np.int32)
    ref = ip._cone_energy_call(d["s"], d["n"], d["tri"], d["c"], d["r"],
                               d["rad2"], jnp.asarray(f, jnp.int32),
                               jnp.asarray(bits), jnp.asarray(seg),
                               jnp.ones((F,), jnp.float32))
    out = ti.cone_energy_parts(
        *(_t(d[k])[None] for k in ("s", "n", "tri", "c", "r", "rad2")),
        _t(f), seg=_t(seg) if parts else None,
        ign_table=_t(tab) if parts else None)
    E = float(ref[0])
    assert E > 0
    assert abs(float(out[0][0]) - E) <= 1e-6 * E
    for got, want in zip(out[1:4], ref[1:]):
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(got[0].numpy() - want).max() <= 1e-6 * scale
    assert int(out[4][0]) > 0


@pytest.fixture(scope="module")
def dense(bodies):
    """The JAX package's dense energy of each frame (its CPU path)."""
    verts, f, _ = bodies
    return np.asarray(xi.batched_self_intersection(
        jnp.asarray(verts), jnp.asarray(f, jnp.int32)))


@pytest.mark.parametrize("path", ["full", "candidates"])
def test_public_api_matches_dense(bodies, dense, path):
    verts, f, _ = bodies
    ids = None
    if path == "candidates":
        # per frame, every face on a pair within 1 cm of firing, in
        # face-id order (5 cm covers every face of this small body)
        scores, counts = ti.intersection_candidate_scores_batched(
            _t(verts), _t(f), margin=0.01)
        K = int(counts[:, 1].max())
        assert K < f.shape[0]
        ids = torch.sort(torch.argsort(scores, dim=1)[:, :K], dim=1).values
    out = ti.batched_self_intersection(_t(verts), _t(f), candidate_ids=ids)
    assert (dense > 0).all()
    np.testing.assert_allclose(out.numpy(), dense, rtol=GATE_RTOL)


def test_large_part_table_matches_dense(bodies):
    """P = 40 parts: the JAX package's Pallas path stops at 32 and falls
    back to the dense sweep; the port reads any [P, P] table."""
    verts, f, _ = bodies
    F = f.shape[0]
    segm = np.random.RandomState(4).randint(0, 40, size=F)
    tab = np.zeros((40, 40), bool)
    tab[np.random.RandomState(5).rand(40, 40) < 0.3] = True
    tab |= tab.T
    ref = xi.self_intersection_loss(jnp.asarray(verts[2]),
                                    jnp.asarray(f, jnp.int32),
                                    segm=jnp.asarray(segm, jnp.int32),
                                    ign_table=jnp.asarray(tab))
    out = ti.batched_self_intersection(_t(verts[2:3]), _t(f),
                                       segm=_t(segm), ign_table=_t(tab))
    full = ti.batched_self_intersection(_t(verts[2:3]), _t(f))
    assert 0 < float(out[0]) < float(full[0])
    np.testing.assert_allclose(float(out[0]), float(ref), rtol=GATE_RTOL)


def _oracle_energy(s, n, tri, c, r, rad2, fid):
    """Straightforward autograd energy in f64: every pair of one frame,
    the gates from the port's own gate arithmetic on the detached f32
    inputs (so they decide as the plain version does), phi = s - n . v
    differentiated by autograd."""
    with torch.no_grad():
        rows = [x[:, None] for x in (c, r, n, s, tri.reshape(-1, 9))]
        cols = [x[None] for x in (c, r, n, s, tri.reshape(-1, 9))]
        d2, rsum, depth, lat2, rdep = ti._pair_geometry(*rows, *cols)
        m = (d2 < rsum * rsum) & ~ti._adjacent(fid, fid)
        m &= (ti._min3(depth) < 0) & (ti._max3(depth) > 0)
        m &= (ti._min3(rdep) < 0) & (ti._max3(rdep) > 0)
    E = 0.0
    for a in range(3):
        v = tri[:, a].double()
        dep = s.double()[:, None] - n.double() @ v.T
        act = m & (depth[a] > 0) & (lat2[a] < rad2[:, None])
        E = E + torch.where(act, dep, torch.zeros_like(dep)).pow(2).sum()
    return E


def test_gradients_match_autograd_oracle(bodies):
    """The Function's hand-written backward against autograd of the
    oracle energy, with respect to the face data and, through the face
    geometry, the vertices."""
    verts, f, _ = bodies
    v = _t(verts[1]).requires_grad_(True)
    tri = ti.face_triangles(v - v.mean(0).detach(), _t(f))
    c, n, r = ti.triangle_geometry(tri)
    s = ti._dot3(c, n)
    rad2 = (0.5 * r) ** 2
    leaves = (s, n, tri)
    E = ti.ConeEnergy.apply(s[None], n[None], tri[None], c[None], r[None],
                            rad2[None], _t(f), None, None)
    g = torch.autograd.grad(E.sum() * 2.0, leaves + (v,), retain_graph=True)
    Eo = _oracle_energy(s, n, tri, c, r, rad2, _t(f))
    go = torch.autograd.grad(Eo * 2.0, leaves + (v,))
    assert abs(float(E[0]) - float(Eo)) <= 1e-6 * float(Eo)
    for a, b in zip(g, go):
        b = b.double()
        scale = max(float(b.abs().max()), 1e-12)
        assert float((a.double() - b).abs().max()) <= 1e-5 * scale


def test_candidate_scores_match_jax(bodies):
    verts, f, _ = bodies
    fj = jnp.asarray(f, jnp.int32)
    scores, counts = ti.intersection_candidate_scores_batched(
        _t(verts), _t(f), margin=0.01)
    for t in range(3):
        sc, c = xi.intersection_candidate_scores(jnp.asarray(verts[t]), fj,
                                                 margin=0.01)
        np.testing.assert_array_equal(counts[t].numpy(), np.asarray(c))
        np.testing.assert_allclose(scores[t].numpy(), np.asarray(sc),
                                   rtol=1e-4, atol=2e-5)
    assert 0 < int(counts[0, 0]) < int(counts[0, 1]) < f.shape[0]


def test_margin0_subset_reproduces_full_energy(bodies):
    """Candidates from the same geometry at margin 0 cover every firing
    face, so the subset energy equals the full sweep (the refresh-time
    contract), at K = n_active and with extra faces."""
    verts, f, _ = bodies
    tv, tf = _t(verts), _t(f)
    full = ti.batched_self_intersection(tv, tf)
    scores, counts = ti.intersection_candidate_scores_batched(tv, tf,
                                                              margin=0.0)
    assert (counts[:, 0] == counts[:, 1]).all()
    order = torch.argsort(scores, dim=1)
    n_act = int(counts[:, 0].max())
    for K in (n_act, n_act + 37):
        ids = torch.sort(order[:, :K], dim=1).values
        sub = ti.batched_self_intersection(tv, tf, candidate_ids=ids)
        np.testing.assert_allclose(sub.numpy(), full.numpy(), rtol=1e-6,
                                   err_msg=f"K={K}")


def test_cpu_tensors_never_reach_the_kernel(bodies):
    verts, f, _ = bodies
    before = intersection_cuda.launches["intersection"]
    ti.batched_self_intersection(_t(verts[:1]), _t(f))
    assert intersection_cuda.launches["intersection"] == before
    pack, ipack, tiles = ti.pack_faces(
        torch.zeros(1, 5), torch.zeros(1, 5, 3), torch.zeros(1, 5, 3, 3),
        torch.zeros(1, 5, 3), torch.zeros(1, 5), torch.zeros(1, 5),
        torch.zeros(5, 3, dtype=torch.int64))
    assert pack.shape == (1, ti.TILE, ti.PACK) and ipack.shape[0] == 1
    with pytest.raises(ValueError, match="CUDA"):
        intersection_cuda.cone_energy_kernel(pack, ipack, tiles, None)


def _may_touch(a, b):
    """csrc/intersection.cu's culls in plain PyTorch: may the spheres a and
    b ([..., 4]: centre, radius) overlap, with the radius sum widened by
    2^-16, in the kernel's rounding."""
    lim = (a[..., 3] + b[..., 3]) * (1.0 + 2.0 ** -16)
    dx, dy, dz = (a[..., k] - b[..., k] for k in range(3))
    return (dx * dx + dy * dy) + dz * dz <= lim * lim


def _operands_on_path(bodies, path):
    verts, f, _ = bodies
    ids = None
    if path == "candidates":
        scores, counts = ti.intersection_candidate_scores_batched(
            _t(verts), _t(f), margin=0.01)
        K = int(counts[:, 1].max())
        ids = torch.sort(torch.argsort(scores, dim=1)[:, :K], dim=1).values
    return ti.kernel_operands(_t(verts), _t(f), candidate_ids=ids)


def _dense_sphere_pairs(pack):
    """Every pair of valid faces of each frame past the sphere gate, with
    no culling, in the kernel's rounding: flat row and column indices into
    pack.reshape(-1, PACK)."""
    T, Kp, _ = pack.shape
    c, r = pack[..., 0:3], pack[..., 7]
    dx, dy, dz = (c[:, :, None, k] - c[:, None, :, k] for k in range(3))
    rsum = r[:, :, None] + r[:, None, :]
    valid = pack[..., 9] > 0
    hit = ((dx * dx + dy * dy) + dz * dz < rsum * rsum) \
        & valid[:, :, None] & valid[:, None, :]
    t, i, j = hit.nonzero(as_tuple=True)
    return t * Kp + i, t * Kp + j


@pytest.mark.parametrize("path", ["full", "candidates"])
def test_kernel_culls_are_exact(bodies, path):
    """Every pair of valid faces past the sphere gate, found by a sweep of
    all K x K pairs of each frame with no culling, lies in a run pair the
    kernel keeps and in a run whose faces reach the other run's sphere,
    so the kernel's skips drop only pairs that fail the sphere gate or
    the validity gate (padding faces have no radius and are left out of
    their run's sphere)."""
    pack, _, runs, _ = _operands_on_path(bodies, path)
    T, Kp, _ = pack.shape
    run = intersection_cuda.RUN
    assert runs.shape == (T, Kp // run, 4)
    torch.testing.assert_close(runs, ti.tile_spheres(pack, run), rtol=0,
                               atol=0)
    keep = _may_touch(runs[:, :, None], runs[:, None, :])
    assert bool((keep == keep.transpose(1, 2)).all())
    spheres = torch.cat([pack[..., 0:3], pack[..., 7:8]], -1).reshape(-1, 4)
    i, j = _dense_sphere_pairs(pack)
    t, W, J = i // Kp, (i % Kp) // run, (j % Kp) // run
    assert bool(keep[t, W, J].all())
    assert bool(_may_touch(spheres[j], runs[t, W]).all())
    # the culls skip something: run pairs, and whole runs for some faces
    assert int(keep.sum()) < keep.numel()
    face_run = _may_touch(spheres.reshape(T, Kp, 1, 4), runs[:, None])
    assert not bool(face_run.all())


def test_gates_are_symmetric_but_the_cone(bodies):
    """The kernel evaluates the gates of a pair once for both directions:
    validity and adjacency agree in both orders, the forward straddle
    test of (i, j) is the reverse one of (j, i) and its depths are (j,
    i)'s forward depths bit for bit; only the cone test differs."""
    verts, f, md = bodies
    seg = _t(md["face_parts"] % 27)
    pack, ipack, _, _ = ti.kernel_operands(_t(verts), _t(f), segm=seg,
                                           ign_table=torch.ones(27, 27,
                                                                dtype=bool))
    T, Kp, _ = pack.shape
    flat = pack.reshape(T * Kp, ti.PACK)
    idx = ipack.expand(T, -1, -1).reshape(T * Kp, 4)
    i, j = next(ti.sphere_pairs(pack))
    m1, fwd1, rev1, dep1, _ = ti.pair_gates(flat[i], flat[j], idx[i], idx[j])
    m2, fwd2, rev2, dep2, _ = ti.pair_gates(flat[j], flat[i], idx[j], idx[i])
    assert torch.equal(m1, m2) and torch.equal(fwd1, rev2) \
        and torch.equal(rev1, fwd2)
    _, _, _, _, rdep1 = ti._pair_geometry(
        flat[i, 0:3], flat[i, 7], flat[i, 3:6], flat[i, 6], flat[i, 10:19],
        flat[j, 0:3], flat[j, 7], flat[j, 3:6], flat[j, 6], flat[j, 10:19])
    for a, b in zip(rdep1, dep2):
        assert torch.equal(a, b)
    assert bool(m1.any() & fwd1.any())


@pytest.mark.parametrize("run", [16, 32, 128])
@pytest.mark.parametrize("path", ["full", "candidates"])
def test_sphere_pairs_are_exact_at_any_run_length(bodies, path, run):
    """The plain version's culled sphere gate (`sphere_pairs`, which the
    plain cone energy and the bound's pair counts run) yields exactly the
    pairs of valid faces that an uncut K x K sweep passes, whatever the
    run length it culls with."""
    pack, _, _, _ = _operands_on_path(bodies, path)
    valid = pack.reshape(-1, ti.PACK)[:, 9] > 0
    got = []
    for i, j in ti.sphere_pairs(pack, run):
        both = valid[i] & valid[j]
        got.append(torch.stack([i[both], j[both]], 1))
    got = torch.cat(got)
    want = torch.stack(_dense_sphere_pairs(pack), 1)
    assert got.shape == want.shape and want.shape[0] > 0
    key = pack.shape[0] * pack.shape[1]
    assert torch.equal(torch.sort(got[:, 0] * key + got[:, 1]).values,
                       torch.sort(want[:, 0] * key + want[:, 1]).values)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(bodies):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    verts, f, md = bodies
    d = {k: _t(x).cuda() for k, x in _face_inputs(verts[2], f).items()}
    seg = torch.as_tensor(md["face_parts"] % 27, device="cuda")
    tab = torch.rand(27, 27, generator=torch.Generator().manual_seed(0)) < 0.2
    packs = ti.pack_faces(*(d[k][None] for k in
                            ("s", "n", "tri", "c", "r", "rad2")),
                          _t(f).cuda(), seg)
    ign = tab.cuda()
    got = intersection_cuda.cone_energy_kernel(*packs, ign)
    again = intersection_cuda.cone_energy_kernel(*packs, ign)
    ke, kg, kt, ka = got
    pe, pg, pt, pa = ti.cone_energy_plain(*packs, ign)
    # repeat launches give the same bits (no atomics, a fixed order)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert abs(float(ke.sum() - pe.sum())) <= 1e-6 * float(pe.sum())
    assert torch.equal(ka, pa)
    for a, b in ((kg, pg), (kt, pt)):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1.0)
