"""The port's scene ops against `lemo_tpu`'s on the CPU: SDF sampling in
the f32, bf16 and fp8 modes (values equal to the JAX samplers' at atol
1e-6, border and out-of-grid points included), z-buffer visibility
(masks equal) and vertex normals (atol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lemo_tpu.ops import sdf as j_sdf
from lemo_tpu.ops import visibility as j_vis
from lemo_tpu_torch.ops import sdf as t_sdf
from lemo_tpu_torch.ops import visibility as t_vis

torch.set_num_threads(2)

_PACK = {"f32": (lambda g: g, False),
         "bf16": (j_sdf.pack_grid_bf16, True),
         "fp8": (j_sdf.pack_grid_fp8_quad, "fp8")}


def _grid(dim, seed):
    rng = np.random.RandomState(seed)
    g = rng.randn(*dim).astype(np.float32) * 0.5
    # a smooth part so that neighbours correlate, as a scene SDF does
    z = np.linspace(-1.0, 3.0, dim[2], dtype=np.float32)
    return g + z[None, None, :]


def _points(n, lo, hi, seed):
    """Points spread 20% beyond the grid on every side, plus its corners."""
    rng = np.random.RandomState(seed)
    span = hi - lo
    pts = lo - 0.2 * span + rng.rand(n, 3) * 1.4 * span
    corners = np.array([[a, b, c] for a in (lo[0], hi[0])
                        for b in (lo[1], hi[1]) for c in (lo[2], hi[2])])
    return np.concatenate([pts, corners]).astype(np.float32)


@pytest.mark.parametrize("mode", ["f32", "bf16", "fp8"])
@pytest.mark.parametrize("dims,crop", [((24, 20, 28), 128),
                                       ((24, 20, 28), None),
                                       ((132, 130, 136), 128)])
def test_sample_sdf_world_matches_jax(mode, dims, crop):
    grid = _grid(dims, 0)
    lo = np.array([-3.0, -2.0, -1.0], np.float32)
    hi = np.array([3.0, 3.5, 3.0], np.float32)
    if crop is not None and min(dims) > crop:
        # a body-sized cluster (the crop window covers its bbox) plus a
        # few points far outside, which clamp to the window's border
        pts = np.concatenate([
            _points(300, lo + 1.0, lo + 3.0, 1),
            _points(20, lo, hi, 2)]).astype(np.float32)
    else:
        pts = _points(400, lo, hi, 1)
    pack, packed = _PACK[mode]
    ref = j_sdf.sample_sdf_world(jnp.asarray(pack(grid)), jnp.asarray(pts),
                                 jnp.asarray(lo), jnp.asarray(hi),
                                 crop=crop, packed=packed)
    q = t_sdf.quantize_grid(torch.as_tensor(grid), mode)
    out = t_sdf.sample_sdf_world(q, torch.as_tensor(pts),
                                 torch.as_tensor(lo), torch.as_tensor(hi),
                                 crop=crop, mode=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["bf16", "fp8"])
def test_quantized_grid_equals_packed_values(mode):
    """quantize_grid holds exactly the values the JAX packers store."""
    grid = _grid((6, 7, 8), 3)
    q = t_sdf.quantize_grid(torch.as_tensor(grid), mode).numpy()
    if mode == "bf16":
        lo = (j_sdf.pack_grid_bf16(grid) & 0xFFFF).astype(np.uint32) << 16
        ref = lo.view(np.float32)
    else:
        b = (j_sdf.pack_grid_fp8_quad(grid) & 0xFF).astype(np.uint8)
        ref = np.asarray(jnp.asarray(b).view(jnp.float8_e4m3fn)
                         .astype(jnp.float32))
    np.testing.assert_array_equal(q, ref)


def test_sdf_gradient_flows_to_points():
    grid = _grid((10, 10, 10), 4)
    lo = np.zeros(3, np.float32)
    hi = np.ones(3, np.float32)
    pts = torch.tensor(_points(50, lo + 0.1, hi - 0.1, 5)[:50],
                       requires_grad=True)
    t_sdf.sample_sdf_world(torch.as_tensor(grid), pts, torch.as_tensor(lo),
                           torch.as_tensor(hi)).sum().backward()
    assert torch.isfinite(pts.grad).all() and pts.grad.abs().sum() > 0


def _body(seed, T, V, F):
    rng = np.random.RandomState(seed)
    verts = (rng.randn(T, V, 3) * [0.25, 0.5, 0.15]
             + [0.1, 0.2, 2.5]).astype(np.float32)
    verts[:, :5, 2] = -1.0                        # behind the camera
    faces = rng.randint(0, V, size=(F, 3)).astype(np.int64)
    return verts, faces


@pytest.mark.parametrize("with_normals", [False, True])
def test_visibility_zbuffer_matches_jax(with_normals):
    T, V = 4, 600
    verts, faces = _body(0, T, V, 1100)
    verts[1, 100:110] = [[9.0, 0.0, 2.0]] * 10    # out of the image
    fx, fy, cx, cy = 1060.53, 1060.38, 951.3, 536.77
    tv = torch.as_tensor(verts)
    tn = (t_vis.vertex_normals(tv, torch.as_tensor(faces))
          if with_normals else None)
    out = t_vis.visibility_zbuffer(tv, fx, fy, cx, cy, normals=tn)
    for t in range(T):
        jn = (j_vis.vertex_normals(jnp.asarray(verts[t]), jnp.asarray(faces))
              if with_normals else None)
        ref = j_vis.visibility_zbuffer(jnp.asarray(verts[t]), fx, fy, cx,
                                       cy, normals=jn)
        np.testing.assert_array_equal(out[t].numpy(), np.asarray(ref))
        single = t_vis.visibility_zbuffer(
            tv[t], fx, fy, cx, cy, normals=None if tn is None else tn[t])
        np.testing.assert_array_equal(single.numpy(), np.asarray(ref))
    assert 0 < int(out.sum()) < T * V


def test_vertex_normals_match_jax():
    verts, faces = _body(1, 3, 300, 560)
    out = t_vis.vertex_normals(torch.as_tensor(verts), torch.as_tensor(faces))
    for t in range(3):
        ref = j_vis.vertex_normals(jnp.asarray(verts[t]), jnp.asarray(faces))
        np.testing.assert_allclose(out[t].numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
