// Self-intersection cone energy with its gradients, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lemo_tpu/ops/intersection_pallas.py
// `_kernel` (one frame per call, lax.map over frames, all faces resident in
// VMEM, [256, 512] face-pair blocks, a Kahan-summed scalar energy and
// VMEM accumulators for the gradients). Here one launch takes every frame:
// the grid is (2 x tiles, frames) and a block of kTile threads owns one
// tile of kTile faces of one frame, one face per thread. The block walks
// every other tile of its frame in a loop and skips a tile pair when the
// two tiles' bounding spheres cannot overlap (exact: then every face pair
// of the two tiles fails the sphere gate); for a tile it keeps, the other
// tile's faces are staged in shared memory and every thread tests its face
// against each of them (all threads read the same entry: a broadcast).
//
// The energy of a pair needs a sum over both of its faces: dE/ds and dE/dn
// go to the cone owner i, dE/d(vertices) to the vertex supplier j. A block
// of the first half of the grid (row role) owns its faces as i and
// accumulates their energy (in f64), dE/dn, dE/ds and active-pair count;
// a block of the second half (column role) owns its faces as j and
// accumulates their dE/d(vertices). Every output element is written once
// by the thread that owns it: no atomics, no cross-block reduction, and
// the result is the same on every run (the PROX refits run under
// torch.use_deterministic_algorithms). The cost of that choice: every
// tested pair's gates are evaluated twice, once in each role.
//
// Arithmetic (ops/intersection.py's plain version and candidate scores
// repeat it op for op, so all three make the same gate decisions): every
// product and sum is a separately rounded f32 intrinsic (no FMA
// contraction), distances are differences then squares, and a dot product
// is (x*x' + y*y') + z*z'. For row face i and column face j:
//   gates: |c_i - c_j|^2 < (r_i + r_j)^2; both valid; no shared vertex id;
//     the part pair not ignored; min_a < 0 < max_a of depth_a =
//     s_i - n_i . v_a (v_a the vertices of j) and of s_j - n_j . u_a (u_a
//     the vertices of i);
//   phi_a = depth_a where depth_a > 0 and |v_a - c_i|^2 - depth_a^2 <
//     rad2_i, else 0; E += phi_a^2, dE/ds_i += 2 phi_a,
//     dE/dn_i -= 2 phi_a v_a, dE/dv_a -= 2 phi_a n_i.
//
// What bounds it: operations. Every pair of a kept tile pair costs the
// sphere gate, 11 f32 operations (3 sub, 3 mul, 2 add for the distance,
// 1 add and 1 mul for (r_i + r_j)^2, 1 compare); a pair past it 14 more
// (validity, adjacency, part), one past those 24 for each straddle test,
// and one past both 90 for the cone tests and the accumulation of both
// roles. The bytes are small: 80 bytes of face data and 16 of ids in, 64
// out, per face. chip_smoke.py counts the pairs by the gate they reach
// (ISECT_OPS) and divides the operations by the card's 67 TFLOP/s f32
// rate; on the H100 at the S3 window's [100, 9216] candidate subsets the
// kernel takes ~22x that bound. The design cuts the pairs with the tile
// skip (faces in face-id order keep a tile compact on the mesh: 56% of
// the pairs skipped there) and pays 2x for determinism (every tested
// pair's gates run once in each role); making it fast (several faces a
// thread, registers instead of shared memory for the staged tile, finer
// tiles, one role with a deterministic reduction of the column sums) is
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;   // faces per tile = threads per block
constexpr int kPack = 20;    // floats per face: c n s r rad2 valid tri pad
constexpr int kIPack = 4;    // ints per face: vertex ids (3), part id

struct Face {
  float c[3], n[3], s, r, rad2, valid, v[9];
  int id[3], seg;
};

__device__ __forceinline__ Face load_face(const float4* p, const int4* q) {
  Face f;
  const float4 a = p[0], b = p[1], c = p[2], d = p[3], e = p[4];
  f.c[0] = a.x; f.c[1] = a.y; f.c[2] = a.z;
  f.n[0] = a.w; f.n[1] = b.x; f.n[2] = b.y;
  f.s = b.z; f.r = b.w; f.rad2 = c.x; f.valid = c.y;
  f.v[0] = c.z; f.v[1] = c.w; f.v[2] = d.x; f.v[3] = d.y; f.v[4] = d.z;
  f.v[5] = d.w; f.v[6] = e.x; f.v[7] = e.y; f.v[8] = e.z;
  const int4 i = q[0];
  f.id[0] = i.x; f.id[1] = i.y; f.id[2] = i.z; f.seg = i.w;
  return f;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                   __fmul_rn(a[2], b[2]));
}

// phi[a]: face fi's cone field at the vertices of face fj. Returns false
// (phi untouched) when a gate fails.
__device__ __forceinline__ bool pair_phi(const Face& fi, const Face& fj,
                                         const unsigned char* ign, int P,
                                         float phi[3]) {
  const float dx = __fsub_rn(fi.c[0], fj.c[0]);
  const float dy = __fsub_rn(fi.c[1], fj.c[1]);
  const float dz = __fsub_rn(fi.c[2], fj.c[2]);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const float rs = __fadd_rn(fi.r, fj.r);
  if (!(d2 < __fmul_rn(rs, rs))) return false;
  if (!(fi.valid > 0.f) || !(fj.valid > 0.f)) return false;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (fi.id[p] == fj.id[q]) return false;
  if (ign != nullptr && ign[fi.seg * P + fj.seg]) return false;
  float dep[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) dep[a] = __fsub_rn(fi.s, dot3(fi.n, fj.v + 3 * a));
  if (!(fminf(fminf(dep[0], dep[1]), dep[2]) < 0.f &&
        fmaxf(fmaxf(dep[0], dep[1]), dep[2]) > 0.f))
    return false;
  float dr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) dr[a] = __fsub_rn(fj.s, dot3(fj.n, fi.v + 3 * a));
  if (!(fminf(fminf(dr[0], dr[1]), dr[2]) < 0.f &&
        fmaxf(fmaxf(dr[0], dr[1]), dr[2]) > 0.f))
    return false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float l[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) l[k] = __fsub_rn(fj.v[3 * a + k], fi.c[k]);
    const float lat2 = __fsub_rn(dot3(l, l), __fmul_rn(dep[a], dep[a]));
    phi[a] = (dep[a] > 0.f && lat2 < fi.rad2) ? dep[a] : 0.f;
  }
  return true;
}

__global__ void __launch_bounds__(kTile)
cone_energy_kernel(const float* __restrict__ pack,
                   const int* __restrict__ ipack,
                   const float* __restrict__ tiles,
                   const unsigned char* __restrict__ ign, int P,
                   double* __restrict__ e_out, float* __restrict__ rowgrad,
                   float* __restrict__ dtri, int* __restrict__ active,
                   int Kp, long long ipack_stride) {
  __shared__ float4 s_pack[kTile * kPack / 4];
  __shared__ int4 s_ipack[kTile];
  const int NT = Kp / kTile;
  const int t = blockIdx.y;
  const bool row_role = (int)blockIdx.x < NT;
  const int own = row_role ? blockIdx.x : blockIdx.x - NT;
  const long long k = (long long)t * Kp + (long long)own * kTile + threadIdx.x;
  const float4* P4 = reinterpret_cast<const float4*>(pack) +
                     (long long)t * Kp * (kPack / 4);
  const int4* I4 = reinterpret_cast<const int4*>(ipack) + (long long)t *
                   (ipack_stride / kIPack);
  const float* tl = tiles + (long long)t * NT * 4;
  const int me_i = own * kTile + threadIdx.x;
  const Face me = load_face(P4 + (long long)me_i * (kPack / 4), I4 + me_i);

  double e = 0.0;
  float ds = 0.f, dn[3] = {0.f, 0.f, 0.f};
  float dv[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int nact = 0;
  for (int u = 0; u < NT; ++u) {
    // the tile-pair test in (row tile, column tile) order, as tile_pairs
    const int ti = row_role ? own : u, tj = row_role ? u : own;
    const float dx = __fsub_rn(tl[4 * ti + 0], tl[4 * tj + 0]);
    const float dy = __fsub_rn(tl[4 * ti + 1], tl[4 * tj + 1]);
    const float dz = __fsub_rn(tl[4 * ti + 2], tl[4 * tj + 2]);
    const float lim = __fadd_rn(tl[4 * ti + 3], tl[4 * tj + 3]);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    if (!(d2 <= __fmul_rn(lim, lim))) continue;   // uniform over the block
    __syncthreads();   // the previous tile is no longer read
    const float4* src = P4 + (long long)u * kTile * (kPack / 4);
    for (int q = threadIdx.x; q < kTile * kPack / 4; q += kTile) s_pack[q] = src[q];
    s_ipack[threadIdx.x] = I4[(long long)u * kTile + threadIdx.x];
    __syncthreads();
    for (int jj = 0; jj < kTile; ++jj) {
      const Face o = load_face(s_pack + jj * (kPack / 4), s_ipack + jj);
      float phi[3];
      if (row_role) {
        if (!pair_phi(me, o, ign, P, phi)) continue;
        bool any = false;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float g = __fadd_rn(phi[a], phi[a]);
          e += (double)__fmul_rn(phi[a], phi[a]);
          ds = __fadd_rn(ds, g);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            dn[c] = __fsub_rn(dn[c], __fmul_rn(g, o.v[3 * a + c]));
          any = any || phi[a] > 0.f;
        }
        nact += any ? 1 : 0;
      } else {
        if (!pair_phi(o, me, ign, P, phi)) continue;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float g = __fadd_rn(phi[a], phi[a]);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            dv[3 * a + c] = __fsub_rn(dv[3 * a + c], __fmul_rn(g, o.n[c]));
        }
      }
    }
  }
  if (row_role) {
    e_out[k] = e;
    rowgrad[4 * k + 0] = dn[0];
    rowgrad[4 * k + 1] = dn[1];
    rowgrad[4 * k + 2] = dn[2];
    rowgrad[4 * k + 3] = ds;
    active[k] = nact;
  } else {
#pragma unroll
    for (int q = 0; q < 9; ++q) dtri[9 * k + q] = dv[q];
  }
}

}  // namespace

extern "C" {

// pack [T, Kp, 20] f32; ipack [T, Kp, 4] (ipack_batched) or [Kp, 4] int32;
// tiles [T, Kp / 128, 4] f32; ign [P, P] bytes or null; outputs e [T, Kp]
// f64, rowgrad [T, Kp, 4] (dn, ds), dtri [T, Kp, 9], active [T, Kp] int32.
// Kp must be a multiple of 128.
int lemo_cone_energy(const float* pack, const int* ipack, const float* tiles,
                     const unsigned char* ign, int P, double* e_out,
                     float* rowgrad, float* dtri, int* active, int T, int Kp,
                     int ipack_batched, void* stream) {
  if (T <= 0 || Kp <= 0) return 0;
  const dim3 grid(2 * (Kp / kTile), T);
  cone_energy_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
      pack, ipack, tiles, ign, P, e_out, rowgrad, dtri, active, Kp,
      ipack_batched ? (long long)Kp * kIPack : 0LL);
  return (int)cudaGetLastError();
}

}  // extern "C"
