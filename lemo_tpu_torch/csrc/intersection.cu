// Self-intersection cone energy with its gradients, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lemo_tpu/ops/intersection_pallas.py
// `_kernel` (one frame per call, lax.map over frames, all faces resident in
// VMEM, [256, 512] face-pair blocks, a Kahan-summed scalar energy and
// VMEM accumulators for the gradients). Here one launch takes every frame:
// the grid is (Kp / kTile, frames), a block is kWarps independent warps,
// and a warp owns one run of 32 consecutive faces of one frame, one face a
// lane, in both roles: as cone owner (energy, dE/dn, dE/ds, active pairs)
// and as vertex supplier (dE/d(vertices)).
//
// What bounds it: not bytes (80 bytes of face data and 16 of ids in, 64
// out, per face) but gate tests on face pairs, nearly all of which fail,
// and the latency of the chain each warp walks per kept run pair.
// chip_smoke.py phase 7 counts the unordered pairs by the gate they reach
// on a culling of its own (32-face runs, ISECT_BOUND_RUN), charges the
// symmetric gates once a pair and the cone field once a direction
// (ISECT_OPS), and divides by the card's 67 TFLOP/s f32 rate; on an H100
// at 700 W the kernel stands at 18-20x that bound at the S3 path's
// [100, K] shapes and 65-75x at full F on 4 frames (PERF.md section 6).
// Measured there: running the sphere gate twice costs nothing and running
// the narrow gates twice adds 29%, so the narrow phase's issue and the
// warps' load latency bound it; capping registers at 64 for more resident
// warps spills and is 15% slower.
//
// Three levers keep the tested pairs few and the lanes busy (PERF.md
// section 6 has what each gave, measured against builds without it):
//
// 1. Finer culling. Every run has a bounding sphere (`runs`, from
//    ops/intersection.py:tile_spheres at 32 faces). A warp tests its
//    run's sphere against 32 other runs at once (one a lane, a ballot),
//    then, for each run J it keeps, skips J when no face of J can reach
//    its run's sphere (`__any_sync`). Both culls are conservative (kSlack
//    widens them by 2^-16 of the radius sum) and so exact: a pair they
//    skip fails the sphere gate, or holds a padding face (valid 0, left
//    out of its run's sphere). Only c and r of J's faces are staged
//    (one float4 a face in shared memory, read as a broadcast by an
//    unrolled loop over all 32), and the rest of a face is loaded only
//    for pairs past the sphere gate.
// 2. A dense-warp narrow phase. The sphere gate gives each lane a 32-bit
//    mask of the faces of J its face overlaps; a warp prefix sum of their
//    popcounts places the passing (own, other) pairs in a shared-memory
//    queue (1,024 entries: one run pair can fill it, never more), ordered
//    by owner then partner. The rest of the gates and the cone field then
//    run with one queued pair a lane, every lane busy. The few pairs with
//    energy are passed to their owner lane by shuffles, in queue order.
// 3. One visit per (owner, partner). Every gate but the cone test is
//    symmetric in (i, j) (the sphere gate, validity, adjacency, both
//    straddle tests; the part table is read in both orders), so a visit
//    evaluates them once and gets both directions' cone fields: i's cone
//    at j's vertices (i's energy, dE/dn, dE/ds) and j's cone at i's
//    vertices (dE/d(i's vertices)). Every output is summed and written by
//    the lane that owns it, in a fixed order (runs in order, then the
//    queue's order): no atomics, and repeat launches give the same bits
//    (the PROX refits run under torch.use_deterministic_algorithms). Each
//    unordered pair is visited twice, once from each face's warp: one
//    visit per unordered pair would need the partner's sums to cross
//    warps, through records whose number is known only after the launch,
//    or atomics.
//
// Arithmetic (ops/intersection.py's plain version and candidate scores
// repeat it op for op, so all three make the same gate decisions): every
// product and sum is a separately rounded f32 intrinsic (no FMA
// contraction), distances are differences then squares, and a dot product
// is (x*x' + y*y') + z*z'. For cone owner i and vertex supplier j:
//   gates: |c_i - c_j|^2 < (r_i + r_j)^2; both valid; no shared vertex id;
//     the part pair (seg_i, seg_j) not ignored; min_a < 0 < max_a of
//     depth_a = s_i - n_i . v_a (v_a the vertices of j) and of
//     s_j - n_j . u_a (u_a the vertices of i);
//   phi_a = depth_a where depth_a > 0 and |v_a - c_i|^2 - depth_a^2 <
//     rad2_i, else 0; E += phi_a^2, dE/ds_i += 2 phi_a,
//     dE/dn_i -= 2 phi_a v_a, dE/dv_a -= 2 phi_a n_i.
//
// Resources (`nvcc -Xptxas -v`, CUDA 12.8, sm_90a): 80 registers, no
// spills, 10,240 bytes of static shared memory a block: per warp the
// 1,024-entry queue of 16-bit pair indices and 32 staged float4 spheres.

#include <cuda_runtime.h>

namespace {

constexpr int kRun = 32;               // faces per run = lanes per warp
constexpr int kWarps = 4;              // warps (runs) per block
constexpr int kTile = kRun * kWarps;   // faces per block; Kp is a multiple
constexpr int kPack = 20;    // floats per face: c n s r rad2 valid tri pad
constexpr int kIPack = 4;    // ints per face: vertex ids (3), part id
constexpr unsigned kAll = 0xffffffffu;
constexpr float kSlack = 1.0f + 1.0f / 65536.0f;   // widens the culls

struct Face {
  float c[3], n[3], s, r, rad2, valid, v[9];
  int id[3], seg;
};

__device__ __forceinline__ Face load_face(const float4* p, const int4* q) {
  Face f;
  const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2),
               d = __ldg(p + 3), e = __ldg(p + 4);
  f.c[0] = a.x; f.c[1] = a.y; f.c[2] = a.z;
  f.n[0] = a.w; f.n[1] = b.x; f.n[2] = b.y;
  f.s = b.z; f.r = b.w; f.rad2 = c.x; f.valid = c.y;
  f.v[0] = c.z; f.v[1] = c.w; f.v[2] = d.x; f.v[3] = d.y; f.v[4] = d.z;
  f.v[5] = d.w; f.v[6] = e.x; f.v[7] = e.y; f.v[8] = e.z;
  const int4 i = __ldg(q);
  f.id[0] = i.x; f.id[1] = i.y; f.id[2] = i.z; f.seg = i.w;
  return f;
}

// a face's centroid and bounding radius (x, y, z, r)
__device__ __forceinline__ float4 load_sphere(const float4* p) {
  const float4 a = __ldg(p), b = __ldg(p + 1);
  return make_float4(a.x, a.y, a.z, b.w);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                   __fmul_rn(a[2], b[2]));
}

__device__ __forceinline__ float dist2(const float4& a, const float4& b) {
  const float dx = __fsub_rn(a.x, b.x);
  const float dy = __fsub_rn(a.y, b.y);
  const float dz = __fsub_rn(a.z, b.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// the culls: may a face or run sphere a reach b? (conservative)
__device__ __forceinline__ bool may_touch(const float4& a, const float4& b) {
  const float lim = __fmul_rn(__fadd_rn(a.w, b.w), kSlack);
  return dist2(a, b) <= __fmul_rn(lim, lim);
}

// straddle test: some depth below 0 and some above
__device__ __forceinline__ bool straddles(const float d[3]) {
  return fminf(fminf(d[0], d[1]), d[2]) < 0.f &&
         fmaxf(fmaxf(d[0], d[1]), d[2]) > 0.f;
}

// phi[a]: the cone field of face f at the vertices v of the other face,
// whose depths in f's cone are dep; true when any phi is > 0
__device__ __forceinline__ bool cone(const Face& f, const float* v,
                                     const float dep[3], float phi[3]) {
  bool any = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float l[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) l[k] = __fsub_rn(v[3 * a + k], f.c[k]);
    const float lat2 = __fsub_rn(dot3(l, l), __fmul_rn(dep[a], dep[a]));
    phi[a] = (dep[a] > 0.f && lat2 < f.rad2) ? dep[a] : 0.f;
    any = any || phi[a] > 0.f;
  }
  return any;
}

// The gates past the sphere gate of the pair (i, j), evaluated once for
// both directions: pij is i's cone at j's vertices, pji j's cone at i's.
// Returns bit 0 when i -> j has energy and bit 1 when j -> i has.
__device__ __forceinline__ int pair_both(const Face& fi, const Face& fj,
                                         const unsigned char* ign, int P,
                                         float pij[3], float pji[3]) {
  if (!(fi.valid > 0.f) || !(fj.valid > 0.f)) return 0;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (fi.id[p] == fj.id[q]) return 0;
  bool ok_ij = true, ok_ji = true;
  if (ign != nullptr) {
    ok_ij = !__ldg(ign + fi.seg * P + fj.seg);
    ok_ji = !__ldg(ign + fj.seg * P + fi.seg);
    if (!ok_ij && !ok_ji) return 0;
  }
  float dep[3], dr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) dep[a] = __fsub_rn(fi.s, dot3(fi.n, fj.v + 3 * a));
  if (!straddles(dep)) return 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) dr[a] = __fsub_rn(fj.s, dot3(fj.n, fi.v + 3 * a));
  if (!straddles(dr)) return 0;
  int act = 0;
  if (ok_ij && cone(fi, fj.v, dep, pij)) act |= 1;
  if (ok_ji && cone(fj, fi.v, dr, pji)) act |= 2;
  return act;
}

__global__ void __launch_bounds__(kTile)
cone_energy_kernel(const float* __restrict__ pack,
                   const int* __restrict__ ipack,
                   const float* __restrict__ runs,
                   const unsigned char* __restrict__ ign, int P,
                   double* __restrict__ e_out, float* __restrict__ rowgrad,
                   float* __restrict__ dtri, int* __restrict__ active,
                   int Kp, long long ipack_stride) {
  __shared__ unsigned short s_queue[kWarps][kRun * kRun];
  __shared__ float4 s_sph[kWarps][kRun];
  const int lane = threadIdx.x & (kRun - 1);
  const int wid = threadIdx.x / kRun;
  unsigned short* queue = s_queue[wid];
  float4* sph = s_sph[wid];
  const int t = blockIdx.y;
  const int NR = Kp / kRun;
  const int W = blockIdx.x * kWarps + wid;   // the warp's own run
  const float4* P4 = reinterpret_cast<const float4*>(pack) +
                     (long long)t * Kp * (kPack / 4);
  const int4* I4 = reinterpret_cast<const int4*>(ipack) + (long long)t *
                   (ipack_stride / kIPack);
  const float4* R4 = reinterpret_cast<const float4*>(runs) +
                     (long long)t * NR;
  const int me = W * kRun + lane;
  const float4 me_sph = load_sphere(P4 + (long long)me * (kPack / 4));
  const float4 w_sph = __ldg(R4 + W);

  double e = 0.0;
  float ds = 0.f, dn[3] = {0.f, 0.f, 0.f};
  float dv[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int nact = 0;
  for (int J0 = 0; J0 < NR; J0 += kRun) {
    // lever 1a: this run's sphere against 32 runs at once
    const int Jl = J0 + lane;
    unsigned kept = __ballot_sync(kAll, Jl < NR && may_touch(w_sph,
                                                             __ldg(R4 + Jl)));
    while (kept) {
      const int J = J0 + __ffs(kept) - 1;
      kept &= kept - 1;
      // lever 1b: skip J when none of its faces can reach this run
      const float4 o_sph = load_sphere(P4 + (long long)(J * kRun + lane) *
                                       (kPack / 4));
      if (!__any_sync(kAll, may_touch(w_sph, o_sph))) continue;
      __syncwarp();   // the previous run's spheres and queue are read
      sph[lane] = o_sph;
      __syncwarp();
      // the sphere gate: lane's face against each face of J
      unsigned mine = 0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const float4 o = sph[j];
        const float rs = __fadd_rn(me_sph.w, o.w);
        if (dist2(me_sph, o) < __fmul_rn(rs, rs)) mine |= 1u << j;
      }
      // lever 2: queue the passing pairs, owner-major
      const int cnt = __popc(mine);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < kRun; o <<= 1) {
        const int x = __shfl_up_sync(kAll, incl, o);
        if (lane >= o) incl += x;
      }
      const int n = __shfl_sync(kAll, incl, kRun - 1);
      if (n == 0) continue;
      for (int pos = incl - cnt; mine; ++pos) {
        queue[pos] = (unsigned short)((lane << 5) | (__ffs(mine) - 1));
        mine &= mine - 1;
      }
      __syncwarp();
      for (int q0 = 0; q0 < n; q0 += kRun) {
        const int q = q0 + lane;
        int owner = 0, act = 0;
        float pij[3] = {0.f, 0.f, 0.f}, pji[3] = {0.f, 0.f, 0.f};
        Face fj = {};
        if (q < n) {
          const int ent = queue[q];
          owner = ent >> 5;
          const int i = W * kRun + owner, j = J * kRun + (ent & 31);
          const Face fi = load_face(P4 + (long long)i * (kPack / 4), I4 + i);
          fj = load_face(P4 + (long long)j * (kPack / 4), I4 + j);
          act = pair_both(fi, fj, ign, P, pij, pji);
        }
        // the pairs with energy reach their owner lane in queue order
        unsigned hits = __ballot_sync(kAll, act != 0);
        while (hits) {
          const int k = __ffs(hits) - 1;
          hits &= hits - 1;
          const int o = __shfl_sync(kAll, owner, k);
          const int a_k = __shfl_sync(kAll, act, k);
          float x[3], y[3], nj[3], vj[9];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            x[a] = __shfl_sync(kAll, pij[a], k);
            y[a] = __shfl_sync(kAll, pji[a], k);
            nj[a] = __shfl_sync(kAll, fj.n[a], k);
          }
#pragma unroll
          for (int a = 0; a < 9; ++a) vj[a] = __shfl_sync(kAll, fj.v[a], k);
          if (lane != o) continue;
          if (a_k & 1) {   // this face's cone at the partner's vertices
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const float g = __fadd_rn(x[a], x[a]);
              e += (double)__fmul_rn(x[a], x[a]);
              ds = __fadd_rn(ds, g);
#pragma unroll
              for (int c = 0; c < 3; ++c)
                dn[c] = __fsub_rn(dn[c], __fmul_rn(g, vj[3 * a + c]));
            }
            ++nact;
          }
          if (a_k & 2) {   // the partner's cone at this face's vertices
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const float g = __fadd_rn(y[a], y[a]);
#pragma unroll
              for (int c = 0; c < 3; ++c)
                dv[3 * a + c] = __fsub_rn(dv[3 * a + c], __fmul_rn(g, nj[c]));
            }
          }
        }
      }
    }
  }
  const long long k = (long long)t * Kp + me;
  e_out[k] = e;
  rowgrad[4 * k + 0] = dn[0];
  rowgrad[4 * k + 1] = dn[1];
  rowgrad[4 * k + 2] = dn[2];
  rowgrad[4 * k + 3] = ds;
  active[k] = nact;
#pragma unroll
  for (int q = 0; q < 9; ++q) dtri[9 * k + q] = dv[q];
}

}  // namespace

extern "C" {

// pack [T, Kp, 20] f32; ipack [T, Kp, 4] (ipack_batched) or [Kp, 4] int32;
// runs [T, Kp / 32, 4] f32 (each 32-face run's bounding sphere); ign
// [P, P] bytes or null; outputs e [T, Kp] f64, rowgrad [T, Kp, 4] (dn,
// ds), dtri [T, Kp, 9], active [T, Kp] int32. Kp must be a multiple of 128.
int lemo_cone_energy(const float* pack, const int* ipack, const float* runs,
                     const unsigned char* ign, int P, double* e_out,
                     float* rowgrad, float* dtri, int* active, int T, int Kp,
                     int ipack_batched, void* stream) {
  if (T <= 0 || Kp <= 0) return 0;
  const dim3 grid(Kp / kTile, T);
  cone_energy_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
      pack, ipack, runs, ign, P, e_out, rowgrad, dtri, active, Kp,
      ipack_batched ? (long long)Kp * kIPack : 0LL);
  return (int)cudaGetLastError();
}

}  // extern "C"
