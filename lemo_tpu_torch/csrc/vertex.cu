// The fused SMPL-X vertex path, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels lemo_tpu/body_model/vertex_pallas.py
// `_fwd_kernel` and `_bwd_kernel`. Per vertex v and frame b:
//
//     vs[n]  = sum_d dirs[n, v, d] * cat[d, b]      (shape + pose blend +
//                                                   template, D = S+9(J-1)+1)
//     T[k]   = sum_j W[v, j] * A2[k, j, b]          (skinning blend, k < 12)
//     out[m] = T[9+m] + sum_n T[3m+n] * vs[n]       (affine apply)
//
// and the backward (dirs and W are constants with no cotangent):
//
//     dT[3m+n] = dout[m] * vs[n],  dT[9+m] = dout[m]
//     dA2[k]   = sum_v W[v, :]^T dT[k, v, :]
//     dvs[n]   = sum_m T[3m+n] * dout[m]
//     dcat     = sum_n sum_v dirs[n, v, :]^T dvs[n, v, :]
//
// Layouts (the wrapper's contract, same as the TPU kernel): cat [D, Bp],
// A2 [12, Jp, Bp], dirs [3, Vp, D], W [Vp, Jp], out/dout [3, Vp, Bp], all
// f32 and contiguous; Vp % 64 == 0, Bp % 32 == 0, Jp <= 64.
//
// What bounds it on the card: operations. At B=100 (Bp=128) the forward is
// 3*2*Vp*D*Bp ~ 4.1 GFLOP of blends plus 12*2*Vp*Jp*Bp ~ 1.8 GFLOP of
// skinning blend, against ~64 MB of dirs read once: ~90 us at the f32
// CUDA-core peak versus ~20 us of HBM traffic. lemo_tpu computes these
// products exactly in f32 (Precision.HIGHEST), and TF32 would miss the
// 2e-6 m tolerance, so the tensor cores are out: the design is a classic
// register-tiled SGEMM on the CUDA cores.
//
// Forward: one block of 128 threads per (64-vertex x 32-frame) tile; each
// thread owns a 4x4 (vertex x frame) micro-tile and keeps its 48 blend
// sums in registers (phase 1: dirs and cat staged through shared memory in
// chunks of D, read as float4). Phase 2 stages W once and one A2 plane at a
// time and forms each T[k] micro-tile in registers, folding it straight
// into the output. The B tile is the fastest grid index, so the blocks
// that read the same dirs rows run together and share them through L2.
// No [B, V, 3] intermediate (vs, T) reaches device memory.
//
// Backward: a pointwise pass and two cross-vertex reductions, six
// launches in one C call (`lemo_vertex_bwd`):
//
//   K1 (`lemo_vertex_bwd_pointwise`) recomputes vs and forms dvs, both to
//      scratch slabs [3, Vp, Bp]:
//      K1a vs [3Vp, Bp] = dirs [3Vp, D] cat [D, Bp]: a GEMM with
//          M = 3 Vp, N = Bp and K = D (`VsProblem`);
//      K1b dvs[n] = sum_m T[3m+n] * dout[m] (`vertex_bwd_dvs_kernel`):
//          T[0..8] = W A2[k] formed on a 64-vertex x 64-frame tile, the
//          three planes of one n staged together.
//   K2 dcat [D, Bp] = dirs^T dvs: a GEMM with M = D, N = Bp and
//      K = 3 Vp (dirs [3, Vp, D] and dvs [3, Vp, Bp] are [3Vp, D] and
//      [3Vp, Bp] row-major, so both operands stream along K).
//   K3 dA2 [12, Jp, Bp] = W^T dT: a GEMM with M = Jp, N = 12 Bp and
//      K = Vp; dT is formed from dout and vs while it is staged.
//
// The three GEMMs share one register-tiled split-K SGEMM
// (`splitk_gemm_kernel`): 256 threads, 8x8 outputs a thread, K staged
// through shared memory in chunks of 16 with the next chunk's loads in
// flight. K1a needs no split. The TPU sums K2 and K3 across V tiles in
// scratch because its grid runs in order; Hopper's blocks run in parallel
// and in no order, so each K slice writes its partial product to a scratch
// slab [S, ...] and `sum_slices_kernel` adds the S slabs in slice order:
// deterministic, no atomics. S follows from the shapes alone (`split_k`):
// enough slices that each product's grid fills two waves of 132 SMs.
//
// Everything accumulates in f32 with FMA: no TF32, no half precision.

#include <cuda_runtime.h>

namespace {

constexpr int TV = 64;        // vertices per block tile
constexpr int TB = 32;        // frames per block tile
constexpr int NT = 128;       // threads per block: 16 (vertex) x 8 (frame)
constexpr int KD = 16;        // D chunk of the blend phase
constexpr int MAXJ = 64;      // largest Jp the tiles hold
constexpr int LDV = TV + 4;   // padded row of a [.][TV] smem tile
constexpr int LDB = TB + 4;   // padded row of a [.][TB] smem tile

// floats of the blend-phase staging: dirs [3][KD][LDV] + cat [KD][TB]
constexpr int STAGE_BLEND = 3 * KD * LDV + KD * TB;
// W as [j][v], A2 plane as [j][b]
constexpr int SM_W = MAXJ * LDV;
constexpr int SM_A = MAXJ * LDB;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Phase 1: vs[n][r][i] for the thread's 4 vertices (r) x 4 frames (i).
__device__ __forceinline__ void blend_phase(
    const float* __restrict__ cat, const float* __restrict__ dirs,
    float* stage, float vs[3][4][4], int D, int Vp, int Bp, int vbase,
    int bbase, int tv, int tb) {
  float* s_dirs = stage;                 // [3][KD][LDV]
  float* s_cat = stage + 3 * KD * LDV;   // [KD][TB]
  const int tid = threadIdx.x;
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) vs[n][r][i] = 0.f;

  for (int d0 = 0; d0 < D; d0 += KD) {
    __syncthreads();
    for (int idx = tid; idx < 3 * TV * KD; idx += NT) {
      const int kd = idx % KD, v = (idx / KD) % TV, n = idx / (KD * TV);
      const int d = d0 + kd;
      s_dirs[(n * KD + kd) * LDV + v] =
          d < D ? dirs[((long)n * Vp + vbase + v) * D + d] : 0.f;
    }
    for (int idx = tid; idx < KD * TB; idx += NT) {
      const int b = idx % TB, kd = idx / TB, d = d0 + kd;
      s_cat[kd * TB + b] = d < D ? cat[(long)d * Bp + bbase + b] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kd = 0; kd < KD; ++kd) {
      const float4 c = ld4(&s_cat[kd * TB + 4 * tb]);
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const float4 a = ld4(&s_dirs[(n * KD + kd) * LDV + 4 * tv]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            vs[n][r][i] += comp(a, r) * comp(c, i);
      }
    }
  }
}

// Stage W [Vp, Jp] rows vbase.. as s_w[j][v] (zero beyond Jp).
__device__ __forceinline__ void stage_w_jv(const float* __restrict__ w,
                                           float* s_w, int Jp, int vbase) {
  for (int idx = threadIdx.x; idx < MAXJ * TV; idx += NT) {
    const int j = idx % MAXJ, v = idx / MAXJ;
    s_w[j * LDV + v] = j < Jp ? w[(long)(vbase + v) * Jp + j] : 0.f;
  }
}

// T[k] micro-tile: stage A2 plane k (after a barrier), then sum over j.
__device__ __forceinline__ void skin_plane(
    const float* __restrict__ a2, const float* s_w, float* s_a, int k,
    float T[4][4], int Jp, int Bp, int bbase, int tv, int tb) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < Jp * TB; idx += NT) {
    const int b = idx % TB, j = idx / TB;
    s_a[j * LDB + b] = a2[((long)k * Jp + j) * Bp + bbase + b];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) T[r][i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < Jp; ++j) {
    const float4 wv = ld4(&s_w[j * LDV + 4 * tv]);
    const float4 av = ld4(&s_a[j * LDB + 4 * tb]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) T[r][i] += comp(wv, r) * comp(av, i);
  }
}

__global__ void __launch_bounds__(NT)
    vertex_fwd_kernel(const float* __restrict__ cat,
                      const float* __restrict__ a2,
                      const float* __restrict__ dirs,
                      const float* __restrict__ w, float* __restrict__ out,
                      int D, int Jp, int Vp, int Bp) {
  __shared__ __align__(16) float smem[SM_W + SM_A > STAGE_BLEND
                                          ? SM_W + SM_A
                                          : STAGE_BLEND];
  const int tid = threadIdx.x, tb = tid % 8, tv = tid / 8;
  const int bbase = blockIdx.x * TB, vbase = blockIdx.y * TV;

  float vs[3][4][4];
  blend_phase(cat, dirs, smem, vs, D, Vp, Bp, vbase, bbase, tv, tb);

  float* s_w = smem;
  float* s_a = smem + SM_W;
  __syncthreads();
  stage_w_jv(w, s_w, Jp, vbase);
  for (int m = 0; m < 3; ++m) {
    float acc[4][4], T[4][4];
    skin_plane(a2, s_w, s_a, 9 + m, acc, Jp, Bp, bbase, tv, tb);
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      skin_plane(a2, s_w, s_a, 3 * m + n, T, Jp, Bp, bbase, tv, tb);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] += T[r][i] * vs[n][r][i];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st4(&out[((long)m * Vp + vbase + 4 * tv + r) * Bp + bbase + 4 * tb],
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
  }
}

// K1b: dvs[n] = sum_m T[3m+n] * dout[m] on a 64-vertex x 64-frame tile;
// for each n the three A2 planes 3m+n are staged at once. 128 threads, 8
// vertices x 4 frames each; dvs goes to scratch [3, Vp, Bp].
constexpr int DV = 64, DB = 64, LDD = DB + 4;

int dvs_smem_bytes(int Jp) {
  return (Jp * LDV + 3 * Jp * LDD) * (int)sizeof(float);
}

__global__ void __launch_bounds__(NT)
    vertex_bwd_dvs_kernel(const float* __restrict__ a2,
                          const float* __restrict__ w,
                          const float* __restrict__ dout,
                          float* __restrict__ dvs_out, int Jp, int Vp,
                          int Bp) {
  extern __shared__ __align__(16) float dsm[];
  float* s_w = dsm;                 // [Jp][LDV]
  float* s_a = dsm + Jp * LDV;      // [3][Jp][LDD]
  const int tid = threadIdx.x, tb = tid % 16, tv = tid / 16;
  const int bbase = blockIdx.x * DB, vbase = blockIdx.y * DV;
  const bool live = bbase + 4 * tb < Bp;   // Bp % 64 == 32: a half tile
  for (int idx = tid; idx < Jp * DV; idx += NT) {
    const int j = idx % Jp, v = idx / Jp;
    s_w[j * LDV + v] = w[(long)(vbase + v) * Jp + j];
  }
  for (int n = 0; n < 3; ++n) {
    __syncthreads();
    for (int idx = tid; idx < 3 * Jp * (DB / 4); idx += NT) {
      const int b4 = idx % (DB / 4), j = (idx / (DB / 4)) % Jp;
      const int m = idx / ((DB / 4) * Jp), b = bbase + 4 * b4;
      st4(&s_a[(m * Jp + j) * LDD + 4 * b4],
          b < Bp ? ld4(&a2[((long)(3 * m + n) * Jp + j) * Bp + b])
                 : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
    for (int m = 0; m < 3; ++m) {
      float T[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) T[r][i] = 0.f;
#pragma unroll 4
      for (int j = 0; j < Jp; ++j) {
        const float4 w0 = ld4(&s_w[j * LDV + 4 * tv]);
        const float4 w1 = ld4(&s_w[j * LDV + DV / 2 + 4 * tv]);
        const float4 av = ld4(&s_a[(m * Jp + j) * LDD + 4 * tb]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            T[r][i] += comp(w0, r) * comp(av, i);
            T[4 + r][i] += comp(w1, r) * comp(av, i);
          }
      }
      if (live) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int v = vbase + (r < 4 ? 4 * tv + r : DV / 2 + 4 * tv + r - 4);
          const float4 d4 =
              ld4(&dout[((long)m * Vp + v) * Bp + bbase + 4 * tb]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][i] += T[r][i] * comp(d4, i);
        }
      }
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int v = vbase + (r < 4 ? 4 * tv + r : DV / 2 + 4 * tv + r - 4);
        st4(&dvs_out[((long)n * Vp + v) * Bp + bbase + 4 * tb],
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
      }
    }
  }
}

// ---- the register-tiled split-K SGEMM of the backward ------------------
//
// C[m, n] = sum_k A(k, m) B(k, n) over one K slice per blockIdx.z. A
// problem type P supplies M, N, K, the element A(k, m), the float4
// B(k, n..n+3) (n % 4 == 0), `store`, which writes a float4 of slice s's
// partial at (m, n..n+3), and kAlongK: whether A's memory runs along k
// (dirs as [3 Vp, D] in vs = dirs cat) or along m (the reductions), which
// sets the order the block reads A in. Out-of-range m, n and k are masked
// here.

constexpr int GT = 256;                // threads of a GEMM block
constexpr int WAVE_BLOCKS = 2 * 132;   // two blocks on each of 132 SMs

// BM x BN block tile, K staged through shared memory KC rows at a time
template <int BM, int BN, int KC, class P>
__global__ void __launch_bounds__(GT, 2)
    splitk_gemm_kernel(const P p, int kslice) {
  constexpr int TX = BN / 8, TY = BM / 8;   // 8x8 outputs a thread
  static_assert(TX * TY == GT, "the block tile must give 8x8 a thread");
  constexpr int LA = KC * BM / GT;          // A elements a thread stages
  constexpr int LB = KC * BN / (4 * GT);    // B float4s a thread stages
  static_assert(LA * GT == KC * BM && LB * 4 * GT == KC * BN, "tile");
  // A's rows padded by 4: 2-way bank conflicts at most when kAlongK
  __shared__ __align__(16) float sa[2][KC][BM + 4];
  __shared__ __align__(16) float sb[2][KC][BN];
  const auto a_at = [](int idx, int& kk, int& mm) {
    kk = P::kAlongK ? idx % KC : idx / BM;
    mm = P::kAlongK ? idx / KC : idx % BM;
  };

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * kslice;
  const int kend = min(p.K, kbeg + kslice);
  const int nchunks = kend > kbeg ? (kend - kbeg + KC - 1) / KC : 0;

  float ra[LA];
  float4 rb[LB];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      int kk, mm;
      a_at(tid + i * GT, kk, mm);
      const int k = k0 + kk, m = m0 + mm;
      ra[i] = k < kend && m < p.M ? p.a(k, m) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int idx = tid + i * GT;
      const int k = k0 + idx / (BN / 4), n = n0 + 4 * (idx % (BN / 4));
      rb[i] = k < kend && n < p.N ? p.b(k, n) : make_float4(0, 0, 0, 0);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      int kk, mm;
      a_at(tid + i * GT, kk, mm);
      sa[buf][kk][mm] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int idx = tid + i * GT;
      st4(&sb[buf][idx / (BN / 4)][4 * (idx % (BN / 4))], rb[i]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (nchunks > 0) {
    load(kbeg);
    stash(0);
  }
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < nchunks) load(kbeg + (c + 1) * KC);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a0 = ld4(&sa[buf][kk][4 * ty]);
      const float4 a1 = ld4(&sa[buf][kk][BM / 2 + 4 * ty]);
      const float4 b0 = ld4(&sb[buf][kk][4 * tx]);
      const float4 b1 = ld4(&sb[buf][kk][BN / 2 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (c + 1 < nchunks) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : BM / 2 + 4 * ty + i - 4);
    if (m >= p.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (BN / 2) + 4 * tx;
      if (n < p.N)
        p.store(blockIdx.z, m, n,
                make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                            acc[i][4 * h + 2], acc[i][4 * h + 3]));
    }
  }
}

// K1a: vs [3 Vp, Bp] = dirs [3 Vp, D] cat [D, Bp], K = D, one slice.
struct VsProblem {
  const float* dirs;   // [3 Vp, D]
  const float* cat;    // [D, Bp]
  float* vs;           // [3 Vp, Bp]
  int M, N, K;         // 3 Vp, Bp, D
  static constexpr bool kAlongK = true;
  __device__ float a(int k, int m) const { return dirs[(long)m * K + k]; }
  __device__ float4 b(int k, int n) const {
    return ld4(&cat[(long)k * N + n]);
  }
  __device__ void store(int, int m, int n, float4 v) const {
    st4(&vs[(long)m * N + n], v);
  }
};
constexpr int VS_BM = 128, VS_BN = 128, VS_KC = 16;

// K2: dcat partials [S, D, Bp] = dirs^T dvs over K = 3 Vp.
struct DcatProblem {
  const float* dirs;   // [3 Vp, D]
  const float* dvs;    // [3 Vp, Bp]
  float* part;         // [S, D, Bp]
  int M, N, K;                      // D, Bp, 3 Vp
  static constexpr bool kAlongK = false;
  __device__ float a(int k, int m) const { return dirs[(long)k * M + m]; }
  __device__ float4 b(int k, int n) const {
    return ld4(&dvs[(long)k * N + n]);
  }
  __device__ void store(int s, int m, int n, float4 v) const {
    st4(&part[((long)s * M + m) * N + n], v);
  }
};
constexpr int DCAT_BM = 128, DCAT_BN = 128, DCAT_KC = 16;

// K3: dA2 partials [S, 12, Jp, Bp] = W^T dT over K = Vp, with column
// n = q Bp + b of plane q: dT[q] = dout[q/3] * vs[q%3] (q < 9), dout[q-9].
struct Da2Problem {
  const float* w;      // [Vp, Jp]
  const float* vs;     // [3, Vp, Bp]
  const float* dout;   // [3, Vp, Bp]
  float* part;         // [S, 12, Jp, Bp]
  int M, N, K, Bp;                  // Jp, 12 Bp, Vp
  static constexpr bool kAlongK = false;
  __device__ float a(int k, int m) const { return w[(long)k * M + m]; }
  __device__ float4 b(int k, int n) const {
    const int q = n / Bp, col = n - q * Bp;
    const long plane = (long)K * Bp;
    float4 d = ld4(&dout[(q < 9 ? q / 3 : q - 9) * plane + (long)k * Bp +
                         col]);
    if (q < 9) {
      const float4 s = ld4(&vs[(q % 3) * plane + (long)k * Bp + col]);
      d = make_float4(d.x * s.x, d.y * s.y, d.z * s.z, d.w * s.w);
    }
    return d;
  }
  __device__ void store(int s, int m, int n, float4 v) const {
    const int q = n / Bp, col = n - q * Bp;
    st4(&part[(((long)s * 12 + q) * M + m) * Bp + col], v);
  }
};
constexpr int DA2_BM = 64, DA2_BN = 256, DA2_KC = 16;

// out[i] = sum_s part[s * n + i], s in order: the deterministic last pass.
__global__ void sum_slices_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, long n,
                                  int slices) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < slices; ++t) s += part[(long)t * n + i];
    out[i] = s;
  }
}

// The K slices of an M x N x K product cut into BM x BN tiles: enough that
// the grid holds about WAVE_BLOCKS blocks, each slice a whole number of
// KC-row chunks. From the shapes alone, so the scratch and the order of
// the sums are fixed for given shapes. Returns S and sets *kslice.
int split_k(int M, int N, int K, int BM, int BN, int KC, int* kslice) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int chunks = (K + KC - 1) / KC;
  int s = (WAVE_BLOCKS + tiles - 1) / tiles;
  s = s < 1 ? 1 : (s > chunks ? chunks : s);
  const int per = (chunks + s - 1) / s;
  *kslice = per * KC;
  return (chunks + per - 1) / per;
}

bool shapes_ok(int D, int Jp, int Vp, int Bp) {
  return D > 0 && Jp > 0 && Jp <= MAXJ && Vp > 0 && Vp % TV == 0 &&
         Bp > 0 && Bp % TB == 0;
}

template <int BM, int BN, int KC, class P>
int launch_reduction(const P& p, float* part, float* out, long n_out,
                     cudaStream_t s) {
  int kslice;
  const int slices = split_k(p.M, p.N, p.K, BM, BN, KC, &kslice);
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN, slices);
  splitk_gemm_kernel<BM, BN, KC, P><<<grid, GT, 0, s>>>(p, kslice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_slices_kernel<<<(int)((n_out + 255) / 256), 256, 0, s>>>(
      part, out, n_out, slices);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lemo_vertex_fwd(const float* cat, const float* a2, const float* dirs,
                    const float* w, float* out, int D, int Jp, int Vp,
                    int Bp, void* stream) {
  if (!shapes_ok(D, Jp, Vp, Bp)) return (int)cudaErrorInvalidValue;
  const dim3 grid(Bp / TB, Vp / TV);
  vertex_fwd_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      cat, a2, dirs, w, out, D, Jp, Vp, Bp);
  return (int)cudaGetLastError();
}

// The backward's split-K slice counts, the leading extents of its partial
// slabs (the caller sizes them, and the vs/dvs slabs [3, Vp, Bp], with
// them): slices[0] for dcat [S0, D, Bp], slices[1] for dA2
// [S1, 12, Jp, Bp]. Returns cudaErrorInvalidValue for shapes the kernels
// do not take.
int lemo_vertex_bwd_slices(int D, int Jp, int Vp, int Bp, int* slices) {
  if (!shapes_ok(D, Jp, Vp, Bp)) return (int)cudaErrorInvalidValue;
  int kslice;
  slices[0] = split_k(D, Bp, 3 * Vp, DCAT_BM, DCAT_BN, DCAT_KC, &kslice);
  slices[1] = split_k(Jp, 12 * Bp, Vp, DA2_BM, DA2_BN, DA2_KC, &kslice);
  return 0;
}

// K1 alone: vs, dvs [3, Vp, Bp] (K1a then K1b).
int lemo_vertex_bwd_pointwise(const float* cat, const float* a2,
                              const float* dirs, const float* w,
                              const float* dout, float* vs, float* dvs,
                              int D, int Jp, int Vp, int Bp, void* stream) {
  if (!shapes_ok(D, Jp, Vp, Bp)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const VsProblem p{dirs, cat, vs, 3 * Vp, Bp, D};
  const dim3 grid_vs((p.M + VS_BM - 1) / VS_BM, (p.N + VS_BN - 1) / VS_BN);
  splitk_gemm_kernel<VS_BM, VS_BN, VS_KC, VsProblem>
      <<<grid_vs, GT, 0, s>>>(p, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = dvs_smem_bytes(Jp);
  const cudaError_t attr = cudaFuncSetAttribute(
      vertex_bwd_dvs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  vertex_bwd_dvs_kernel<<<dim3((Bp + DB - 1) / DB, Vp / DV), NT, smem, s>>>(
      a2, w, dout, dvs, Jp, Vp, Bp);
  return (int)cudaGetLastError();
}

// K2 and its sum: dcat [D, Bp] from dirs and dvs; part_dcat [S0, D, Bp].
int lemo_vertex_bwd_dcat(const float* dirs, const float* dvs, float* dcat,
                         float* part_dcat, int D, int Vp, int Bp,
                         void* stream) {
  if (!shapes_ok(D, 1, Vp, Bp)) return (int)cudaErrorInvalidValue;
  const DcatProblem p{dirs, dvs, part_dcat, D, Bp, 3 * Vp};
  return launch_reduction<DCAT_BM, DCAT_BN, DCAT_KC>(
      p, part_dcat, dcat, (long)D * Bp, (cudaStream_t)stream);
}

// K3 and its sum: dA2 [12, Jp, Bp] from W, vs and dout; part_da2
// [S1, 12, Jp, Bp].
int lemo_vertex_bwd_da2(const float* w, const float* vs, const float* dout,
                        float* da2, float* part_da2, int Jp, int Vp, int Bp,
                        void* stream) {
  if (!shapes_ok(1, Jp, Vp, Bp)) return (int)cudaErrorInvalidValue;
  const Da2Problem p{w, vs, dout, part_da2, Jp, 12 * Bp, Vp, Bp};
  return launch_reduction<DA2_BM, DA2_BN, DA2_KC>(
      p, part_da2, da2, 12L * Jp * Bp, (cudaStream_t)stream);
}

// The whole backward, K1 then K2 and K3 with their sums, on one stream.
// Scratch: vs, dvs [3, Vp, Bp]; part_dcat and part_da2 sized by
// lemo_vertex_bwd_slices.
int lemo_vertex_bwd(const float* cat, const float* a2, const float* dirs,
                    const float* w, const float* dout, float* dcat,
                    float* da2, float* vs, float* dvs, float* part_dcat,
                    float* part_da2, int D, int Jp, int Vp, int Bp,
                    void* stream) {
  int err = lemo_vertex_bwd_pointwise(cat, a2, dirs, w, dout, vs, dvs, D, Jp,
                                      Vp, Bp, stream);
  if (err) return err;
  err = lemo_vertex_bwd_dcat(dirs, dvs, dcat, part_dcat, D, Vp, Bp, stream);
  if (err) return err;
  return lemo_vertex_bwd_da2(w, vs, dout, da2, part_da2, Jp, Vp, Bp, stream);
}

}  // extern "C"
