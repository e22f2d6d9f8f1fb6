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
// Both directions start from the blend K1a, vs [3 Vp, Bp] = dirs [3 Vp, D]
// cat [D, Bp]: a GEMM with M = 3 Vp, N = Bp and K = D (`VsProblem`) into a
// scratch slab [3, Vp, Bp]. Its 128 x 128 tile covers all of Bp = 128, so
// dirs is read once.
//
// Forward, two launches in one C call (`lemo_vertex_fwd`):
//
//   K1a the blend;
//   F2  out[m] = T[9+m] + sum_n T[3m+n] * vs[n] (`vertex_fwd_apply_kernel`)
//       on a 64-vertex x 64-frame tile: for each m the four A2 planes 9+m,
//       3m, 3m+1 and 3m+2 are staged together, their T micro-tiles formed
//       in registers (two per pass over j) and added in the TPU kernel's
//       order. vs was just written and is read back from L2.
//
// Backward: a pointwise pass and two cross-vertex reductions, six
// launches in one C call (`lemo_vertex_bwd`), or five from the forward's
// vs (`lemo_vertex_bwd_from_vs`, which skips K1a: the same kernel on the
// same operands gives the same bits):
//
//   K1a the blend, as above;
//   K1b dvs[n] = sum_m T[3m+n] * dout[m] (`vertex_bwd_dvs_kernel`):
//       T[0..8] = W A2[k] formed on the same 64 x 64 tile, the three
//       planes of one n staged together; dvs to scratch [3, Vp, Bp].
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
// deterministic, no atomics. The slices follow from K alone (`split_k`,
// at most DCAT_SLICES or DA2_SLICES), not from the frame count: a frame's
// sums and
// their order are then the same whatever frames share its launch, so a
// fit of several clips folded into one batch rounds each clip as its own
// fit does.
//
// Everything accumulates in f32 with FMA: no TF32, no half precision.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;           // threads of a skinning block: 16 x 8
constexpr int DV = 64, DB = 64;   // vertices and frames of a skinning tile
constexpr int MAXJ = 64;          // largest Jp the kernels take
constexpr int LDV = DV + 4;       // padded row of W staged as [j][v]
constexpr int LDD = DB + 4;       // padded row of an A2 plane as [j][b]

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// ---- the skinning tile of F2 and K1b ------------------------------------
//
// 128 threads own a 64-vertex x 64-frame tile, 8 vertices x 4 frames a
// thread: frames 4 tb..4 tb+3 (tb = tid % 16) of vertices 4 tv..4 tv+3 and
// 32+4 tv..32+4 tv+3 (tv = tid / 16), so each float4 read of staged W or
// A2 serves four outputs. Row r < 8 of the thread's micro-tile:
__device__ __forceinline__ int tile_row(int r, int tv) {
  return r < 4 ? 4 * tv + r : DV / 2 + 4 * tv + r - 4;
}

// W rows vbase.. staged as s_w[j][v].
__device__ __forceinline__ void stage_w(const float* __restrict__ w,
                                        float* s_w, int Jp, int vbase) {
  for (int idx = threadIdx.x; idx < Jp * DV; idx += NT) {
    const int j = idx % Jp, v = idx / Jp;
    s_w[j * LDV + v] = w[(long)(vbase + v) * Jp + j];
  }
}

// A2 planes plane(0..NQ-1) at frames bbase.. (zero past Bp) staged as
// s_a[q][j][b].
template <int NQ, class Plane>
__device__ __forceinline__ void stage_planes(const float* __restrict__ a2,
                                             float* s_a, Plane plane, int Jp,
                                             int Bp, int bbase) {
  for (int idx = threadIdx.x; idx < NQ * Jp * (DB / 4); idx += NT) {
    const int b4 = idx % (DB / 4), j = (idx / (DB / 4)) % Jp;
    const int q = idx / ((DB / 4) * Jp), b = bbase + 4 * b4;
    st4(&s_a[(q * Jp + j) * LDD + 4 * b4],
        b < Bp ? ld4(&a2[((long)plane(q) * Jp + j) * Bp + b])
               : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// T[q] = sum_j W[v, j] A2[q, j, b] on the thread's micro-tile for the NQ
// staged planes, in one pass over j.
template <int NQ>
__device__ __forceinline__ void skin_tiles(const float* s_w, const float* s_a,
                                           float T[NQ][8][4], int Jp, int tv,
                                           int tb) {
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) T[q][r][i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < Jp; ++j) {
    const float4 w0 = ld4(&s_w[j * LDV + 4 * tv]);
    const float4 w1 = ld4(&s_w[j * LDV + DV / 2 + 4 * tv]);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 av = ld4(&s_a[(q * Jp + j) * LDD + 4 * tb]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          T[q][r][i] += comp(w0, r) * comp(av, i);
          T[q][4 + r][i] += comp(w1, r) * comp(av, i);
        }
    }
  }
}

// dynamic shared memory of a skinning block with NQ staged planes
int skin_smem_bytes(int Jp, int nq) {
  return (Jp * LDV + nq * Jp * LDD) * (int)sizeof(float);
}

// F2: out [3, Vp, Bp] from vs [3, Vp, Bp]. For each m the planes 9+m,
// 3m, 3m+1, 3m+2 are staged in that order, one barrier pair for the four;
// F2_PLANES of them are formed per pass over j and folded into the sum in
// that order, the TPU kernel's: T[9+m], + T[3m] vs[0], + T[3m+1] vs[1],
// + T[3m+2] vs[2]. Two planes a pass under a 3-block cap (168 registers,
// no spills) beat four a pass (253 registers, two blocks an SM, so the
// 328 blocks ran in 1.24 waves) and one a pass (PERF.md, section 6).
constexpr int F2_PLANES = 2;       // T micro-tiles in registers at once
constexpr int F2_MIN_BLOCKS = 3;   // blocks an SM (__launch_bounds__)

__global__ void __launch_bounds__(NT, F2_MIN_BLOCKS)
    vertex_fwd_apply_kernel(const float* __restrict__ vs,
                            const float* __restrict__ a2,
                            const float* __restrict__ w,
                            float* __restrict__ out, int Jp, int Vp,
                            int Bp) {
  extern __shared__ __align__(16) float fsm[];
  float* s_w = fsm;                 // [Jp][LDV]
  float* s_a = fsm + Jp * LDV;      // [4][Jp][LDD]: 9+m, 3m, 3m+1, 3m+2
  const int tid = threadIdx.x, tb = tid % 16, tv = tid / 16;
  const int bbase = blockIdx.x * DB, vbase = blockIdx.y * DV;
  const bool live = bbase + 4 * tb < Bp;   // Bp % 64 == 32: a half tile
  const long plane = (long)Vp * Bp;
  stage_w(w, s_w, Jp, vbase);
  for (int m = 0; m < 3; ++m) {
    __syncthreads();
    stage_planes<4>(
        a2, s_a, [m](int q) { return q == 0 ? 9 + m : 3 * m + q - 1; }, Jp,
        Bp, bbase);
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int p0 = 0; p0 < 4; p0 += F2_PLANES) {
      float T[F2_PLANES][8][4];
      skin_tiles<F2_PLANES>(s_w, s_a + p0 * Jp * LDD, T, Jp, tv, tb);
      if (!live) continue;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const long at = (long)(vbase + tile_row(r, tv)) * Bp + bbase + 4 * tb;
#pragma unroll
        for (int q = 0; q < F2_PLANES; ++q) {
          const int n = p0 + q - 1;   // the staged plane 3m+n; -1: 9+m
          if (n < 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[r][i] = T[q][r][i];
          } else {
            const float4 v = ld4(&vs[n * plane + at]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[r][i] += T[q][r][i] * comp(v, i);
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const long at = (long)(vbase + tile_row(r, tv)) * Bp + bbase + 4 * tb;
        st4(&out[m * plane + at],
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
      }
    }
  }
}

// K1b: dvs [3, Vp, Bp], the three planes 3m+n of one n a barrier pair.
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
  stage_w(w, s_w, Jp, vbase);
  for (int n = 0; n < 3; ++n) {
    __syncthreads();
    stage_planes<3>(a2, s_a, [n](int q) { return 3 * q + n; }, Jp, Bp,
                    bbase);
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
    for (int m = 0; m < 3; ++m) {
      float T[1][8][4];
      skin_tiles<1>(s_w, s_a + m * Jp * LDD, T, Jp, tv, tb);
      if (live) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int v = vbase + tile_row(r, tv);
          const float4 d4 =
              ld4(&dout[((long)m * Vp + v) * Bp + bbase + 4 * tb]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][i] += T[0][r][i] * comp(d4, i);
        }
      }
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int v = vbase + tile_row(r, tv);
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
// K slices at most: at Bp <= 128 (one clip) SMPL-X's D = 507 rows (4
// tiles) then fill two blocks on each of 132 SMs, as the slice count the
// kernel took from the shapes before did there
constexpr int DCAT_SLICES = 66;

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
constexpr int DA2_SLICES = 44;   // as DCAT_SLICES: 6 tiles at Bp 128

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

// The K slices of a product with K rows staged KC at a time: at most
// max_slices slices of a whole number of KC-row chunks each. From K
// alone, so each output's sums, and the order they are added in, do not
// depend on M or N (the frame count). Returns S and sets *kslice.
int split_k(int K, int KC, int max_slices, int* kslice) {
  const int chunks = (K + KC - 1) / KC;
  const int per = (chunks + max_slices - 1) / max_slices;
  *kslice = per * KC;
  return (chunks + per - 1) / per;
}

bool shapes_ok(int D, int Jp, int Vp, int Bp) {
  return D > 0 && Jp > 0 && Jp <= MAXJ && Vp > 0 && Vp % DV == 0 &&
         Bp > 0 && Bp % (DB / 2) == 0;
}

template <int BM, int BN, int KC, int SLICES, class P>
int launch_reduction(const P& p, float* part, float* out, long n_out,
                     cudaStream_t s) {
  int kslice;
  const int slices = split_k(p.K, KC, SLICES, &kslice);
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN, slices);
  splitk_gemm_kernel<BM, BN, KC, P><<<grid, GT, 0, s>>>(p, kslice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_slices_kernel<<<(int)((n_out + 255) / 256), 256, 0, s>>>(
      part, out, n_out, slices);
  return (int)cudaGetLastError();
}

// K1a: vs [3 Vp, Bp] = dirs [3 Vp, D] cat [D, Bp], one K slice.
int launch_blend(const float* cat, const float* dirs, float* vs, int D,
                 int Vp, int Bp, cudaStream_t s) {
  const VsProblem p{dirs, cat, vs, 3 * Vp, Bp, D};
  const dim3 grid((p.M + VS_BM - 1) / VS_BM, (p.N + VS_BN - 1) / VS_BN);
  splitk_gemm_kernel<VS_BM, VS_BN, VS_KC, VsProblem><<<grid, GT, 0, s>>>(p,
                                                                        D);
  return (int)cudaGetLastError();
}

// A skinning-tile kernel (F2 or K1b) over the whole [Vp, Bp] grid, with
// the dynamic shared memory of nq staged planes.
template <class... Params, class... Args>
int launch_skin(void (*kernel)(Params...), int nq, int Jp, int Vp, int Bp,
                cudaStream_t s, Args... args) {
  const int smem = skin_smem_bytes(Jp, nq);
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<dim3((Bp + DB - 1) / DB, Vp / DV), NT, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1a alone: vs [3, Vp, Bp].
int lemo_vertex_blend(const float* cat, const float* dirs, float* vs, int D,
                      int Vp, int Bp, void* stream) {
  if (!shapes_ok(D, 1, Vp, Bp)) return (int)cudaErrorInvalidValue;
  return launch_blend(cat, dirs, vs, D, Vp, Bp, (cudaStream_t)stream);
}

// F2 alone: out [3, Vp, Bp] from vs [3, Vp, Bp].
int lemo_vertex_fwd_apply(const float* vs, const float* a2, const float* w,
                          float* out, int Jp, int Vp, int Bp, void* stream) {
  if (!shapes_ok(1, Jp, Vp, Bp)) return (int)cudaErrorInvalidValue;
  return launch_skin(vertex_fwd_apply_kernel, 4, Jp, Vp, Bp,
                     (cudaStream_t)stream, vs, a2, w, out, Jp, Vp, Bp);
}

// The forward, K1a then F2 on one stream; vs [3, Vp, Bp] is the caller's
// scratch and holds the blend afterwards.
int lemo_vertex_fwd(const float* cat, const float* a2, const float* dirs,
                    const float* w, float* vs, float* out, int D, int Jp,
                    int Vp, int Bp, void* stream) {
  if (!shapes_ok(D, Jp, Vp, Bp)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_blend(cat, dirs, vs, D, Vp, Bp, s);
  if (err) return err;
  return launch_skin(vertex_fwd_apply_kernel, 4, Jp, Vp, Bp, s, vs, a2, w,
                     out, Jp, Vp, Bp);
}

// The backward's split-K slice counts, the leading extents of its partial
// slabs (the caller sizes them, and the vs/dvs slabs [3, Vp, Bp], with
// them): slices[0] for dcat [S0, D, Bp], slices[1] for dA2
// [S1, 12, Jp, Bp]. Returns cudaErrorInvalidValue for shapes the kernels
// do not take.
int lemo_vertex_bwd_slices(int D, int Jp, int Vp, int Bp, int* slices) {
  if (!shapes_ok(D, Jp, Vp, Bp)) return (int)cudaErrorInvalidValue;
  int kslice;
  slices[0] = split_k(3 * Vp, DCAT_KC, DCAT_SLICES, &kslice);
  slices[1] = split_k(Vp, DA2_KC, DA2_SLICES, &kslice);
  return 0;
}

// K1 alone: vs, dvs [3, Vp, Bp] (K1a then K1b).
int lemo_vertex_bwd_pointwise(const float* cat, const float* a2,
                              const float* dirs, const float* w,
                              const float* dout, float* vs, float* dvs,
                              int D, int Jp, int Vp, int Bp, void* stream) {
  if (!shapes_ok(D, Jp, Vp, Bp)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_blend(cat, dirs, vs, D, Vp, Bp, s);
  if (err) return err;
  return launch_skin(vertex_bwd_dvs_kernel, 3, Jp, Vp, Bp, s, a2, w, dout,
                     dvs, Jp, Vp, Bp);
}

// K2 and its sum: dcat [D, Bp] from dirs and dvs; part_dcat [S0, D, Bp].
int lemo_vertex_bwd_dcat(const float* dirs, const float* dvs, float* dcat,
                         float* part_dcat, int D, int Vp, int Bp,
                         void* stream) {
  if (!shapes_ok(D, 1, Vp, Bp)) return (int)cudaErrorInvalidValue;
  const DcatProblem p{dirs, dvs, part_dcat, D, Bp, 3 * Vp};
  return launch_reduction<DCAT_BM, DCAT_BN, DCAT_KC, DCAT_SLICES>(
      p, part_dcat, dcat, (long)D * Bp, (cudaStream_t)stream);
}

// K3 and its sum: dA2 [12, Jp, Bp] from W, vs and dout; part_da2
// [S1, 12, Jp, Bp].
int lemo_vertex_bwd_da2(const float* w, const float* vs, const float* dout,
                        float* da2, float* part_da2, int Jp, int Vp, int Bp,
                        void* stream) {
  if (!shapes_ok(1, Jp, Vp, Bp)) return (int)cudaErrorInvalidValue;
  const Da2Problem p{w, vs, dout, part_da2, Jp, 12 * Bp, Vp, Bp};
  return launch_reduction<DA2_BM, DA2_BN, DA2_KC, DA2_SLICES>(
      p, part_da2, da2, 12L * Jp * Bp, (cudaStream_t)stream);
}

// The backward from a blend vs [3, Vp, Bp] already formed (the forward's):
// K1b, then K2 and K3 with their sums, on one stream. lemo_vertex_bwd's
// arguments without cat, vs now an input. Scratch: dvs [3, Vp, Bp];
// part_dcat and part_da2 sized by lemo_vertex_bwd_slices.
int lemo_vertex_bwd_from_vs(const float* a2, const float* dirs,
                            const float* w, const float* dout, float* dcat,
                            float* da2, const float* vs, float* dvs,
                            float* part_dcat, float* part_da2, int D, int Jp,
                            int Vp, int Bp, void* stream) {
  if (!shapes_ok(D, Jp, Vp, Bp)) return (int)cudaErrorInvalidValue;
  int err = launch_skin(vertex_bwd_dvs_kernel, 3, Jp, Vp, Bp,
                        (cudaStream_t)stream, a2, w, dout, dvs, Jp, Vp, Bp);
  if (err) return err;
  err = lemo_vertex_bwd_dcat(dirs, dvs, dcat, part_dcat, D, Vp, Bp, stream);
  if (err) return err;
  return lemo_vertex_bwd_da2(w, vs, dout, da2, part_da2, Jp, Vp, Bp, stream);
}

// The whole backward: K1a into the scratch vs [3, Vp, Bp], then
// lemo_vertex_bwd_from_vs.
int lemo_vertex_bwd(const float* cat, const float* a2, const float* dirs,
                    const float* w, const float* dout, float* dcat,
                    float* da2, float* vs, float* dvs, float* part_dcat,
                    float* part_da2, int D, int Jp, int Vp, int Bp,
                    void* stream) {
  if (!shapes_ok(D, Jp, Vp, Bp)) return (int)cudaErrorInvalidValue;
  const int err =
      launch_blend(cat, dirs, vs, D, Vp, Bp, (cudaStream_t)stream);
  if (err) return err;
  return lemo_vertex_bwd_from_vs(a2, dirs, w, dout, dcat, da2, vs, dvs,
                                 part_dcat, part_da2, D, Jp, Vp, Bp, stream);
}

}  // extern "C"
