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
// register-tiled SGEMM on the CUDA cores, fused so that no [B, V, 3]
// intermediate (vs, T) ever reaches device memory.
//
// Design: one block of 128 threads per (64-vertex x 32-frame) tile; each
// thread owns a 4x4 (vertex x frame) micro-tile and keeps its 48 blend
// sums in registers (phase 1: dirs and cat staged through shared memory in
// chunks of D, read as float4). Phase 2 stages W once and one A2 plane at a
// time and forms each T[k] micro-tile in registers, folding it straight
// into the output. The B tile is the fastest grid index, so the blocks
// that read the same dirs rows run together and share them through L2.
//
// The TPU backward sums dcat and dA2 across V tiles in scratch, because its
// grid runs in order. Hopper's blocks run in parallel and in no order, so
// each V tile writes its partial dcat [D, Bp] and dA2 [12, Jp, Bp] to a
// scratch slab [nVtiles, ...] and a second pass sums the slabs in a fixed
// order: deterministic, no atomics.
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
constexpr int LDJ = MAXJ + 4; // padded row of a [.][MAXJ] smem tile

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

// Backward shared memory (floats): vs, dout, dvs tiles [3][TV][TB] each,
// W as [j][v], and one staging area reused by every phase.
constexpr int SM_TILE = 3 * TV * TB;
constexpr int STAGE_BWD =
    STAGE_BLEND > TV * LDJ ? (STAGE_BLEND > SM_A ? STAGE_BLEND : SM_A)
                           : (TV * LDJ > SM_A ? TV * LDJ : SM_A);
constexpr int BWD_SMEM_FLOATS = 3 * SM_TILE + SM_W + STAGE_BWD;
constexpr int KD4 = 64;  // D chunk of the dcat phase (staged as [v][LDJ])
static_assert(TV * LDJ >= TV * (KD4 + 4), "dcat staging must fit");

__global__ void __launch_bounds__(NT)
    vertex_bwd_kernel(const float* __restrict__ cat,
                      const float* __restrict__ a2,
                      const float* __restrict__ dirs,
                      const float* __restrict__ w,
                      const float* __restrict__ dout,
                      float* __restrict__ part_dcat,
                      float* __restrict__ part_da2, int D, int Jp, int Vp,
                      int Bp) {
  extern __shared__ __align__(16) float dsm[];
  float* s_vs = dsm;                    // [3][TV][TB]
  float* s_dout = s_vs + SM_TILE;       // [3][TV][TB]
  float* s_dvs = s_dout + SM_TILE;      // [3][TV][TB]
  float* s_w = s_dvs + SM_TILE;         // [MAXJ][LDV]
  float* stage = s_w + SM_W;

  const int tid = threadIdx.x, tb = tid % 8, tv = tid / 8;
  const int bbase = blockIdx.x * TB, vbase = blockIdx.y * TV;
  const int tile = blockIdx.y;

  // phase 1: recompute vs; park it and dout in shared memory
  {
    float vs[3][4][4];
    blend_phase(cat, dirs, stage, vs, D, Vp, Bp, vbase, bbase, tv, tb);
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        st4(&s_vs[(n * TV + 4 * tv + r) * TB + 4 * tb],
            make_float4(vs[n][r][0], vs[n][r][1], vs[n][r][2], vs[n][r][3]));
  }
  for (int idx = tid; idx < 3 * TV * TB; idx += NT) {
    const int b = idx % TB, v = (idx / TB) % TV, m = idx / (TB * TV);
    s_dout[idx] = dout[((long)m * Vp + vbase + v) * Bp + bbase + b];
  }
  stage_w_jv(w, s_w, Jp, vbase);

  // phase 2: dvs[n] = sum_m T[3m+n] * dout[m]
  {
    float dvs[3][4][4];
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) dvs[n][r][i] = 0.f;
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        float T[4][4];
        skin_plane(a2, s_w, stage, 3 * m + n, T, Jp, Bp, bbase, tv, tb);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 d4 = ld4(&s_dout[(m * TV + 4 * tv + r) * TB + 4 * tb]);
#pragma unroll
          for (int i = 0; i < 4; ++i) dvs[n][r][i] += T[r][i] * comp(d4, i);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        st4(&s_dvs[(n * TV + 4 * tv + r) * TB + 4 * tb],
            make_float4(dvs[n][r][0], dvs[n][r][1], dvs[n][r][2],
                        dvs[n][r][3]));
  }

  // phase 3: partial dA2[k][j][b] = sum_v W[v][j] dT[k][v][b]; W staged as
  // [v][j]; thread owns 4 joints (4*tj..) x 4 frames
  __syncthreads();
  float* s_wvj = stage;  // [TV][LDJ]
  for (int idx = tid; idx < TV * MAXJ; idx += NT) {
    const int j = idx % MAXJ, v = idx / MAXJ;
    s_wvj[v * LDJ + j] = j < Jp ? w[(long)(vbase + v) * Jp + j] : 0.f;
  }
  __syncthreads();
  const int tj = tid / 8;
#pragma unroll 1
  for (int k = 0; k < 12; ++k) {
    float acc[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
    const float* dsrc = s_dout + (k < 9 ? k / 3 : k - 9) * TV * TB;
    const float* vsrc = s_vs + (k % 3) * TV * TB;
#pragma unroll 4
    for (int v = 0; v < TV; ++v) {
      const float4 wv = ld4(&s_wvj[v * LDJ + 4 * tj]);
      float4 dt = ld4(&dsrc[v * TB + 4 * tb]);
      if (k < 9) {
        const float4 s4 = ld4(&vsrc[v * TB + 4 * tb]);
        dt = make_float4(dt.x * s4.x, dt.y * s4.y, dt.z * s4.z, dt.w * s4.w);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] += comp(wv, c) * comp(dt, i);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * tj + c;
      if (j < Jp)
        st4(&part_da2[(((long)tile * 12 + k) * Jp + j) * Bp + bbase + 4 * tb],
            make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]));
    }
  }

  // phase 4: partial dcat[d][b] = sum_n sum_v dirs[n][v][d] dvs[n][v][b];
  // one n at a time, dirs staged as [v][d] in chunks of KD4; thread owns
  // 4 d (4*td..) x 4 frames
  const int td = tid / 8;
  for (int d0 = 0; d0 < D; d0 += KD4) {
    float acc[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;
    for (int n = 0; n < 3; ++n) {
      __syncthreads();
      for (int idx = tid; idx < TV * KD4; idx += NT) {
        const int dd = idx % KD4, v = idx / KD4, d = d0 + dd;
        stage[v * LDJ + dd] =
            d < D ? dirs[((long)n * Vp + vbase + v) * D + d] : 0.f;
      }
      __syncthreads();
      const float* g = s_dvs + n * TV * TB;
#pragma unroll 4
      for (int v = 0; v < TV; ++v) {
        const float4 a = ld4(&stage[v * LDJ + 4 * td]);
        const float4 g4 = ld4(&g[v * TB + 4 * tb]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[c][i] += comp(a, c) * comp(g4, i);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = d0 + 4 * td + c;
      if (d < D)
        st4(&part_dcat[((long)tile * D + d) * Bp + bbase + 4 * tb],
            make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]));
    }
  }
}

// out[i] = sum_t part[t * n + i], t in order: the deterministic second pass.
__global__ void sum_tiles_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, long n,
                                 int tiles) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += part[(long)t * n + i];
    out[i] = s;
  }
}

bool shapes_ok(int D, int Jp, int Vp, int Bp) {
  return D > 0 && Jp > 0 && Jp <= MAXJ && Vp > 0 && Vp % TV == 0 &&
         Bp > 0 && Bp % TB == 0;
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

// Number of V tiles, the leading extent of the backward's scratch slabs
// (the caller sizes them with it); -1 when Vp is not a whole number of
// tiles.
int lemo_vertex_bwd_tiles(int Vp) {
  return Vp > 0 && Vp % TV == 0 ? Vp / TV : -1;
}

// part_dcat: scratch [tiles, D, Bp]; part_da2: scratch [tiles, 12, Jp, Bp],
// tiles = lemo_vertex_bwd_tiles(Vp)
int lemo_vertex_bwd(const float* cat, const float* a2, const float* dirs,
                    const float* w, const float* dout, float* dcat,
                    float* da2, float* part_dcat, float* part_da2, int D,
                    int Jp, int Vp, int Bp, void* stream) {
  if (!shapes_ok(D, Jp, Vp, Bp)) return (int)cudaErrorInvalidValue;
  const int smem = BWD_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      vertex_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(Bp / TB, Vp / TV);
  vertex_bwd_kernel<<<grid, NT, smem, s>>>(cat, a2, dirs, w, dout,
                                           part_dcat, part_da2, D, Jp, Vp,
                                           Bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = Vp / TV;
  const long n_dcat = (long)D * Bp, n_da2 = 12L * Jp * Bp;
  sum_tiles_kernel<<<(int)((n_dcat + 255) / 256), 256, 0, s>>>(
      part_dcat, dcat, n_dcat, tiles);
  sum_tiles_kernel<<<(int)((n_da2 + 255) / 256), 256, 0, s>>>(
      part_da2, da2, n_da2, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
