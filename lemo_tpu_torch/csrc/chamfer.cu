// Masked nearest neighbour (min, argmin) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lemo_tpu/ops/chamfer_pallas.py `_kernel`
// (one [TQ, 4] query tile against [4, TP] point tiles on the MXU). Here a
// block owns 256 queries of ONE frame; the grid runs over (query tile,
// frame), so the T frames of a window are one launch. Point tiles of 1024
// are staged in shared memory as float4 (x, y, z, |p|^2) after recentring;
// a masked or out-of-range point is (0, 0, 0, +inf), so its distance is
// +inf and it never wins. Every thread of a warp reads the same tile entry
// (a shared-memory broadcast), and keeps its running (min, argmin) in
// registers.
//
// Arithmetic (the plain version in lemo_tpu_torch/ops/chamfer.py repeats
// it op for op, so the two agree bit for bit): coordinates recentred on
// the frame's query mean `center[t]`,
//   d = (|q|^2 + |p|^2) - 2 (q . p),  |q|^2 = (x*x + y*y) + z*z,
//   q . p = (qx*px + qy*py) + qz*pz,
// every operation a separately rounded f32 intrinsic: no FMA contraction,
// no TF32, no fast math. At scene scale (|q|^2 ~ 10 m^2 after recentring
// on a mean that includes padding rows) one rounding is ~1e-6 m^2, so an
// FMA here would already make the kernel and its plain version pick
// different winners among near-ties. Ties go to the lowest index: points are
// visited in ascending order and only a strictly smaller d replaces the
// carry, as the TPU kernel's strict `<` across tiles and first minimum
// within a tile do. A frame with no valid point returns +inf and index 0.
//
// What bounds it: operations. Per pair it issues one 16-byte shared load
// and 9 f32 operations (3 mul + 2 add for q.p, add, mul, sub, compare);
// the bytes (each query and point read once) are negligible. The bound
// counts those 9 operations per pair at the card's f32 rate. Making it
// fast (several queries per thread to reuse each shared load, the tile in
// registers) is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
nn_select_kernel(const float* __restrict__ query,
                 const float* __restrict__ points,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ center,
                 long long* __restrict__ out_idx,
                 float* __restrict__ out_d, int N, int M,
                 long long p_stride, long long m_stride) {
  __shared__ float4 tile[kTile];
  const int t = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float cx = center[3 * t + 0];
  const float cy = center[3 * t + 1];
  const float cz = center[3 * t + 2];

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < N) {
    const float* q = query + ((long long)t * N + i) * 3;
    qx = __fsub_rn(q[0], cx);
    qy = __fsub_rn(q[1], cy);
    qz = __fsub_rn(q[2], cz);
  }
  const float q2 = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                             __fmul_rn(qz, qz));
  const float* P = points + (long long)t * p_stride;
  const unsigned char* Mk = mask ? mask + (long long)t * m_stride : nullptr;

  float best = CUDART_INF_F;
  int best_i = 0;
  for (int base = 0; base < M; base += kTile) {
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const int m = base + j;
      float4 e = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
      if (m < M && (Mk == nullptr || Mk[m])) {
        const float x = __fsub_rn(P[3LL * m + 0], cx);
        const float y = __fsub_rn(P[3LL * m + 1], cy);
        const float z = __fsub_rn(P[3LL * m + 2], cz);
        e = make_float4(x, y, z,
                        __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                  __fmul_rn(z, z)));
      }
      tile[j] = e;
    }
    __syncthreads();
    const int n = min(kTile, M - base);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float4 p = tile[j];
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
                                  __fmul_rn(qz, p.z));
      const float d = __fsub_rn(__fadd_rn(q2, p.w), __fmul_rn(2.f, dot));
      if (d < best) {
        best = d;
        best_i = base + j;
      }
    }
  }
  if (i < N) {
    out_idx[(long long)t * N + i] = best_i;
    out_d[(long long)t * N + i] = best;
  }
}

}  // namespace

extern "C" {

// query [T, N, 3]; points [T, M, 3] (points_batched) or [M, 3]; mask
// [T, M] (mask_batched) or [M] bytes, or null for all valid; center
// [T, 3]; out_idx [T, N] int64; out_d [T, N].
int lemo_nn_select(const float* query, const float* points,
                   const unsigned char* mask, const float* center,
                   long long* out_idx, float* out_d, int T, int N, int M,
                   int points_batched, int mask_batched, void* stream) {
  if (T <= 0 || N <= 0) return 0;
  const dim3 grid((N + kThreads - 1) / kThreads, T);
  nn_select_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      query, points, mask, center, out_idx, out_d, N, M,
      points_batched ? 3LL * M : 0LL, mask_batched ? (long long)M : 0LL);
  return (int)cudaGetLastError();
}

}  // extern "C"
