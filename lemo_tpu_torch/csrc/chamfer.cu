// Masked nearest neighbour (min, argmin) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lemo_tpu/ops/chamfer_pallas.py `_kernel`
// (one [TQ, 4] query tile against [4, TP] point tiles on the MXU). Here a
// block owns a tile of at most kThreads x kQueries consecutive queries of
// ONE frame (each thread kQueries consecutive ones); the grid runs over
// (query tile, frame), so the T frames of a window are one launch.
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
// different winners among near-ties. Ties go to the lowest index: the
// valid points are visited in ascending order and only a strictly smaller
// d replaces the carry, as the TPU kernel's strict `<` across tiles and
// first minimum within a tile do. A frame with no valid point returns +inf
// and index 0.
//
// What bounds it: instruction slots. Per (query, valid point) pair a
// thread executes 8 separately rounded f32 operations (3 mul + 2 add for
// q.p, add, mul, sub), a compare and two selects; none of them can be an
// FMA. The bytes (each query and point read once) are negligible. The
// design:
//
// 1. Only valid points are visited. A block stages its frame's points in
//    chunks of kChunk. For a masked call, each warp ballots the mask of
//    kThreads-point rounds, warp 0 scans the per-(round, warp) counts
//    (shuffles), and each valid point is written to its compacted slot in
//    ascending index order, as a recentred float4 (x, y, z, |p|^2) with
//    its original index beside it. The inner loop runs over the compacted
//    count only; a thread keeps the winner's slot within the chunk and
//    translates it to the original index once per chunk. One launch, no
//    host sync, no `nonzero`: the step stays capturable. An unmasked call
//    (the shared scene cloud of the contact term) stages the chunk as it
//    is, with no scan.
// 2. Each thread carries kQueries queries, so every broadcast float4 load
//    of shared memory feeds kQueries pairs.
// 3. A chunk of 2,048 points is 40 KB of static shared memory, which
//    leaves room for 5 blocks an SM. A frame's queries are cut evenly
//    into the fewest tiles of at most 128 threads x 2 queries: 800
//    blocks of 256 at the depth terms' 2,048 x 2,048, 500 of 225 at the
//    contact term's 1,121 queries. On the card 2 queries a thread beat 4
//    and 8 on the main path: the finer grid spreads over the 132 SMs
//    better than the shared load it saves (PERF.md). Tiles cut
//    finer than the fewest leave warps part-empty and restage the
//    frame's points; they lost.
// The staging's loads are not double-buffered: staged with cp.async into
// two buffers while the previous chunk is computed, the kernel ran no
// faster on the card.
//
// Not used, and why: tensor cores (the cross term is a K = 3 product that
// lemo_tpu asks for at Precision.HIGHEST; the port's rule is exact f32,
// and 3xTF32 would not reproduce the plain version's bits, which decide
// near-ties at scene scale), and FMA contraction (the __f*_rn intrinsics).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQueries = 2;
constexpr int kChunk = 2048;
constexpr int kUnroll = 4;                   // of the loop over points
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = kChunk / kThreads;   // mask ballots of a chunk
constexpr int kSlots = kRounds * kWarps;     // (round, warp) counts
constexpr int kSlotsPerLane = (kSlots + 31) / 32;
constexpr int kTileQ = kThreads * kQueries;
static_assert(kThreads % 32 == 0 && kChunk % kThreads == 0,
              "a chunk is whole rounds of whole warps");

__device__ __forceinline__ float4 recentred(const float* P, int m, float cx,
                                            float cy, float cz) {
  const float x = __fsub_rn(P[3LL * m + 0], cx);
  const float y = __fsub_rn(P[3LL * m + 1], cy);
  const float z = __fsub_rn(P[3LL * m + 2], cz);
  return make_float4(x, y, z,
                     __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                               __fmul_rn(z, z)));
}

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
nn_select_kernel(const float* __restrict__ query,
                 const float* __restrict__ points,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ center,
                 long long* __restrict__ out_idx,
                 float* __restrict__ out_d, int N, int M, int nq,
                 long long p_stride, long long m_stride) {
  __shared__ float4 pts[kChunk];
  __shared__ int ids[kChunk];
  __shared__ unsigned ballots[kSlots];
  __shared__ int offsets[kSlots];
  __shared__ int n_valid;
  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the block's queries [first, end), nq <= kTileQ; a warp with none of
  // them skips the pairs (warp-uniform)
  const int first = (int)blockIdx.x * nq;
  const int end = min(N, first + nq);
  const int i0 = first + (int)threadIdx.x * kQueries;
  const bool busy = first + warp * 32 * kQueries < end;
  const float cx = center[3 * t + 0];
  const float cy = center[3 * t + 1];
  const float cz = center[3 * t + 2];

  float qx[kQueries], qy[kQueries], qz[kQueries], q2[kQueries];
  float best[kQueries];
  int best_i[kQueries], win[kQueries];
#pragma unroll
  for (int r = 0; r < kQueries; ++r) {
    const int i = i0 + r;
    qx[r] = qy[r] = qz[r] = 0.f;
    if (i < end) {
      const float* q = query + ((long long)t * N + i) * 3;
      qx[r] = __fsub_rn(q[0], cx);
      qy[r] = __fsub_rn(q[1], cy);
      qz[r] = __fsub_rn(q[2], cz);
    }
    q2[r] = __fadd_rn(__fadd_rn(__fmul_rn(qx[r], qx[r]),
                                __fmul_rn(qy[r], qy[r])),
                      __fmul_rn(qz[r], qz[r]));
    best[r] = CUDART_INF_F;
    best_i[r] = 0;
  }
  const float* P = points + (long long)t * p_stride;
  const unsigned char* Mk = kMasked ? mask + (long long)t * m_stride : nullptr;

  for (int base = 0; base < M; base += kChunk) {
    __syncthreads();  // the previous chunk is no longer read
    int n;
    if constexpr (kMasked) {
      // a ballot of each kThreads-point round, per warp
#pragma unroll 4
      for (int r = 0; r < kRounds; ++r) {
        const int m = base + r * kThreads + threadIdx.x;
        const unsigned b = __ballot_sync(0xffffffffu, m < M && Mk[m] != 0);
        if (lane == 0) ballots[r * kWarps + warp] = b;
      }
      __syncthreads();
      // exclusive scan of the (round, warp) counts, in index order
      if (warp == 0) {
        int cnt[kSlotsPerLane];
        int local = 0;
#pragma unroll
        for (int k = 0; k < kSlotsPerLane; ++k) {
          const int s = lane * kSlotsPerLane + k;
          cnt[k] = s < kSlots ? __popc(ballots[s]) : 0;
          local += cnt[k];
        }
        int incl = local;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int up = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += up;
        }
        int run = incl - local;
#pragma unroll
        for (int k = 0; k < kSlotsPerLane; ++k) {
          const int s = lane * kSlotsPerLane + k;
          if (s < kSlots) offsets[s] = run;
          run += cnt[k];
        }
        if (lane == 31) n_valid = incl;
      }
      __syncthreads();
      // each valid point to its compacted slot
      const unsigned below = (1u << lane) - 1u;
#pragma unroll 4
      for (int r = 0; r < kRounds; ++r) {
        const unsigned b = ballots[r * kWarps + warp];
        if ((b >> lane) & 1u) {
          const int m = base + r * kThreads + threadIdx.x;
          const int s = offsets[r * kWarps + warp] + __popc(b & below);
          pts[s] = recentred(P, m, cx, cy, cz);
          ids[s] = m;
        }
      }
      __syncthreads();
      n = n_valid;
    } else {
      n = min(kChunk, M - base);
      for (int j = threadIdx.x; j < n; j += kThreads)
        pts[j] = recentred(P, base + j, cx, cy, cz);
      __syncthreads();
    }

    if (!busy) continue;
#pragma unroll
    for (int r = 0; r < kQueries; ++r) win[r] = -1;
#pragma unroll (kUnroll)
    for (int j = 0; j < n; ++j) {
      const float4 p = pts[j];
#pragma unroll
      for (int r = 0; r < kQueries; ++r) {
        const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx[r], p.x),
                                              __fmul_rn(qy[r], p.y)),
                                    __fmul_rn(qz[r], p.z));
        const float d = __fsub_rn(__fadd_rn(q2[r], p.w),
                                  __fmul_rn(2.f, dot));
        if (d < best[r]) {
          best[r] = d;
          win[r] = j;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kQueries; ++r)
      if (win[r] >= 0) best_i[r] = kMasked ? ids[win[r]] : base + win[r];
  }
#pragma unroll
  for (int r = 0; r < kQueries; ++r) {
    const int i = i0 + r;
    if (i < end) {
      out_idx[(long long)t * N + i] = best_i[r];
      out_d[(long long)t * N + i] = best[r];
    }
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
  // the fewest tiles that hold N, cut evenly
  const int tiles = (N + kTileQ - 1) / kTileQ;
  const int nq = (N + tiles - 1) / tiles;
  const dim3 grid(tiles, T);
  const long long p_stride = points_batched ? 3LL * M : 0LL;
  const long long m_stride = mask_batched ? (long long)M : 0LL;
  if (mask)
    nn_select_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        query, points, mask, center, out_idx, out_d, N, M, nq, p_stride,
        m_stride);
  else
    nn_select_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        query, points, mask, center, out_idx, out_d, N, M, nq, p_stride,
        m_stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
