// Kinematic-chain composition, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels lemo_tpu/body_model/chain_pallas.py:48
// `_fwd_kernel` (the walk G[j] = G[p] L[j]) and :82 `_bwd_kernel` (its
// reverse sweep). The `affine` entry points also take in the XLA ops
// that surround that pair in lemo_tpu/body_model/lbs.py:_lbs_fused: the
// rel-joint translations t_l[j] = jr[j] - jr[p] before the walk, the bone
// affines A = [R_g; t_g - R_g jr] after it, and their transposes.
//
// Layout: planes [9|3|12, Jp, B] (row k = 3m+n of a rotation plane holds
// R[m, n]); element (k, j, b) sits at (k*Jp + j)*B + b.
//
// What bounds it: neither bytes (~0.3 MB at B = 128, 0.0002-0.0003 ms at
// 3.35 TB/s) nor operations (~1 MFLOP), but latency and the launch. The
// walk is a chain of dependent steps, and a call lasts a few microseconds,
// close to an empty launch. The first design gave each frame's tree to
// one thread: 54 serial steps, each a round trip through global memory,
// on one block of one SM.
//
// This design: a block owns kFrames frames. It stages their planes and
// the level schedule (built by the wrapper from the parents) in shared
// memory, every load of a thread in flight at once (one round trip), then
// walks the tree one level at a time, one thread per (joint of the level,
// frame, output entry), with one barrier between levels: 10 dependent
// steps for SMPL-X (depths 0..10), all in shared memory. A level's items
// (12 x its joints x kFrames) fit one pass of the block for SMPL-X's
// widest level (10 joints). kFrames = 2 spreads Bp = 128 frames over 64
// blocks of 256 threads, on 64 SMs: of 1, 2, 4 and 8 frames a block it
// took the least device time on the H100 (scripts/bench_torch_chain.py,
// PERF.md), since fewer threads make the barriers cheaper while the
// loads stay one round trip.
//
// The backward walks from the deepest level up. Each joint of a level
// writes dL and dt_l, and its 9-value contribution to its parent's dG
// into shared memory. Then each parent on the level above adds its
// children's contributions in decreasing child index. That is the order
// of the serial walk j = Jp-1 .. 1, so the sums need no atomics, do not
// depend on the schedule, and repeat launches are bit-identical.
//
// Arithmetic: each entry is the first design's expression in the order
// its build contracted it into FMAs (`cuobjdump -sass`), spelled out with
// __fmul_rn / __fmaf_rn / __fadd_rn (`dot3`), so the outputs match it to
// the bit. The affine epilogue uses no FMA: the eager ops it replaces
// round after every multiply and add, and A and t_g match them to the bit.
//
// Shared memory a frame, at Jp = 56: forward 24 x Jp floats (5.4 KB),
// backward 42 x Jp (9.4 KB), affine backward 48 x Jp (10.8 KB); at
// kFrames = 2 at most 21.5 KB a block, plus 1,104 B of schedule, below
// the 48 KB that needs cudaFuncSetAttribute (which `launch` calls above
// it). Registers and spills: scripts/bench_torch_chain.py prints ptxas's
// report (PERF.md: none spill).
//
// Requires parents[j] < j (the wrapper renumbers any other tree first).
// All f32; no TF32, no half precision.

#include <cuda_runtime.h>

namespace {

constexpr int kFrames = 2;           // frames a block
constexpr int kLevelWidth = 10;      // SMPL-X's widest level: one pass
constexpr int kThreads = (12 * kLevelWidth * kFrames + 31) / 32 * 32;
constexpr int kMaxJoints = 64;       // the static limits the wrapper checks
constexpr int kMaxLevels = 16;
constexpr int kMaxRows = 36;         // planes a block stages (affine backward)
constexpr int kLoadsPerThread =
    (kMaxRows * kMaxJoints * kFrames + kThreads - 1) / kThreads;

// The level schedule, as the wrapper packs it (int32):
// parent[Jp], order[Jp] (the joints by level, root first), child_start[Jp+1],
// child[Jp-1] (each joint's children in decreasing index), level_start[nlev+1].
struct Schedule {
  int parent[kMaxJoints];
  int order[kMaxJoints];
  int child_start[kMaxJoints + 1];
  int child[kMaxJoints];
  int level_start[kMaxLevels + 1];
};

__device__ __forceinline__ void stage_schedule(Schedule& s, const int* sched,
                                               int nlev, int Jp) {
  for (int i = threadIdx.x; i < Jp; i += blockDim.x) {
    s.parent[i] = sched[i];
    s.order[i] = sched[Jp + i];
    s.child_start[i] = sched[2 * Jp + i];
    if (i < Jp - 1) s.child[i] = sched[3 * Jp + 1 + i];
  }
  if (threadIdx.x == 0) s.child_start[Jp] = sched[3 * Jp];
  for (int i = threadIdx.x; i <= nlev; i += blockDim.x)
    s.level_start[i] = sched[4 * Jp + i];
}

// Stage rows [k*Jp + j] of the block's frames into shared memory: element
// i = row*kFrames + f comes from src(row)[b0 + f] (0 past the last frame)
// and goes to put(i, v). Every load of a thread is issued before its first
// store, so the block waits for one round trip to global memory, not one
// per element.
template <class Src, class Put>
__device__ __forceinline__ void stage_rows(int n, int nf, int b0, Src src,
                                           Put put) {
  float v[kLoadsPerThread];
#pragma unroll
  for (int u = 0; u < kLoadsPerThread; ++u) {
    const int i = threadIdx.x + u * kThreads;
    v[u] = i < n && i % kFrames < nf ? src(i / kFrames)[b0 + i % kFrames]
                                     : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kLoadsPerThread; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < n) put(i, v[u]);
  }
}

// a0*b0 + a1*b1 + a2*b2 as the first design's build evaluated it
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a0, b0, __fmul_rn(a1, b1)));
}

// t_g[m] - (R_g[m, 0] jr[0] + R_g[m, 1] jr[1] + R_g[m, 2] jr[2]), rounded
// after every operation, as the eager epilogue does
__device__ __forceinline__ float rel_translation(float t, float r0, float j0,
                                                 float r1, float j1, float r2,
                                                 float j2) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(r0, j0), __fmul_rn(r1, j1)),
                            __fmul_rn(r2, j2));
  return __fsub_rn(t, s);
}

// shared-memory planes [comp][Jp][kFrames]
struct Planes {
  float* base;
  int Jp;
  __device__ __forceinline__ float& operator()(int k, int j, int f) const {
    return base[(k * Jp + j) * kFrames + f];
  }
};

// t_l[n] of non-root joint j: the plane itself, or in the affine form
// jr[j] - jr[p] (jr[j] for the padding joints j >= J)
template <bool kAffine>
__device__ __forceinline__ float local_t(const Planes& t, int n, int j, int p,
                                         int f, int J) {
  if (kAffine && j < J) return __fsub_rn(t(n, j, f), t(n, p, f));
  return t(n, j, f);
}

// Forward. In: rl [9], t_in [3] (t_l, or jr in the affine form). Out: the
// rotations into r_out [9] (or A [12]: R_g, then the rel translations) and
// t_g into tg [3].
template <bool kAffine>
__device__ __forceinline__ void chain_fwd_body(
    const int* __restrict__ sched, int nlev, const float* __restrict__ rl,
    const float* __restrict__ t_in, float* __restrict__ r_out,
    float* __restrict__ tg_out, int J, int Jp, int B) {
  __shared__ Schedule s;
  extern __shared__ __align__(16) float smem[];
  const int JF = Jp * kFrames;
  const Planes L{smem, Jp}, T{smem + 9 * JF, Jp}, G{smem + 12 * JF, Jp},
      TG{smem + 21 * JF, Jp};
  const int b0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, B - b0);
  stage_schedule(s, sched, nlev, Jp);

  // L and t_in in (rows k*Jp + j of the two, back to back); the root's
  // G is its L and its t_g its t_l (= jr[0] in the affine form)
  stage_rows(
      12 * JF, nf, b0,
      [&](int row) {
        return row < 9 * Jp ? rl + (long)row * B
                            : t_in + (long)(row - 9 * Jp) * B;
      },
      [&](int i, float v) {
        const int f = i % kFrames, row = i / kFrames;
        smem[i] = v;
        if (row % Jp == 0) {
          if (row < 9 * Jp) G(row / Jp, 0, f) = v;
          else TG(row / Jp - 9, 0, f) = v;
        }
      });
  __syncthreads();

  for (int lev = 1; lev < nlev; ++lev) {
    const int first = s.level_start[lev];
    const int items = (s.level_start[lev + 1] - first) * 12 * kFrames;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int f = i % kFrames, e = (i / kFrames) % 12;
      const int j = s.order[first + i / (12 * kFrames)];
      const int p = s.parent[j];
      if (e < 9) {
        // G[j][m, n] = sum_k G[p][m, k] L[j][k, n]
        const int m = e / 3, n = e % 3;
        G(e, j, f) = dot3(G(3 * m, p, f), L(n, j, f), G(3 * m + 1, p, f),
                          L(3 + n, j, f), G(3 * m + 2, p, f), L(6 + n, j, f));
      } else {
        // t_g[j][m] = sum_k G[p][m, k] t_l[j][k] + t_g[p][m]
        const int m = e - 9;
        const float t0 = local_t<kAffine>(T, 0, j, p, f, J);
        const float t1 = local_t<kAffine>(T, 1, j, p, f, J);
        const float t2 = local_t<kAffine>(T, 2, j, p, f, J);
        TG(m, j, f) = __fadd_rn(dot3(G(3 * m, p, f), t0, G(3 * m + 1, p, f),
                                     t1, G(3 * m + 2, p, f), t2),
                                TG(m, p, f));
      }
    }
    __syncthreads();
  }

  // out: R_g, t_g, and in the affine form the rel translations
  const int rows = kAffine ? 15 : 12;
  for (int i = threadIdx.x; i < rows * JF; i += blockDim.x) {
    const int f = i % kFrames, row = i / kFrames;
    if (f >= nf) continue;
    const int k = row / Jp, j = row % Jp;
    if (k < 9) {
      r_out[(long)row * B + b0 + f] = G(k, j, f);
    } else if (k < 12) {
      tg_out[(long)(row - 9 * Jp) * B + b0 + f] = TG(k - 9, j, f);
    } else {
      const int m = k - 12;
      r_out[(long)((9 + m) * Jp + j) * B + b0 + f] = rel_translation(
          TG(m, j, f), G(3 * m, j, f), T(0, j, f), G(3 * m + 1, j, f),
          T(1, j, f), G(3 * m + 2, j, f), T(2, j, f));
    }
  }
}

// Backward. In: rl [9], t_in [3] (t_l, or jr), rg [9] (R_g), the
// cotangents d_in [9] of R_g (or [12] of A) and dtg [3] of t_g. Out: drl
// [9] and dt_out [3]: dt_l, or in the affine form djr.
template <bool kAffine>
__device__ __forceinline__ void chain_bwd_body(
    const int* __restrict__ sched, int nlev, const float* __restrict__ rl,
    const float* __restrict__ t_in, const float* __restrict__ rg,
    const float* __restrict__ d_in, const float* __restrict__ dtg,
    float* __restrict__ drl, float* __restrict__ dt_out, int J, int Jp,
    int B) {
  __shared__ Schedule s;
  extern __shared__ __align__(16) float smem[];
  const int JF = Jp * kFrames;
  // loaded: L, t_in, G, dG (running), dt_g (running), in the affine form
  // dA's rel-translation rows; then the children's contributions to dG,
  // and in the affine form dt_l
  const Planes L{smem, Jp}, T{smem + 9 * JF, Jp}, G{smem + 12 * JF, Jp},
      SG{smem + 21 * JF, Jp}, ST{smem + 30 * JF, Jp}, DREL{smem + 33 * JF, Jp};
  const int nload = kAffine ? 36 : 33;
  const Planes C{smem + nload * JF, Jp}, DTL{smem + (nload + 9) * JF, Jp};
  const int b0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, B - b0);
  stage_schedule(s, sched, nlev, Jp);

  stage_rows(
      nload * JF, nf, b0,
      [&](int row) {
        const int k = row / Jp;
        if (k < 9) return rl + (long)row * B;
        if (k < 12) return t_in + (long)(row - 9 * Jp) * B;
        if (k < 21) return rg + (long)(row - 12 * Jp) * B;
        if (k < 30) return d_in + (long)(row - 21 * Jp) * B;
        if (k < 33) return dtg + (long)(row - 30 * Jp) * B;
        return d_in + (long)(row - 24 * Jp) * B;   // dA rows 9..11
      },
      [&](int i, float v) { smem[i] = v; });
  __syncthreads();

  if (kAffine) {
    // through the epilogue: dG = dA[0:9] - drel (x) jr, dt_g += drel
    for (int i = threadIdx.x; i < 12 * JF; i += blockDim.x) {
      const int f = i % kFrames, row = i / kFrames;
      const int k = row / Jp, j = row % Jp;
      if (k < 9) {
        SG(k, j, f) = __fsub_rn(SG(k, j, f),
                                __fmul_rn(DREL(k / 3, j, f), T(k % 3, j, f)));
      } else {
        ST(k - 9, j, f) = __fadd_rn(ST(k - 9, j, f), DREL(k - 9, j, f));
      }
    }
    __syncthreads();
  }

  for (int lev = nlev - 1; lev >= 1; --lev) {
    // the joints of this level: dL, dt_l, and their parents' shares
    const int first = s.level_start[lev];
    const int items = (s.level_start[lev + 1] - first) * 12 * kFrames;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int f = i % kFrames, e = (i / kFrames) % 12;
      const int j = s.order[first + i / (12 * kFrames)];
      const int p = s.parent[j];
      if (e < 9) {
        const int m = e / 3, n = e % 3;
        // dL[j][m, n] = sum_k G[p][k, m] dG[j][k, n]
        const float d = dot3(G(m, p, f), SG(n, j, f), G(3 + m, p, f),
                             SG(3 + n, j, f), G(6 + m, p, f), SG(6 + n, j, f));
        if (f < nf) drl[(long)(e * Jp + j) * B + b0 + f] = d;
        // dG[p][m, n] += sum_k dG[j][m, k] L[j][n, k] + dt_g[j][m] t_l[j][n]
        C(e, j, f) = __fmaf_rn(
            ST(m, j, f), local_t<kAffine>(T, n, j, p, f, J),
            dot3(SG(3 * m, j, f), L(3 * n, j, f), SG(3 * m + 1, j, f),
                 L(3 * n + 1, j, f), SG(3 * m + 2, j, f), L(3 * n + 2, j, f)));
      } else {
        // dt_l[j][m] = sum_k G[p][k, m] dt_g[j][k]
        const int m = e - 9;
        const float d = dot3(G(m, p, f), ST(0, j, f), G(3 + m, p, f),
                             ST(1, j, f), G(6 + m, p, f), ST(2, j, f));
        if (kAffine) DTL(m, j, f) = d;
        else if (f < nf) dt_out[(long)(m * Jp + j) * B + b0 + f] = d;
      }
    }
    __syncthreads();
    // the parents on the level above add their children's shares, in
    // decreasing child index; dt_g[p] += dt_g[child]
    const int pfirst = s.level_start[lev - 1];
    const int pitems = (first - pfirst) * 12 * kFrames;
    for (int i = threadIdx.x; i < pitems; i += blockDim.x) {
      const int f = i % kFrames, e = (i / kFrames) % 12;
      const int p = s.order[pfirst + i / (12 * kFrames)];
      const int c0 = s.child_start[p], c1 = s.child_start[p + 1];
      if (c0 == c1) continue;
      float& acc = e < 9 ? SG(e, p, f) : ST(e - 9, p, f);
      float sum = acc;
      for (int c = c0; c < c1; ++c)
        sum = __fadd_rn(sum, e < 9 ? C(e, s.child[c], f)
                                   : ST(e - 9, s.child[c], f));
      acc = sum;
    }
    __syncthreads();
  }

  // the root: dL[0] = dG[0], dt_l[0] = dt_g[0]
  for (int i = threadIdx.x; i < 12 * kFrames; i += blockDim.x) {
    const int f = i % kFrames, e = i / kFrames;
    if (e < 9) {
      if (f < nf) drl[(long)(e * Jp) * B + b0 + f] = SG(e, 0, f);
    } else if (kAffine) {
      DTL(e - 9, 0, f) = ST(e - 9, 0, f);
    } else if (f < nf) {
      dt_out[(long)((e - 9) * Jp) * B + b0 + f] = ST(e - 9, 0, f);
    }
  }
  if (!kAffine) return;
  __syncthreads();

  // djr[j] = dt_l[j] - sum_children dt_l[c] (children c < J, decreasing)
  //          - sum_m drel[m] R_g[m, n]
  for (int i = threadIdx.x; i < 3 * JF; i += blockDim.x) {
    const int f = i % kFrames, row = i / kFrames;
    if (f >= nf) continue;
    const int n = row / Jp, j = row % Jp;
    float acc = DTL(n, j, f);
    if (j < J) {
      for (int c = s.child_start[j]; c < s.child_start[j + 1]; ++c)
        if (s.child[c] < J) acc = __fsub_rn(acc, DTL(n, s.child[c], f));
    }
    acc = __fsub_rn(acc, dot3(DREL(0, j, f), G(n, j, f), DREL(1, j, f),
                              G(3 + n, j, f), DREL(2, j, f), G(6 + n, j, f)));
    dt_out[(long)row * B + b0 + f] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    chain_fwd_kernel(const int* sched, int nlev, const float* rl,
                     const float* tl, float* rg, float* tg, int Jp, int B) {
  chain_fwd_body<false>(sched, nlev, rl, tl, rg, tg, Jp, Jp, B);
}

__global__ void __launch_bounds__(kThreads)
    chain_affine_fwd_kernel(const int* sched, int nlev, const float* rl,
                            const float* jr, float* A, float* tg, int J,
                            int Jp, int B) {
  chain_fwd_body<true>(sched, nlev, rl, jr, A, tg, J, Jp, B);
}

__global__ void __launch_bounds__(kThreads)
    chain_bwd_kernel(const int* sched, int nlev, const float* rl,
                     const float* tl, const float* rg, const float* drg,
                     const float* dtg, float* drl, float* dtl, int Jp, int B) {
  chain_bwd_body<false>(sched, nlev, rl, tl, rg, drg, dtg, drl, dtl, Jp, Jp,
                        B);
}

__global__ void __launch_bounds__(kThreads)
    chain_affine_bwd_kernel(const int* sched, int nlev, const float* rl,
                            const float* jr, const float* A, const float* dA,
                            const float* dtg, float* drl, float* djr, int J,
                            int Jp, int B) {
  chain_bwd_body<true>(sched, nlev, rl, jr, A, dA, dtg, drl, djr, J, Jp, B);
}

bool shapes_ok(int nlev, int J, int Jp, int B) {
  return Jp >= 1 && Jp <= kMaxJoints && nlev >= 1 && nlev <= kMaxLevels &&
         J >= 1 && J <= Jp && B >= 1;
}

// launch `kernel` on ceil(B / kFrames) blocks with `floats` x Jp x kFrames
// floats of dynamic shared memory
template <class Kernel, class... Args>
int launch(Kernel* kernel, int floats, int Jp, int B, void* stream,
           Args... args) {
  const size_t smem = sizeof(float) * floats * Jp * kFrames;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + kFrames - 1) / kFrames;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* lemo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int lemo_chain_fwd(const int* sched, int nlev, const float* rl,
                   const float* tl, float* rg, float* tg, int Jp, int B,
                   void* stream) {
  if (!shapes_ok(nlev, Jp, Jp, B)) return (int)cudaErrorInvalidValue;
  return launch(chain_fwd_kernel, 24, Jp, B, stream, sched, nlev, rl, tl, rg,
                tg, Jp, B);
}

int lemo_chain_bwd(const int* sched, int nlev, const float* rl,
                   const float* tl, const float* rg, const float* drg,
                   const float* dtg, float* drl, float* dtl, int Jp, int B,
                   void* stream) {
  if (!shapes_ok(nlev, Jp, Jp, B)) return (int)cudaErrorInvalidValue;
  return launch(chain_bwd_kernel, 42, Jp, B, stream, sched, nlev, rl, tl, rg,
                drg, dtg, drl, dtl, Jp, B);
}

int lemo_chain_affine_fwd(const int* sched, int nlev, const float* rl,
                          const float* jr, float* A, float* tg, int J, int Jp,
                          int B, void* stream) {
  if (!shapes_ok(nlev, J, Jp, B)) return (int)cudaErrorInvalidValue;
  return launch(chain_affine_fwd_kernel, 24, Jp, B, stream, sched, nlev, rl,
                jr, A, tg, J, Jp, B);
}

int lemo_chain_affine_bwd(const int* sched, int nlev, const float* rl,
                          const float* jr, const float* A, const float* dA,
                          const float* dtg, float* drl, float* djr, int J,
                          int Jp, int B, void* stream) {
  if (!shapes_ok(nlev, J, Jp, B)) return (int)cudaErrorInvalidValue;
  return launch(chain_affine_bwd_kernel, 48, Jp, B, stream, sched, nlev, rl,
                jr, A, dA, dtg, drl, djr, J, Jp, B);
}

}  // extern "C"
