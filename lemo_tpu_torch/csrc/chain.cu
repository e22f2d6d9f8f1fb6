// Kinematic-chain composition, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels lemo_tpu/body_model/chain_pallas.py
// `_fwd_kernel` (serial walk G[j] = G[p] L[j]) and `_bwd_kernel` (the
// reverse sweep).
//
// Layout: rotation planes [9, Jp, B] and translation planes [3, Jp, B]
// (row k = 3m+n of a rotation plane holds R[m, n]); element (k, j, b) sits
// at (k*Jp + j)*B + b. One thread walks the whole tree for one frame, so
// neighbouring threads read neighbouring b and every load and store is
// coalesced. Within a frame the walk is serial (a child needs its parent's
// global transform), which is exactly the TPU kernel's schedule.
//
// What bounds it: neither bytes (~0.3 MB at B=128) nor operations (~0.3
// MFLOP) — the walk is a chain of ~55 dependent steps of ~40 FMAs each,
// run by only B threads (one or a few warps on a 132-SM card). It is
// latency-bound by construction; the design keeps every step's operands
// in L1 (the parent row it reads back was written by the same thread a
// few steps earlier) and does no synchronisation at all. Making it fast
// (several threads per frame, one per subtree) is later work.
//
// Requires parents[j] < j (the wrapper renumbers the joints of any other
// tree into a topological order first). Accumulates in f32 with FMA: no TF32, no half precision.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void chain_fwd_kernel(const int* __restrict__ parents,
                                 const float* __restrict__ rl,
                                 const float* __restrict__ tl,
                                 float* rg, float* tg, int Jp, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long plane = (long)Jp * B;
  auto at = [&](int k, int j) { return k * plane + (long)j * B + b; };

  // root: G[0] = L[0]
  for (int k = 0; k < 9; ++k) rg[at(k, 0)] = rl[at(k, 0)];
  for (int k = 0; k < 3; ++k) tg[at(k, 0)] = tl[at(k, 0)];

  for (int j = 1; j < Jp; ++j) {
    const int p = parents[j];
    float gp[9], lj[9], tj[3], tp[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      gp[k] = rg[at(k, p)];
      lj[k] = rl[at(k, j)];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      tj[k] = tl[at(k, j)];
      tp[k] = tg[at(k, p)];
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        float acc = gp[3 * m + 0] * lj[0 + n];
        acc += gp[3 * m + 1] * lj[3 + n];
        acc += gp[3 * m + 2] * lj[6 + n];
        rg[at(3 * m + n, j)] = acc;
      }
      tg[at(m, j)] = gp[3 * m + 0] * tj[0] + gp[3 * m + 1] * tj[1] +
                     gp[3 * m + 2] * tj[2] + tp[m];
    }
  }
}

// sg/st: scratch [9|3, Jp, B] holding the running cotangents of G and t_g
// (the incoming cotangents plus every child's contribution).
__global__ void chain_bwd_kernel(const int* __restrict__ parents,
                                 const float* __restrict__ rl,
                                 const float* __restrict__ tl,
                                 const float* __restrict__ rg,
                                 const float* __restrict__ drg_in,
                                 const float* __restrict__ dtg_in,
                                 float* __restrict__ drl,
                                 float* __restrict__ dtl, float* sg,
                                 float* st, int Jp, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long plane = (long)Jp * B;
  auto at = [&](int k, int j) { return k * plane + (long)j * B + b; };

  for (int j = 0; j < Jp; ++j) {
    for (int k = 0; k < 9; ++k) sg[at(k, j)] = drg_in[at(k, j)];
    for (int k = 0; k < 3; ++k) st[at(k, j)] = dtg_in[at(k, j)];
  }

  // children before parents: walk j = Jp-1 .. 1
  for (int j = Jp - 1; j >= 1; --j) {
    const int p = parents[j];
    float gp[9], lj[9], tj[3], dgj[9], dtj[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      gp[k] = rg[at(k, p)];
      lj[k] = rl[at(k, j)];
      dgj[k] = sg[at(k, j)];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      tj[k] = tl[at(k, j)];
      dtj[k] = st[at(k, j)];
    }
    // dL[j] = G[p]^T dG[j];  dt_l[j] = R_g[p]^T dt_g[j]
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        float acc = gp[0 + m] * dgj[0 + n];
        acc += gp[3 + m] * dgj[3 + n];
        acc += gp[6 + m] * dgj[6 + n];
        drl[at(3 * m + n, j)] = acc;
      }
      dtl[at(m, j)] = gp[0 + m] * dtj[0] + gp[3 + m] * dtj[1] +
                      gp[6 + m] * dtj[2];
    }
    // dG[p] += dG[j] L[j]^T + dt_g[j] (x) t_l[j];  dt_g[p] += dt_g[j]
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        float acc = dgj[3 * m + 0] * lj[3 * n + 0];
        acc += dgj[3 * m + 1] * lj[3 * n + 1];
        acc += dgj[3 * m + 2] * lj[3 * n + 2];
        acc += dtj[m] * tj[n];
        sg[at(3 * m + n, p)] += acc;
      }
      st[at(m, p)] += dtj[m];
    }
  }
  // root: dL[0] = dG[0], dt_l[0] = dt_g[0]
  for (int k = 0; k < 9; ++k) drl[at(k, 0)] = sg[at(k, 0)];
  for (int k = 0; k < 3; ++k) dtl[at(k, 0)] = st[at(k, 0)];
}

}  // namespace

extern "C" {

const char* lemo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int lemo_chain_fwd(const int* parents, const float* rl, const float* tl,
                   float* rg, float* tg, int Jp, int B, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  chain_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      parents, rl, tl, rg, tg, Jp, B);
  return (int)cudaGetLastError();
}

int lemo_chain_bwd(const int* parents, const float* rl, const float* tl,
                   const float* rg, const float* drg, const float* dtg,
                   float* drl, float* dtl, float* sg, float* st, int Jp,
                   int B, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  chain_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      parents, rl, tl, rg, drg, dtg, drl, dtl, sg, st, Jp, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
