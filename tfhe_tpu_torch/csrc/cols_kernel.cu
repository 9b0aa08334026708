// Kernel G: the column-split whole blind rotation in one launch.
//
// Replaces: tfhe_tpu/ops/pallas/blind_rotate_kernel.py, blind_rotate_fused_cols
// (body _kernel_cols): carry-chain digits, key_limbs 4 (exact) or 3 (the low
// byte of each sign-twisted key word dropped).  The step is the one
// whole_scan.cuh writes out.  The TPU kernel's grid splits the output
// columns: each (step, column) expands only that column's key rows, and the
// digits are computed once per step into a scratch the columns share.
//
// What bounds it on the H100: integer multiply-adds, R*N*C*N per sample and
// step (1.05e13 for B=1024 over 722 steps at default_128).
// A CTA of Kernel B holds all C accumulator planes of its samples; here a
// CTA holds one, so its shared memory goes to samples instead.
//
// Design: the TPU's column grid axis becomes a thread-block cluster of C =
// k+1 CTAs over the same S samples, CTA p owning output column p (and so
// accumulator plane p, a third of Kernel B's accumulator memory at
// default_128).  Each step, CTA p rotates and decomposes its own poly p into
// its `levels` digit rows, in a buffer of step parity; one cluster barrier
// later every CTA copies all C CTAs' rows of that parity over distributed
// shared memory into its local [S][R][N] digit block, then contracts it
// against its column's key rows (one staged row w(+-g) at a time, as Kernel
// B) and updates its plane.  The parity double buffer makes the one barrier
// per step enough: CTA p rewrites a parity at step s+2 only after the
// barrier of step s+1, which each peer reaches after it has copied step s's
// rows.  A last cluster barrier keeps every CTA's shared memory alive until
// its peers have read it.  A thread owns kU=8 consecutive outputs of the
// column for 2 samples (S/2 groups of N/8 threads; 1 sample when S=1).
// Shared memory: S*N u32 plane, 2*S*levels*N int8 own rows, S*R*N int8
// digits and one staged row (141 KB at default_128 with S=8; the wrapper
// picks S in {8, 4, 2, 1} from the card's opt-in budget).

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "whole_scan.cuh"

namespace cg = cooperative_groups;

namespace {

using whole_scan::kU;
using whole_scan::pad;
using whole_scan::Shape;

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;  // the portable cluster size

__host__ int threads_for(const Shape& s) {
  const int spt = s.spc == 1 ? 1 : 2;
  return ((s.N / kU) * (s.spc / spt) + 31) / 32 * 32;
}

__host__ size_t smem_bytes(const Shape& s) {
  const size_t S = s.spc, N = s.N, L = s.levels, R = s.C * L;
  return 4 * S * N + 2 * S * L * N + S * R * N + 4 * pad(2 * s.N) + 4 * S;
}

template <int SPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
cols_kernel(const uint32_t* __restrict__ acc0, const uint32_t* __restrict__ bk,
            const int32_t* __restrict__ a_hat, uint32_t* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = s.spc, N = s.N, C = s.C, L = s.levels, R = C * L, CN = C * N, LN = L * N;
  const int mask2 = 2 * N - 1;
  int8_t* own = reinterpret_cast<int8_t*>(smem);   // [2][S][L][N], this poly's rows
  int8_t* dig = own + 2 * S * LN;                  // [S][R][N], all polys' rows
  uint32_t* plane = reinterpret_cast<uint32_t*>(dig + S * R * N);  // [S][N]
  uint32_t* gext = plane + S * N;                  // [pad(2N)]
  int* a_s = reinterpret_cast<int*>(gext + pad(2 * N));  // [S]

  const int tid = threadIdx.x, T = blockDim.x;
  const int p = static_cast<int>(cluster.block_rank());
  const int b0 = (blockIdx.x / C) * S;
  const int nb = min(S, s.B - b0);
  const int upc = N / kU;
  const bool active = tid < upc * (S / SPT);
  const int o0 = (tid % upc) * kU, bs = active ? (tid / upc) * SPT : 0;

  for (int idx = tid; idx < S * N; idx += T) {
    const int bb = idx / N;
    plane[idx] = bb < nb ? acc0[(static_cast<size_t>(b0) + bb) * CN + p * N + idx - bb * N] : 0u;
  }
  for (int step = 0; step < s.n_steps; ++step) {
    int8_t* mine = own + (step & 1) * S * LN;
    if (tid < S)
      a_s[tid] = tid < nb ? (a_hat[static_cast<size_t>(step) * s.B + b0 + tid] & mask2) : 0;
    __syncthreads();  // last step's plane update and this step's exponents
    for (int idx = tid; idx < S * N; idx += T) {
      const int bb = idx / N, i = idx - bb * N;
      whole_scan::rotate_decompose(plane + bb * N, i, a_s[bb], s, mine + bb * LN + i, N);
    }
    cluster.sync();  // every CTA's rows of this parity are written
    // gather: rows of poly q, sample bb -> dig[bb][q*L .. q*L+L-1]
    const int vecs = LN / 16;
    for (int idx = tid; idx < C * S * vecs; idx += T) {
      const int q = idx / (S * vecs), rem = idx - q * S * vecs, bb = rem / vecs;
      const int v = rem - bb * vecs;
      const int8_t* src = cluster.map_shared_rank(mine, q) + bb * LN;
      reinterpret_cast<uint4*>(dig + (bb * R + q * L) * N)[v] =
          reinterpret_cast<const uint4*>(src)[v];
    }
    __syncthreads();

    uint32_t delta[SPT][kU];
#pragma unroll
    for (int bb = 0; bb < SPT; ++bb)
#pragma unroll
      for (int u = 0; u < kU; ++u) delta[bb][u] = 0u;
    const uint32_t* bk_step = bk + static_cast<size_t>(step) * R * CN;
    for (int r = 0; r < R; ++r) {
      whole_scan::stage_row(bk_step + static_cast<size_t>(r) * CN + p * N, s, gext, tid, T);
      __syncthreads();
      if (active)
        whole_scan::contract_row<SPT>(delta, gext, dig + bs * R * N + r * N, R * N, o0, N);
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int bb = 0; bb < SPT; ++bb)
#pragma unroll
        for (int u = 0; u < kU; ++u) plane[(bs + bb) * N + o0 + u] += delta[bb][u];
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still read its rows
  for (int idx = tid; idx < nb * N; idx += T) {
    const int bb = idx / N;
    out[(static_cast<size_t>(b0) + bb) * CN + p * N + idx - bb * N] = plane[idx];
  }
}

template <int SPT>
int launch(const void* acc0, const void* bk, const void* a_hat, void* out, const Shape& s,
           int* info, cudaStream_t stream) {
  const int threads = threads_for(s);
  const size_t smem = smem_bytes(s);
  if (smem > static_cast<size_t>(whole_scan::smem_optin()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(cols_kernel<SPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((s.B + s.spc - 1) / s.spc) * s.C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = s.C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, cols_kernel<SPT>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorInvalidValue);
  info[0] = s.spc;
  info[1] = threads;
  info[2] = static_cast<int>(smem);
  info[3] = static_cast<int>(cfg.gridDim.x);
  info[4] = active;
  err = cudaLaunchKernelEx(&cfg, cols_kernel<SPT>, static_cast<const uint32_t*>(acc0),
                           static_cast<const uint32_t*>(bk), static_cast<const int32_t*>(a_hat),
                           static_cast<uint32_t*>(out), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// acc0 u32 [B, C, N], bk u32 [n, R, C, N] (canonical rows p*levels + j),
// a_hat int32 [n, B] -> out u32 [B, C, N], carry-chain digits, with `spc`
// samples per cluster of C CTAs.  info (host, 5 ints) receives the plan:
// samples per CTA, threads per CTA, dynamic shared memory bytes, CTAs, and
// the clusters the card holds at once (cudaOccupancyMaxActiveClusters).
// Returns cudaErrorInvalidValue unless N is a power of two >= 16, 1 <= C <=
// kMaxCluster, B >= 1, key_limbs is 3 or 4, spc is 1, 2, 4 or 8, the
// threads fit kMaxThreads, the shared memory fits the card's opt-in budget
// and the card can hold one cluster.
int blind_rotate_fused_cols(const void* acc0, const void* bk, const void* a_hat, void* out,
                            int n_steps, int B, int C, int N, int levels, int log_base,
                            int ignored_bits, int key_limbs, int spc, int* info,
                            void* stream) {
  const Shape s{n_steps, B, C, N, levels, log_base, ignored_bits, 0, 0u, key_limbs, spc};
  if (N < 16 || (N & (N - 1)) || C < 1 || C > kMaxCluster || B < 1 ||
      (key_limbs != 3 && key_limbs != 4) || (spc != 1 && spc != 2 && spc != 4 && spc != 8) ||
      threads_for(s) > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return spc == 1 ? launch<1>(acc0, bk, a_hat, out, s, info, st)
                  : launch<2>(acc0, bk, a_hat, out, s, info, st);
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
