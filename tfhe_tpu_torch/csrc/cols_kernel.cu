// Kernel G: the column-split whole blind rotation in one launch.
//
// Replaces: tfhe_tpu/ops/pallas/blind_rotate_kernel.py, blind_rotate_fused_cols
// (body _kernel_cols): carry-chain digits, key_limbs 4 (exact) or 3 (the low
// byte of each sign-twisted key word dropped).  The step is the one
// whole_scan.cuh writes out.  The TPU kernel's grid splits the output
// columns: each (step, column) expands only that column's key rows, and the
// digits are computed once per step into a scratch the columns share.
//
// What bounds it on the H100: int8 tensor-core operations, as for Kernel B:
// R*C*L*N*N multiply-adds per sample and step (L = key_limbs), 42.31 ms for
// B=1024 over 722 steps at default_128 with L=4 and 31.73 ms with L=3, at
// the 1979e12 ops/s peak.  The sums are Kernel B's, on mma.sync over the
// int8 limb planes (mma_row.cuh).
//
// Design: the TPU's column grid axis becomes a thread-block cluster of C =
// k+1 CTAs over the same S samples, CTA p owning output column p (and so
// accumulator plane p: a CTA holds a third of Kernel B's accumulators at
// default_128).  Each step, CTA p rotates and decomposes its own poly p
// only, into a buffer of step parity laid out as Kernel B's digits are,
// [levels][S][drow]: one contiguous block.  One cluster barrier later every
// CTA copies the C blocks of that parity over distributed shared memory into
// its [R][S][drow] digit block, then runs Kernel B's row loop for its own
// column: R key rows per step, each coming in by cp.async two rows ahead,
// the next row's planes built under the current row's mmas, one barrier per
// row, and at the step's end the limb sums recombined mod 2^32 into its
// plane.  Its warps cover the N outputs of the column as Kernel B's do.  So
// each CTA builds 1/C of Kernel B's digits and planes per step, and does
// 1/C of its mmas.  The parity double buffer makes the one cluster barrier
// per step enough: CTA p rewrites a parity at step s+2 only after the
// barrier of step s+1, which each peer reaches after it has copied step s's
// blocks.  A last cluster barrier keeps every CTA's shared memory alive
// until its peers have read it.  Shared memory: the S*N plane, two plane
// buffers, two raw key rows, 2*levels*S padded rows of own digits and R*S
// of gathered ones (181 KB at default_128 with S=8; the wrapper picks S in
// {8, 4, 2, 1} from the card's opt-in budget), so one CTA per SM: at
// B=1024 the 128 clusters of 3 run in waves of what the card holds at once
// (the plan's max_active_clusters, PERF.md).  Above N = 512 the column
// runs in Kernel B's 512 x 512 blocks (mma_row.cuh): passes ob, each over
// units (r, kc), its sums added at offset 512 ob of the plane.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "limb_planes.cuh"
#include "mma_row.cuh"
#include "whole_scan.cuh"

namespace cg = cooperative_groups;

namespace {

using limb_planes::block_width;
using limb_planes::build_window;
using limb_planes::cp_async16;
using limb_planes::cp_async_commit_wait;
using limb_planes::digit_row_bytes;
using limb_planes::kBlock;
using limb_planes::kMaxDegree;
using limb_planes::mma_row;
using limb_planes::next_unit;
using limb_planes::plane_set_words;
using limb_planes::tiles_per_warp;
using limb_planes::window_base;
using whole_scan::Shape;

constexpr int kMaxThreads = 256;  // N/(16*T) warps: 8 at N=512, and above it
constexpr int kMaxCluster = 8;    // the portable cluster size

__host__ size_t smem_bytes(const Shape& s) {
  const size_t S = s.spc, N = s.N, L = s.levels, R = s.C * L, drow = digit_row_bytes(s.N);
  return 4 * S * N                                                         // accumulator plane p
         + 4 * 2 * static_cast<size_t>(plane_set_words(block_width(s.N)))  // two plane buffers
         + 4 * 2 * N                                          // two raw key rows
         + 2 * L * S * drow                                   // own digits, by parity
         + R * S * drow                                       // gathered digits
         + 4 * S;                                             // exponents
}

// L: key limbs kept (4, or 3 with limb 0 dropped); T: tiles_per_warp(N);
// kBlocked: N > kBlock, the circulant in blocks (mma_row.cuh).
template <int L, int T, bool kBlocked>
__global__ void __launch_bounds__(kMaxThreads, 1)
cols_kernel(const uint32_t* __restrict__ acc0, const uint32_t* __restrict__ bk,
            const int32_t* __restrict__ a_hat, uint32_t* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = s.spc, N = s.N, C = s.C, R = C * s.levels, CN = C * N;
  // the blocks of the column and of a row, and their width
  const int blocks = kBlocked ? N / kBlock : 1, bw = kBlocked ? kBlock : N;
  const int mask2 = 2 * N - 1, ps = plane_set_words(bw), drow = digit_row_bytes(N);
  const int blk = s.levels * S * drow;  // one poly's digit block
  uint32_t* plane = reinterpret_cast<uint32_t*>(smem);    // [S][N]
  uint32_t* planes = plane + S * N;                        // [2][16 copies]
  uint32_t* graw = planes + 2 * ps;                        // [2][N]
  int8_t* own = reinterpret_cast<int8_t*>(graw + 2 * N);   // [2][levels][S][drow]
  int8_t* dig = own + 2 * blk;                             // [R][S][drow]
  int* a_s = reinterpret_cast<int*>(dig + R * S * drow);   // [S]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int p = static_cast<int>(cluster.block_rank());
  const int b0 = (blockIdx.x / C) * S;
  const int nb = min(S, s.B - b0);
  const limb_planes::Lane ln = limb_planes::lane_of<L, T, kBlocked>(N, S);

  for (int idx = tid; idx < S * N; idx += nthr) {
    const int bb = idx / N;
    plane[idx] =
        bb < nb ? acc0[(static_cast<size_t>(b0) + bb) * CN + p * N + idx - bb * N] : 0u;
  }
  // key row q = (step, ob, r) of column p, 16-byte pieces into graw[q & 1]
  const int rows = s.n_steps * blocks * R, units = rows * blocks;
  auto issue = [&](int q) {
    const int step = q / (R * blocks), r = q % R;
    const uint32_t* src = bk + ((static_cast<size_t>(step) * R + r) * C + p) * N;
    uint32_t* dst = graw + (q & 1) * N;
    for (int ch = tid; ch < N / 4; ch += nthr) cp_async16(dst + 4 * ch, src + 4 * ch, true);
  };
  if (rows > 0) {
    issue(0);
    cp_async_commit_wait();
    __syncthreads();
    build_window<true>(graw, planes, N, bw, window_base<kBlocked>(0, 0, N));
    if (rows > 1) issue(1);
  }

  int u = 0;  // unit (q, kc): chunk kc of row q's inputs
  for (int step = 0; step < s.n_steps; ++step) {
    int8_t* mine = own + (step & 1) * blk;
    __syncthreads();  // last step's plane updates
    if (tid < S)
      a_s[tid] = tid < nb ? (a_hat[static_cast<size_t>(step) * s.B + b0 + tid] & mask2) : 0;
    __syncthreads();
    for (int idx = tid; idx < S * N; idx += nthr) {
      const int bb = idx / N, i = idx - bb * N;
      whole_scan::rotate_decompose(plane + bb * N, i, a_s[bb], s, mine + bb * drow + i,
                                   S * drow);
    }
    cluster.sync();  // every CTA's block of this parity is written
    // gather: poly pp's block -> rows pp*levels .. of dig, 16 bytes a thread
    const int vecs = blk / 16;
    for (int idx = tid; idx < C * vecs; idx += nthr) {
      const int pp = idx / vecs, v = idx - pp * vecs;
      reinterpret_cast<uint4*>(dig + pp * blk)[v] =
          reinterpret_cast<const uint4*>(cluster.map_shared_rank(mine, pp))[v];
    }
    // the first unit's barrier below also orders the gather before the mmas
    for (int ob = 0; ob < blocks; ++ob) {  // pass: output block ob
      int sums[L][T][4];
#pragma unroll
      for (int l = 0; l < L; ++l)
#pragma unroll
        for (int a = 0; a < T; ++a)
#pragma unroll
          for (int i = 0; i < 4; ++i) sums[l][a][i] = 0;
      for (int ru = 0; ru < R * blocks; ++ru, ++u) {
        const int r = ru / blocks, kc = ru - r * blocks, q = u / blocks;
        // row q+1's words have landed and every warp is done with unit u-1,
        // whose plane buffer (and raw row, past its last chunk) is free
        cp_async_commit_wait();
        __syncthreads();
        if (kc == blocks - 1 && q + 2 < rows) issue(q + 2);
        mma_row<L, T>(sums, planes + (u & 1) * ps + ln.copy,
                      reinterpret_cast<const uint32_t*>(dig + r * S * drow) + ln.dig +
                          kc * (bw / 4),
                      bw, ln.x0 >> 2,
                      next_unit<kBlocked>(graw, planes + ((u + 1) & 1) * ps, N, q, kc, ob, ru,
                                          R, blocks, u + 1 == units));
      }
      limb_planes::add_column<L, T>(sums, plane, N, ob * bw, ln, S);
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still read its blocks
  for (int idx = tid; idx < nb * N; idx += nthr) {
    const int bb = idx / N;
    out[(static_cast<size_t>(b0) + bb) * CN + p * N + idx - bb * N] = plane[idx];
  }
}

template <int L, int T, bool kBlocked>
int launch(const void* acc0, const void* bk, const void* a_hat, void* out, const Shape& s,
           int* info, cudaStream_t stream) {
  const int threads = 32 * (block_width(s.N) / (16 * T));
  const size_t smem = smem_bytes(s);
  if (smem > static_cast<size_t>(whole_scan::smem_optin()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(cols_kernel<L, T, kBlocked>,
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
  err = cudaOccupancyMaxActiveClusters(&active, cols_kernel<L, T, kBlocked>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return static_cast<int>(cudaErrorInvalidValue);
  info[0] = s.spc;
  info[1] = threads;
  info[2] = static_cast<int>(smem);
  info[3] = static_cast<int>(cfg.gridDim.x);
  info[4] = active;
  err = cudaLaunchKernelEx(&cfg, cols_kernel<L, T, kBlocked>,
                           static_cast<const uint32_t*>(acc0), static_cast<const uint32_t*>(bk),
                           static_cast<const int32_t*>(a_hat), static_cast<uint32_t*>(out), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// acc0 u32 [B, C, N], bk u32 [n, R, C, N] (canonical rows p*levels + j,
// 16-byte aligned), a_hat int32 [n, B] -> out u32 [B, C, N], carry-chain
// digits, with `spc` samples per cluster of C CTAs.  info (host, 5 ints)
// receives the plan: samples per CTA, threads per CTA, dynamic shared memory
// bytes, CTAs, and the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters).  Returns cudaErrorInvalidValue unless N
// is a power of two with 64 <= N <= kMaxDegree (Kernel B's tiles and
// blocks), 1 <= C <=
// kMaxCluster, B >= 1, bk is 16-byte aligned, key_limbs is 3 or 4, spc is 1,
// 2, 4 or 8, the shared memory fits the card's opt-in budget and the card
// can hold one cluster.
int blind_rotate_fused_cols(const void* acc0, const void* bk, const void* a_hat, void* out,
                            int n_steps, int B, int C, int N, int levels, int log_base,
                            int ignored_bits, int key_limbs, int spc, int* info,
                            void* stream) {
  if (N < 64 || N > kMaxDegree || (N & (N - 1)) || C < 1 || C > kMaxCluster || B < 1 ||
      reinterpret_cast<uintptr_t>(bk) % 16 || (key_limbs != 3 && key_limbs != 4) ||
      (spc != 1 && spc != 2 && spc != 4 && spc != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{n_steps, B, C, N, levels, log_base, ignored_bits, 0, 0u, key_limbs, spc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > kBlock)
    return key_limbs == 4 ? launch<4, 4, true>(acc0, bk, a_hat, out, s, info, st)
                          : launch<3, 4, true>(acc0, bk, a_hat, out, s, info, st);
  if (tiles_per_warp(N) == 4)
    return key_limbs == 4 ? launch<4, 4, false>(acc0, bk, a_hat, out, s, info, st)
                          : launch<3, 4, false>(acc0, bk, a_hat, out, s, info, st);
  return key_limbs == 4 ? launch<4, 2, false>(acc0, bk, a_hat, out, s, info, st)
                        : launch<3, 2, false>(acc0, bk, a_hat, out, s, info, st);
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
