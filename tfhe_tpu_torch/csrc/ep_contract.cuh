// Device code shared by the two external-product contraction kernels:
// Kernel A (ep_kernel.cu; digits [R, B, N], limb planes [C, 4, B, N]) and
// Kernel H (ep_batch_kernel.cu; digits [B, R, N], limb sums [B, C*4, N]).
// They replace tfhe_tpu/ops/pallas/ep_kernel.py's ep_contract_pallas_rbn
// and ep_contract_pallas.  Both compute, exactly, in their own layouts,
//
//   out[b, c*4 + l, o] = sum_{r, m} d[b, r, m] * limb_l( ext[r, c, (o - m) mod 2N] )
//
// with ext = [g, -g] in u32 (the negacyclic sign goes on BEFORE the balanced
// 8-bit limb split, (w + 0x80808080) ^ 0x80808080, since the limb -128
// cannot be negated in int8).  g is u32 [R, C, N].  Row order is free (the
// contraction is row-order invariant) as long as digits and key rows agree.
//
// What bounds it on the H100: tensor-core operations at B >= 64,
// B*R*C*4*N*N int8 multiply-adds (3.6e9 at default_128, B=64: 3.7 us at the
// 1979e12 ops/s int8 peak).  Device memory bounds it nowhere: 110 KB of key
// rows, 0.6 MB of digits and 1.6 MB of output at B=64.  mma.sync issues an
// m16n8k32 about every 16 clocks per SM sub-partition on this card, about a
// quarter of the peak (PERF.md); only wgmma reaches the rest.
//
// Design: the sums are int8 mma.sync m16n8k32 (s8 x s8 -> s32) with the
// samples as M, the output coefficients o as N and the input coefficients
// m as K.  The TPU kernels build each row's [N, N] circulant; here it is
// never built: an mma B-fragment register, which holds k = 4*(lane%4) + j
// (j = 0..3) at n = lane/4, is the four consecutive bytes P_l[x .. x+3],
// x = (m0 + 4*(lane%4) - o) mod 2N, one aligned 32-bit load from the
// byte-shifted limb planes of limb_planes.cuh.  A registers are 4
// consecutive digits of one digit row: one 32-bit load from the CTA's digit
// rows in shared memory (rows padded by 16 bytes against bank conflicts;
// rows past B are zero and are never stored).
//
// A CTA owns `bm` samples (16 or 32: MT = bm/16 M tiles), one column c,
// `16*warps` outputs o and all 4 limbs, over its share of the rows: a warp
// owns 16 outputs (two n-tiles) for all bm samples, MT*2*4 tiles of s32
// accumulators in registers.  Per row the next row's digits and key words
// come in by cp.async while this row's mmas run (with two digit buffers, when
// the plan gives them), then the 16 plane copies are built from the key
// words.  The tiles alone leave SMs idle at small B, so the plan
// (ops/cuda/ep_kernel.py:ep_plan) splits the rows over a thread-block
// cluster of `split` CTAs until every SM holds two CTAs; each writes its
// int32 partial tile to its shared memory and, after a cluster barrier, sums
// a slice of all the cluster's partials over distributed shared memory and
// stores it: no atomics, no second launch, and the sums are exact in any
// order (int32 addition is associative, and |sum| <= R*N*128*128 < 2^31 for
// every parameter set).
//
// A wgmma version needs K-major B tiles built in shared memory (a tile-build
// stage) and is later work.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "limb_planes.cuh"

namespace ep {

namespace cg = cooperative_groups;
using limb_planes::build_planes;
using limb_planes::copy_words;
using limb_planes::cp_async16;
using limb_planes::cp_async_commit_wait;
using limb_planes::digit_row_bytes;
using limb_planes::kLimbs;
using limb_planes::mma_s8;

constexpr int kMaxSplit = 8;  // the portable cluster size
constexpr int kNT = 2;        // n-tiles of 8 outputs per warp

// Element strides of one layout: the digit row (r, b) starts at
// (r*d_r + b*d_b)*N, the output row (f, b), f = c*4 + l, at (f*o_f + b*o_b)*N.
struct Layout {
  int d_r, d_b, o_f, o_b;
};

// One launch's shape and plan (ops/cuda/ep_kernel.py:ep_plan).
struct Plan {
  int R, B, C, N;
  int bm;        // samples per CTA: 16 or 32
  int warps;     // warps per CTA, 16 outputs each
  int split;     // CTAs per cluster, each over rows_per rows
  int rows_per;  // rows per split
  int nbuf;      // digit buffers: 2 (prefetch under the mmas) or 1
};

// Ints of one row of the partial tile.
__host__ __device__ inline int partial_row(int warps) { return 16 * warps + 8; }

// Dynamic shared memory of one CTA: the 16 plane copies, the digit buffers
// and the raw key row, or the partial tile if that is larger.
__host__ inline size_t smem_bytes(const Plan& p) {
  const size_t planes = 4ull * kLimbs * 4 * copy_words(p.N);
  const size_t digits = static_cast<size_t>(p.nbuf) * p.bm * digit_row_bytes(p.N);
  const size_t stage = planes + digits + 4ull * p.N;
  const size_t partial = 4ull * kLimbs * p.bm * partial_row(p.warps);
  return stage > partial ? stage : partial;
}

// Start the copies of row r: the CTA's bm digit rows into `dig` and the key
// row g[r, c] into `graw`.  The caller waits.
__device__ __forceinline__ void issue_row(const int8_t* __restrict__ digits,
                                          const uint32_t* __restrict__ rows, const Plan& p,
                                          const Layout& lay, int r, int b0, int c, int8_t* dig,
                                          uint32_t* graw) {
  const int N = p.N, chunks = N / 16, dr = digit_row_bytes(N);
  for (int idx = threadIdx.x; idx < p.bm * chunks; idx += blockDim.x) {
    const int bb = idx / chunks, ch = idx - bb * chunks;
    const int b = b0 + bb;
    const bool valid = b < p.B;
    const size_t row = valid ? static_cast<size_t>(r) * lay.d_r + static_cast<size_t>(b) * lay.d_b
                             : 0;
    cp_async16(dig + bb * dr + ch * 16, digits + row * N + ch * 16, valid);
  }
  const uint32_t* g = rows + (static_cast<size_t>(r) * p.C + c) * N;
  for (int ch = threadIdx.x; ch < N / 4; ch += blockDim.x)
    cp_async16(graw + ch * 4, g + ch * 4, true);
}

// One staged row's mmas for this warp: all N/32 K steps.
template <int MT>
__device__ __forceinline__ void mma_row(int (&acc)[MT][kNT][kLimbs][4], const int8_t* dig,
                                        const uint32_t* planes, int N, int o_warp) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int half = N / 2, cw = copy_words(N), mask2 = 2 * N - 1;
  const int dw = digit_row_bytes(N) / 4;
  const uint32_t* drow = reinterpret_cast<const uint32_t*>(dig) + g * dw + t;
  for (int m0 = 0; m0 < N; m0 += 32) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t* d = drow + mt * 16 * dw + m0 / 4;
      a[mt][0] = d[0];
      a[mt][1] = d[8 * dw];
      a[mt][2] = d[4];
      a[mt][3] = d[8 * dw + 4];
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int x = (m0 + 4 * t - (o_warp + nt * 8) - g) & mask2;
      const int w = x >> 2;
      const uint32_t* p0 = planes + (x & 3) * cw;
      const int w0 = w, w1 = (w + 4) & (half - 1);  // k + 16 is x + 16
#pragma unroll
      for (int l = 0; l < kLimbs; ++l) {
        const uint32_t b0 = p0[l * 4 * cw + w0], b1 = p0[l * 4 * cw + w1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt][l], a[mt], b0, b1);
      }
    }
  }
}

// The body of both kernels.  Grid (split, C * N/(16*warps), ceil(B/bm)),
// clusters of (split, 1, 1), 32*warps threads.
template <int MT>
__device__ __forceinline__ void contract(const int8_t* __restrict__ digits,
                                         const uint32_t* __restrict__ rows,
                                         int32_t* __restrict__ out, const Plan& p,
                                         const Layout& lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int N = p.N, to = 16 * p.warps, o_tiles = N / to;
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem);
  int8_t* dig0 = reinterpret_cast<int8_t*>(planes + kLimbs * 4 * copy_words(N));
  const int dig_bytes = p.bm * digit_row_bytes(N);
  uint32_t* graw = reinterpret_cast<uint32_t*>(dig0 + p.nbuf * dig_bytes);
  int32_t* partial = reinterpret_cast<int32_t*>(smem);  // [4][bm][partial_row], after the rows

  const int q = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.y / o_tiles;
  const int o0 = (blockIdx.y - c * o_tiles) * to;
  const int b0 = blockIdx.z * p.bm;
  const int warp = threadIdx.x >> 5;
  const int r_begin = q * p.rows_per;
  const int r_end = min(p.R, r_begin + p.rows_per);

  int acc[MT][kNT][kLimbs][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int l = 0; l < kLimbs; ++l)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][l][i] = 0;

  if (r_begin < r_end) {
    issue_row(digits, rows, p, lay, r_begin, b0, c, dig0, graw);
    cp_async_commit_wait();
    __syncthreads();
    build_planes(graw, planes, N);
    __syncthreads();
  }
  for (int r = r_begin, i = 0; r < r_end; ++r, ++i) {
    const int8_t* dig = dig0 + (p.nbuf == 2 ? (i & 1) : 0) * dig_bytes;
    const bool more = r + 1 < r_end;
    if (more && p.nbuf == 2)  // the next digits land in the other buffer
      issue_row(digits, rows, p, lay, r + 1, b0, c, dig0 + ((i + 1) & 1) * dig_bytes, graw);
    mma_row<MT>(acc, dig, planes, N, o0 + warp * 16);
    if (more) {
      if (p.nbuf == 1) {
        __syncthreads();  // the only digit buffer is free
        issue_row(digits, rows, p, lay, r + 1, b0, c, dig0, graw);
      }
      cp_async_commit_wait();
      __syncthreads();  // the planes are free and row r+1's words have landed
      build_planes(graw, planes, N);
    }
    __syncthreads();
  }

  // this CTA's partial tile: partial[l][bb][o - o0]
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int pr = partial_row(p.warps);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int l = 0; l < kLimbs; ++l) {
        const int o = warp * 16 + nt * 8 + 2 * t;
        int32_t* lo = partial + (l * p.bm + mt * 16 + g) * pr + o;
        *reinterpret_cast<int2*>(lo) = make_int2(acc[mt][nt][l][0], acc[mt][nt][l][1]);
        *reinterpret_cast<int2*>(lo + 8 * pr) = make_int2(acc[mt][nt][l][2], acc[mt][nt][l][3]);
      }
  cluster.sync();  // every partial of the cluster is written

  // CTA q sums the partial rows rho = q, q + split, ... over the cluster
  const int chunks = to / 4, n_rows = kLimbs * p.bm;
  const int mine = (n_rows - q + p.split - 1) / p.split;
  for (int idx = threadIdx.x; idx < mine * chunks; idx += blockDim.x) {
    const int rho = q + (idx / chunks) * p.split, ch = idx % chunks;
    const int l = rho / p.bm, bb = rho - l * p.bm;
    const int b = b0 + bb;
    if (b >= p.B) continue;
    int4 s = make_int4(0, 0, 0, 0);
    for (int peer = 0; peer < p.split; ++peer) {
      const int4 v = *reinterpret_cast<const int4*>(
          cluster.map_shared_rank(partial, peer) + rho * pr + ch * 4);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const size_t row = static_cast<size_t>(c * kLimbs + l) * lay.o_f +
                       static_cast<size_t>(b) * lay.o_b;
    *reinterpret_cast<int4*>(out + row * N + o0 + ch * 4) = s;
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partial
}

using KernelFn = void (*)(const int8_t*, const uint32_t*, int32_t*, Plan);

// Launches the kernel instance for p.bm (kernels[0] for bm = 16, kernels[1]
// for 32) on `stream` without synchronising and returns its cudaError_t as
// an int.  info (host, 2 ints) receives the dynamic shared memory bytes and
// the CTAs.  Returns cudaErrorInvalidValue, with nothing launched, unless N
// is a power of two >= 32, R, B, C >= 1, bm is 16 or 32, warps is 2 or 4
// with 16*warps <= N, 1 <= split <= kMaxSplit, the splits of rows_per rows
// cover the R rows with none empty, nbuf is 1 or 2 and the shared memory
// fits the card's opt-in budget.  The shared-memory attribute applies to
// the current device's copy of the kernel, so it is set when an instance
// first needs a size above what it was given on that device, not on every
// launch.  It is `static` so that each library keeps its own record of the
// sizes set: the static local of an inline function is one object for the
// whole process (a unique symbol), shared by Kernels A's and H's libraries.
static int launch(const KernelFn (&kernels)[2], const void* digits, const void* rows, void* out,
                  const Plan& p, int* info, void* stream) {
  const bool bad_split = p.split < 1 || p.split > kMaxSplit || p.rows_per < 1 ||
                         p.split * p.rows_per < p.R || (p.split - 1) * p.rows_per >= p.R;
  if (p.N < 32 || (p.N & (p.N - 1)) || p.R < 1 || p.B < 1 || p.C < 1 ||
      (p.bm != 16 && p.bm != 32) || (p.warps != 2 && p.warps != 4) || 16 * p.warps > p.N ||
      bad_split || (p.nbuf != 1 && p.nbuf != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int which = p.bm == 16 ? 0 : 1;
  const size_t smem = smem_bytes(p);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  // the largest size each instance was given, per device; a device past
  // kMaxDevices has no record and sets the attribute on every launch
  constexpr int kMaxDevices = 64;
  static size_t attr_bytes[kMaxDevices][2] = {};
  size_t* given = dev < kMaxDevices ? &attr_bytes[dev][which] : nullptr;
  if (given == nullptr || smem > *given) {
    err = cudaFuncSetAttribute(kernels[which], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (given != nullptr) *given = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.split, p.C * (p.N / (16 * p.warps)), (p.B + p.bm - 1) / p.bm);
  cfg.blockDim = dim3(32 * p.warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  info[0] = static_cast<int>(smem);
  info[1] = static_cast<int>(cfg.gridDim.x * cfg.gridDim.y * cfg.gridDim.z);
  err = cudaLaunchKernelEx(&cfg, kernels[which], static_cast<const int8_t*>(digits),
                           static_cast<const uint32_t*>(rows), static_cast<int32_t*>(out), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ep
