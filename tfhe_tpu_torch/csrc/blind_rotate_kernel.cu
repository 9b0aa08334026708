// Kernel B: the whole blind rotation (all n CMUX steps) in one launch.
//
// Replaces: tfhe_tpu/ops/pallas/blind_rotate_kernel.py, blind_rotate_fused
// (wide body _kernel_wide with _rotate_negacyclic, _decompose_kept_int8 and
// _decompose_balanced_int8), key_limbs=4 (the exact mode) and key_limbs=3
// (the low balanced byte of each sign-twisted key word dropped).  The step
// is the one whole_scan.cuh writes out.
//
// As the TPU kernel does, the product is taken as int8 limb planes on the
// tensor cores: the contraction of one staged key row, mma_row.cuh (shared
// with Kernels E, F and G), whose comment derives it.  At key_limbs=3 limb 0
// is not computed at all, which is the truncation whole_scan.cuh states.
//
// What bounds it on the H100: int8 tensor-core operations, R*C*L*N*N
// multiply-adds per sample and step (L = key_limbs; 5.7e7 at default_128,
// 4.2e13 for B=1024 over 722 steps: 42.3 ms at the 1979e12 ops/s peak).
// Device memory is no limit: the key streams once per step per CTA (110 KB
// at default_128, served from L2 since every CTA reads the same step) and
// the accumulators never leave the SM.  mma.sync reaches about half that
// peak at best: this kernel's loop issues one m16n8k32 per ~9.5 clocks per
// SM sub-partition, and the plane build and the digit phase stop it for a
// quarter of the kernel's time (PERF.md).  At N > 512 fewer samples fit a
// CTA (4 at large_2048, 2 at large_4096), and the mma's spare sample
// columns are work the bound does not count.
//
// Design: each CTA owns S samples (S in {8, 4, 2, 1}, the largest whose
// shared memory fits the card's opt-in budget; 163 KB at default_128 with
// S=8) for all n steps, with no inter-CTA synchronisation, and keeps their
// accumulators (S*C*N u32) and digits (R*S rows of N int8, padded by 16
// bytes) in shared memory.  The rotation is a gather with the closed-form
// sign, then the digits (whole_scan::rotate_decompose).  The sums run on
// mma.sync through mma_row: the circulant as A (M = 16 outputs), the 8
// samples as B, the input coefficients as K; a warp owns 4 M tiles of one
// column and all kept limbs.  Columns run one after another
// (the accumulators of all C columns would pass the register file); at a
// column's end each thread recombines its limbs and adds them to the
// accumulators in shared memory.  Key rows run in the order (step, c, r):
// while a row's mmas run, each warp builds its share of the next row's
// planes into the second plane buffer (after its first group of K steps,
// with those mmas in flight) and the row after it comes in by cp.async, so
// one barrier per row separates them.  Above N = 512 the circulant runs in
// 512 x 512 blocks (mma_row.cuh): units in the order (step, c, ob, r, kc),
// the sums of pass (c, ob) in registers over all (r, kc), the next unit's
// window of planes built under the current unit's mmas, a raw key row
// brought in once per (pass, r) and read by its `blocks` windows.

#include <cstdint>
#include <cuda_runtime.h>

#include "limb_planes.cuh"
#include "mma_row.cuh"
#include "whole_scan.cuh"

namespace {

using limb_planes::block_width;
using limb_planes::build_window;
using limb_planes::copy_words;
using limb_planes::cp_async16;
using limb_planes::cp_async_commit_wait;
using limb_planes::digit_row_bytes;
using limb_planes::kBlock;
using limb_planes::kLimbs;
using limb_planes::kMaxDegree;
using limb_planes::mma_row;
using limb_planes::next_unit;
using limb_planes::plane_set_words;
using limb_planes::tiles_per_warp;
using limb_planes::window_base;
using whole_scan::Shape;

constexpr int kMaxThreads = 256;  // N/(16*T) warps: 8 at N=512, and above it

__host__ size_t smem_bytes(const Shape& s) {
  const size_t S = s.spc, C = s.C, N = s.N, R = C * s.levels;
  return 4 * S * C * N                                                     // accumulators
         + 4 * 2 * static_cast<size_t>(plane_set_words(block_width(s.N)))  // two plane buffers
         + 4 * 2 * N                                                       // two raw key rows
         + R * S * digit_row_bytes(s.N)                                    // digits
         + 4 * S;                                                          // exponents
}

// L: key limbs kept (4, or 3 with limb 0 dropped); T: tiles_per_warp(N);
// kBlocked: N > kBlock, the circulant in blocks (mma_row.cuh).
template <int L, int T, bool kBlocked>
__global__ void __launch_bounds__(kMaxThreads, 1)
blind_rotate_kernel(const uint32_t* __restrict__ acc0, const uint32_t* __restrict__ bk,
                    const int32_t* __restrict__ a_hat, uint32_t* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = s.spc, N = s.N, C = s.C, R = C * s.levels, CN = C * N;
  // the blocks of a column and of a row, and their width
  const int blocks = kBlocked ? N / kBlock : 1, bw = kBlocked ? kBlock : N;
  const int mask2 = 2 * N - 1, ps = plane_set_words(bw), drow = digit_row_bytes(N);
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);      // [S][C][N]
  uint32_t* planes = acc + S * CN;                         // [2][16 copies]
  uint32_t* graw = planes + 2 * ps;                        // [2][N]
  int8_t* dig = reinterpret_cast<int8_t*>(graw + 2 * N);   // [R][S][drow]
  int* a_s = reinterpret_cast<int*>(dig + R * S * drow);   // [S]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * S;
  const int nb = min(S, s.B - b0);
  // the lane's place in the warp tiling (limb_planes::lane_of and
  // add_column, which Kernels E, F and G call, spell out these lines; Kernel B
  // keeps them inline, which keeps its machine code as it was)
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // the warp's first tile: warp pairs share 32T outputs, interleaved by 16
  const int o_t = 32 * T * (warp >> 1) + 16 * (warp & 1);
  const int x0 = (4 * t - o_t - 8 - g + (kBlocked ? kBlock : 0)) & (2 * bw - 1);
  const int lane_copy = (kLimbs - L) * 4 * copy_words(bw) + (x0 & 3) * copy_words(bw);
  const int lane_dig = (g & (S - 1)) * (drow / 4) + t;  // words

  for (int idx = tid; idx < S * CN; idx += nthr) {
    const int bb = idx / CN;
    acc[idx] = bb < nb ? acc0[static_cast<size_t>(b0) * CN + idx] : 0u;
  }
  // key row q = (step, c, ob, r) of the sequence, 16-byte pieces into graw[q & 1]
  const int rows = s.n_steps * C * blocks * R, units = rows * blocks;
  auto issue = [&](int q) {
    const int r = q % R, step = q / (R * blocks * C), c = (q / (R * blocks)) % C;
    const uint32_t* src = bk + ((static_cast<size_t>(step) * R + r) * C + c) * N;
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
    __syncthreads();  // last step's accumulator updates
    if (tid < S)
      a_s[tid] = tid < nb ? (a_hat[static_cast<size_t>(step) * s.B + b0 + tid] & mask2) : 0;
    __syncthreads();
    for (int idx = tid; idx < S * CN; idx += nthr) {
      const int bb = idx / CN, rem = idx - bb * CN;
      const int p = rem / N, i = rem - p * N;
      whole_scan::rotate_decompose(acc + bb * CN + p * N, i, a_s[bb], s,
                                   dig + (p * s.levels * S + bb) * drow + i, S * drow);
    }
    // the first unit's barrier below also orders the digits before the mmas
    for (int cb = 0; cb < C * blocks; ++cb) {  // pass: column c, output block ob
      const int c = cb / blocks, ob = cb - c * blocks;
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
        mma_row<L, T>(sums, planes + (u & 1) * ps + lane_copy,
                      reinterpret_cast<const uint32_t*>(dig + r * S * drow) + lane_dig +
                          kc * (bw / 4),
                      bw, x0 >> 2,
                      next_unit<kBlocked>(graw, planes + ((u + 1) & 1) * ps, N, q, kc, ob, ru,
                                          R, blocks, u + 1 == units));
      }
      // recombine the limbs mod 2^32 and add this warp's outputs of the pass
#pragma unroll
      for (int a = 0; a < T; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // c0, c1: row g (output o_t + 32a + 8 + g); c2, c3: row g + 8 (output
          // o_t + 32a + g); samples 2t, 2t + 1
          const int bb = 2 * t + (i & 1), o = o_t + 32 * a + g + (i < 2 ? 8 : 0);
          uint32_t delta = 0u;
#pragma unroll
          for (int l = 0; l < L; ++l)
            delta += static_cast<uint32_t>(sums[l][a][i]) << (8 * (kLimbs - L + l));
          if (bb < S) acc[bb * CN + c * N + ob * bw + o] += delta;
        }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nb * CN; idx += nthr)
    out[static_cast<size_t>(b0) * CN + idx] = acc[idx];
}

template <int L, int T, bool kBlocked>
int launch(const void* acc0, const void* bk, const void* a_hat, void* out, const Shape& s,
           int* info, cudaStream_t stream) {
  const int threads = 32 * (block_width(s.N) / (16 * T));
  const size_t smem = smem_bytes(s);
  if (smem > static_cast<size_t>(whole_scan::smem_optin()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_kernel<L, T, kBlocked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = s.spc;
  info[1] = threads;
  info[2] = static_cast<int>(smem);
  info[3] = (s.B + s.spc - 1) / s.spc;
  blind_rotate_kernel<L, T, kBlocked><<<info[3], threads, smem, stream>>>(
      static_cast<const uint32_t*>(acc0), static_cast<const uint32_t*>(bk),
      static_cast<const int32_t*>(a_hat), static_cast<uint32_t*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// acc0 u32 [B, C, N], bk u32 [n, R, C, N] (canonical rows p*levels + j,
// 16-byte aligned), a_hat int32 [n, B] -> out u32 [B, C, N], with `spc`
// samples per CTA.  info (host, 4 ints) receives the plan: samples per CTA,
// threads per CTA, dynamic shared memory bytes and CTAs.  Returns
// cudaErrorInvalidValue unless N is a power of two with 64 <= N <=
// kMaxDegree (N/(16T) warps of T tiles up to 512, blocks of 512 above),
// C >= 1, B >= 1, bk is 16-byte aligned, key_limbs is 3 or 4, spc is 1, 2,
// 4 or 8 and its shared memory fits the card's opt-in budget.
int blind_rotate_fused(const void* acc0, const void* bk, const void* a_hat, void* out,
                       int n_steps, int B, int C, int N, int levels, int log_base,
                       int ignored_bits, int balanced, unsigned int balanced_offset,
                       int key_limbs, int spc, int* info, void* stream) {
  if (N < 64 || N > kMaxDegree || (N & (N - 1)) || C < 1 || B < 1 ||
      reinterpret_cast<uintptr_t>(bk) % 16 || (key_limbs != 3 && key_limbs != 4) ||
      (spc != 1 && spc != 2 && spc != 4 && spc != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{n_steps, B, C, N, levels, log_base, ignored_bits, balanced,
                balanced_offset, key_limbs, spc};
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
