// Kernel F: the wide-contraction, software-pipelined whole blind rotation
// in one launch.
//
// Replaces: tfhe_tpu/ops/pallas/blind_rotate_kernel.py,
// blind_rotate_fused_wide_pipe (body _kernel_wide_pipe): both digit modes,
// key_limbs=4 (exact).  The step is the one whole_scan.cuh writes out.  The
// TPU kernel's difference from _kernel_pipe is one wide contraction per
// output column over all R digit rows (K = R*N) against that column's whole
// key block, with each poly's next-step digits staged as soon as its column
// is final.
//
// What bounds it on the H100: int8 tensor-core operations, as for Kernel B:
// R*C*4*N*N multiply-adds per sample and step, 42.31 ms for B=1024 over 722
// steps at default_128 at the 1979e12 ops/s peak.  The sums are Kernel B's,
// on mma.sync over the int8 limb planes (mma_row.cuh).  What Kernel B spends
// besides is mostly exposed: the plane build and the digit phase.
//
// Design: Kernel B's CTA (S samples for all n steps, their accumulators in
// shared memory, columns one after another, key rows in the order (step, c,
// r) by cp.async two rows ahead, the next row's planes built under the
// current row's mmas) with the TPU kernel's digit pipeline.  A column's sums
// still run over all R rows in registers, the TPU's wide contraction, but
// its key block (36 KB at default_128) is not staged whole: beside the digit
// slots the budget has room for two rows.  The moment column c's plane is
// final (the barrier that opens column c+1), poly c's digits for step s+1
// are built under column c+1's mmas: in row r of that column each warp
// builds its share of chunk r of the S*N coefficients after its first
// group of K steps, where mma_row builds the next planes.  Only the last
// poly's digits are built exposed, after column C-1.  The digits live in a
// ring of 2C-1 poly slots, [levels][S][drow] each (25 KB at default_128
// with S=8): step s+1's polys 0..C-2 are written while column C-1 of step s
// still reads all C of step s, and step s+1's poly C-1 takes the slot of
// step s's poly 0 once column C-1 is done.  Poly p of step s sits in slot
// (s*C + p) mod (2C-1); the slot it overwrites was last read by a column
// that has finished.  Shared memory: S*C*N u32 accumulators, two plane
// buffers, two raw key rows and the ring (214 KB at default_128 with S=8;
// the wrapper picks S in {8, 4, 2, 1} from the card's opt-in budget).
// Above N = 512 the circulant runs in Kernel B's 512 x 512 blocks
// (mma_row.cuh), units (step, c, ob, r, kc) in place of rows, and poly c-1's
// next digits are built in R*blocks^2 unit-sized chunks under column c.

#include <cstdint>
#include <cuda_runtime.h>

#include "limb_planes.cuh"
#include "mma_row.cuh"
#include "whole_scan.cuh"

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

__host__ size_t smem_bytes(const Shape& s) {
  const size_t S = s.spc, C = s.C, N = s.N, slot = s.levels * S * digit_row_bytes(s.N);
  return 4 * S * C * N                                                     // accumulators
         + 4 * 2 * static_cast<size_t>(plane_set_words(block_width(s.N)))  // two plane buffers
         + 4 * 2 * N                                                       // two raw key rows
         + (2 * C - 1) * slot                                              // the digit ring
         + 4 * 2 * S;                                                      // exponents, by parity
}

// T: tiles_per_warp(N); kBlocked: N > kBlock, the circulant in blocks
// (mma_row.cuh); the key is exact (all 4 limbs).
template <int T, bool kBlocked>
__global__ void __launch_bounds__(kMaxThreads, 1)
wide_pipe_kernel(const uint32_t* __restrict__ acc0, const uint32_t* __restrict__ bk,
                 const int32_t* __restrict__ a_hat, uint32_t* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = s.spc, N = s.N, C = s.C, R = C * s.levels, CN = C * N, SN = S * N;
  // the blocks of a column and of a row, and their width
  const int blocks = kBlocked ? N / kBlock : 1, bw = kBlocked ? kBlock : N;
  const int mask2 = 2 * N - 1, ps = plane_set_words(bw), drow = digit_row_bytes(N);
  const int blk = s.levels * S * drow, nslots = 2 * C - 1;
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);       // [S][C][N]
  uint32_t* planes = acc + S * CN;                          // [2][16 copies]
  uint32_t* graw = planes + 2 * ps;                         // [2][N]
  int8_t* ring = reinterpret_cast<int8_t*>(graw + 2 * N);   // [2C-1][levels][S][drow]
  int* a_s = reinterpret_cast<int*>(ring + nslots * blk);   // [2][S] by step parity

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * S;
  const int nb = min(S, s.B - b0);
  const limb_planes::Lane ln = limb_planes::lane_of<4, T, kBlocked>(N, S);

  // the digits of coefficients [lo, hi) of the S*N of poly p at step `step`
  // (whose exponents are at a_s[step & 1]) into its ring slot
  auto digits = [&](int step, int p, int lo, int hi) {
    int8_t* slot = ring + ((step * C + p) % nslots) * blk;
    const int* a = a_s + (step & 1) * S;
    for (int idx = lo + tid; idx < hi; idx += nthr) {
      const int bb = idx / N, i = idx - bb * N;
      whole_scan::rotate_decompose(acc + bb * CN + p * N, i, a[bb], s, slot + bb * drow + i,
                                   S * drow);
    }
  };

  for (int idx = tid; idx < S * CN; idx += nthr) {
    const int bb = idx / CN;
    acc[idx] = bb < nb ? acc0[static_cast<size_t>(b0) * CN + idx] : 0u;
  }
  if (tid < S) a_s[tid] = tid < nb ? (a_hat[b0 + tid] & mask2) : 0;
  // key row q = (step, c, ob, r) of the sequence, 16-byte pieces into graw[q & 1]
  const int rows = s.n_steps * C * blocks * R, units = rows * blocks;
  auto issue = [&](int q) {
    const int r = q % R, step = q / (R * blocks * C), c = (q / (R * blocks)) % C;
    const uint32_t* src = bk + ((static_cast<size_t>(step) * R + r) * C + c) * N;
    uint32_t* dst = graw + (q & 1) * N;
    for (int ch = tid; ch < N / 4; ch += nthr) cp_async16(dst + 4 * ch, src + 4 * ch, true);
  };
  if (rows > 0) issue(0);
  __syncthreads();
  for (int p = 0; p < C && s.n_steps > 0; ++p) digits(0, p, 0, SN);
  if (rows > 0) {
    cp_async_commit_wait();
    __syncthreads();
    build_window<true>(graw, planes, N, bw, window_base<kBlocked>(0, 0, N));
    if (rows > 1) issue(1);
  }

  const int chunk = (SN + R * blocks * blocks - 1) / (R * blocks * blocks);  // per unit
  int u = 0;  // unit (q, kc): chunk kc of row q's inputs
  for (int step = 0; step < s.n_steps; ++step) {
    const bool last = step + 1 == s.n_steps;
    // step s+1's exponents take the parity whose digits (step s-1's) are built
    if (!last && tid < S)
      a_s[((step + 1) & 1) * S + tid] =
          tid < nb ? (a_hat[static_cast<size_t>(step + 1) * s.B + b0 + tid] & mask2) : 0;
    for (int cb = 0; cb < C * blocks; ++cb) {  // pass: column c, output block ob
      const int c = cb / blocks, ob = cb - c * blocks;
      int sums[4][T][4];
#pragma unroll
      for (int l = 0; l < 4; ++l)
#pragma unroll
        for (int a = 0; a < T; ++a)
#pragma unroll
          for (int i = 0; i < 4; ++i) sums[l][a][i] = 0;
      for (int ru = 0; ru < R * blocks; ++ru, ++u) {
        const int r = ru / blocks, kc = ru - r * blocks, q = u / blocks;
        // row q+1's words have landed, every warp is done with unit u-1 (whose
        // plane buffer, and raw row past its last chunk, are free), and plane
        // c-1 is final
        cp_async_commit_wait();
        __syncthreads();
        if (kc == blocks - 1 && q + 2 < rows) issue(q + 2);
        const int8_t* slot = ring + ((step * C + r / s.levels) % nslots) * blk;
        const int8_t* row = slot + (r % s.levels) * S * drow;
        const int uc = ob * R * blocks + ru;  // the unit's place in column c
        auto next_digits = [&] {
          if (!last && c > 0) digits(step + 1, c - 1, uc * chunk, min(SN, (uc + 1) * chunk));
        };
        mma_row<4, T>(sums, planes + (u & 1) * ps + ln.copy,
                      reinterpret_cast<const uint32_t*>(row) + ln.dig + kc * (bw / 4), bw,
                      ln.x0 >> 2,
                      next_unit<kBlocked>(graw, planes + ((u + 1) & 1) * ps, N, q, kc, ob, ru,
                                          R, blocks, u + 1 == units),
                      next_digits);
      }
      limb_planes::add_column<4, T>(sums, acc, CN, c * N + ob * bw, ln, S);
    }
    if (!last) {
      __syncthreads();  // plane C-1 is final and every column of step s is read
      digits(step + 1, C - 1, 0, SN);
      // the next row's barrier orders these digits before their first read
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nb * CN; idx += nthr)
    out[static_cast<size_t>(b0) * CN + idx] = acc[idx];
}

template <int T, bool kBlocked>
int launch(const void* acc0, const void* bk, const void* a_hat, void* out, const Shape& s,
           int* info, cudaStream_t stream) {
  const int threads = 32 * (block_width(s.N) / (16 * T));
  const size_t smem = smem_bytes(s);
  if (smem > static_cast<size_t>(whole_scan::smem_optin()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      wide_pipe_kernel<T, kBlocked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = s.spc;
  info[1] = threads;
  info[2] = static_cast<int>(smem);
  info[3] = (s.B + s.spc - 1) / s.spc;
  wide_pipe_kernel<T, kBlocked><<<info[3], threads, smem, stream>>>(
      static_cast<const uint32_t*>(acc0), static_cast<const uint32_t*>(bk),
      static_cast<const int32_t*>(a_hat), static_cast<uint32_t*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// acc0 u32 [B, C, N], bk u32 [n, R, C, N] (canonical rows p*levels + j,
// 16-byte aligned), a_hat int32 [n, B] -> out u32 [B, C, N], exact key,
// with `spc` samples per CTA.  info (host, 4 ints) receives the plan:
// samples per CTA, threads per CTA, dynamic shared memory bytes and CTAs.
// Returns cudaErrorInvalidValue unless N is a power of two with 64 <= N <=
// kMaxDegree (Kernel B's tiles and blocks), C >= 1, B >= 1, bk is 16-byte
// aligned, spc is 1,
// 2, 4 or 8 and the shared memory fits the card's opt-in budget.
int blind_rotate_fused_wide_pipe(const void* acc0, const void* bk, const void* a_hat,
                                 void* out, int n_steps, int B, int C, int N, int levels,
                                 int log_base, int ignored_bits, int balanced,
                                 unsigned int balanced_offset, int spc, int* info,
                                 void* stream) {
  if (N < 64 || N > kMaxDegree || (N & (N - 1)) || C < 1 || B < 1 ||
      reinterpret_cast<uintptr_t>(bk) % 16 || (spc != 1 && spc != 2 && spc != 4 && spc != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{n_steps, B, C, N, levels, log_base, ignored_bits, balanced, balanced_offset,
                4, spc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > kBlock) return launch<4, true>(acc0, bk, a_hat, out, s, info, st);
  return tiles_per_warp(N) == 4 ? launch<4, false>(acc0, bk, a_hat, out, s, info, st)
                                : launch<2, false>(acc0, bk, a_hat, out, s, info, st);
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
