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
// What bounds it on the H100: integer multiply-adds, R*N*C*N per sample and
// step (1.05e13 for B=1024 over 722 steps at default_128).
// What a scan that stages one key row at a time spends besides: CTA
// barriers around the staging of each row.
//
// Design: column-outer.  For each step s and output column c the CTA copies
// the column's whole key block (R rows of N u32, 36 KB at default_128) from
// device memory into shared memory with 16-byte cp.async, into one of two
// buffers, started as soon as column c-1's contraction starts (the buffer it
// fills was last read by column c-2).  So the copy of the next block runs
// under the current contraction, and the contraction of a column runs over
// all R rows with no barrier between them.  The block holds g only; a thread
// loads its 16-word window of +-g as four 16-byte vectors and negates the
// vectors that lie in the wrapped half.  Each row is padded by 4 words in 32
// so the eight threads of a quarter warp hit distinct 16-byte bank groups.
// A thread owns kU=8 consecutive outputs of the column for one sample (S
// groups of N/8 threads).  After column c's update and a barrier, every
// thread rotates and decomposes its share of poly c by step s+1's exponents
// into the other buffer of a parity double buffer of digits.  Shared memory:
// 2 key blocks, S*C*N u32 accumulators and 2*S*R*N int8 digits (177 KB at
// default_128 with S=4; the wrapper picks S in {8, 4, 2, 1} from the card's
// opt-in budget).

#include <cstdint>
#include <cuda_runtime.h>

#include "whole_scan.cuh"

namespace {

using whole_scan::kU;
using whole_scan::Shape;

constexpr int kMaxThreads = 512;

__host__ __device__ __forceinline__ int row_words(int N) { return N + N / 8; }

// padded position of word j of a staged key row: 4 padding words per 32
__device__ __forceinline__ int kpad(int j) { return j + 4 * (j >> 5); }

__host__ int threads_for(const Shape& s) { return ((s.N / kU) * s.spc + 31) / 32 * 32; }

__host__ size_t smem_bytes(const Shape& s) {
  const size_t S = s.spc, C = s.C, N = s.N, R = C * s.levels;
  return 4 * 2 * R * row_words(s.N) + 4 * S * C * N + 2 * S * R * N + 4 * 2 * S;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Start the copy of key block (step, column c) into `dst` and commit it.
__device__ __forceinline__ void copy_block(const uint32_t* __restrict__ bk, int step, int c,
                                           const Shape& s, uint32_t* dst, int tid, int T) {
  const int R = s.C * s.levels, q_per_row = s.N / 4, rw = row_words(s.N);
  for (int idx = tid; idx < R * q_per_row; idx += T) {
    const int r = idx / q_per_row, j = (idx - r * q_per_row) * 4;
    cp_async16(dst + r * rw + kpad(j),
               bk + ((static_cast<size_t>(step) * R + r) * s.C + c) * s.N + j);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kMaxThreads, 1)
wide_pipe_kernel(const uint32_t* __restrict__ acc0, const uint32_t* __restrict__ bk,
                 const int32_t* __restrict__ a_hat, uint32_t* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = s.spc, N = s.N, C = s.C, R = C * s.levels, CN = C * N, RN = R * N;
  const int mask2 = 2 * N - 1, rw = row_words(N);
  uint32_t* kblk = reinterpret_cast<uint32_t*>(smem);         // [2][R][rw]
  uint32_t* acc = kblk + 2 * R * rw;                           // [S][C][N]
  int8_t* dig = reinterpret_cast<int8_t*>(acc + S * CN);      // [2][S][R][N]
  int* a_s = reinterpret_cast<int*>(dig + 2 * S * RN);        // [2][S] by step parity

  const int tid = threadIdx.x, T = blockDim.x;
  const int b0 = blockIdx.x * S;
  const int nb = min(S, s.B - b0);
  const int upc = N / kU;
  const bool active = tid < upc * S;
  const int o0 = (tid % upc) * kU, bb = active ? tid / upc : 0;

  if (s.n_steps > 0) copy_block(bk, 0, 0, s, kblk, tid, T);
  for (int idx = tid; idx < S * CN; idx += T) {
    const int b = idx / CN;
    acc[idx] = b < nb ? acc0[static_cast<size_t>(b0) * CN + idx] : 0u;
  }
  if (tid < S) a_s[tid] = tid < nb ? (a_hat[b0 + tid] & mask2) : 0;
  __syncthreads();
  for (int idx = tid; idx < S * CN; idx += T) {
    const int b = idx / CN, rem = idx - b * CN, p = rem / N, i = rem - p * N;
    whole_scan::rotate_decompose(acc + b * CN + p * N, i, a_s[b], s,
                                 dig + (b * R + p * s.levels) * N + i, N);
  }

  int blk = 0;  // key blocks consumed so far; block blk sits in buffer blk % 2
  for (int step = 0; step < s.n_steps; ++step) {
    const bool last = step + 1 == s.n_steps;
    int* a_next = a_s + ((step + 1) & 1) * S;
    if (!last && tid < S)
      a_next[tid] = tid < nb ? (a_hat[static_cast<size_t>(step + 1) * s.B + b0 + tid] & mask2)
                             : 0;
    const int8_t* dcur = dig + (step & 1) * S * RN + bb * RN;
    int8_t* dnext = dig + ((step + 1) & 1) * S * RN;
    for (int c = 0; c < C; ++c, ++blk) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();  // block blk has landed; the other buffer is free
      if (c + 1 < C)
        copy_block(bk, step, c + 1, s, kblk + ((blk + 1) & 1) * R * rw, tid, T);
      else if (!last)
        copy_block(bk, step + 1, 0, s, kblk + ((blk + 1) & 1) * R * rw, tid, T);
      const uint32_t* kb = kblk + (blk & 1) * R * rw;

      uint32_t delta[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) delta[u] = 0u;
      if (active) {
        for (int r = 0; r < R; ++r) {
          const uint32_t* row = kb + r * rw;
          const int8_t* drow = dcur + r * N;
          for (int m0 = 0; m0 < N; m0 += kU) {
            // win[t] = +-g[(o0 - m0 - kU + t) mod 2N]; output o0+u at m0+mm
            // reads win[u - mm + kU].  The window starts on a multiple of 8
            // and 2N is one, so each 4-word vector lies in one half.
            uint32_t win[2 * kU];
            const int start = (o0 - m0 - kU) & mask2;
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int idx = (start + 4 * v) & mask2;
              uint4 q = *reinterpret_cast<const uint4*>(row + kpad(idx & (N - 1)));
              if (idx >= N) {
                q.x = 0u - q.x;
                q.y = 0u - q.y;
                q.z = 0u - q.z;
                q.w = 0u - q.w;
              }
              win[4 * v] = q.x;
              win[4 * v + 1] = q.y;
              win[4 * v + 2] = q.z;
              win[4 * v + 3] = q.w;
            }
            const uint2 dv = *reinterpret_cast<const uint2*>(drow + m0);
#pragma unroll
            for (int mm = 0; mm < kU; ++mm) {
              const uint32_t d =
                  static_cast<uint32_t>(whole_scan::sbyte(mm < 4 ? dv.x : dv.y, mm & 3));
#pragma unroll
              for (int u = 0; u < kU; ++u) delta[u] += d * win[u - mm + kU];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) acc[bb * CN + c * N + o0 + u] += delta[u];
      }
      if (last) continue;
      __syncthreads();  // plane c is final
      for (int idx = tid; idx < S * N; idx += T) {
        const int b = idx / N, i = idx - b * N;
        whole_scan::rotate_decompose(acc + b * CN + c * N, i, a_next[b], s,
                                     dnext + (b * R + c * s.levels) * N + i, N);
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nb * CN; idx += T)
    out[static_cast<size_t>(b0) * CN + idx] = acc[idx];
}

}  // namespace

extern "C" {

// acc0 u32 [B, C, N], bk u32 [n, R, C, N] (canonical rows p*levels + j,
// 16-byte aligned), a_hat int32 [n, B] -> out u32 [B, C, N], exact key,
// with `spc` samples per CTA.  info (host, 4 ints) receives the plan:
// samples per CTA, threads per CTA, dynamic shared memory bytes and CTAs.
// Returns cudaErrorInvalidValue unless N is a power of two >= 32, C >= 1,
// B >= 1, spc is 1, 2, 4 or 8, the threads fit kMaxThreads and the shared
// memory fits the card's opt-in budget.
int blind_rotate_fused_wide_pipe(const void* acc0, const void* bk, const void* a_hat,
                                 void* out, int n_steps, int B, int C, int N, int levels,
                                 int log_base, int ignored_bits, int balanced,
                                 unsigned int balanced_offset, int spc, int* info,
                                 void* stream) {
  const Shape s{n_steps, B, C, N, levels, log_base, ignored_bits, balanced, balanced_offset,
                4, spc};
  if (N < 32 || (N & (N - 1)) || C < 1 || B < 1 ||
      (spc != 1 && spc != 2 && spc != 4 && spc != 8) || threads_for(s) > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(s);
  if (smem > static_cast<size_t>(whole_scan::smem_optin()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(wide_pipe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = spc;
  info[1] = threads_for(s);
  info[2] = static_cast<int>(smem);
  info[3] = (B + spc - 1) / spc;
  wide_pipe_kernel<<<info[3], info[1], smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc0), static_cast<const uint32_t*>(bk),
      static_cast<const int32_t*>(a_hat), static_cast<uint32_t*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
