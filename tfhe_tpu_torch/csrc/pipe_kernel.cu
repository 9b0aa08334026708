// Kernel E: the software-pipelined whole blind rotation in one launch.
//
// Replaces: tfhe_tpu/ops/pallas/blind_rotate_kernel.py, blind_rotate_fused_pipe
// (body _kernel_pipe): carry-chain digits, key_limbs 4 (exact) or 3 (the low
// byte of each sign-twisted key word dropped).  The step is the one
// whole_scan.cuh writes out.  Step s+1's digits are built while step s's
// remaining columns contract, staged in a parity double buffer.
//
// What bounds it on the H100: integer multiply-adds, R*N*C*N per sample and
// step (1.05e13 for B=1024 over 722 steps at default_128);
// the key streams once per step per CTA from L2 and the accumulators never
// leave the SM.  The digit pipeline (rotation and decomposition, ~0.5% of
// the operations) is what the TPU kernel hid under its matrix unit; here it
// costs a barrier-separated phase of every warp in Kernel B.
//
// Design: the CTA's warps are split.  The consumer warps own kU=8
// consecutive outputs of the current column for 2 samples each (S/2 groups
// of N/8 threads; 1 sample when S=1) and contract column c of step s against
// digit buffer s%2, one staged key row w(+-g) at a time, column by column.
// After column c's update they arrive on named barrier "plane c".  Two
// producer warps wait there, rotate poly c by step s+1's exponents and write
// its digits into buffer (s+1)%2 while the consumers go on with column c+1;
// after the last poly they arrive on barrier "digits", where the consumers
// wait before step s+1.  So only the last column's digit work is exposed, as
// on the TPU.  Shared memory: S*C*N u32 accumulators, 2*S*R*N int8 digits and
// one staged row (197 KB at default_128 with S=8; the wrapper picks S in
// {8, 4, 2, 1} from the card's opt-in budget).

#include <cstdint>
#include <cuda_runtime.h>

#include "whole_scan.cuh"

namespace {

using whole_scan::kU;
using whole_scan::pad;
using whole_scan::Shape;

constexpr int kProducers = 64;  // two producer warps
constexpr int kMaxConsumers = 512;
constexpr int kMaxColumns = 8;  // named barriers 4 .. 4+C-1
// named barriers (0 is __syncthreads)
constexpr int kBarConsumers = 1, kBarProducers = 2, kBarDigits = 3, kBarPlane = 4;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__host__ int consumers(const Shape& s) {
  const int spt = s.spc == 1 ? 1 : 2;
  return ((s.N / kU) * (s.spc / spt) + 31) / 32 * 32;
}

__host__ size_t smem_bytes(const Shape& s) {
  const size_t S = s.spc, C = s.C, N = s.N, R = C * s.levels;
  return 4 * S * C * N + 2 * S * R * N + 4 * pad(2 * s.N) + 4 * 2 * S;
}

template <int SPT>
__global__ void __launch_bounds__(kMaxConsumers + kProducers, 1)
pipe_kernel(const uint32_t* __restrict__ acc0, const uint32_t* __restrict__ bk,
            const int32_t* __restrict__ a_hat, uint32_t* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = s.spc, N = s.N, C = s.C, R = C * s.levels, CN = C * N, RN = R * N;
  const int mask2 = 2 * N - 1;
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);         // [S][C][N]
  uint32_t* gext = acc + S * CN;                              // [pad(2N)]
  int8_t* dig = reinterpret_cast<int8_t*>(gext + pad(2 * N));  // [2][S][R][N]
  int* a_s = reinterpret_cast<int*>(dig + 2 * S * RN);        // [2][S] by step parity

  const int tid = threadIdx.x, T = blockDim.x, Tc = T - kProducers;
  const int b0 = blockIdx.x * S;
  const int nb = min(S, s.B - b0);

  // prologue (all threads): the accumulators and step 0's digits
  for (int idx = tid; idx < S * CN; idx += T) {
    const int bb = idx / CN;
    acc[idx] = bb < nb ? acc0[static_cast<size_t>(b0) * CN + idx] : 0u;
  }
  if (tid < S) a_s[tid] = tid < nb ? (a_hat[b0 + tid] & mask2) : 0;
  __syncthreads();
  for (int idx = tid; idx < S * CN; idx += T) {
    const int bb = idx / CN, rem = idx - bb * CN, p = rem / N, i = rem - p * N;
    whole_scan::rotate_decompose(acc + bb * CN + p * N, i, a_s[bb], s,
                                 dig + (bb * R + p * s.levels) * N + i, N);
  }
  __syncthreads();

  if (tid < Tc) {
    // consumers: unit (o0 .. o0+7 of the current column) x SPT samples
    const int upc = N / kU;
    const bool active = tid < upc * (S / SPT);
    const int o0 = (tid % upc) * kU, bs = active ? (tid / upc) * SPT : 0;
    for (int step = 0; step < s.n_steps; ++step) {
      const int8_t* dstep = dig + (step & 1) * S * RN + bs * RN;
      if (step > 0) bar_sync(kBarDigits, T);  // the producers staged this step's digits
      const uint32_t* bk_step = bk + static_cast<size_t>(step) * R * CN;
      for (int c = 0; c < C; ++c) {
        uint32_t delta[SPT][kU];
#pragma unroll
        for (int bb = 0; bb < SPT; ++bb)
#pragma unroll
          for (int u = 0; u < kU; ++u) delta[bb][u] = 0u;
        for (int r = 0; r < R; ++r) {
          whole_scan::stage_row(bk_step + static_cast<size_t>(r) * CN + c * N, s, gext, tid, Tc);
          bar_sync(kBarConsumers, Tc);
          if (active) whole_scan::contract_row<SPT>(delta, gext, dstep + r * N, RN, o0, N);
          bar_sync(kBarConsumers, Tc);
        }
        if (active) {
#pragma unroll
          for (int bb = 0; bb < SPT; ++bb)
#pragma unroll
            for (int u = 0; u < kU; ++u) acc[(bs + bb) * CN + c * N + o0 + u] += delta[bb][u];
        }
        if (step + 1 < s.n_steps) bar_arrive(kBarPlane + c, T);  // plane c is final
      }
    }
  } else {
    // producers: poly c's step-s+1 digits as soon as plane c is final
    const int pt = tid - Tc;
    for (int step = 0; step + 1 < s.n_steps; ++step) {
      int* a_next = a_s + ((step + 1) & 1) * S;
      int8_t* dnext = dig + ((step + 1) & 1) * S * RN;
      if (pt < S)
        a_next[pt] = pt < nb ? (a_hat[static_cast<size_t>(step + 1) * s.B + b0 + pt] & mask2) : 0;
      bar_sync(kBarProducers, kProducers);
      for (int c = 0; c < C; ++c) {
        bar_sync(kBarPlane + c, T);
        for (int idx = pt; idx < S * N; idx += kProducers) {
          const int bb = idx / N, i = idx - bb * N;
          whole_scan::rotate_decompose(acc + bb * CN + c * N, i, a_next[bb], s,
                                       dnext + (bb * R + c * s.levels) * N + i, N);
        }
      }
      bar_arrive(kBarDigits, T);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nb * CN; idx += T)
    out[static_cast<size_t>(b0) * CN + idx] = acc[idx];
}

template <int SPT>
int launch(const void* acc0, const void* bk, const void* a_hat, void* out, const Shape& s,
           int* info, cudaStream_t stream) {
  const int threads = consumers(s) + kProducers;
  const size_t smem = smem_bytes(s);
  if (smem > static_cast<size_t>(whole_scan::smem_optin()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(pipe_kernel<SPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = s.spc;
  info[1] = threads;
  info[2] = static_cast<int>(smem);
  info[3] = (s.B + s.spc - 1) / s.spc;
  pipe_kernel<SPT><<<info[3], threads, smem, stream>>>(
      static_cast<const uint32_t*>(acc0), static_cast<const uint32_t*>(bk),
      static_cast<const int32_t*>(a_hat), static_cast<uint32_t*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// acc0 u32 [B, C, N], bk u32 [n, R, C, N] (canonical rows p*levels + j),
// a_hat int32 [n, B] -> out u32 [B, C, N], carry-chain digits, with `spc`
// samples per CTA.  info (host, 4 ints) receives the plan: samples per CTA,
// threads per CTA, dynamic shared memory bytes and CTAs.  Returns
// cudaErrorInvalidValue unless N is a power of two >= kU, 1 <= C <=
// kMaxColumns, B >= 1, key_limbs is 3 or 4, spc is 1, 2, 4 or 8, the
// consumers fit kMaxConsumers and the shared memory fits the card's opt-in
// budget.
int blind_rotate_fused_pipe(const void* acc0, const void* bk, const void* a_hat, void* out,
                            int n_steps, int B, int C, int N, int levels, int log_base,
                            int ignored_bits, int key_limbs, int spc, int* info,
                            void* stream) {
  const Shape s{n_steps, B, C, N, levels, log_base, ignored_bits, 0, 0u, key_limbs, spc};
  if (N < kU || (N & (N - 1)) || C < 1 || C > kMaxColumns || B < 1 ||
      (key_limbs != 3 && key_limbs != 4) || (spc != 1 && spc != 2 && spc != 4 && spc != 8) ||
      consumers(s) > kMaxConsumers)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return spc == 1 ? launch<1>(acc0, bk, a_hat, out, s, info, st)
                  : launch<2>(acc0, bk, a_hat, out, s, info, st);
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
