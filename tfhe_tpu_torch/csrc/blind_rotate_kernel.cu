// Kernel B: the whole blind rotation (all n CMUX steps) in one launch.
//
// Replaces: tfhe_tpu/ops/pallas/blind_rotate_kernel.py, blind_rotate_fused
// (wide body _kernel_wide with _rotate_negacyclic, _decompose_kept_int8 and
// _decompose_balanced_int8), key_limbs=4 (the exact mode) and key_limbs=3
// (the low byte of each sign-twisted key word dropped; whole_scan.cuh).
// The step is the one whole_scan.cuh writes out.
//
// The product is accumulated directly in wrapping u32 multiply-adds.  That is
// bit-identical to the TPU kernel's int8 limb planes, because the limb
// recombination sum_l limb_l * 2^(8l) is an exact mod-2^32 reconstruction of
// the key word (of its kept limbs at key_limbs=3).  So key_limbs=3 saves no
// work here: it is one multiply-add per key word either way.
//
// What bounds it on the H100: integer multiply-adds, R*N*C*N per sample and
// step (1.4e7 at default_128; 1.05e13 for B=1024 over 722 steps).  Device
// memory is no limit.  The key streams once per step per CTA (110 KB at
// default_128, served from L2 since every CTA reads the same step), and the
// accumulators never leave the SM.
//
// Design: the TPU kernel keeps R*(k+1)*4*N^2 int8 Toeplitz planes resident
// on chip, hundreds of times the 227 KB of shared memory of an SM.  Here no
// Toeplitz operand exists.  Each CTA owns S samples for all n steps, with
// no inter-CTA synchronisation (samples are independent), and keeps their
// accumulators (S*C*N u32) and digits (S*R*N int8) in shared memory: 134 KB
// at default_128 with S=8.  The wrapper picks S in {8, 4, 2, 1}, the largest
// whose shared memory fits the card's opt-in budget.  The rotation is a
// gather with the closed-form sign (the TPU's barrel shifter exists only
// because a gather was slow there).  Per digit row r the CTA stages w(+-g)
// of every column (C*2N u32, padded one word in nine against bank conflicts)
// and each thread reads them on the fly.  A thread owns kU=8 consecutive
// outputs o of one column for all S samples (8*S u32 accumulators in
// registers).  It walks m in chunks of 8 with a 15-word sliding window, so
// each staged key word feeds S samples x up to 8 multiply-adds.  Tensor
// cores (int8 mma on limb planes), TMA staging of the key and a pipeline
// over steps are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "whole_scan.cuh"

namespace {

using whole_scan::kU;
using whole_scan::pad;
using whole_scan::Shape;

constexpr int kMaxThreads = 256;

__host__ size_t smem_bytes(const Shape& s) {
  const size_t S = s.spc, C = s.C, N = s.N, R = C * s.levels;
  return 4 * (S * C * N + C * pad(2 * s.N)) + S * R * N + 4 * S;
}

template <int S>
__global__ void __launch_bounds__(kMaxThreads, 1)
blind_rotate_kernel(const uint32_t* __restrict__ acc0, const uint32_t* __restrict__ bk,
                    const int32_t* __restrict__ a_hat, uint32_t* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = s.N, C = s.C, R = C * s.levels, CN = C * N;
  const int mask2 = 2 * N - 1, gstride = pad(2 * N);
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);           // [S][C][N]
  uint32_t* gext = acc + S * CN;                                // [C][pad(2N)]
  int8_t* dig = reinterpret_cast<int8_t*>(gext + C * gstride);  // [S][R][N]
  int* a_s = reinterpret_cast<int*>(dig + S * R * N);           // [S]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * S;
  const int nb = min(S, s.B - b0);

  for (int idx = tid; idx < S * CN; idx += nthr) {
    const int bb = idx / CN;
    acc[idx] = bb < nb ? acc0[static_cast<size_t>(b0) * CN + idx] : 0u;
  }
  // this thread's outputs: column c, coefficients o0 .. o0+kU-1
  const int units = CN / kU;
  const bool active = tid < units;
  const int c = active ? tid / (N / kU) : 0;
  const int o0 = active ? (tid % (N / kU)) * kU : 0;

  for (int step = 0; step < s.n_steps; ++step) {
    if (tid < S)
      a_s[tid] = tid < nb ? (a_hat[static_cast<size_t>(step) * s.B + b0 + tid] & mask2) : 0;
    __syncthreads();  // last step's acc updates and this step's exponents
    for (int idx = tid; idx < S * CN; idx += nthr) {
      const int bb = idx / CN, rem = idx - bb * CN;
      const int p = rem / N, i = rem - p * N;
      whole_scan::rotate_decompose(acc + bb * CN + p * N, i, a_s[bb], s,
                                   dig + (bb * R + p * s.levels) * N + i, N);
    }
    __syncthreads();

    uint32_t delta[S][kU];
#pragma unroll
    for (int bb = 0; bb < S; ++bb)
#pragma unroll
      for (int u = 0; u < kU; ++u) delta[bb][u] = 0u;

    const uint32_t* bk_step = bk + static_cast<size_t>(step) * R * CN;
    for (int r = 0; r < R; ++r) {
      for (int j = tid; j < C * 2 * N; j += nthr) {
        const int cc = j / (2 * N), jj = j - cc * 2 * N;
        const uint32_t g = bk_step[static_cast<size_t>(r) * CN + cc * N + (jj & (N - 1))];
        gext[cc * gstride + pad(jj)] = whole_scan::key_word(jj < N ? g : 0u - g, s.key_limbs);
      }
      __syncthreads();
      if (active)
        whole_scan::contract_row<S>(delta, gext + c * gstride, dig + r * N, R * N, o0, N);
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int bb = 0; bb < S; ++bb)
#pragma unroll
        for (int u = 0; u < kU; ++u) acc[bb * CN + c * N + o0 + u] += delta[bb][u];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nb * CN; idx += nthr)
    out[static_cast<size_t>(b0) * CN + idx] = acc[idx];
}

template <int S>
int launch(const void* acc0, const void* bk, const void* a_hat, void* out, const Shape& s,
           int* info, cudaStream_t stream) {
  const int units = s.C * s.N / kU;
  const int threads = units < 32 ? 32 : (units + 31) / 32 * 32;
  const size_t smem = smem_bytes(s);
  if (smem > static_cast<size_t>(whole_scan::smem_optin()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = S;
  info[1] = threads;
  info[2] = static_cast<int>(smem);
  info[3] = (s.B + S - 1) / S;
  blind_rotate_kernel<S><<<info[3], threads, smem, stream>>>(
      static_cast<const uint32_t*>(acc0), static_cast<const uint32_t*>(bk),
      static_cast<const int32_t*>(a_hat), static_cast<uint32_t*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// acc0 u32 [B, C, N], bk u32 [n, R, C, N] (canonical rows p*levels + j),
// a_hat int32 [n, B] -> out u32 [B, C, N], with `spc` samples per CTA.
// info (host, 4 ints) receives the plan: samples per CTA, threads per CTA,
// dynamic shared memory bytes and CTAs.  Returns cudaErrorInvalidValue
// unless N is a power of two >= kU, C*N/kU <= kMaxThreads, B >= 1,
// key_limbs is 3 or 4, spc is 1, 2, 4 or 8 and its shared memory fits the
// card's opt-in budget.
int blind_rotate_fused(const void* acc0, const void* bk, const void* a_hat, void* out,
                       int n_steps, int B, int C, int N, int levels, int log_base,
                       int ignored_bits, int balanced, unsigned int balanced_offset,
                       int key_limbs, int spc, int* info, void* stream) {
  if (N < kU || (N & (N - 1)) || C < 1 || C * N / kU > kMaxThreads || B < 1 ||
      (key_limbs != 3 && key_limbs != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{n_steps, B, C, N, levels, log_base, ignored_bits, balanced,
                balanced_offset, key_limbs, spc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (spc) {
    case 1: return launch<1>(acc0, bk, a_hat, out, s, info, st);
    case 2: return launch<2>(acc0, bk, a_hat, out, s, info, st);
    case 4: return launch<4>(acc0, bk, a_hat, out, s, info, st);
    case 8: return launch<8>(acc0, bk, a_hat, out, s, info, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
