// Device code shared by the two external-product contraction kernels:
// Kernel A (ep_kernel.cu; digits [R, B, N], limb planes [C, 4, B, N]) and
// Kernel H (ep_batch_kernel.cu; digits [B, R, N], limb sums [B, C*4, N]).
// Both compute, exactly, in their own layouts,
//
//   out[b, c*4 + l, o] = sum_{r, m} d[b, r, m] * limb_l( +-g[r, c, (o - m) mod N] )
//
// with the negacyclic sign applied to g in u32 BEFORE the balanced 8-bit limb
// split (x + 0x80808080, bytes minus 128), since the limb -128 cannot be
// negated in int8.  g is u32 [R, C, N].  Row order is free (the contraction
// is row-order invariant) as long as digits and key rows agree.
//
// What bounds it on the H100: integer multiply-adds.  Each (digit, key word)
// pair costs 4 IMADs, one per limb: B*R*C*N*N*4 of them per call (about
// 3.6e9 at default_128, B=64).  Device memory is no limit: the key rows are
// R*C*N*4 bytes (110 KB at default_128) and every CTA re-reads them from L2.
//
// Design: the TPU kernels build each row's [N, N] circulant in VMEM with one
// strided roll.  Here the circulant is never built.  Per row r a CTA stages
// the 2N packed limb words of [g, -g] for its column in shared memory once,
// and reads entry (o - m) mod 2N on the fly. That is one conflict-free 32-bit
// load per (o, m), shared by the CTA's 8 samples and 4 limbs (32 IMADs).  A
// CTA owns 8 samples x one column c x up to 128 outputs o (one per thread),
// so B=64 at N=512 still gives 8*3*4 = 96 CTAs.  The 32 limb sums of a thread
// stay in registers for all R rows, and the writes are coalesced along o in
// both layouts.  Tensor cores (mma.sync s8 -> s32 on circulant tiles) are
// later work.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ep {

constexpr int kBT = 8;       // samples per CTA
constexpr int kMaxOT = 128;  // output coefficients per CTA, one per thread

// Element strides of one layout: the digit row (r, b) starts at
// (r*d_r + b*d_b)*N, the output row (f, b), f = c*4 + l, at (f*o_f + b*o_b)*N.
struct Layout {
  int d_r, d_b, o_f, o_b;
};

__device__ __forceinline__ int sbyte(uint32_t word, int i) {
  return static_cast<int>(word << (24 - 8 * i)) >> 24;
}

// The body of both kernels: grid (ceil(B/kBT), C, N/ot), ot threads.
__device__ __forceinline__ void contract(const int8_t* __restrict__ digits,
                                         const uint32_t* __restrict__ rows,
                                         int32_t* __restrict__ out, int R, int B, int C,
                                         int N, Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* wext = reinterpret_cast<uint32_t*>(smem);    // [2N] limbs of [g, -g]
  int8_t* ds = reinterpret_cast<int8_t*>(wext + 2 * N);  // [N][kBT] digits
  const int b0 = blockIdx.x * kBT;
  const int c = blockIdx.y;
  const int o = blockIdx.z * blockDim.x + threadIdx.x;
  const int mask2 = 2 * N - 1;

  int acc[kBT][4];
#pragma unroll
  for (int bb = 0; bb < kBT; ++bb)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[bb][l] = 0;

  for (int r = 0; r < R; ++r) {
    const uint32_t* g = rows + (static_cast<size_t>(r) * C + c) * N;
    for (int j = threadIdx.x; j < 2 * N; j += blockDim.x) {
      const uint32_t w = j < N ? g[j] : 0u - g[j - N];
      // balanced limbs: byte i of (w + 0x80808080) minus 128 == that byte ^ 0x80
      wext[j] = (w + 0x80808080u) ^ 0x80808080u;
    }
    for (int idx = threadIdx.x; idx < kBT * N; idx += blockDim.x) {
      const int bb = idx / N, m = idx - bb * N;
      const int b = b0 + bb;
      const size_t row = static_cast<size_t>(r) * lay.d_r + static_cast<size_t>(b) * lay.d_b;
      ds[m * kBT + bb] = b < B ? digits[row * N + m] : 0;
    }
    __syncthreads();
    for (int m = 0; m < N; ++m) {
      const uint32_t w = wext[(o - m) & mask2];
      int wl[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) wl[l] = sbyte(w, l);
      const uint2 dv = *reinterpret_cast<const uint2*>(ds + m * kBT);
#pragma unroll
      for (int bb = 0; bb < kBT; ++bb) {
        const int d = sbyte(bb < 4 ? dv.x : dv.y, bb & 3);
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[bb][l] += d * wl[l];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int bb = 0; bb < kBT; ++bb) {
    const int b = b0 + bb;
    if (b < B) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const size_t row = (static_cast<size_t>(c) * 4 + l) * lay.o_f +
                           static_cast<size_t>(b) * lay.o_b;
        out[row * N + o] = acc[bb][l];
      }
    }
  }
}

using KernelFn = void (*)(const int8_t*, const uint32_t*, int32_t*, int, int, int, int);

// Launches `kernel` (whose body is `contract`) on `stream` without
// synchronising and returns its cudaError_t as an int: cudaErrorInvalidValue,
// with nothing launched, unless N is a power of two >= 8 and B, C >= 1.
inline int launch(KernelFn kernel, const void* digits, const void* rows, void* out, int R,
                  int B, int C, int N, void* stream) {
  if (N < 8 || (N & (N - 1)) || B < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ot = N < kMaxOT ? N : kMaxOT;
  const dim3 grid((B + kBT - 1) / kBT, C, N / ot);
  const size_t smem = 2 * static_cast<size_t>(N) * sizeof(uint32_t) +
                      static_cast<size_t>(N) * kBT;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, ot, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(digits), static_cast<const uint32_t*>(rows),
      static_cast<int32_t*>(out), R, B, C, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ep
