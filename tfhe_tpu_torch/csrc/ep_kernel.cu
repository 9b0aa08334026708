// Kernel A: one external-product step, int8 digits x GGSW rows -> int32 limb planes.
//
// Replaces: tfhe_tpu/ops/pallas/ep_kernel.py, ep_contract_pallas_rbn (body
// _ep_kernel_rbn).  It computes, exactly,
//
//   out[c, l, b, o] = sum_{r, m} d[r, b, m] * limb_l( +-g[r, c, (o - m) mod N] )
//
// with the negacyclic sign applied to g in u32 BEFORE the balanced 8-bit limb
// split (x + 0x80808080, bytes minus 128), since the limb -128 cannot be
// negated in int8.  Shapes: d int8 [R, B, N], g u32 [R, C, N], out int32
// [C, 4, B, N].  Row order is free (the contraction is row-order invariant);
// the blind-rotation scan passes level-major rows.
//
// What bounds it on the H100: integer multiply-adds.  Each (digit, key word)
// pair costs 4 IMADs, one per limb plane: B*R*C*N*N*4 of them per call
// (about 3.6e9 at default_128, B=64).  Device memory is no limit: the key rows
// are R*C*N*4 bytes (110 KB at default_128) and every CTA re-reads them from L2.
//
// Design: the TPU kernel builds each row's [N, N] circulant in VMEM with one
// strided roll.  Here the circulant is never built.  Per row r a CTA stages
// the 2N packed limb words of [g, -g] for its column in shared memory once,
// and reads entry (o - m) mod 2N on the fly. That is one conflict-free 32-bit
// load per (o, m), shared by the CTA's 8 samples and 4 limbs (32 IMADs).  A
// CTA owns 8 samples x one column c x up to 128 outputs o (one per thread),
// so B=64 at N=512 still gives 8*3*4 = 96 CTAs.  The 32 limb sums of a thread
// stay in registers for all R rows.  Tensor cores (mma.sync s8 -> s32 on
// circulant tiles) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBT = 8;       // samples per CTA
constexpr int kMaxOT = 128;  // output coefficients per CTA, one per thread

__device__ __forceinline__ int sbyte(uint32_t word, int i) {
  return static_cast<int>(word << (24 - 8 * i)) >> 24;
}

__global__ void ep_contract_rbn_kernel(const int8_t* __restrict__ digits,
                                       const uint32_t* __restrict__ rows,
                                       int32_t* __restrict__ out,
                                       int R, int B, int C, int N) {
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
      ds[m * kBT + bb] = b < B ? digits[(static_cast<size_t>(r) * B + b) * N + m] : 0;
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
      for (int l = 0; l < 4; ++l)
        out[((static_cast<size_t>(c) * 4 + l) * B + b) * N + o] = acc[bb][l];
    }
  }
}

}  // namespace

extern "C" {

// digits int8 [R, B, N], rows u32 [R, C, N] -> out int32 [C, 4, B, N].
// Returns cudaErrorInvalidValue unless N is a power of two >= 8 and B, C >= 1.
int ep_contract_rbn(const void* digits, const void* rows, void* out, int R, int B,
                    int C, int N, void* stream) {
  if (N < 8 || (N & (N - 1)) || B < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ot = N < kMaxOT ? N : kMaxOT;
  const dim3 grid((B + kBT - 1) / kBT, C, N / ot);
  const size_t smem = 2 * static_cast<size_t>(N) * sizeof(uint32_t) +
                      static_cast<size_t>(N) * kBT;
  cudaError_t err = cudaFuncSetAttribute(
      ep_contract_rbn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ep_contract_rbn_kernel<<<grid, ot, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(digits), static_cast<const uint32_t*>(rows),
      static_cast<int32_t*>(out), R, B, C, N);
  return static_cast<int>(cudaGetLastError());
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
