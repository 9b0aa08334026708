// Kernel B: the whole blind rotation (all n CMUX steps) in one launch.
//
// Replaces: tfhe_tpu/ops/pallas/blind_rotate_kernel.py, blind_rotate_fused
// (wide body _kernel_wide with _rotate_negacyclic, _decompose_kept_int8 and
// _decompose_balanced_int8), key_limbs=4 (the exact mode).  Per step s and
// sample b, with a = a_hat[s, b] mod 2N:
//
//   rot[p, i]  = (-1)^floor(((i - a) mod 2N) / N) * acc[p, (i - a) mod N]
//   d[r, m]    = signed gadget digits of rot - acc, row r = p*levels + j
//                (MSB-first; reference carry chain, or the closed-form
//                balanced digits when `balanced`)
//   acc[c, o] += sum_{r, m} d[r, m] * (+-bk[s, r, c, (o - m) mod N])   (mod 2^32)
//
// The product is accumulated directly in wrapping u32 multiply-adds.  That is
// bit-identical to the TPU kernel's four int8 limb planes, because the limb
// recombination sum_l limb_l * 2^(8l) is an exact mod-2^32 reconstruction of
// the key word.
//
// What bounds it on the H100: integer multiply-adds, R*N*C*N per sample and
// step (1.4e7 at default_128; 1.05e13 for B=1024 over 722 steps).  Device
// memory is no limit.  The key streams once per step per CTA (110 KB at
// default_128, served from L2 since every CTA reads the same step), and the
// accumulators never leave the SM.
//
// Design: the TPU kernel keeps R*(k+1)*4*N^2 int8 Toeplitz planes resident
// on chip, hundreds of times the 227 KB of shared memory of an SM.  Here no
// Toeplitz operand exists.  Each CTA owns kBT samples for all n steps, with
// no inter-CTA synchronisation (samples are independent), and
// keeps their accumulators (kBT*C*N u32) and digits (kBT*R*N int8) in shared
// memory: 134 KB at default_128.  The rotation is a gather with the
// closed-form sign (the TPU's barrel shifter exists only because a gather
// was slow there).  Per digit row r the CTA stages [g, -g] of every column
// (C*2N u32, padded one word in nine against bank conflicts) and each thread
// reads +-g[(o - m) mod N] on the fly.  A thread owns kU=8 consecutive
// outputs o of one column for all kBT samples (64 u32 accumulators in
// registers).  It walks m in chunks of 8 with a 15-word sliding window, so
// each staged key word feeds 8 samples x up to 8 multiply-adds.  Tensor
// cores (int8 mma on limb planes), TMA staging of the key and a pipeline
// over steps are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBT = 8;  // samples per CTA
constexpr int kU = 8;   // consecutive output coefficients per thread
constexpr int kMaxThreads = 256;

struct Shape {
  int n_steps, B, C, N, levels, log_base, ignored_bits, balanced;
  uint32_t balanced_offset;  // C of decompose_balanced_planes (host-computed)
};

__device__ __forceinline__ int pad(int j) { return j + (j >> 3); }

__device__ __forceinline__ int sbyte(uint32_t word, int i) {
  return static_cast<int>(word << (24 - 8 * i)) >> 24;
}

// Signed digits of one u32 value, written MSB-first at out[j * stride].
__device__ __forceinline__ void decompose(uint32_t diff, const Shape& s,
                                          int8_t* out, int stride) {
  const uint32_t mask = (1u << s.log_base) - 1u;
  const int half = 1 << (s.log_base - 1);
  const int ig = s.ignored_bits;
  if (s.balanced) {
    const uint32_t u = (diff + s.balanced_offset) >> ig;
    for (int l = 0; l < s.levels; ++l)
      out[(s.levels - 1 - l) * stride] =
          static_cast<int8_t>(static_cast<int>((u >> (s.log_base * l)) & mask) - half);
  } else {
    // round_value then the reference carry chain (src/decomposer.rs:42-80)
    // from the first kept digit: the digits below it are zero after rounding
    const uint32_t v = ig ? (diff >> ig) + ((diff >> (ig - 1)) & 1u) : diff;
    int carry = 0;
    for (int l = 0; l < s.levels; ++l) {
      int res = static_cast<int>((v >> (s.log_base * l)) & mask) + carry;
      const int cm = res & half;
      res -= cm << 1;  // in [-B/2, B]: the +B anomaly stays
      carry = cm >> (s.log_base - 1);
      out[(s.levels - 1 - l) * stride] = static_cast<int8_t>(res);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1)
blind_rotate_kernel(const uint32_t* __restrict__ acc0, const uint32_t* __restrict__ bk,
                    const int32_t* __restrict__ a_hat, uint32_t* __restrict__ out,
                    Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = s.N, C = s.C, R = C * s.levels, CN = C * N;
  const int mask2 = 2 * N - 1, gstride = pad(2 * N);
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);      // [kBT][C][N]
  uint32_t* gext = acc + kBT * CN;                         // [C][pad(2N)]
  int8_t* dig = reinterpret_cast<int8_t*>(gext + C * gstride);  // [kBT][R][N]
  int* a_s = reinterpret_cast<int*>(dig + kBT * R * N);   // [kBT]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * kBT;
  const int nb = min(kBT, s.B - b0);

  for (int idx = tid; idx < kBT * CN; idx += nthr) {
    const int bb = idx / CN;
    acc[idx] = bb < nb ? acc0[static_cast<size_t>(b0) * CN + idx] : 0u;
  }
  // this thread's outputs: column c, coefficients o0 .. o0+kU-1
  const int units = CN / kU;
  const bool active = tid < units;
  const int c = active ? tid / (N / kU) : 0;
  const int o0 = active ? (tid % (N / kU)) * kU : 0;

  for (int step = 0; step < s.n_steps; ++step) {
    if (tid < kBT)
      a_s[tid] = tid < nb ? (a_hat[static_cast<size_t>(step) * s.B + b0 + tid] & mask2) : 0;
    __syncthreads();  // last step's acc updates and this step's exponents
    for (int idx = tid; idx < kBT * CN; idx += nthr) {
      const int bb = idx / CN, rem = idx - bb * CN;
      const int p = rem / N, i = rem - p * N;
      const int src = (i - a_s[bb]) & mask2;
      uint32_t rot = acc[bb * CN + p * N + (src & (N - 1))];
      if (src >= N) rot = 0u - rot;
      decompose(rot - acc[idx], s, dig + (bb * R + p * s.levels) * N + i, N);
    }
    __syncthreads();

    uint32_t delta[kBT][kU];
#pragma unroll
    for (int bb = 0; bb < kBT; ++bb)
#pragma unroll
      for (int u = 0; u < kU; ++u) delta[bb][u] = 0u;

    const uint32_t* bk_step = bk + static_cast<size_t>(step) * R * CN;
    for (int r = 0; r < R; ++r) {
      for (int j = tid; j < C * 2 * N; j += nthr) {
        const int cc = j / (2 * N), jj = j - cc * 2 * N;
        const uint32_t g = bk_step[static_cast<size_t>(r) * CN + cc * N + (jj & (N - 1))];
        gext[cc * gstride + pad(jj)] = jj < N ? g : 0u - g;
      }
      __syncthreads();
      if (active) {
        const uint32_t* gx = gext + c * gstride;
        const int8_t* drow = dig + r * N;
        for (int m0 = 0; m0 < N; m0 += kU) {
          // win[t] = +-g[(o0 - m0 - kU + t) mod 2N]; output o0+u at m0+mm
          // reads win[u - mm + kU]
          uint32_t win[2 * kU];
#pragma unroll
          for (int t = 1; t < 2 * kU; ++t) win[t] = gx[pad((o0 - m0 - kU + t) & mask2)];
#pragma unroll
          for (int bb = 0; bb < kBT; ++bb) {
            const uint2 dv = *reinterpret_cast<const uint2*>(drow + bb * R * N + m0);
#pragma unroll
            for (int mm = 0; mm < kU; ++mm) {
              const uint32_t d = static_cast<uint32_t>(sbyte(mm < 4 ? dv.x : dv.y, mm & 3));
#pragma unroll
              for (int u = 0; u < kU; ++u) delta[bb][u] += d * win[u - mm + kU];
            }
          }
        }
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int bb = 0; bb < kBT; ++bb)
#pragma unroll
        for (int u = 0; u < kU; ++u) acc[bb * CN + c * N + o0 + u] += delta[bb][u];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nb * CN; idx += nthr)
    out[static_cast<size_t>(b0) * CN + idx] = acc[idx];
}

}  // namespace

extern "C" {

// acc0 u32 [B, C, N], bk u32 [n, R, C, N] (canonical rows p*levels + j),
// a_hat int32 [n, B] -> out u32 [B, C, N].  Returns cudaErrorInvalidValue
// unless N is a power of two >= kU, C*N/kU <= kMaxThreads and B >= 1.
int blind_rotate_fused(const void* acc0, const void* bk, const void* a_hat, void* out,
                       int n_steps, int B, int C, int N, int levels, int log_base,
                       int ignored_bits, int balanced, unsigned int balanced_offset,
                       void* stream) {
  if (N < kU || (N & (N - 1)) || C < 1 || C * N / kU > kMaxThreads || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{n_steps, B, C, N, levels, log_base, ignored_bits, balanced,
                balanced_offset};
  const int units = C * N / kU;
  const int threads = units < 32 ? 32 : (units + 31) / 32 * 32;
  const size_t smem = sizeof(uint32_t) * (static_cast<size_t>(kBT) * C * N +
                                          static_cast<size_t>(C) * (2 * N + 2 * N / 8)) +
                      static_cast<size_t>(kBT) * C * levels * N + sizeof(int) * kBT;
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  blind_rotate_kernel<<<(B + kBT - 1) / kBT, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc0), static_cast<const uint32_t*>(bk),
      static_cast<const int32_t*>(a_hat), static_cast<uint32_t*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
