// Device helpers shared by the whole-scan blind-rotation kernels (Kernels B,
// E, F and G): the gadget decompositions of one rotated-minus-accumulator
// value (all four), and for Kernel E alone, the one u32 kernel left, the
// truncated-key word, the staged [g, -g] row and the per-row negacyclic
// contraction of a thread's samples against it (Kernels B, F and G take the
// int8 limb planes of limb_planes.cuh through mma_row.cuh instead, and drop
// limb 0 at key_limbs = 3).
//
// Every kernel computes, per step s and sample b with a = a_hat[s, b] mod 2N:
//
//   rot[p, i]  = (-1)^floor(((i - a) mod 2N) / N) * acc[p, (i - a) mod N]
//   d[r, m]    = signed gadget digits of rot - acc, row r = p*levels + j
//   acc[c, o] += sum_{r, m} d[r, m] * w(+-bk[s, r, c, (o - m) mod N])   (mod 2^32)
//
// with w the identity (key_limbs = 4) or the truncation below (key_limbs = 3).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace whole_scan {

constexpr int kU = 8;  // consecutive output coefficients per thread

// The current device's opt-in shared memory per block (bytes), or -1.
inline int smem_optin() {
  int dev = 0, bytes = -1;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  return bytes;
}

struct Shape {
  int n_steps, B, C, N, levels, log_base, ignored_bits, balanced;
  uint32_t balanced_offset;  // C of decompose_balanced_planes (host-computed)
  int key_limbs;             // 4: exact; 3: the low byte of each twisted key word dropped
  int spc;                   // samples per CTA
};

// one padding word in nine: consecutive threads read words 8 apart
__host__ __device__ __forceinline__ int pad(int j) { return j + (j >> 3); }

__device__ __forceinline__ int sbyte(uint32_t word, int i) {
  return static_cast<int>(word << (24 - 8 * i)) >> 24;
}

// key_limbs = 3: the TPU kernels split the sign-twisted word w = +-g into
// balanced bytes and drop byte 0, whose value is sext8(w & 0xFF).  The sign
// is applied first: sext8(-g) != -sext8(g) when the low byte of g is 0x80.
__device__ __forceinline__ uint32_t key_word(uint32_t w, int key_limbs) {
  return key_limbs == 4 ? w : w - static_cast<uint32_t>(sbyte(w, 0));
}

// Signed digits of one u32 value, written MSB-first at out[j * stride].
__device__ __forceinline__ void decompose(uint32_t diff, const Shape& s, int8_t* out,
                                          int stride) {
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

// The digits of coefficient i of one poly plane `plane` (N words) rotated by
// a: written MSB-first at out[j * stride].
__device__ __forceinline__ void rotate_decompose(const uint32_t* plane, int i, int a,
                                                 const Shape& s, int8_t* out, int stride) {
  const int src = (i - a) & (2 * s.N - 1);
  uint32_t rot = plane[src & (s.N - 1)];
  if (src >= s.N) rot = 0u - rot;
  decompose(rot - plane[i], s, out, stride);
}

// Stage row `row` (N words of one key column) as w(+-g) over 2N padded words.
__device__ __forceinline__ void stage_row(const uint32_t* __restrict__ row, const Shape& s,
                                          uint32_t* gext, int tid, int nthr) {
  for (int j = tid; j < 2 * s.N; j += nthr) {
    const uint32_t g = row[j & (s.N - 1)];
    gext[pad(j)] = key_word(j < s.N ? g : 0u - g, s.key_limbs);
  }
}

// delta[bb][u] += sum_m d_bb[m] * gx[pad((o0 + u - m) mod 2N)] for the
// thread's SPT samples, whose digit rows start at drow + bb * dstride.
// win[t] holds gx at (o0 - m0 - kU + t); output o0+u at m0+mm reads
// win[u - mm + kU], so each staged word feeds SPT x up to kU multiply-adds.
template <int SPT>
__device__ __forceinline__ void contract_row(uint32_t (&delta)[SPT][kU], const uint32_t* gx,
                                             const int8_t* drow, int dstride, int o0, int N) {
  const int mask2 = 2 * N - 1;
  for (int m0 = 0; m0 < N; m0 += kU) {
    uint32_t win[2 * kU];
#pragma unroll
    for (int t = 1; t < 2 * kU; ++t) win[t] = gx[pad((o0 - m0 - kU + t) & mask2)];
#pragma unroll
    for (int bb = 0; bb < SPT; ++bb) {
      const uint2 dv = *reinterpret_cast<const uint2*>(drow + bb * dstride + m0);
#pragma unroll
      for (int mm = 0; mm < kU; ++mm) {
        const uint32_t d = static_cast<uint32_t>(sbyte(mm < 4 ? dv.x : dv.y, mm & 3));
#pragma unroll
        for (int u = 0; u < kU; ++u) delta[bb][u] += d * win[u - mm + kU];
      }
    }
  }
}

}  // namespace whole_scan
