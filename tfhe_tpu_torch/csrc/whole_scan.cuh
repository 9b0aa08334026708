// Device helpers shared by the whole-scan blind-rotation kernels (Kernels B,
// E, F and G): the gadget decompositions of one rotated-minus-accumulator
// value, or of four (Kernel E).  The contraction itself is the int8 tensor-core one of
// limb_planes.cuh and mma_row.cuh, which drops limb 0 of each sign-twisted
// key word at key_limbs = 3.
//
// Every kernel computes, per step s and sample b with a = a_hat[s, b] mod 2N:
//
//   rot[p, i]  = (-1)^floor(((i - a) mod 2N) / N) * acc[p, (i - a) mod N]
//   d[r, m]    = signed gadget digits of rot - acc, row r = p*levels + j
//   acc[c, o] += sum_{r, m} d[r, m] * w(+-bk[s, r, c, (o - m) mod N])   (mod 2^32)
//
// with w the identity (key_limbs = 4) or, at key_limbs = 3, the word less
// its low balanced byte sext8(w & 0xFF), the sign applied first (sext8(-g)
// != -sext8(g) when the low byte of g is 0x80).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace whole_scan {

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

// rotate_decompose of coefficients i .. i+3 with carry-chain digits (Kernel
// E's producers; i a multiple of 4, plane 16-byte and out 4-byte aligned),
// each digit row's 4 bytes written as one word at out[j * stride]: the
// rotated window is two aligned 16-byte groups of the plane, shifted by
// (i - a) mod 4.
__device__ __forceinline__ void rotate_decompose4(const uint32_t* plane, int i, int a,
                                                  const Shape& s, int8_t* out, int stride) {
  const int mask2 = 2 * s.N - 1, s0 = (i - a) & mask2, sh = s0 & 3;
  const int g0 = s0 - sh, g1 = (g0 + 4) & mask2;
  uint4 u0 = *reinterpret_cast<const uint4*>(plane + (g0 & (s.N - 1)));
  uint4 u1 = *reinterpret_cast<const uint4*>(plane + (g1 & (s.N - 1)));
  if (g0 >= s.N) u0 = make_uint4(0u - u0.x, 0u - u0.y, 0u - u0.z, 0u - u0.w);
  if (g1 >= s.N) u1 = make_uint4(0u - u1.x, 0u - u1.y, 0u - u1.z, 0u - u1.w);
  const uint32_t w[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
  const uint4 cur = *reinterpret_cast<const uint4*>(plane + i);
  const uint32_t c[4] = {cur.x, cur.y, cur.z, cur.w};
  const uint32_t mask = (1u << s.log_base) - 1u;
  const int half = 1 << (s.log_base - 1), ig = s.ignored_bits;
  uint32_t v[4];
  int carry[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    uint32_t rot = w[u];
    rot = sh == 1 ? w[u + 1] : rot;
    rot = sh == 2 ? w[u + 2] : rot;
    rot = sh == 3 ? w[u + 3] : rot;
    const uint32_t diff = rot - c[u];  // then decompose's rounding and carry chain
    v[u] = ig ? (diff >> ig) + ((diff >> (ig - 1)) & 1u) : diff;
    carry[u] = 0;
  }
  for (int l = 0; l < s.levels; ++l) {
    uint32_t word = 0u;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int res = static_cast<int>((v[u] >> (s.log_base * l)) & mask) + carry[u];
      const int cm = res & half;
      res -= cm << 1;
      carry[u] = cm >> (s.log_base - 1);
      word |= (static_cast<uint32_t>(res) & 0xFFu) << (8 * u);
    }
    *reinterpret_cast<uint32_t*>(out + (s.levels - 1 - l) * stride) = word;
  }
}

}  // namespace whole_scan
