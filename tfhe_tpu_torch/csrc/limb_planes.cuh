// The int8 tensor-core pieces shared by the contraction kernels A and H
// (ep_contract.cuh) and the whole-scan blind rotations, Kernels B, E, F and
// G (through mma_row.cuh): the mma.sync m16n8k32 s8 x s8 -> s32 wrapper,
// cp.async, and the byte-shifted limb planes of one key row (Kernel E builds
// its own, pipe_kernel.cu:build_kept_planes).
//
// The negacyclic circulant of a key row g (u32 [N]) is never built.  With
// ext = [g, -g] (u32 [2N]; the sign goes on BEFORE the balanced 8-bit limb
// split, (w + 0x80808080) ^ 0x80808080, since the limb -128 cannot be negated
// in int8) and P_l[x] = limb_l(ext[(-x) mod 2N]), the circulant's entry
// (m, o) is P_l[(m - o) mod 2N].  An mma operand register holds 4
// consecutive K bytes, i.e. the four bytes P_l[x .. x+3]; x mod 4 varies
// with the output o, so per key row the CTA keeps four byte-shifted copies
// of each limb plane as 32-bit words (copy s, word w holds P_l[4w + s + j],
// j = 0..3, circularly), and every such register is one aligned 32-bit
// shared load: copy x & 3, word x >> 2.  The copies lie 8 banks apart, so
// the ~20 distinct words a warp's load touches fall in distinct banks.
//
// A window of the planes (build_window) holds P_l[base + y] for y = 0 ..
// 2nb - 1 only, nb <= N: the whole-scan kernels stage one such window of
// 2*512 entries per 512 x 512 block of the circulant at N > 512
// (mma_row.cuh), where the whole planes would pass the shared memory.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace limb_planes {

constexpr int kLimbs = 4;

// Words of one byte-shifted copy of a limb plane: N/2 words and 8 more (room
// for a wrap copy of the first 8), so that the four copies lie 8 banks apart.
__host__ __device__ inline int copy_words(int N) { return N / 2 + 8; }
// Bytes of one staged int8 digit row of N coefficients, padded by 16 so
// that the 8 rows of an mma fragment's 8 groups of lanes (row stride
// N/4 + 4 words) fall in distinct banks.
__host__ __device__ inline int digit_row_bytes(int N) { return N + 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Commit the copies this thread issued and wait for all of them.  Other
// threads see them after a barrier.
__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16 plane copies of the window [base, base + 2nb) of P (mod 2N) from the
// raw key row graw (u32 [N] in shared memory): copy (l, s) starts at planes
// + (l*4 + s) * copy_words(nb), and its word w holds P_l[base + 4w + s + j],
// j = 0..3.  With kWrap its words 0..7 are repeated after its last (words
// nb/2 .. nb/2+7), so that a read a few words past a word index taken mod
// nb/2 needs no second mask.  A thread of the CTA builds word w of all 16
// copies from the 7 limb words ext[-(base + 4w + k)], k = 0..6.
template <bool kWrap = false>
__device__ __forceinline__ void build_window(const uint32_t* graw, uint32_t* planes, int N,
                                             int nb, int base) {
  const int cw = copy_words(nb), mask2 = 2 * N - 1;
  for (int w = threadIdx.x; w < nb / 2; w += blockDim.x) {
    uint32_t e[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const int i = (-(base + 4 * w + k)) & mask2;
      const uint32_t v = i < N ? graw[i] : 0u - graw[i - N];
      // balanced limbs: byte l of (v + 0x80808080) minus 128 == that byte ^ 0x80
      e[k] = (v + 0x80808080u) ^ 0x80808080u;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // transpose bytes: limb l of e[s + j] -> byte j of limb word l
      const uint32_t lo01 = __byte_perm(e[s], e[s + 1], 0x5140);
      const uint32_t lo23 = __byte_perm(e[s + 2], e[s + 3], 0x5140);
      const uint32_t hi01 = __byte_perm(e[s], e[s + 1], 0x7362);
      const uint32_t hi23 = __byte_perm(e[s + 2], e[s + 3], 0x7362);
      uint32_t* dst = planes + s * cw + w;
      dst[0 * 4 * cw] = __byte_perm(lo01, lo23, 0x5410);
      dst[1 * 4 * cw] = __byte_perm(lo01, lo23, 0x7632);
      dst[2 * 4 * cw] = __byte_perm(hi01, hi23, 0x5410);
      dst[3 * 4 * cw] = __byte_perm(hi01, hi23, 0x7632);
      if (kWrap && w < 8) {
#pragma unroll
        for (int l = 0; l < kLimbs; ++l) dst[l * 4 * cw + nb / 2] = dst[l * 4 * cw];
      }
    }
  }
}

// The whole planes of graw: the window of all 2N entries.
template <bool kWrap = false>
__device__ __forceinline__ void build_planes(const uint32_t* graw, uint32_t* planes, int N) {
  build_window<kWrap>(graw, planes, N, N, 0);
}

}  // namespace limb_planes
