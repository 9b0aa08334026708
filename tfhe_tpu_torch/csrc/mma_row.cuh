// The int8 tensor-core contraction of one staged key row, shared by the
// whole-scan kernels B (blind_rotate_kernel.cu), E (pipe_kernel.cu), F
// (wide_pipe_kernel.cu) and G (cols_kernel.cu): each keeps its own schedule
// around it.
//
// The product is taken as int8 limb planes: with limb_l the balanced bytes
// of the sign-twisted key word w = +-g,
//
//   sum_l[c, o] = sum_{r, m} d[r, m] * limb_l(w[r, c, (o - m) mod 2N])   (exact in s32:
//                 |sum| <= R*N*16*128 < 2^31)
//   acc[c, o]  += sum_l 2^(8l) * sum_l                                     (mod 2^32)
//
// which is the u32 product exactly, because the limbs recombine to w mod
// 2^32 (key_limbs = 3 leaves limb 0 out, the truncation whole_scan.cuh
// states).  The sums run on mma.sync m16n8k32 s8 x s8 -> s32 with the
// circulant as A (M = 16 outputs o), the digits as B (N = 8 samples; with
// fewer samples per CTA the spare columns repeat a sample and are dropped)
// and the input coefficients m as K.  An A register holds the four bytes
// P_l[x .. x+3] of row o, x = (m0 + 4t - o) mod 2N, one aligned load from
// the byte-shifted limb planes of limb_planes.cuh; a B register holds 4
// consecutive digits of one sample.
//
// A warp owns T = 4 M tiles (2 at N=64) 32 outputs apart, of one column,
// and all L kept limbs: L*T*4 s32 accumulators per thread.  With the two
// halves of each tile's M rows swapped (row g is output o + 8 + g, row g+8
// output o + g), a lane's four A registers are the words P_l[x + 8i], i =
// 0..3, and tile a's quad at K step j is the quad of x + 32(j - a), which
// the warp's first tile loaded at step j - a.  So each K step loads one
// quad per limb (4 words) for T mmas, the quads rotate through T register
// slots that the compiler fixes (the K steps run in groups of T), and 2
// digit words per K step serve all L*T mmas.  Warp pairs share 32T
// outputs, interleaved by 16.
//
// Up to N = kBlock (512), N/(16T) warps cover the N outputs of one column
// and a row's sums run over all N inputs from the whole planes.  Above it
// the circulant runs in kBlock x kBlock blocks, with 8 warps (T = 4) per
// CTA: a pass (column c, output block ob) holds the sums of outputs
// [512 ob, +512) in registers over every row r and input chunk kc, m in
// [512 kc, +512), and one unit (r, kc) is mma_row over the 512 inputs of
// the chunk.  Its A entries P_l[(m - o) mod 2N] lie in a window of 1023
// consecutive entries, from base = 512 (kc - ob - 1) mod 2N: with m', o'
// the offsets in the chunk and block, y = m' - o' + 512 in [1, 1023] is
// the offset in the window.  So a unit's planes are build_window of 2*512
// entries (limb_planes.cuh), a 512-wide row's worth, the lane's x0 gains
// 512, no read leaves the window's 256 words, and each window build serves
// 512 x 512 multiply-adds per sample, as one row does at N = 512.  The
// digits of chunk kc are bytes [512 kc, +512) of the row's digits, and the
// pass adds its outputs at offset 512 ob of the column.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "limb_planes.cuh"

namespace limb_planes {

// M tiles per warp: 4, or 2 at N=64 (a warp's tiles lie 32 outputs apart,
// and the K steps, N/32, run in groups of T).
__host__ __device__ inline int tiles_per_warp(int N) { return N >= 128 ? 4 : 2; }

// Words of one set of 16 plane copies.
__host__ __device__ inline int plane_set_words(int N) { return kLimbs * 4 * copy_words(N); }

// The block width of the blocked tiling, and the width of the circulant's
// blocks at degree N: N itself up to kBlock.  The whole-scan kernels take N
// up to kMaxDegree.
constexpr int kBlock = 512;
constexpr int kMaxDegree = 4096;
__host__ __device__ inline int block_width(int N) { return N > kBlock ? kBlock : N; }

// The window base of unit (ob, kc) at degree N (see the header): 0, the
// whole planes, unless kBlocked.
template <bool kBlocked>
__device__ __forceinline__ int window_base(int ob, int kc, int N) {
  return kBlocked ? (kBlock * (kc - ob - 1)) & (2 * N - 1) : 0;
}

// Nothing to do after the first group of K steps.
struct NoHook {
  __device__ __forceinline__ void operator()() const {}
};

// The planes mma_row builds while its first mmas run: the window of nb (its
// block width) from `base` of the raw row graw (N coefficients) into
// planes, or nothing when graw is null.
struct NextPlanes {
  const uint32_t* graw;
  uint32_t* planes;
  int N, base;
};

// What mma_row builds under unit (row q, chunk kc) of pass ob, the ru-th of
// the pass's R*blocks units: the next unit's planes (chunk kc+1 of row q,
// or chunk 0 of row q+1, of the next pass after the pass's last unit) from
// the raw rows graw [2][N] (row q in graw[q & 1]) into planes_next, or
// nothing after the last unit.
template <bool kBlocked>
__device__ __forceinline__ NextPlanes next_unit(const uint32_t* graw, uint32_t* planes_next,
                                                int N, int q, int kc, int ob, int ru, int R,
                                                int blocks, bool last) {
  const bool next_row = kc + 1 == blocks;
  const int ob_next = !next_row || ru + 1 < R * blocks ? ob : (ob + 1 < blocks ? ob + 1 : 0);
  return NextPlanes{last ? nullptr : graw + ((next_row ? q + 1 : q) & 1) * N, planes_next, N,
                    window_base<kBlocked>(ob_next, next_row ? 0 : kc + 1, N)};
}

// One unit's mmas for this warp: all nb/32 K steps of a block nb wide (the
// row, up to N = kBlock), the L kept limbs (4 - L .. 3), the warp's T tiles.
// pl points at the lane's copy (x0 & 3) of the first kept limb, x0 = (4t -
// o_t - 8 - g) mod 2nb for the warp's first tile o_t (+ kBlock when
// blocked); tile a is o_t + 32a.  With the two halves of the M rows swapped
// (row g is output o_t + 8 + g, row g + 8 output o_t + g), the four A
// registers of a lane are P_l[x + 8i .. +3], i = 0..3: words w, w+2, w+4,
// w+6 of its copy, w = x >> 2.  Tile a at K step j reads the quad of x0 +
// 32(j - a), which tile 0 loaded at step j - a: each K step loads one quad
// per limb (4 words) for T mmas, and the quads rotate through T register
// slots, fixed at compile time because the K steps run in groups of T.
// drow points at word t of the lane's digit row (sample g mod S) in the
// block's inputs.  The warp builds its share of `next` after its first
// group of K steps, while those mmas are still in the tensor pipe; then it
// runs hook() there too.
template <int L, int T, class Hook = NoHook>
__device__ __forceinline__ void mma_row(int (&sums)[L][T][4], const uint32_t* pl,
                                        const uint32_t* drow, int nb, int w0,
                                        const NextPlanes& next, Hook hook = Hook()) {
  const int cw = copy_words(nb), wmask = nb / 2 - 1;
  uint32_t quad[L][T][4];  // quad[l][(j - a) mod T] = tile a's registers at step j
  // the quads of steps -1 .. -(T-1); the copies repeat their first 8 words
  // after the last, so the words w+2i of a masked w need no second mask
#pragma unroll
  for (int jj = 1; jj < T; ++jj) {
    const uint32_t* p = pl + ((w0 - 8 * jj) & wmask);
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int i = 0; i < 4; ++i) quad[l][T - jj][i] = p[l * 4 * cw + 2 * i];
  }
  for (int j0 = 0; j0 < nb / 32; j0 += T) {
#pragma unroll
    for (int jj = 0; jj < T; ++jj) {
      const int j = j0 + jj;
      const uint32_t b0 = drow[8 * j], b1 = drow[8 * j + 4];
      const uint32_t* p = pl + ((w0 + 8 * j) & wmask);
#pragma unroll
      for (int l = 0; l < L; ++l)
#pragma unroll
        for (int i = 0; i < 4; ++i) quad[l][jj][i] = p[l * 4 * cw + 2 * i];
#pragma unroll
      for (int l = 0; l < L; ++l)
#pragma unroll
        for (int a = 0; a < T; ++a) mma_s8(sums[l][a], quad[l][(jj - a + T) % T], b0, b1);
    }
    if (j0 == 0 && next.graw != nullptr)
      build_window<true>(next.graw, next.planes, next.N, nb, next.base);
    if (j0 == 0) hook();
  }
}

// This lane's place in the warp tiling of one column (of one output block
// when kBlocked): its group g and thread t in the mma fragments, the warp's
// first tile's output o_t, x0 (mma_row's w0 is x0 >> 2), the lane's plane
// copy offset (words, from the planes of limb 0; limb 4 - L is the first
// kept) and its digit word offset within a row of S samples.  (Kernel B
// spells out lane_of and add_column inline, as it did before they were
// shared: so its machine code stays.)
struct Lane {
  int g, t, o_t, x0, copy, dig;
};

template <int L, int T, bool kBlocked = false>
__device__ __forceinline__ Lane lane_of(int N, int S) {
  const int nb = kBlocked ? kBlock : N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // the warp's first tile: warp pairs share 32T outputs, interleaved by 16
  const int o_t = 32 * T * (warp >> 1) + 16 * (warp & 1);
  const int x0 = (4 * t - o_t - 8 - g + (kBlocked ? kBlock : 0)) & (2 * nb - 1);
  const int copy = (kLimbs - L) * 4 * copy_words(nb) + (x0 & 3) * copy_words(nb);
  const int dig = (g & (S - 1)) * (digit_row_bytes(N) / 4) + t;  // words
  return Lane{g, t, o_t, x0, copy, dig};
}

// Recombine a column's (or a pass's) limb sums mod 2^32 and add this warp's
// outputs to acc[bb * stride + off + o] for sample bb and output o of the
// column (of the output block).
template <int L, int T>
__device__ __forceinline__ void add_column(const int (&sums)[L][T][4], uint32_t* acc,
                                           int stride, int off, const Lane& ln, int S) {
#pragma unroll
  for (int a = 0; a < T; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // c0, c1: row g (output o_t + 32a + 8 + g); c2, c3: row g + 8 (output
      // o_t + 32a + g); samples 2t, 2t + 1
      const int bb = 2 * ln.t + (i & 1), o = ln.o_t + 32 * a + ln.g + (i < 2 ? 8 : 0);
      uint32_t delta = 0u;
#pragma unroll
      for (int l = 0; l < L; ++l)
        delta += static_cast<uint32_t>(sums[l][a][i]) << (8 * (kLimbs - L + l));
      if (bb < S) acc[bb * stride + off + o] += delta;
    }
}

}  // namespace limb_planes
