// Kernel D: the whole block-NTT blind rotation (all n CMUX steps) in one
// launch, its three products on int8 tensor cores (mma.sync), the key shared
// across a thread-block cluster.
//
// Replaces: tfhe_tpu/ops/pallas/ntt_kernel.py, blind_rotate_nttf (body
// _kernel_nttf).  Per step s and sample b, with a = a_hat[s, b] mod 2N:
//
//   rot[p, m]  = (-1)^floor(((m - a) mod 2N) / N) * acc[p, (m - a) mod N]
//   d[r, m]    = reference carry-chain digits of rot - acc, r = p*levels + j
//   per CRT prime p in {12289, 40961}, with m = i*N2 + j1:
//     Dh[bin, (r,j1)]     = sum_i w_fwd[i, bin] * d[r, i*N2 + j1]            (mod p)
//     Ch[bin, q]          = sum_(r,j1) Dh[bin, (r,j1)] * K[s, p, bin, q, (r,j1)] (mod p)
//     res_p[q, i]         = sum_bin w_inv[bin, i] * Ch[bin, q]                (mod p)
//   with q = (c*L + lam)*N2 + j_out, then the centered CRT lift
//     S = r1 + p1 * center((r2 - r1) * p1^-1 mod p2)   (|S| < p1*p2/2: exact)
//   and acc[c, i*N2 + j_out] += sum_lam S << (key_bits*lam)   (mod 2^32).
//
// K is the key as the JAX package lays it out (ops/ntt.py:ntt_key_lhs_form):
// bk_lhs int8[n, P, N1, 2*CLN2, RN2], rows (key byte hi/lo, q), columns
// (r, j1) with r in canonical order, the twisted-circulant Z-twist folded in.
// Every residue is exact, so the result equals impl='fused' bit for bit.
//
// What bounds it on the H100: per sample and step the forward transforms
// take 2*RN2*N1*N1 int8 products, the per-bin contraction 4*N1*CLN2*RN2 and
// the inverse transforms 4*CLN2*N1*N1, per prime (residues ride in two
// balanced bytes, digits in one): 1.0e7 at default_128 (N1=64, N2=8,
// RN2=144, CLN2=72), 7.4e12 for B=1024 over 722 steps, 7.5 ms at the int8
// tensor-core peak.  Once the products run on the tensor cores the key can
// be the wall: a step's key block is 2.65 MB, and a CTA that contracts
// every bin must take all of it into its shared memory each step.
// Splitting the bins over a cluster cuts each SM's intake to 1/split of
// the block (PERF.md section 5 times a cluster of 1 against 4 and 8).
//
// Design.  All three products are int8 mma.sync (m16n8k32, m16n8k16 for a
// K tail of 16) on tiles whose rows 0-7 are the hi byte plane and rows 8-15
// the lo byte plane of the same 8 rows, so that each thread's four
// accumulators are the byte-plane products hh, hl, lh, ll (or the hi and lo
// sums of the forward) of one output, combined, reduced and split again in
// registers.  Each phase of a pass runs every CRT prime of the pass, whose
// work is independent up to the lift and of the same shapes, so every warp
// keeps those primes' accumulator chains in flight.  A step is one pass of
// both primes where their exchange blocks fit the shared memory, else two
// passes of one prime each (the plan's `np`, primes a pass):
//  - forward, per group of 8 bins: A = w_fwd^T's two planes of each prime
//    (16 rows, K = i, fragments from `frags`, built by the wrapper), B = the
//    digit rows (sample, r, j1) of 64 bytes (one per i) by ldmatrix, loaded
//    once for the pass's primes;
//  - contraction, per bin: A = 16 key rows (8 q's, hi and lo) of each
//    prime's slice of the bin as stored, B = the bin's Dh rows of that prime
//    (sample, plane), 8 columns (4 samples) per n-tile, K = (r, j1);
//  - inverse: A = w_inv^T's two planes of each prime (K = bin), B = the Ch
//    rows (prime, sample, q, plane) of 64 bytes (one per bin), grouped so
//    that one thread holds every key limb lam of one (sample, c, j_out, i):
//    with both primes in the pass it lifts their residues by CRT in
//    registers and adds the sum to the accumulator itself; with one, the
//    first pass keeps its residues in shared memory (`r1`) for the second.
// Each sum stays inside int32 with one reduction of hi*256 + lo (forward)
// or two of (hh*256 + hl + lh)*256 + ll (contraction, inverse), by exact
// integer % by compile-time primes.
//
// A thread-block cluster is `split` CTAs, each owning S samples; they
// split the 64 bins.  A pass is: the forward of the CTA's own samples for
// every bin and the pass's primes; one Dh exchange, which sends each CTA of
// the cluster the Dh of that CTA's bins; the contraction of the CTA's own
// bins for all the cluster's S*split samples (so each key fragment serves
// split/2 n-tiles), bin by bin with the pass's slices of a bin in hand; one
// Ch exchange, which sends each CTA the Ch of that CTA's samples; the
// inverse (and the lift); one wait for the outgoing blocks to be read and
// one barrier.  A step is the digits and its passes, so it makes 2 or 4
// exchanges.  A transfer is one block per pair of CTAs, staged in the
// sender's shared memory and moved by a bulk copy into the receiver's
// (distributed shared memory), counted on the receiver's mbarrier (Dh and
// Ch complete), which expects every sender's bytes once per pass.  The
// sender reuses a block once its bulk copies have read it; a receiver's
// buffers are refilled only after it has sent its own next blocks, which it
// does after reading them.  A producer warp streams the CTA's own bins' key
// slices (each bin's slice of every prime of the pass in turn) through a
// ring of key stages by cp.async.bulk completing on mbarriers; the
// consumers take `np` stages at a time, one per prime, and release a stage
// once they have used it.  Nine consumer warps own one of the nine
// contraction m-tiles each at default_128 and split the forward and inverse
// tiles.  Shared memory: accumulators, the first prime's residues (one
// prime a pass), the digit rows, the received and outgoing Dh and Ch blocks
// of the pass's primes, the key stages, the barriers.  The wrapper can
// force the plan (samples per CTA, split); otherwise the C entry point
// picks it per batch from the card's cluster occupancy.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kP1 = 12289, kP2 = 40961;
constexpr int kN1 = 64;        // the NTT size of every parameter set
constexpr int kRow = 64;       // bytes of one digit or Ch row (N1 int8)
constexpr int kWarps = 9;      // consumer warps: the contraction's m-tiles at default_128
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kGroup = 8;      // bins per forward tile
constexpr int kMaxOwned = 4;   // contraction m-tiles per warp: CLN2 <= 8 * 9 * 4
constexpr int kMaxNt = 4;      // contraction n-tiles: S * split <= 16 samples
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxStages = 6;  // key stages
constexpr int kBarConsumers = 1;  // named barrier (0 is __syncthreads)
// uint4s of one m-tile's mma fragments (32 lanes, 2 k-steps) and of one
// table (8 m-tiles); `frags` holds [prime][fwd, inv] tables
constexpr int kFragTile = 64, kFragTable = 8 * kFragTile;

// contraction n-tiles at S samples per CTA: 2 * S * split / 8 <= 2 * S
template <int S>
constexpr int kNt = 2 * S < kMaxNt ? 2 * S : kMaxNt;

struct Shape {
  int n_steps, B, C, N, levels, log_base, ignored_bits;
  int N2, RN2, RN2p, CLN2, L, key_bits, inv_p1;
  // the plan: samples per CTA, CTAs of a cluster (splitting the bins),
  // primes a pass (2, or 1 where both primes' blocks do not fit), key
  // stages, contraction m-tiles per stage, whether the outgoing Dh and Ch
  // blocks share their room, and what follows from it
  int S, split, np, stages, mcs, share, MT, nchunks, T, ngroups, bins, nt, stage_bytes;
  // one prime's part of the exchange blocks (Dh and Ch one CTA sends
  // another; a block holds the pass's primes), and the blocks' strides in
  // the receiver (padded against bank conflicts)
  int blk_dh, blk_ch, dhs, chs;
  // for the divisions in the device loops: log2 of N2 and of bins, and
  // fdiv multipliers for C, the forward's unit pairs per group and n-tiles
  // per sample, and the inverse's triple groups
  int lg_N2, lg_bins;
  uint32_t m_C, m_pairs, m_nps, m_groups;
  // byte offsets of the shared-memory sections, and the total
  int off_r1, off_dig, off_dh, off_ch, off_out, off_out2, off_key, off_bar, off_a, smem;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x / d for 0 <= x < 2^16 and 1 <= d <= 2^16, m = magic(d): a multiply
// where the divisor is known only at run time
__host__ __device__ inline uint32_t magic(int d) {
  return d == 1 ? 0u : static_cast<uint32_t>((0x100000000ull + d - 1) / d);
}
__device__ __forceinline__ int fdiv(int x, uint32_t m) {
  return m ? static_cast<int>(__umulhi(static_cast<uint32_t>(x), m)) : x;
}

template <int P>
__device__ __forceinline__ int center(int x) {
  int r = x % P;  // in (-P, P), with the sign of x
  if (r > P / 2) r -= P;
  else if (r < -(P / 2)) r += P;
  return r;
}

// (hh*256 + hl + lh)*256 + ll mod P, centered: |hh| <= RN2*128*128 keeps
// hh*256 + hl + lh inside int32 for RN2 <= 384
template <int P>
__device__ __forceinline__ int combine(const int (&c)[4]) {
  return center<P>(center<P>(c[0] * 256 + c[1] + c[2]) * 256 + c[3]);
}

// centered x -> balanced bytes x = hi*256 + lo, lo in [-128, 128); returns
// hi in bits 8..15 and lo in bits 0..7
__device__ __forceinline__ uint32_t split2(int x) {
  const int l = ((x + 128) & 255) - 128;
  return (static_cast<uint32_t>((x - l) >> 8) & 0xFFu) << 8 | (static_cast<uint32_t>(l) & 0xFFu);
}

__device__ __forceinline__ void mma32(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                      uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma16(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// ldmatrix: lanes 8m..8m+7 give the 8 row addresses (16 bytes each) of
// matrix m; each thread receives bytes 4*(lane%4)..+3 of row lane/4 of each
__device__ __forceinline__ void ldm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldm2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ldm1(uint32_t addr) {
  uint32_t r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n" : "=r"(r) : "r"(addr));
  return r;
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// byte offset of 16-byte chunk `chunk` of 64-byte row `row`, the chunks
// swizzled so that 8 consecutive rows read by one ldmatrix phase fall in
// distinct banks
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kRow + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kBarConsumers), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// the shared::cluster address of `p`'s offset in cluster CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the same, ordered after the arrivals of other CTAs of the cluster
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAITC:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAITC;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> this
// CTA's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// `bytes` (a multiple of 16, 16-byte aligned) of this CTA's shared memory
// into another's (a shared::cluster address), counted on its mbarrier
// `bar` (in the same CTA)
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, const void* src, int bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// this thread's bulk copies so far form a group; wait until every group's
// source has been read
__device__ __forceinline__ void bulk_commit_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's generic-proxy shared-memory writes, made visible to the
// async proxy (the bulk copies) after a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The producer (one thread): every key stage of the launch, in order: per
// pass, the slices of this CTA's bins (cluster CTA gb owns bins gb*bins ..),
// bin by bin, each chunk of a bin's rows for every prime of the pass in turn.
__device__ void produce(const Shape& s, const int8_t* __restrict__ bk, int8_t* keys,
                        uint64_t* full, uint64_t* consumed) {
  const int gb = cluster_rank();
  const int RN2 = s.RN2, CLN2 = s.CLN2;
  const size_t slice_bytes = static_cast<size_t>(2) * CLN2 * RN2;
  const int total = 2 * s.bins * s.nchunks * s.n_steps;
  // stage b in its use u; the slice (step, prime = pass*np + p, own bin bl)
  // and its chunk
  int b = 0, u = 0, p = 0, chunk = 0, bl = 0, pass = 0;
  size_t step = 0;
  for (int t = 0; t < total; ++t) {
    if (u > 0) mbar_wait(consumed + b, (u - 1) & 1);  // the consumers left use u-1
    const int prime = pass * s.np + p;
    const int8_t* src = bk + ((step * 2 + prime) * kN1 + gb * s.bins + bl) * slice_bytes;
    int8_t* dst = keys + b * s.stage_bytes;
    const int q0 = chunk * 8 * s.mcs, rows = min(8 * s.mcs, CLN2 - q0);
    mbar_expect(full + b, 2 * rows * RN2);
    if (s.nchunks == 1) {
      bulk_copy(dst, src, 2 * CLN2 * RN2, full + b);
    } else {
      bulk_copy(dst, src + q0 * RN2, rows * RN2, full + b);
      bulk_copy(dst + rows * RN2, src + (CLN2 + q0) * RN2, rows * RN2, full + b);
    }
    if (++b == s.stages) b = 0, ++u;
    if (++p == s.np && (p = 0, ++chunk == s.nchunks) && (chunk = 0, ++bl == s.bins) &&
        (bl = 0, ++pass == 2 / s.np))
      pass = 0, ++step;
  }
}

// Dh of this CTA's S samples for all 64 bins and the pass's NP primes (P0
// and on) into the outgoing blocks `out`: [owner][own bin of the owner]
// [prime][sample, plane][RN2p], one block of NP*blk_dh bytes per CTA of the
// cluster (the owner of the bins).  A unit is one group of 8 bins (one
// m-tile: the bins' hi and lo table rows, K = i) and two n-tiles of 8 digit
// rows of one sample; its digit fragments serve every prime's table, so a
// warp keeps 2*NP accumulators in flight.
template <int S, int NP, int P0>
__device__ void forward(const Shape& s, const uint4* __restrict__ frags, const int8_t* dig,
                        int8_t* out, int warp, int lane) {
  const int gid = lane >> 2, tig = lane & 3, RN2p = s.RN2p, ntl = S * RN2p / 8;
  const int pairs = (ntl + 1) / 2, units = (kN1 / kGroup) * pairs;  // unit pairs
  // the fragments come from L2 (shared memory leaves L1 little room), so
  // the next pair's are loaded while this one computes: [prime][k-step]
  auto load = [&](uint4 (&f)[NP][2], int g) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        f[p][k] = frags[2 * (P0 + p) * kFragTable + (g * 32 + lane) * 2 + k];
  };
  int ng = fdiv(warp, s.m_pairs);
  uint4 nf[NP][2];
  load(nf, ng);
  for (int up = warp; up < units; up += kWarps) {
    const int g = ng, nt0 = 2 * (up - g * pairs);
    uint4 f[NP][2];
#pragma unroll
    for (int p = 0; p < NP; ++p) f[p][0] = nf[p][0], f[p][1] = nf[p][1];
    ng = fdiv(min(up + kWarps, units - 1), s.m_pairs);
    load(nf, ng);
    uint32_t b[2][4];
    int c[NP][2][4] = {};  // [prime][n-tile]
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ldm4(b[h], smem_addr(dig + swz(min(nt0 + h, ntl - 1) * 8 + (lane & 7), lane >> 3)));
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mma32(c[p][h], f[p][k].x, f[p][k].y, f[p][k].z, f[p][k].w, b[h][2 * k],
                b[h][2 * k + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (nt0 + h >= ntl) break;
      const int sb = fdiv(nt0 + h, s.m_nps), col = (nt0 + h) * 8 - sb * RN2p + 4 * (tig >> 1);
      const int bin = g * kGroup + gid;  // the owners' blocks follow one another
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        // rows gid: hi plane of bin 8g+gid, gid+8: its lo plane; |hi| <= 64*80*64
        const int y0 = c[p][h][0] * 256 + c[p][h][2], y1 = c[p][h][1] * 256 + c[p][h][3];
        const uint32_t x0 = split2(P0 + p ? center<kP2>(y0) : center<kP1>(y0));
        const uint32_t x1 = split2(P0 + p ? center<kP2>(y1) : center<kP1>(y1));
        // lanes tig, tig^1 trade halves: the even one stores the hi bytes of
        // their 4 columns, the odd one the lo bytes
        const uint32_t hi = x0 >> 8 | (x1 & 0xFF00u), lo = (x0 & 0xFFu) | (x1 & 0xFFu) << 8;
        const uint32_t got = __shfl_xor_sync(0xFFFFFFFFu, tig & 1 ? hi : lo, 1);
        const uint32_t word = tig & 1 ? got | lo << 16 : hi | got << 16;
        const int row = ((bin * NP + p) * S + sb) * 2 + (tig & 1);
        *reinterpret_cast<uint32_t*>(out + row * RN2p + col) = word;
      }
    }
  }
}

// Ch of one own bin (bl of this CTA's bins) for the cluster's S*split
// samples and the pass's NP primes (P0 and on), those of this warp's
// m-tiles (warp + kWarps*j) in the chunk, 4 bins packed per 32-bit store
// into the outgoing blocks `out`: [owner][prime][sample, q, plane][own
// bin], one block of NP*blk_ch bytes per cluster CTA.  `key[p]` is the
// stage holding the chunk of the bin's slice of prime P0+p; `dh` holds the
// received Dh: [sender][own bin][prime][sample, plane][RN2p] at stride dhs
// per sender.
template <int S, int NP, int P0>
__device__ __forceinline__ void contract(const Shape& s, const int8_t* const (&key)[NP],
                                         int chunk, const int8_t* dh, int8_t* out, int bl,
                                         int warp, int lane,
                                         uint32_t (&ph)[NP][kMaxOwned][kNt<S>],
                                         uint32_t (&pl)[NP][kMaxOwned][kNt<S>]) {
  constexpr int NT = kNt<S>;
  const int gid = lane >> 2, tig = lane & 3, RN2 = s.RN2, RN2p = s.RN2p, CLN2 = s.CLN2;
  const int q0 = chunk * 8 * s.mcs, rows = min(8 * s.mcs, CLN2 - q0);
  const bool ldm = (RN2 & 15) == 0;
  const int nk32 = RN2p / 32, tail = RN2p & 16, slots = S * s.split;
  const int dhp = 2 * S * RN2p;  // a prime's Dh rows follow the one's before
  // this lane's B row (ldmatrix) of the first prime in each n-tile: column
  // n = slot*2 + plane, slot = sender*S + sample
  uint32_t brow[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = 8 * nt + (lane & 7), slot = n < 2 * slots ? n >> 1 : 0;
    brow[nt] = smem_addr(dh + (slot / S) * s.dhs +
                         (bl * 2 * NP * S + 2 * (slot % S) + (n & 1)) * RN2p);
  }
#pragma unroll
  for (int j = 0; j < kMaxOwned; ++j) {
    const int mt = warp + kWarps * j;
    if (mt >= s.MT) break;
    if (mt < chunk * s.mcs || mt >= (chunk + 1) * s.mcs) continue;
    // this lane's A rows in each stage: ldmatrix row (lane & 7) of the hi or
    // lo plane, and for plain loads row gid; rows past the stage repeat its
    // last
    const int base = mt * 8 - q0;
    const int lq = min(base + (lane & 7), rows - 1), gq = min(base + gid, rows - 1);
    const int arow = ((lane >> 3) & 1 ? rows + lq : lq) * RN2 + 16 * (lane >> 4);
    const int ahi = gq * RN2 + 4 * tig, alo = (rows + gq) * RN2 + 4 * tig;
    int c[NP][NT][4] = {};  // [prime][n-tile]
    for (int ks = 0; ks < nk32; ++ks) {
      const int k0 = 32 * ks;
      uint32_t a[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (ldm) {
          ldm4(a[p], smem_addr(key[p] + arow + k0));
        } else {
          a[p][0] = ld32(key[p] + ahi + k0), a[p][1] = ld32(key[p] + alo + k0);
          a[p][2] = ld32(key[p] + ahi + k0 + 16), a[p][3] = ld32(key[p] + alo + k0 + 16);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= s.nt) break;
        uint32_t b[NP][2];
#pragma unroll
        for (int p = 0; p < NP; ++p) ldm2(b[p], brow[nt] + p * dhp + k0 + 16 * ((lane >> 3) & 1));
#pragma unroll
        for (int p = 0; p < NP; ++p)
          mma32(c[p][nt], a[p][0], a[p][1], a[p][2], a[p][3], b[p][0], b[p][1]);
      }
    }
    if (tail) {
      const int k0 = 32 * nk32;
      uint32_t a[NP][2];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (ldm) {
          ldm2(a[p], smem_addr(key[p] + arow + k0));
        } else {
          a[p][0] = ld32(key[p] + ahi + k0), a[p][1] = ld32(key[p] + alo + k0);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= s.nt) break;
#pragma unroll
        for (int p = 0; p < NP; ++p)
          mma16(c[p][nt], a[p][0], a[p][1], ldm1(brow[nt] + p * dhp + k0));
      }
    }
    const int sh = 8 * (bl & 3), q = mt * 8 + gid;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= s.nt) break;
      const int slot = 4 * nt + tig, owner = slot / S;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint32_t x = split2(P0 + p ? combine<kP2>(c[p][nt]) : combine<kP1>(c[p][nt]));
        ph[p][j][nt] = (bl & 3 ? ph[p][j][nt] : 0u) | (x >> 8) << sh;
        pl[p][j][nt] = (bl & 3 ? pl[p][j][nt] : 0u) | (x & 0xFFu) << sh;
        if ((bl & 3) == 3 && slot < slots && q < CLN2) {
          int8_t* at = out + (NP * owner + p) * s.blk_ch +
                       ((slot - owner * S) * CLN2 + q) * 2 * s.bins + (bl & ~3);
          *reinterpret_cast<uint32_t*>(at) = ph[p][j][nt];
          *reinterpret_cast<uint32_t*>(at + s.bins) = pl[p][j][nt];
        }
      }
    }
  }
}

// acc += sum_lam lift(res_p1, res_p2)[q][i] << (key_bits*lam), with res_p =
// w_inv . Ch_p[q] over bins.  A unit is one m-tile of 8 i's and one group
// of 4 (sample, c, j_out) triples, whose L n-tiles (one per key limb lam)
// give each thread the pass's residues of every lam of its (triple, i).
// With both primes in the pass it lifts them by CRT in registers; with one,
// the first pass stores its residues in r1 and the second lifts them with
// its own.  `ch` holds the received Ch: [sender][prime][sample, q, plane]
// [sender's bin] at stride chs per sender.
template <int S, int L, int NP, int P0>
__device__ void inverse(const Shape& s, const uint4* __restrict__ frags, const int8_t* ch,
                        int16_t* r1, uint32_t* acc, int warp, int lane) {
  constexpr bool kLift = NP == 2 || P0 == 1;
  const int gid = lane >> 2, tig = lane & 3;
  const int N2 = s.N2, C = s.C, CLN2 = s.CLN2, T = s.T, ngroups = s.ngroups, bins = s.bins;
  // the fragments come from L2 (shared memory leaves L1 little room), so
  // the next unit's are loaded while this one computes: [prime][k-step]
  auto load = [&](uint4 (&f)[NP][2], int mt) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        f[p][k] = frags[(2 * (P0 + p) + 1) * kFragTable + (mt * 32 + lane) * 2 + k];
  };
  int nmt = fdiv(warp, s.m_groups);
  uint4 nf[NP][2];
  load(nf, nmt);
  for (int un = warp; un < 8 * ngroups; un += kWarps) {
    const int mt = nmt, u = un - mt * ngroups;
    uint4 f[NP][2];
#pragma unroll
    for (int p = 0; p < NP; ++p) f[p][0] = nf[p][0], f[p][1] = nf[p][1];
    nmt = fdiv(min(un + kWarps, 8 * ngroups - 1), s.m_groups);
    load(nf, nmt);
    // this lane's B column: triple tl, plane gid & 1; its 4 registers hold
    // bins 4*tig + 16*r, r < 4, each inside one sender's block
    const int tl = min(4 * u + (gid >> 1), T - 1);
    const int sp = tl >> s.lg_N2, sl = fdiv(sp, s.m_C);  // triple = (sl, cl, jl)
    const int jl = tl & (N2 - 1), cl = sp - sl * C;
    const int8_t* col[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 16 * r + 4 * tig;
      col[r] = ch + (k >> s.lg_bins) * s.chs + (k & (bins - 1)) +
               (sl * CLN2 * 2 + (gid & 1)) * bins;
    }
    const int to = 4 * u + tig, i = mt * 8 + gid;
    uint32_t delta = 0u;
#pragma unroll
    for (int lam = 0; lam < L; ++lam) {
      const int off = ((cl * L + lam) * N2 + jl) * 2 * bins;  // row q
      int c[NP][4] = {};
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int p = 0; p < NP; ++p)
          mma32(c[p], f[p][k].x, f[p][k].y, f[p][k].z, f[p][k].w,
                ld32(col[2 * k] + p * s.blk_ch + off), ld32(col[2 * k + 1] + p * s.blk_ch + off));
      int16_t* r1p = r1 + (to * L + lam) * (kN1 + 2) + i;
      int a, b;  // the residues mod kP1 and kP2
      if constexpr (NP == 2) {
        a = combine<kP1>(c[0]), b = combine<kP2>(c[1]);
      } else if constexpr (P0 == 0) {
        if (to < T) *r1p = static_cast<int16_t>(combine<kP1>(c[0]));
        continue;
      } else {
        a = to < T ? *r1p : 0, b = combine<kP2>(c[0]);
      }
      const int sv = a + kP1 * center<kP2>((b - a) * s.inv_p1);  // |.| < 2^31
      delta += static_cast<uint32_t>(sv) << (s.key_bits * lam);
    }
    if (kLift && to < T) {
      const int po = to >> s.lg_N2, so = fdiv(po, s.m_C);
      const int jo = to & (N2 - 1), co = po - so * C;
      acc[(so * C + co) * s.N + i * N2 + jo] += delta;
    }
  }
}

template <int S, int L, int NP>
__global__ void __launch_bounds__(kThreads, 1)
ntt_kernel(const uint32_t* __restrict__ acc0, const int8_t* __restrict__ bk,
           const int32_t* __restrict__ a_hat, const uint4* __restrict__ frags,
           uint32_t* __restrict__ out, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = s.N, CN = s.C * N, N2 = s.N2, RN2p = s.RN2p, mask2 = 2 * N - 1;
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);             // [S][C][N]
  int16_t* r1 = reinterpret_cast<int16_t*>(smem + s.off_r1);     // [T][L][N1+2] if NP == 1
  int8_t* dig = reinterpret_cast<int8_t*>(smem + s.off_dig);     // [S*RN2p][64], swizzled
  int8_t* dh = reinterpret_cast<int8_t*>(smem + s.off_dh);       // [split][dhs]: Dh received
  int8_t* ch = reinterpret_cast<int8_t*>(smem + s.off_ch);       // [split][chs]: Ch received
  int8_t* dh_out = reinterpret_cast<int8_t*>(smem + s.off_out);  // [split][NP*blk_dh]: Dh sent
  int8_t* ch_out = reinterpret_cast<int8_t*>(smem + s.off_out2); // [split][NP*blk_ch]: Ch sent
  int8_t* keys = reinterpret_cast<int8_t*>(smem + s.off_key);    // [stages][stage_bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + s.off_bar);  // [stages] each
  uint64_t* consumed = full + s.stages;
  uint64_t* dh_ready = consumed + s.stages;  // this CTA's Dh is complete
  uint64_t* ch_ready = dh_ready + 1;         // this CTA's Ch is complete
  int* a_s = reinterpret_cast<int*>(smem + s.off_a);             // [S]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gb = cluster_rank();
  const int b0 = blockIdx.x * S;
  const int nb = min(S, s.B - b0);  // <= 0 in the spare CTAs of the last cluster

  if (tid == 0) {
    for (int b = 0; b < s.stages; ++b) {
      mbar_init(full + b, 1);
      mbar_init(consumed + b, kWarps);
    }
    mbar_init(dh_ready, 1);
    mbar_init(ch_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int idx = tid; idx < S * CN; idx += kThreads)
    acc[idx] = idx / CN < nb ? acc0[static_cast<size_t>(b0) * CN + idx] : 0u;
  for (int idx = tid; idx < S * RN2p * kRow / 16; idx += kThreads)
    reinterpret_cast<uint4*>(dig)[idx] = make_uint4(0u, 0u, 0u, 0u);  // rows past RN2 stay 0
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before any copy or remote access

  if (warp == kWarps) {
    if (lane == 0) produce(s, bk, keys, full, consumed);
  } else {
    const int levels = s.levels, lb = s.log_base, ig = s.ignored_bits;
    const uint32_t dmask = (1u << lb) - 1u;
    const int half = 1 << (lb - 1);
    // the cluster's exchange: this CTA's block of `sent` (blk bytes) for
    // each CTA of the cluster into its buffer `in` (at this CTA's place),
    // counted on its `ready`; then this CTA waits until its own `ready` has
    // every sender's block
    auto exchange = [&](int8_t* sent, int blk, int8_t* in, int stride, uint64_t* ready,
                        int phase) {
      fence_proxy_async();  // the consumers' writes of `sent`, for the bulk copies
      bar_consumers();
      if (tid == 0) {
        for (int peer = 0; peer < s.split; ++peer)
          bulk_to_peer(cluster_addr(in + gb * stride, peer), sent + peer * blk, blk,
                       cluster_addr(ready, peer));
        if (s.share) bulk_commit_wait_read();  // `sent` is shared by Dh and Ch
        else bulk_commit();
        mbar_expect(ready, s.split * blk);
      }
      if (s.share) bar_consumers();
      mbar_wait_cluster(ready, phase);
    };
    int kb = 0, kpar = 0;  // the key stage to consume next, and its phase parity
    for (int step = 0; step < s.n_steps; ++step) {
      if (tid < S)
        a_s[tid] = tid < nb ? (a_hat[static_cast<size_t>(step) * s.B + b0 + tid] & mask2) : 0;
      bar_consumers();
      // digits: rows (sample, r*N2 + j1), byte i of m = i*N2 + j1; a thread
      // takes i = 4*i4 .. +3 of one (sample, poly, j1) and stores a word per row
      for (int idx = tid; idx < S * s.C * N2 * (kN1 / 4); idx += kConsumers) {
        const int j1 = idx & (N2 - 1), rest = idx / N2;  // N2 is a power of two
        const int i4 = rest & (kN1 / 4 - 1), sp = rest / (kN1 / 4);  // sp = sample*C + poly
        const int sb = fdiv(sp, s.m_C);
        const uint32_t* a = acc + sp * N;
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int m = (4 * i4 + k) * N2 + j1;
          const int src = (m - a_s[sb]) & mask2;
          uint32_t rot = a[src & (N - 1)];
          if (src >= N) rot = 0u - rot;
          const uint32_t diff = rot - a[m];
          // round_value, then the reference carry chain
          // (src/decomposer.rs:42-80) from the first kept digit
          v[k] = ig ? (diff >> ig) + ((diff >> (ig - 1)) & 1u) : diff;
        }
        int carry[4] = {0, 0, 0, 0};
        for (int l = 0; l < levels; ++l) {
          uint32_t word = 0u;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            int res = static_cast<int>((v[k] >> (lb * l)) & dmask) + carry[k];
            const int cm = res & half;
            res -= cm << 1;  // in [-B/2, B]: the +B anomaly stays
            carry[k] = cm >> (lb - 1);
            word |= (static_cast<uint32_t>(res) & 0xFFu) << (8 * k);
          }
          // MSB-first: level l is row levels-1-l of the poly
          const int row = sb * RN2p + ((sp - sb * s.C) * levels + levels - 1 - l) * N2 + j1;
          *reinterpret_cast<uint32_t*>(dig + swz(row, i4 >> 2) + 4 * (i4 & 3)) = word;
        }
      }
      bar_consumers();
      // one pass of the primes P0 .. P0+NP-1
      auto pass = [&](auto first) {
        constexpr int P0 = decltype(first)::value;
        const int phase = ((2 / NP) * step + P0) & 1;
        forward<S, NP, P0>(s, frags, dig, dh_out, warp, lane);
        exchange(dh_out, NP * s.blk_dh, dh, s.dhs, dh_ready, phase);
        uint32_t ph[NP][kMaxOwned][kNt<S>] = {}, pl[NP][kMaxOwned][kNt<S>] = {};
        for (int bl = 0; bl < s.bins; ++bl) {
          for (int chunk = 0; chunk < s.nchunks; ++chunk) {
            // the stages of the chunk of each prime's slice, in turn
            int kbs[NP];
            const int8_t* key[NP];
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              kbs[p] = kb;
              key[p] = keys + kb * s.stage_bytes;
              mbar_wait(full + kb, kpar);
              if (++kb == s.stages) kb = 0, kpar ^= 1;
            }
            contract<S, NP, P0>(s, key, chunk, dh, ch_out, bl, warp, lane, ph, pl);
            __syncwarp();
            if (lane == 0) {
#pragma unroll
              for (int p = 0; p < NP; ++p) mbar_arrive(consumed + kbs[p]);
            }
          }
        }
        exchange(ch_out, NP * s.blk_ch, ch, s.chs, ch_ready, phase);
        inverse<S, L, NP, P0>(s, frags, ch, r1, acc, warp, lane);
        // every read of Ch (and of acc and r1) is done before the next Dh
        // lets a peer refill it; the bulk copies have read the outgoing blocks
        if (tid == 0) bulk_commit_wait_read();
        bar_consumers();
      };
      pass(std::integral_constant<int, 0>{});
      if constexpr (NP == 1) pass(std::integral_constant<int, 1>{});
    }
    for (int idx = tid; idx < nb * CN; idx += kConsumers)
      out[static_cast<size_t>(b0) * CN + idx] = acc[idx];
  }
  cluster_sync();  // no CTA leaves while a peer may still write to it
}

int align_up(int x, int a) { return (x + a - 1) / a * a; }

// the shared-memory layout of the plan in s; returns its size in bytes
int layout(Shape& s) {
  const int S = s.S;
  s.MT = (s.CLN2 + 7) / 8;
  s.nchunks = (s.MT + s.mcs - 1) / s.mcs;
  s.T = S * s.C * s.N2;
  s.ngroups = (s.T + 3) / 4;
  s.bins = kN1 / s.split;
  s.nt = (2 * S * s.split + 7) / 8;
  s.blk_dh = s.bins * 2 * S * s.RN2p;
  s.blk_ch = S * s.CLN2 * 2 * s.bins;
  // senders' blocks shifted 32*S and 64 bytes apart: the rows of one
  // ldmatrix (Dh) or LDS phase (Ch) from two senders fall in other banks
  s.dhs = s.np * s.blk_dh + 32 * S;
  s.chs = s.np * s.blk_ch + 64;
  s.lg_N2 = __builtin_ctz(s.N2);
  s.lg_bins = __builtin_ctz(s.bins);
  s.m_C = magic(s.C);
  s.m_pairs = magic((S * s.RN2p / 8 + 1) / 2);
  s.m_nps = magic(s.RN2p / 8);
  s.m_groups = magic(s.ngroups);
  s.stage_bytes = align_up(2 * std::min(8 * s.mcs, s.CLN2) * s.RN2 + 16, 128);
  int off = align_up(S * s.C * s.N * 4, 128);
  s.off_r1 = off;  // the first prime's residues, with one prime a pass
  if (s.np == 1) off += align_up(s.T * s.L * (kN1 + 2) * 2, 128);
  s.off_dig = off;
  off += align_up(S * s.RN2p * kRow, 128);
  s.off_dh = off;
  off += align_up(s.split * s.dhs, 128);
  s.off_ch = off;
  off += align_up(s.split * s.chs, 128);
  s.off_out = off;  // the outgoing Dh, and Ch after it or in its place
  s.off_out2 = s.share ? off : off + align_up(s.split * s.np * s.blk_dh, 128);
  off = s.off_out2 +
        align_up(s.split * s.np * (s.share ? std::max(s.blk_dh, s.blk_ch) : s.blk_ch), 128);
  s.off_key = off;
  off += s.stages * s.stage_bytes;
  s.off_bar = off;
  off += align_up((2 * s.stages + 2) * 8, 16);
  s.off_a = off;
  off += align_up(S * 4, 16);
  s.smem = off;
  return off;
}

// the primes a pass, key stages, m-tiles per stage and sharing of the
// outgoing blocks for the plan in s, both primes a pass if any of these
// fits, else one: as many stages (3 to kMaxStages) of whole bin slices as
// fit with separate outgoing blocks, else (2 to kMaxStages) with the Dh and
// Ch blocks sharing their room, else two stages of as many m-tiles as fit;
// false if one m-tile per stage does not fit with one prime a pass
bool fit_stages(Shape& s, int budget) {
  const int MT = (s.CLN2 + 7) / 8;
  for (s.np = 2; s.np >= 1; --s.np) {
    s.mcs = MT;
    for (s.share = 0; s.share <= 1; ++s.share)
      for (s.stages = kMaxStages; s.stages >= 3 - s.share; --s.stages)
        if (layout(s) <= budget) return true;
    s.share = 1;
    s.stages = 2;
    if ((s.RN2 & 15) != 0) continue;  // a chunk's two copies must be 16-byte pieces
    for (s.mcs = MT - 1; s.mcs >= 1; --s.mcs)
      if (layout(s) <= budget) return true;
  }
  return false;
}

template <int S, int L, int NP>
cudaError_t configure(const Shape& s, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                      int* active) {
  cudaError_t err = cudaFuncSetAttribute(ntt_kernel<S, L, NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
  if (err != cudaSuccess) return err;
  const int clusters = ((s.B + S - 1) / S + s.split - 1) / s.split;
  cfg = {};
  cfg.gridDim = dim3(clusters * s.split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = s.smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = s.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(active, ntt_kernel<S, L, NP>, &cfg);
}

template <int L, int NP>
cudaError_t configure_s(const Shape& s, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                        int* active) {
  if (s.S == 4) return configure<4, L, NP>(s, cfg, attr, active);
  if (s.S == 2) return configure<2, L, NP>(s, cfg, attr, active);
  return configure<1, L, NP>(s, cfg, attr, active);
}

// the instance of the plan in s: key limbs and primes a pass
cudaError_t configure_plan(const Shape& s, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                           int* active) {
  if (s.L == 3)
    return s.np == 2 ? configure_s<3, 2>(s, cfg, attr, active)
                     : configure_s<3, 1>(s, cfg, attr, active);
  return s.np == 2 ? configure_s<4, 2>(s, cfg, attr, active)
                   : configure_s<4, 1>(s, cfg, attr, active);
}

template <int L, int NP>
cudaError_t launch_s(const Shape& s, cudaLaunchConfig_t& cfg, const void* acc0, const void* bk,
                     const void* a_hat, const void* frags, void* out) {
  const auto args = [&](auto kernel) {
    return cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint32_t*>(acc0),
                              static_cast<const int8_t*>(bk), static_cast<const int32_t*>(a_hat),
                              static_cast<const uint4*>(frags), static_cast<uint32_t*>(out), s);
  };
  if (s.S == 4) return args(ntt_kernel<4, L, NP>);
  if (s.S == 2) return args(ntt_kernel<2, L, NP>);
  return args(ntt_kernel<1, L, NP>);
}

cudaError_t launch_plan(const Shape& s, cudaLaunchConfig_t& cfg, const void* acc0,
                        const void* bk, const void* a_hat, const void* frags, void* out) {
  if (s.L == 3)
    return s.np == 2 ? launch_s<3, 2>(s, cfg, acc0, bk, a_hat, frags, out)
                     : launch_s<3, 1>(s, cfg, acc0, bk, a_hat, frags, out);
  return s.np == 2 ? launch_s<4, 2>(s, cfg, acc0, bk, a_hat, frags, out)
                   : launch_s<4, 1>(s, cfg, acc0, bk, a_hat, frags, out);
}

int mod_pow(long long b, long long e, long long m) {
  long long r = 1;
  for (b %= m; e; e >>= 1, b = b * b % m)
    if (e & 1) r = r * b % m;
  return static_cast<int>(r);
}

}  // namespace

extern "C" {

// acc0 u32 [B, C, N]; bk_lhs int8 [n, 2, N1, 2*CLN2, RN2] (16-byte aligned);
// a_hat int32 [n, B]; frags: the transforms' mma fragments (the wrapper's
// kernel_tables: int8 [2 primes][fwd, inv][8 m-tiles][32 lanes][2 k-steps]
// [4 registers][4 bytes]) -> out u32 [B, C, N].  spc (1, 2 or 4) and split
// (1, 2, 4 or 8; spc*split <= 16) force the plan, 0 lets the entry point
// pick: the largest split the samples allow, and among the samples per CTA
// those whose key stages hold whole bin slices, if any does, and of those
// the one whose waves of clusters (cudaOccupancyMaxActiveClusters) take the
// least time by waves * (spc + 2).  Each plan runs both primes a pass where
// their blocks fit (fit_stages), else one.  Takes N1 = 64 dividing N, R*N2 a
// multiple of 4 and at most 384, C*key_limbs*N2 <= 288, key_limbs 3 or 4,
// 1 <= log_base <= 6, B >= 1, when one sample's shared memory fits the card;
// returns cudaErrorInvalidValue for anything else, and an error a launch
// before it left pending.  info[0..9] <- samples per CTA, threads, shared
// bytes, CTAs, split, clusters the card holds at once, key stages,
// contraction m-tiles per stage, whether the outgoing Dh and Ch blocks
// share their room, and the cluster exchanges a step (2 with both primes a
// pass, 4 with one).
int blind_rotate_nttf(const void* acc0, const void* bk_lhs, const void* a_hat,
                      const void* frags, void* out, int n_steps, int B, int C, int N,
                      int levels, int log_base, int ignored_bits, int N1, int key_bits,
                      int key_limbs, int spc, int split, int* info, void* stream) {
  auto pow2_upto8 = [](int x) { return x == 1 || x == 2 || x == 4 || x == 8; };
  if (N1 != kN1 || N % kN1 || (N & (N - 1)) || C < 1 || B < 1 || levels < 1 ||
      log_base < 1 || log_base > 6 || (key_limbs != 3 && key_limbs != 4) ||
      reinterpret_cast<uintptr_t>(bk_lhs) % 16 || (spc && spc != 1 && spc != 2 && spc != 4) ||
      (split && !pow2_upto8(split)))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s{};
  s.n_steps = n_steps;
  s.B = B;
  s.C = C;
  s.N = N;
  s.levels = levels;
  s.log_base = log_base;
  s.ignored_bits = ignored_bits;
  s.N2 = N / kN1;
  s.RN2 = C * levels * s.N2;
  s.RN2p = (s.RN2 + 15) / 16 * 16;
  s.CLN2 = C * key_limbs * s.N2;
  s.L = key_limbs;
  s.key_bits = key_bits;
  s.inv_p1 = mod_pow(kP1, kP2 - 2, kP2);
  if (s.RN2 % 4 || s.RN2 > 384 || (s.CLN2 + 7) / 8 > kWarps * kMaxOwned ||
      (2 * s.CLN2 * s.RN2) % 16)
    return static_cast<int>(cudaErrorInvalidValue);

  // the search below clears the errors of the candidates the card refuses,
  // so an earlier launch's error is returned first
  cudaError_t err = cudaPeekAtLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, budget = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&budget, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Shape best{};
  long best_cost = -1;
  int best_active = 0;
  bool best_chunked = false;
  for (int S = 4; S >= 1; S /= 2) {
    if (spc && S != spc) continue;
    for (int sp = kMaxCluster; sp >= 1; sp /= 2) {
      if ((split && sp != split) || (!split && sp != std::min(kMaxCluster, 16 / S)) ||
          S * sp > 4 * kMaxNt)
        continue;
      s.S = S, s.split = sp;
      if (!fit_stages(s, budget)) continue;
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      int active = 0;
      err = configure_plan(s, cfg, attr, &active);
      if (err != cudaSuccess || active < 1) {
        cudaGetLastError();  // a cluster the card cannot hold is not a fault
        continue;
      }
      const long waves = (cfg.gridDim.x / sp + active - 1) / active;
      const long cost = waves * (S + 2);
      // chunks of a slice leave the warps whose m-tiles are in other chunks idle
      const bool chunked = s.nchunks > 1;
      if (best_cost < 0 || chunked < best_chunked ||
          (chunked == best_chunked && cost < best_cost))
        best = s, best_cost = cost, best_active = active, best_chunked = chunked;
    }
  }
  if (best_cost < 0) return static_cast<int>(cudaErrorInvalidValue);
  s = best;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  err = configure_plan(s, cfg, attr, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.stream = static_cast<cudaStream_t>(stream);
  const int plan[10] = {s.S, kThreads, s.smem, static_cast<int>(cfg.gridDim.x), s.split,
                        best_active, s.stages, s.mcs, s.share, 2 * (2 / s.np)};
  std::copy(plan, plan + 10, info);
  err = launch_plan(s, cfg, acc0, bk_lhs, a_hat, frags, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
