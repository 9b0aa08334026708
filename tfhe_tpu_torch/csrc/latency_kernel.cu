// Kernel C: the small-batch blind rotation (all steps) in one launch, its
// products on the int8 tensor cores (mma.sync).
//
// Replaces: tfhe_tpu/ops/pallas/latency_kernel.py, blind_rotate_latency (body
// _kernel_latency), for V=1 (impl fusedl, B <= 8) and V=3 (impl bmmpl, the
// BMMP halved-depth form, B <= 4).  Per step s and sample b:
//
//   rot_v[p, i] = acc[p] * X^{a_v}, a_v = a_vhat[s, v, b] mod 2N
//   d[r, m]     = reference carry-chain digits of rot_v - acc, row
//                 r = v*R + p*levels + j (MSB-first), rows >= V*R zero
//   out[c,l,j]  = sum_{g,t,lane} K[s, (c,l), (g,t,lane)] * +-d[4g+lane, (j-t) mod N]
//                 (minus where j < t)
//   acc[c, j]  += sum_l out[c,l,j] << 8l   (mod 2^32)
//
// K is the int8 key operand of bk_latency_operand, read as it is stored:
// row (c, l) holds limb l of the canonical key word bk[s, 4g+lane, c, t] at
// column (g, t, lane).
//
// What bounds it on the H100: the int8 products.  One sample-step is
// (k+1)*4 * G * N * N of them (1.57e7 at default_128 with V=1, 4.4e7 with
// V=3), ~1.1e10 a sample at V=1: far too much for one SM at B=1, the regime
// this kernel exists for.  One sample runs on one thread-block cluster of at
// most 16 SMs, so at B=1 the bound is that of 16 of the card's SMs.  The
// key is the other wall: a step's key block is 122,880 bytes at V=1, and an
// SM takes in bulk copies at ~20 bytes a clock (PERF.md, section 5), so a
// CTA that contracts every key column takes ~6,000 clocks a step for its
// key alone.  Hence the CTAs of a cluster split the key columns.
//
// Design.  The contraction is int8 mma.sync m16n8k32 (s8 x s8 -> s32): the
// key is A (M = the (c, l) rows, 4C <= 16; rows past 4C are zero and not
// loaded), the output coefficients j of a sample are N, and K runs over the
// key columns (g, t, lane).  Both operands are already in fragment form: a
// k-chunk is one g and eight t's (t0 .. t0+7), four lanes to a 32-bit word
// on both sides, so a thread (groupID gid, tig) of a warp holds
//   A: a0 = K word (row gid, g, t0+tig), a2 = (row gid, g, t0+4+tig), and
//      a1, a3 the same for row gid+8;
//   B: b0 = the digit word of group g at offset (j0 + gid - t0 - tig) mod 2N,
//      b1 the same at t0 + 4,
// where the word at offset m < N packs the digit bytes d[4g..4g+3, m] and
// the one at N + m their negations, so the circulant is never built.  b
// depends on j0 - t0 alone (Toeplitz): a warp owning NTW n-tiles j0, j0+8,
// .. keeps a window of 2*NTW B words in registers and, walking t0 up by 8,
// loads two new words per k-chunk; each A fragment serves all NTW n-tiles.
// Every sum stays inside int32 at every shape the entry point takes: a sum
// has at most 4*G*N terms of |K| <= 128 and |d| <= 2^log_base, and the
// entry point refuses shapes where that could reach 2^31; partial sums are
// added in uint32_t, where only the value mod 2^32 counts.
//
// Each sample runs on one cluster of `cs` CTAs.  CTA r owns the N/cs
// coefficients i of every column for all steps, in shared memory
// (acc_mine), and the r-th 1/cs of each step's key columns (its k-chunks),
// which its producer warp streams through a ring of stages, one step's
// share a stage, 4C bulk copies (one per row, rows padded to 4 mod 32 words
// against bank conflicts) completing on the stage's mbarrier, a ring's
// depth of steps ahead.  Per step, each CTA
//   1. after a cluster barrier (every slice holds the previous step's
//      accumulator), computes the digit words of its own coefficients of
//      every variant and poly, reading rot's acc[p, i - a] from the CTA that
//      holds it (distributed shared memory);
//   2. sends every CTA of the cluster the digit groups that CTA's k-chunks
//      touch, by bulk copies into the place of its coefficients in their
//      `ext`, counted on the receiver's mbarrier ext_ready, which expects
//      every CTA's share;
//   3. contracts its k-chunks against the digit words for every output:
//      the warps take blocks of NTW n-tiles (and, where there are fewer
//      blocks than warps, split the k-chunks); a warp adds its
//      limb rows (c, l) as sum_l out << 8l across the lanes that hold them
//      (rows 4c+l of one column sit on lanes 4 apart) into a partial delta;
//   4. sends each CTA the partial deltas of that CTA's coefficients, counted
//      on its mbarrier delta_ready, which expects every CTA's partials: once
//      it is complete, every CTA has also read this step's accumulator;
//   5. adds the cluster's partials into its slice and arrives on the
//      cluster barrier.  A CTA's ext and received partials are rewritten
//      only after it has arrived, so after it has read them.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

#include "limb_planes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;  // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxNtw = 8;                 // n-tiles per warp
constexpr int kMaxStages = 8;
constexpr int kMaxRows = 16;  // the (c, l) rows: one m16 tile, C <= 4
constexpr int kClusterSizes[] = {16, 8, 4, 2, 1};
constexpr int kBarConsumers = 1;  // named barrier (0 is __syncthreads)
constexpr int kPlanInts = 7;

struct Shape {
  int n_steps, B, V, C, N, levels, log_base, ignored_bits;
  // the plan: CTAs of a cluster (one sample's), key stages
  int cs, stages;
  // what follows from it: digit groups, key rows (4C), coefficients per CTA,
  // k-chunks per CTA and step, n-tiles per warp block, blocks per warp,
  // k-splits, log2 of N and nj, key words of a stage row and its padded
  // stride, and the most digit groups one CTA's k-chunks touch
  int G, R4, nj, cpc, ntw, bpw, ks, lgN, lgnj, kw, kws, GD;
  // byte offsets of the shared-memory sections, and the total
  int off_ext, off_sent, off_part, off_recv, off_key, off_bar, stage_bytes, smem;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");  // .release
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");  // .acquire
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kBarConsumers), "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(limb_planes::smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(limb_planes::smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   limb_planes::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(limb_planes::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the same, ordered after the bulk copies of other CTAs of the cluster
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAITC:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAITC;\n"
      "}\n" ::"r"(limb_planes::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// this thread's generic-proxy shared-memory writes, made visible to the
// async proxy (the bulk copies) after a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// this thread's bulk copies so far form a group; wait until every group's
// source has been read
__device__ __forceinline__ void bulk_commit_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> this
// CTA's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(limb_planes::smem_addr(dst)), "l"(src), "r"(bytes), "r"(limb_planes::smem_addr(bar))
      : "memory");
}

// the shared::cluster address of `p`'s offset in cluster CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(limb_planes::smem_addr(p)), "r"(rank));
  return a;
}

// `bytes` (a multiple of 16, 16-byte aligned) of this CTA's shared memory
// into another's (a shared::cluster address), counted on its mbarrier `bar`
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, const void* src, int bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(limb_planes::smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// the first and last digit group that CTA r's k-chunks touch
__device__ __forceinline__ int group_lo(const Shape& s, int r) { return r * s.cpc / (s.N / 8); }
__device__ __forceinline__ int group_hi(const Shape& s, int r) {
  return ((r + 1) * s.cpc - 1) / (s.N / 8);
}

// The producer (one thread): the key stages of steps `t` on, up to `limit`,
// each into ring slot t mod stages once the consumers have released its
// last use: this CTA's k-chunks of the step, one bulk copy per row.
__device__ void produce(const Shape& s, const int8_t* __restrict__ bk, int8_t* keys,
                        uint64_t* full, uint64_t* empty, int rank, int& t, int limit) {
  const size_t row_bytes = static_cast<size_t>(s.G) * s.N * 4;
  for (; t < limit; ++t) {
    const int slot = t % s.stages, use = t / s.stages;
    if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
    const int8_t* src = bk + static_cast<size_t>(t) * s.R4 * row_bytes + rank * s.kw * 4;
    int8_t* dst = keys + slot * s.stage_bytes;
    mbar_expect(full + slot, s.R4 * s.kw * 4);
    for (int r = 0; r < s.R4; ++r)
      bulk_copy(dst + r * s.kws * 4, src + r * row_bytes, s.kw * 4, full + slot);
  }
}

template <int NTW>
__global__ void __launch_bounds__(kThreads, 1)
latency_kernel(const uint32_t* __restrict__ acc0, const int8_t* __restrict__ bk,
               const int32_t* __restrict__ a_vhat, uint32_t* __restrict__ out, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int N = s.N, C = s.C, nj = s.nj, mask2 = 2 * N - 1;
  const int CN = C * N, items = C * nj;  // items: this CTA's (column, i)
  const int gnj = s.G * nj;              // words of one sign of a CTA's digit block
  const int gdnj = s.GD * nj;            // words of one sign of a CTA's block received
  uint32_t* acc_mine = reinterpret_cast<uint32_t*>(smem);           // [C][nj]
  uint32_t* ext = reinterpret_cast<uint32_t*>(smem + s.off_ext);    // [2][cs][GD][nj]
  uint32_t* sent = reinterpret_cast<uint32_t*>(smem + s.off_sent);  // [2][G][nj]
  uint32_t* part = reinterpret_cast<uint32_t*>(smem + s.off_part);  // [ks][cs][C][nj]
  uint32_t* recv = reinterpret_cast<uint32_t*>(smem + s.off_recv);  // [cs][C][nj]
  int8_t* keys = reinterpret_cast<int8_t*>(smem + s.off_key);       // [stages][R4][kws]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + s.off_bar);   // [stages] each
  uint64_t* empty = full + s.stages;
  uint64_t* ext_ready = empty + s.stages;  // every CTA's digit block has arrived
  uint64_t* delta_ready = ext_ready + 1;   // every CTA's partials of this slice have

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = cluster_rank();
  const int b = blockIdx.x / s.cs;  // the cluster's sample

  if (tid == 0) {
    for (int k = 0; k < s.stages; ++k) {
      mbar_init(full + k, 1);
      mbar_init(empty + k, kWarps);
    }
    mbar_init(ext_ready, 1);
    mbar_init(delta_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int it = tid; it < items; it += kThreads) {
    const int c = it >> s.lgnj, jl = it & (nj - 1);
    acc_mine[it] = acc0[static_cast<size_t>(b) * CN + (c << s.lgN) + rank * nj + jl];
  }
  for (int idx = tid; idx < 2 * gnj; idx += kThreads) sent[idx] = 0u;  // padding rows stay 0
  __syncthreads();

  cluster_arrive();
  if (warp == kWarps) {
    // the producer warp: lane 0 streams the key, a ring's depth of steps
    // ahead; the warp keeps the cluster barrier's order
    int t = 0;
    for (int step = 0; step < s.n_steps; ++step) {
      cluster_wait();
      const int limit = min(s.n_steps, step + 1 + s.stages);
      if (lane == 0) produce(s, bk, keys, full, empty, rank, t, limit);
      __syncwarp();
      cluster_arrive();
    }
  } else {
    const int R = C * s.levels, lb = s.log_base, ig = s.ignored_bits;
    const uint32_t dmask = (1u << lb) - 1u;
    const int half = 1 << (lb - 1);
    unsigned char* sent_b = reinterpret_cast<unsigned char*>(sent);
    const int gid = lane >> 2, tig = lane & 3;
    const int cpg = N >> 3;  // k-chunks per digit group
    // this warp's k-split and its k-chunks of the CTA's share
    const int kq = warp % s.ks, q_lo = kq * s.cpc / s.ks, q_hi = (kq + 1) * s.cpc / s.ks;
    const int q0 = rank * s.cpc;  // the CTA's first k-chunk of a step
    const int g_lo = group_lo(s, rank);
    const bool row_lo = gid < s.R4, row_hi = gid + 8 < s.R4;
    const int a_lo = gid * s.kws + tig, a_hi = (gid + 8) * s.kws + tig;
    const uint32_t* key_w = reinterpret_cast<const uint32_t*>(keys);
    const int stage_words = s.stage_bytes / 4;
    const int pitems = s.cs * items;  // words of one k-split's partials

    for (int step = 0; step < s.n_steps; ++step) {
      cluster_wait();  // every slice holds the previous step's accumulator
      // the digits of this CTA's coefficients i of every variant and poly,
      // four rows packed per word: rot reads acc[p, i - a] from the CTA that
      // holds it
      for (int job = tid; job < s.V * items; job += kConsumers) {
        const int jl = job & (nj - 1), rest = job >> s.lgnj, p = rest % C, v = rest / C;
        const int a = a_vhat[(static_cast<size_t>(step) * s.V + v) * s.B + b] & mask2;
        const int src = (rank * nj + jl - a) & mask2, sn = src & (N - 1);
        const uint32_t* slice = cluster.map_shared_rank(acc_mine, sn >> s.lgnj);
        uint32_t rot = slice[p * nj + (sn & (nj - 1))];
        if (src >= N) rot = 0u - rot;
        const uint32_t diff = rot - acc_mine[p * nj + jl];
        // round_value, then the reference carry chain (src/decomposer.rs:42-80)
        const uint32_t val = ig ? (diff >> ig) + ((diff >> (ig - 1)) & 1u) : diff;
        int carry = 0;
        for (int l = 0; l < s.levels; ++l) {
          int res = static_cast<int>((val >> (lb * l)) & dmask) + carry;
          const int cm = res & half;
          res -= cm << 1;  // in [-B/2, B]: the +B anomaly stays
          carry = cm >> (lb - 1);
          const int row = v * R + p * s.levels + s.levels - 1 - l;
          const int off = ((row >> 2) * nj + jl) * 4 + (row & 3);
          sent_b[off] = static_cast<unsigned char>(res);
          sent_b[off + 4 * gnj] = static_cast<unsigned char>(-res);
        }
      }
      // this CTA's digit block into every CTA's ext, at the place of its
      // coefficients: thread d sends CTA d the groups its k-chunks touch,
      // sign by sign
      fence_proxy_async();
      bar_consumers();
      if (tid == 0)  // every CTA's block of this CTA's groups
        mbar_expect(ext_ready, 2 * s.cs * (group_hi(s, rank) - group_lo(s, rank) + 1) * nj * 4);
      if (tid < s.cs) {
        const int glo = group_lo(s, tid), words = (group_hi(s, tid) - glo + 1) * nj;
        for (int sign = 0; sign < 2; ++sign)
          bulk_to_peer(cluster_addr(ext + (sign * s.cs + rank) * gdnj, tid),
                       sent + (sign * s.G + glo) * nj, words * 4, cluster_addr(ext_ready, tid));
        bulk_commit_wait_read();
      }
      mbar_wait_cluster(ext_ready, step & 1);

      // the contraction of this step's key stage
      const int slot = step % s.stages;
      mbar_wait(full + slot, (step / s.stages) & 1);
      const uint32_t* st = key_w + slot * stage_words;
      for (int k = 0; k < s.bpw; ++k) {
        // n-tile block `blk`: outputs j0 .. j0 + 8*NTW - 1
        const int blk = warp / s.ks + k * (kWarps / s.ks), j0 = blk * NTW * 8;
        const int jd = j0 + gid - tig;
        int acc[NTW][4];
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[n][r] = 0;
        // the A registers of the CTA's k-chunk q
        const auto load_a = [&](uint32_t(&a)[4], int q) {
          const int lc = 8 * q;
          a[0] = row_lo ? st[a_lo + lc] : 0u;
          a[1] = row_hi ? st[a_hi + lc] : 0u;
          a[2] = row_lo ? st[a_lo + lc + 4] : 0u;
          a[3] = row_hi ? st[a_hi + lc + 4] : 0u;
        };
        // the k-chunks in segments within one digit group: k-chunk q of the
        // step is group q / cpg at t0 = 8 * (q mod cpg)
        for (int qa = q_lo; qa < q_hi;) {
          const int g = (q0 + qa) / cpg, qb = min(q_hi, (g + 1) * cpg - q0);
          const int t0a = (q0 + qa - g * cpg) * 8;
          // the digit word of offset m of group g:
          // ext[m / N][m / nj mod cs][g - group_lo(rank)][m mod nj]
          const uint32_t* e = ext + (g - g_lo) * nj;
          const auto word = [&](int m) {
            m &= mask2;
            return e[(m >> s.lgnj) * gdnj + (m & (nj - 1))];
          };
          // the window of k-chunk t0: win(m) = digit word of offset
          // j0 - t0 - 4 + 4m, m < 2*NTW; b0 of n-tile n is win(2n+1), b1
          // win(2n), held as the pair v[2n], v[2n+1].  The next k-chunk's
          // window is this one shifted up by two, so v holds the pair of
          // n-tile n of the u-th k-chunk of a run of NTW at v[(2n - 2u) mod
          // 2*NTW], and each k-chunk loads the next one's new pair into the
          // slots its last pair leaves
          uint32_t v[2 * NTW];
#pragma unroll
          for (int n = 0; n < NTW; ++n) {
            v[2 * n] = word(jd - t0a + 8 * n);
            v[2 * n + 1] = word(jd - t0a - 4 + 8 * n);
          }
          uint32_t a[4], next[4];
          load_a(a, qa);
          int q = qa;
          for (; q + NTW <= qb; q += NTW) {
#pragma unroll
            for (int u = 0; u < NTW; ++u) {
              load_a(next, q + u + 1 < qb ? q + u + 1 : q + u);
#pragma unroll
              for (int n = 0; n < NTW; ++n) {
                const int k = (2 * n - 2 * u) & (2 * NTW - 1);
                limb_planes::mma_s8(acc[n], a, v[k], v[k + 1]);
              }
              const int t0 = t0a + 8 * (q - qa + u + 1), k = (-2 * u - 2) & (2 * NTW - 1);
              v[k] = word(jd - t0);
              v[k + 1] = word(jd - t0 - 4);
#pragma unroll
              for (int r = 0; r < 4; ++r) a[r] = next[r];
            }
          }
          for (; q < qb; ++q) {  // the last k-chunks of the segment, fewer than NTW
            load_a(next, q + 1 < qb ? q + 1 : q);
#pragma unroll
            for (int n = 0; n < NTW; ++n) limb_planes::mma_s8(acc[n], a, v[2 * n], v[2 * n + 1]);
            const int t0 = t0a + 8 * (q - qa + 1);
#pragma unroll
            for (int m = 2 * NTW - 1; m >= 2; --m) v[m] = v[m - 2];
            v[0] = word(jd - t0);
            v[1] = word(jd - t0 - 4);
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = next[r];
          }
          qa = qb;
        }
        // rows (c, l) = 4c + l of one column sit on lanes 4 apart: recombine
        // sum_l out << 8l there (all shuffles first, none diverging), then
        // the lanes of limb l store the sums of their c_l register: rows gid
        // (c0, c1) and gid+8 (c2, c3) are columns gid/4 and 2 + gid/4, and
        // output j goes to the partials of its owner
        uint32_t x[NTW][4];
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) x[n][r] = static_cast<uint32_t>(acc[n][r]) << (8 * (gid & 3));
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) x[n][r] += __shfl_xor_sync(0xFFFFFFFFu, x[n][r], 4);
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) x[n][r] += __shfl_xor_sync(0xFFFFFFFFu, x[n][r], 8);
        const int l = gid & 3, c = 2 * (l >> 1) + (gid >> 2);
        if (c < C) {
          uint32_t* pq = part + kq * pitems + c * nj;
#pragma unroll
          for (int n = 0; n < NTW; ++n) {
            const int j = j0 + 8 * n + 2 * tig + (l & 1);
            const uint32_t sum = l == 0 ? x[n][0] : l == 1 ? x[n][1] : l == 2 ? x[n][2] : x[n][3];
            pq[(j >> s.lgnj) * items + (j & (nj - 1))] = sum;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
      if (s.ks > 1) {  // the k-splits' partials, summed
        bar_consumers();
        for (int it = tid; it < pitems; it += kConsumers) {
          uint32_t d = 0u;
          for (int q = 0; q < s.ks; ++q) d += part[q * pitems + it];
          part[it] = d;
        }
      }
      // each CTA's partials into its `recv`, at this CTA's place
      fence_proxy_async();
      bar_consumers();
      if (tid == 0) mbar_expect(delta_ready, s.cs * items * 4);  // every CTA's partials
      if (tid < s.cs) {
        bulk_to_peer(cluster_addr(recv + rank * items, tid), part + tid * items, items * 4,
                     cluster_addr(delta_ready, tid));
        bulk_commit_wait_read();
      }
      // this also orders every CTA's reads of this slice before its update
      mbar_wait_cluster(delta_ready, step & 1);
      for (int it = tid; it < items; it += kConsumers) {
        uint32_t d = 0u;
        for (int o = 0; o < s.cs; ++o) d += recv[o * items + it];
        acc_mine[it] += d;
      }
      cluster_arrive();
    }
  }
  cluster_wait();
  for (int it = tid; it < items; it += kThreads) {
    const int c = it >> s.lgnj, jl = it & (nj - 1);
    out[static_cast<size_t>(b) * CN + (c << s.lgN) + rank * nj + jl] = acc_mine[it];
  }
}

int align_up(int x, int a) { return (x + a - 1) / a * a; }

int log2i(int x) { return __builtin_ctz(static_cast<unsigned>(x)); }

// the plan's derived sizes; false unless the cluster's CTAs split the key
// columns evenly and each CTA's coefficients fill whole n-tiles
bool derive(Shape& s) {
  s.G = (s.V * s.C * s.levels + 3) / 4;
  s.R4 = 4 * s.C;
  s.nj = s.N / s.cs;
  const int chunks = s.G * s.N / 8;  // k-chunks of a step
  if (s.nj < 8 || chunks % s.cs) return false;
  s.cpc = chunks / s.cs;
  const int tiles = s.N / 8;  // n-tiles of a sample
  s.ntw = tiles / kWarps;
  s.ntw = s.ntw < 1 ? 1 : s.ntw > kMaxNtw ? kMaxNtw : s.ntw;
  const int blocks = tiles / s.ntw;
  s.ks = blocks < kWarps ? kWarps / blocks : 1;
  s.bpw = blocks < kWarps ? 1 : blocks / kWarps;
  s.lgN = log2i(s.N);
  s.lgnj = log2i(s.nj);
  s.kw = 8 * s.cpc;
  s.kws = s.kw + 4;  // rows 4 banks apart: a warp's A loads hit 32 banks
  s.GD = 0;
  for (int r = 0; r < s.cs; ++r) {
    const int groups = ((r + 1) * s.cpc - 1) / (s.N / 8) - r * s.cpc / (s.N / 8) + 1;
    s.GD = groups > s.GD ? groups : s.GD;
  }
  return true;
}

int layout(Shape& s) {
  const int items = s.C * s.nj, gnj = s.G * s.nj;
  int off = align_up(items * 4, 128);  // acc_mine
  s.off_ext = off;
  off += align_up(2 * s.cs * s.GD * s.nj * 4, 128);
  s.off_sent = off;
  off += align_up(2 * gnj * 4, 128);
  s.off_part = off;
  off += align_up(s.ks * s.cs * items * 4, 128);
  s.off_recv = off;
  off += align_up(s.cs * items * 4, 128);
  s.stage_bytes = align_up(s.R4 * s.kws * 4, 128);
  s.off_key = off;
  off += s.stages * s.stage_bytes;
  s.off_bar = off;
  off += (2 * s.stages + 2) * 8;
  s.smem = off;
  return off;
}

// as many key stages (kMaxStages down to 1) as fit `budget`; false if 1 does not
bool fit_stages(Shape& s, int budget) {
  for (s.stages = kMaxStages; s.stages >= 1; --s.stages)
    if (layout(s) <= budget) return true;
  return false;
}

template <int NTW>
cudaError_t configure_t(const Shape& s, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                        int* active) {
  cudaError_t err = cudaFuncSetAttribute(latency_kernel<NTW>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(latency_kernel<NTW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               s.smem);
  if (err != cudaSuccess) return err;
  cfg = {};
  cfg.gridDim = dim3(s.B * s.cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = s.smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = s.cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return active ? cudaOccupancyMaxActiveClusters(active, latency_kernel<NTW>, &cfg) : cudaSuccess;
}

cudaError_t configure(const Shape& s, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                      int* active) {
  if (s.ntw == 8) return configure_t<8>(s, cfg, attr, active);
  if (s.ntw == 4) return configure_t<4>(s, cfg, attr, active);
  if (s.ntw == 2) return configure_t<2>(s, cfg, attr, active);
  return configure_t<1>(s, cfg, attr, active);
}

cudaError_t launch(const Shape& s, cudaLaunchConfig_t& cfg, const void* acc0, const void* bk,
                   const void* a_vhat, void* out) {
  const auto args = [&](auto kernel) {
    return cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint32_t*>(acc0),
                              static_cast<const int8_t*>(bk), static_cast<const int32_t*>(a_vhat),
                              static_cast<uint32_t*>(out), s);
  };
  if (s.ntw == 8) return args(latency_kernel<8>);
  if (s.ntw == 4) return args(latency_kernel<4>);
  if (s.ntw == 2) return args(latency_kernel<2>);
  return args(latency_kernel<1>);
}

// the picks made so far: a launch at a shape and forced cluster size seen
// before skips the search (its cudaFuncSetAttribute and occupancy queries)
struct Pick {
  int dev, B, V, C, N, levels, forced;
  int cs, stages, active;
};
std::mutex g_picks_mutex;
std::vector<Pick> g_picks;

}  // namespace

extern "C" {

// acc0 u32 [B, C, N], bk_lat int8 [n_steps, C*4, 4*G*N] (16-byte aligned),
// a_vhat int32 [n_steps, V, B] -> out u32 [B, C, N].  `cluster` (16, 8, 4, 2
// or 1 CTAs) forces the cluster size, 0 lets the entry point pick: the size
// whose waves of clusters (cudaOccupancyMaxActiveClusters) take the least
// time by waves * (N / cluster / 8 + 2) (the contraction shrinks with the
// cluster, the exchanges do not), the larger first among equals.  Returns
// cudaErrorInvalidValue unless N is a power of two >= 8, V is 1 or 3,
// 1 <= C <= 4 (the C*4 limb rows fit one m16 tile), B >= 1, levels >= 1,
// 1 <= log_base <= 6 (digits and their negations fit int8), no sum can reach
// 2^31, and some cluster size fits the card; and an error a launch before it
// left pending.  info (host, 7 ints) receives the plan: cluster size,
// threads per CTA, dynamic shared memory bytes, the clusters of that size
// the card holds at once, CTAs, key stages and k-splits.
int blind_rotate_latency(const void* acc0, const void* bk_lat, const void* a_vhat, void* out,
                         int n_steps, int B, int V, int C, int N, int levels, int log_base,
                         int ignored_bits, int cluster, int* info, void* stream) {
  const int G = (V * C * levels + 3) / 4;
  if (N < 8 || (N & (N - 1)) || (V != 1 && V != 3) || B < 1 || C < 1 || 4 * C > kMaxRows ||
      levels < 1 || log_base < 1 || log_base > 6 || n_steps < 0 ||
      reinterpret_cast<uintptr_t>(bk_lat) % 16 ||
      (cluster && cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16) ||
      4.0 * G * N * 128.0 * (1 << log_base) >= 2147483648.0)
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
  Shape s{};
  s.n_steps = n_steps;
  s.B = B;
  s.V = V;
  s.C = C;
  s.N = N;
  s.levels = levels;
  s.log_base = log_base;
  s.ignored_bits = ignored_bits;
  const Pick key{dev, B, V, C, N, levels, cluster, 0, 0, 0};
  Pick pick{};
  bool found = false;
  {
    std::lock_guard<std::mutex> lock(g_picks_mutex);
    for (const Pick& p : g_picks)
      if (p.dev == dev && p.B == B && p.V == V && p.C == C && p.N == N && p.levels == levels &&
          p.forced == cluster)
        pick = p, found = true;
  }
  if (!found) {
    long best_cost = -1;
    for (int cs : kClusterSizes) {
      if (cluster && cs != cluster) continue;
      s.cs = cs;
      if (!derive(s) || !fit_stages(s, budget)) continue;
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      int active = 0;
      if (configure(s, cfg, attr, &active) != cudaSuccess || active < 1) {
        cudaGetLastError();  // a cluster the card cannot hold is not a fault
        continue;
      }
      const long cost = (B + active - 1) / active * (s.nj / 8 + 2);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        pick = key;
        pick.cs = cs, pick.stages = s.stages, pick.active = active;
      }
    }
    if (best_cost < 0) return static_cast<int>(cudaErrorInvalidValue);
    std::lock_guard<std::mutex> lock(g_picks_mutex);
    g_picks.push_back(pick);
  }
  s.cs = pick.cs;
  derive(s);
  s.stages = pick.stages;
  layout(s);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = configure(s, cfg, attr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.stream = static_cast<cudaStream_t>(stream);
  const int plan[kPlanInts] = {s.cs, kThreads, s.smem, pick.active,
                               static_cast<int>(cfg.gridDim.x), s.stages, s.ks};
  for (int k = 0; k < kPlanInts; ++k) info[k] = plan[k];
  err = launch(s, cfg, acc0, bk_lat, a_vhat, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
