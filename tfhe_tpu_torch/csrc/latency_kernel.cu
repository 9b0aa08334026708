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
// coefficients i = r*nj .. r*nj + nj - 1 of every column (its slice) and the
// r-th 1/cs of each step's key columns (its k-chunks), which its producer
// warp streams through a ring of stages, one step's share a stage, 4C bulk
// copies (one per row, rows padded to 4 mod 32 words against bank
// conflicts) completing on the stage's mbarrier, a ring's depth of steps
// ahead.  Every CTA keeps the whole accumulator in shared memory (`acc`,
// slice by slice: its replica).  Per step, each CTA
//   1. waits on its mbarrier acc_ready until every owner's slice of this
//      step's accumulator has arrived in its replica (step 4 of the last);
//   2. makes, from its replica alone, the digit words of every coefficient
//      for the groups its own k-chunks touch into `dig` [group][2N words]
//      (offset m < N holds group g's digit bytes of coefficient m, N + m
//      their negations): no reads of other CTAs' memory, no digit exchange;
//   3. contracts its k-chunks for every output: the warps take blocks of NTW
//      n-tiles (and, where there are fewer blocks than warps, split the
//      k-chunks); a warp adds its limb rows (c, l) as sum_l out << 8l across
//      the lanes that hold them (rows 4c+l of one column sit on lanes 4
//      apart) into a partial delta, plus the CTA's own slice of this step's
//      accumulator where the output is its own, and each lane adds its words
//      into the owner's `sums` (its slice of the next accumulator, zeroed
//      beforehand) by asynchronous remote reductions (red.async), counted on
//      the owner's mbarrier delta_ready;
//   4. once every CTA's partials have arrived, copies its `sums` into every
//      replica, its own included, 16 bytes a thread at a time (st.async),
//      counted on their acc_ready (not after the last step).
// Two cluster-wide exchanges a step, the reduction and the all-gather, and
// no cluster barrier.  No barrier guards the buffers either: an owner sends
// its slice only after every CTA's partials of the step have reached it, and
// each CTA sends those only after its digit phase and contraction have read
// its replica and `dig`, so the slices of step s + 1 overwrite a replica
// nobody reads any more, and a CTA whose replica is complete again has no
// warp left reading `dig`.  `sums` rotates through three buffers by step: a
// CTA zeroes the one of step s + 2 in step s, after a barrier its consumers
// reach only once they have read it in step s - 1, and before the barrier
// after which they send their slices of step s + 1, which every CTA must
// have before it adds into it.

#include <cstdint>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

#include "limb_planes.cuh"

namespace {

constexpr int kWarps = 8;  // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMaxNtw = 8;                 // n-tiles per warp
constexpr int kMaxStages = 8;
constexpr int kMaxRows = 16;  // the (c, l) rows: one m16 tile, C <= 4
constexpr int kClusterSizes[] = {16, 8, 4, 2, 1};
constexpr int kBarConsumers = 1;  // named barrier (0 is __syncthreads)
constexpr int kIlp = 4;           // digit chains a consumer thread runs side by side
constexpr int kPlanInts = 8;
constexpr int kExchanges = 2;  // cluster-wide exchanges a step: the reduction, the all-gather

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
  int off_dig, off_sums, off_key, off_bar, stage_bytes, smem;
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

// the same, ordered after the writes of other CTAs of the cluster counted on it
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
// async proxy after a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// 16 bytes into another CTA's shared memory, counted on its mbarrier
__device__ __forceinline__ void st_async_v4(uint32_t dst, uint4 w, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(dst), "r"(w.x), "r"(w.y), "r"(w.z), "r"(w.w), "r"(bar) : "memory");
}

// a word added into another CTA's shared memory, counted on its mbarrier
__device__ __forceinline__ void red_async_add(uint32_t dst, uint32_t v, uint32_t bar) {
  asm volatile(
      "red.async.relaxed.cluster.shared::cluster.mbarrier::complete_tx::bytes.add.u32 [%0], %1, [%2];\n"
      ::"r"(dst), "r"(v), "r"(bar) : "memory");
}

// the first and last digit group that CTA r's k-chunks touch
__host__ __device__ __forceinline__ int group_lo(const Shape& s, int r) {
  return r * s.cpc / (s.N / 8);
}
__host__ __device__ __forceinline__ int group_hi(const Shape& s, int r) {
  return ((r + 1) * s.cpc - 1) / (s.N / 8);
}

// The digit phase: for each poly f0 <= f < f0 + nf of the V*C (rows
// v*R + p*levels .., f = v*C + p) and coefficient i < N, digit l of
// (rot_v - acc)[p, i], rot_v[p, i] = acc[p, i - a_v], by round_value and the
// reference carry chain (src/decomposer.rs:42-80), is the byte of row
// (f+1)*levels - 1 - l; where that row lies in [r0, r1), it and its
// negation go to byte row mod 4 of words [row/4 - g0][sign][i] of `dst`.
// at(p, m) reads acc[p, m].
// Each consumer thread runs kIlp chains side by side: a chain is a few
// dozen dependent operations, so one at a time leaves the SM waiting.
template <typename At>
__device__ __forceinline__ void make_digits(const Shape& s, int tid, int f0, int nf, int g0,
                                            int r0, int r1, int3 ex, At at, uint32_t* dst) {
  const int N = s.N, L = s.levels, jobs = nf << s.lgN;
  const int lb = s.log_base, ig = s.ignored_bits;
  const uint32_t dmask = (1u << lb) - 1u;
  const int half = 1 << (lb - 1);
  // byte r mod 4 of word (r/4 - g0)*2N + i is byte r + (r/4)*(8N - 4) - 8*g0*N + 4i
  const int stride = 8 * N - 4;
  // with an even number of levels every poly's rows start even and [r0, r1)
  // holds whole pairs of rows: they are stored a halfword at a time
  const bool pairs = (L & 1) == 0;
  unsigned char* bytes = reinterpret_cast<unsigned char*>(dst);
  for (int base = tid; base < jobs; base += kIlp * kConsumers) {
    uint32_t val[kIlp];
    int carry[kIlp], top[kIlp], lo[kIlp], at_i[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const int job = min(base + u * kConsumers, jobs - 1);
      const int f = f0 + (job >> s.lgN), i = job & (N - 1);
      const int v = (f >= s.C) + (f >= 2 * s.C), p = f - v * s.C;  // f < V*C <= 3C
      const int src = (i - (v == 0 ? ex.x : v == 1 ? ex.y : ex.z)) & (2 * N - 1);
      uint32_t rot = at(p, src & (N - 1));
      if (src >= N) rot = 0u - rot;
      const uint32_t diff = rot - at(p, i);
      val[u] = ig ? (diff >> ig) + ((diff >> (ig - 1)) & 1u) : diff;
      carry[u] = 0;
      top[u] = (f + 1) * L - 1;  // the row of level 0
      // the levels whose rows lie in [r0, r1) are lo .. lo + r1 - r0 - 1
      lo[u] = base + u * kConsumers < jobs ? top[u] - r1 + 1 : 1 << 30;
      at_i[u] = 4 * (i - 2 * g0 * N);
    }
    if (pairs) {
      // two levels a pass: rows r (level l + 1) and r + 1 (level l) make one
      // halfword, r even; r steps down by 2, so its byte offset o moves by 2
      // within a word and by 2 + stride to the word before
      int o[kIlp];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int r = top[u] - 1;
        o[u] = r + (r >> 2) * stride + at_i[u];
      }
      for (int l = 0; l < L; l += 2) {
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          const bool in_word = ((top[u] - 1 - l) & 2) != 0;
          int hi = static_cast<int>((val[u] >> (lb * l)) & dmask) + carry[u];
          int cm = hi & half;
          hi -= cm << 1;  // in [-B/2, B]: the +B anomaly stays
          int c1 = cm >> (lb - 1);
          int lw = static_cast<int>((val[u] >> (lb * (l + 1))) & dmask) + c1;
          cm = lw & half;
          lw -= cm << 1;
          carry[u] = cm >> (lb - 1);
          if (static_cast<unsigned>(l + 1 - lo[u]) < static_cast<unsigned>(r1 - r0)) {
            *reinterpret_cast<uint16_t*>(bytes + o[u]) = __byte_perm(lw, hi, 0x0040);
            *reinterpret_cast<uint16_t*>(bytes + o[u] + 4 * N) = __byte_perm(-lw, -hi, 0x0040);
          }
          o[u] -= in_word ? 2 : 2 + stride;
        }
      }
    } else {
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          int res = static_cast<int>((val[u] >> (lb * l)) & dmask) + carry[u];
          const int cm = res & half;
          res -= cm << 1;  // in [-B/2, B]: the +B anomaly stays
          carry[u] = cm >> (lb - 1);
          const bool in = static_cast<unsigned>(l - lo[u]) < static_cast<unsigned>(r1 - r0);
          const int r = top[u] - l, o = r + (r >> 2) * stride + at_i[u];
          if (in) {
            bytes[o] = static_cast<unsigned char>(res);
            bytes[o + 4 * N] = static_cast<unsigned char>(-res);
          }
        }
      }
    }
  }
}

// The producer (one thread): the key stage of every step t, each into ring
// slot t mod stages once the consumers have released its last use: this
// CTA's k-chunks of the step, one bulk copy per row.
__device__ void produce(const Shape& s, const int8_t* __restrict__ bk, int8_t* keys,
                        uint64_t* full, uint64_t* empty, int rank) {
  const size_t row_bytes = static_cast<size_t>(s.G) * s.N * 4;
  for (int t = 0; t < s.n_steps; ++t) {
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
  const int N = s.N, C = s.C, nj = s.nj, mask2 = 2 * N - 1;
  const int CN = C * N, items = C * nj;  // items: a slice's (column, i)
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);                // [cs][C][nj]
  uint32_t* dig = reinterpret_cast<uint32_t*>(smem + s.off_dig);    // [GD][2N]
  uint32_t* sums = reinterpret_cast<uint32_t*>(smem + s.off_sums);  // [3][C][nj]
  int8_t* keys = reinterpret_cast<int8_t*>(smem + s.off_key);       // [stages][R4][kws]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + s.off_bar);   // [stages] each
  uint64_t* empty = full + s.stages;
  uint64_t* acc_ready = empty + s.stages;  // every slice of the step's accumulator has
  uint64_t* delta_ready = acc_ready + 1;   // every CTA's partials of `sums` have

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = cluster_rank();
  const int b = blockIdx.x / s.cs;  // the cluster's sample
  uint32_t* own = acc + rank * items;

  if (tid == 0) {
    for (int k = 0; k < s.stages; ++k) {
      mbar_init(full + k, 1);
      mbar_init(empty + k, kWarps);
    }
    mbar_init(acc_ready, 1);
    mbar_init(delta_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // `sums` starts at 0, and so do the digit bytes of rows past V*R, never written
  for (int it = tid; it < (s.off_key - s.off_dig) / 4; it += kThreads) dig[it] = 0u;
  for (int it = tid; it < CN; it += kThreads) {
    const int o = it / items, r = it - o * items, c = r >> s.lgnj, jl = r & (nj - 1);
    acc[it] = acc0[static_cast<size_t>(b) * CN + (c << s.lgN) + o * nj + jl];
  }
  fence_proxy_async();
  __syncthreads();
  cluster_arrive();
  cluster_wait();  // every CTA's mbarriers and `sums` are ready

  if (warp == kWarps) {
    // the producer warp: lane 0 streams the key, a ring's depth of steps ahead
    if (lane == 0) produce(s, bk, keys, full, empty, rank);
  } else {
    const int gid = lane >> 2, tig = lane & 3;
    const int cpg = N >> 3;  // k-chunks per digit group
    // this warp's k-split and its k-chunks of the CTA's share
    const int kq = warp % s.ks, q_lo = kq * s.cpc / s.ks, q_hi = (kq + 1) * s.cpc / s.ks;
    const int q0 = rank * s.cpc;  // the CTA's first k-chunk of a step
    const int g_lo = group_lo(s, rank), gn = group_hi(s, rank) - g_lo + 1;
    const bool row_lo = gid < s.R4, row_hi = gid + 8 < s.R4;
    const int a_lo = gid * s.kws + tig, a_hi = (gid + 8) * s.kws + tig;
    const uint32_t* key_w = reinterpret_cast<const uint32_t*>(keys);
    const int stage_words = s.stage_bytes / 4;
    // the digit rows of this CTA's groups, [r0, r1), and their first poly
    const int r0 = 4 * g_lo, r1 = min(4 * (g_lo + gn), s.V * C * s.levels), f0 = r0 / s.levels;
    const auto at = [&](int p, int m) {  // acc[p, m] in the replica
      return acc[(m >> s.lgnj) * items + p * nj + (m & (nj - 1))];
    };

    for (int step = 0; step < s.n_steps; ++step) {
      uint32_t* sums_s = sums + step % 3 * items;  // this step's sums: the next slice
      // every slice of this step's accumulator has arrived
      if (step > 0) mbar_wait_cluster(acc_ready, (step - 1) & 1);
      // the step's exponents a_v mod 2N, then the digit words of every
      // coefficient of this CTA's groups
      const int32_t* av = a_vhat + static_cast<size_t>(step) * s.V * s.B + b;
      const int3 ex = make_int3(av[0] & mask2, s.V > 1 ? av[s.B] & mask2 : 0,
                                s.V > 2 ? av[2 * s.B] & mask2 : 0);
      make_digits(s, tid, f0, (r1 - 1) / s.levels - f0 + 1, g_lo, r0, r1, ex, at, dig);
      bar_consumers();
      // the sums of step + 2 start at 0: every consumer has passed the
      // barrier, so has read them last step, and no CTA adds into them before
      // the slices of step + 1 reach it, sent after the next such barrier
      for (int it = tid; it < items; it += kConsumers) sums[(step + 2) % 3 * items + it] = 0u;
      fence_proxy_async();

      // the contraction of this step's key stage
      const int slot = step % s.stages;
      mbar_wait(full + slot, (step / s.stages) & 1);
      const uint32_t* st = key_w + slot * stage_words;
      for (int k = 0; k < s.bpw; ++k) {
        // n-tile block `blk`: outputs j0 .. j0 + 8*NTW - 1
        const int blk = warp / s.ks + k * (kWarps / s.ks), j0 = blk * NTW * 8;
        const int jd = j0 + gid - tig;
        int acc_c[NTW][4];
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc_c[n][r] = 0;
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
          // the digit word of offset m of group g
          const uint32_t* e = dig + (g - g_lo) * 2 * N;
          const auto word = [&](int m) { return e[m & mask2]; };
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
                limb_planes::mma_s8(acc_c[n], a, v[k], v[k + 1]);
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
            for (int n = 0; n < NTW; ++n) limb_planes::mma_s8(acc_c[n], a, v[2 * n], v[2 * n + 1]);
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
        // the lanes of limb l add the sums of their c_l register into the
        // owner's sums: rows gid (c0, c1) and gid+8 (c2, c3) are columns gid/4
        // and 2 + gid/4
        uint32_t x[NTW][4];
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            x[n][r] = static_cast<uint32_t>(acc_c[n][r]) << (8 * (gid & 3));
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
#pragma unroll
          for (int n = 0; n < NTW; ++n) {
            const int j = j0 + 8 * n + 2 * tig + (l & 1), o = j >> s.lgnj;
            const uint32_t sum = l == 0 ? x[n][0] : l == 1 ? x[n][1] : l == 2 ? x[n][2] : x[n][3];
            // the CTA's own slice of the accumulator rides with its partials
            const uint32_t self = o == rank && kq == 0 ? own[c * nj + (j & (nj - 1))] : 0u;
            red_async_add(cluster_addr(sums_s + c * nj + (j & (nj - 1)), o), sum + self,
                          cluster_addr(delta_ready, o));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
      if (tid == 0) mbar_expect(delta_ready, s.cs * s.ks * items * 4);  // every k-split's partials
      // this also orders every CTA's reads of this step's replica before the
      // slices of the next overwrite it
      mbar_wait_cluster(delta_ready, step & 1);
      if (step + 1 < s.n_steps) {  // the slice of the next accumulator into every replica
        if (tid == 0) mbar_expect(acc_ready, s.cs * items * 4);  // every slice
        const int chunks = items / 4;  // of 16 bytes
        for (int job = tid; job < s.cs * chunks; job += kConsumers) {
          const int d = job / chunks, k = job - d * chunks;
          st_async_v4(cluster_addr(own + 4 * k, d), reinterpret_cast<const uint4*>(sums_s)[k],
                      cluster_addr(acc_ready, d));
        }
      }
    }
  }
  cluster_arrive();
  cluster_wait();
  const uint32_t* result = s.n_steps ? sums + (s.n_steps - 1) % 3 * items : own;
  for (int it = tid; it < items; it += kThreads) {
    const int c = it >> s.lgnj, jl = it & (nj - 1);
    out[static_cast<size_t>(b) * CN + (c << s.lgN) + rank * nj + jl] = result[it];
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
    const int groups = group_hi(s, r) - group_lo(s, r) + 1;
    s.GD = groups > s.GD ? groups : s.GD;
  }
  return true;
}

int layout(Shape& s) {
  const int items = s.C * s.nj;
  int off = align_up(s.C * s.N * 4, 128);  // acc
  s.off_dig = off;
  off += align_up(s.GD * 2 * s.N * 4, 128);
  s.off_sums = off;
  off += align_up(3 * items * 4, 128);
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

using KernelFn = void (*)(const uint32_t*, const int8_t*, const int32_t*, uint32_t*, Shape);

// the kernel instance of a plan: its n-tiles per warp
KernelFn kernel_for(const Shape& s) {
  if (s.ntw == 8) return latency_kernel<8>;
  if (s.ntw == 4) return latency_kernel<4>;
  if (s.ntw == 2) return latency_kernel<2>;
  return latency_kernel<1>;
}

cudaError_t configure(const Shape& s, cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                      int* active) {
  const KernelFn kernel = kernel_for(s);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
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
  return active ? cudaOccupancyMaxActiveClusters(active, kernel, &cfg) : cudaSuccess;
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
// left pending.  info (host, 8 ints) receives the plan: cluster size,
// threads per CTA, dynamic shared memory bytes, the clusters of that size
// the card holds at once, CTAs, key stages, k-splits and the cluster-wide
// exchanges a step (2).
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
  const int plan[kPlanInts] = {s.cs, kThreads, s.smem, pick.active, static_cast<int>(cfg.gridDim.x),
                               s.stages, s.ks, kExchanges};
  for (int k = 0; k < kPlanInts; ++k) info[k] = plan[k];
  err = cudaLaunchKernelEx(&cfg, kernel_for(s), static_cast<const uint32_t*>(acc0),
                           static_cast<const int8_t*>(bk_lat), static_cast<const int32_t*>(a_vhat),
                           static_cast<uint32_t*>(out), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
