// Kernel E: the software-pipelined whole blind rotation in one launch, with
// warp-specialised int8 tensor-core consumers fed by producer warps.
//
// Replaces: tfhe_tpu/ops/pallas/blind_rotate_kernel.py, blind_rotate_fused_pipe
// (body _kernel_pipe): carry-chain digits, key_limbs 4 (exact) or 3 (limb 0
// of each sign-twisted key word dropped).  The step is the one
// whole_scan.cuh writes out; the TPU kernel builds step s+1's digits while
// step s's remaining columns contract.
//
// What bounds it on the H100: int8 tensor-core operations, as for Kernel B:
// R*C*L*N*N multiply-adds per sample and step (L = key_limbs; 42.31 ms for
// B=1024 over 722 steps at default_128 at the 1979e12 ops/s peak).  The sums
// are Kernel B's mma.sync contraction over the int8 limb planes
// (mma_row.cuh).  What Kernel B spends besides, the plane build and the
// digit phase, stops all its warps' mmas (PERF.md); here warps that issue no
// mma do that work.  Their shared-memory traffic still slows the consumers'
// loop, so they keep it small: wide reads, no plane of a dropped limb, one
// 32-bit store per digit row of 4 coefficients.
//
// Design: Kernel B's CTA (S samples for all n steps, their accumulators in
// shared memory, columns one after another, key rows in the order (step, c,
// r)) with its warps in two roles that meet only at mbarriers:
//  - kConsumerWarps consumer warps (the N/(16T) that own outputs; the rest
//    leave at once) run mma_row on each key row's planes and nothing else,
//    and at a column's end add its limb sums to the accumulators;
//  - kProducerWarps producer warps (one warpgroup) bring each key row in two
//    rows ahead by one bulk copy (cp.async.bulk, 4N bytes, completing on an
//    mbarrier), build the limb-plane copies the consumers read
//    (build_kept_planes) into a ring of kPlaneBufs plane buffers, and build
//    the next step's digits of each poly (whole_scan::rotate_decompose4)
//    into Kernel F's ring of 2C-1 poly slots once its column is in the
//    accumulators.
// Digit job (st, p), poly p of step st >= 1, reads accumulator plane p as
// column p of step st-1 left it (the last row of that column is row e) and
// is first read at row f, row p*levels of column 0 of step st.  The
// producers build it in chunks, one per row, over rows e+kPlaneBufs .. f-1
// (at most e+R): a producer that has waited for a free plane buffer at row
// e+kPlaneBufs has seen the consumers finish row e, so it rarely waits for
// the column.  So polys 0..C-2 are built under the next column, and poly C-1
// under the first (C-1)*levels rows of the next step, which read polys
// 0..C-2 only: no digit work is exposed, where the TPU kernel leaves the
// last poly's.  Poly p of step st sits in slot (st*C + p) mod (2C-1); the
// slot it overwrites was last read by a column that is done.  Its last chunk
// is built before row f's planes, so a consumer that has waited for those
// finds its digits complete.
//
// Above N = 512 the circulant runs in Kernel B's 512 x 512 blocks
// (mma_row.cuh): the sequence is one of units (step, c, ob, r, kc), each a
// window of planes in the ring, the consumers' sums of pass (c, ob) stay in
// registers over its R*blocks units, a raw row comes in once per (pass, r)
// and is freed after its last window, and a digit job spreads over the
// units rather than the rows (a column is R*blocks^2 units).
//
// Handshakes, each an mbarrier waited on with its phase parity: plane
// buffer full (producers arrive) and empty (consumers), raw row landed (the
// bulk copy's bytes) and column c in the accumulators (consumers).  A named
// barrier among the producers per row frees the raw row and publishes the
// step's exponents; __syncthreads runs only in the prologue.  The producers
// give up registers (setmaxnreg) so that the consumers keep Kernel B's
// mma_row body (180 registers at L=4) beside them: 384 threads at one CTA
// per SM.  (2 producer warps, 320 threads and no setmaxnreg, or 8, two
// warpgroups, are slower: PERF.md.)  Shared memory: S*C*N u32 accumulators,
// kPlaneBufs plane buffers, two raw rows, the digit ring, the mbarriers and
// the exponents of two steps (230,808 bytes at default_128 with S=8; the
// wrapper picks S in {8, 4, 2, 1} from the card's opt-in budget).

#include <cstdint>
#include <cuda_runtime.h>

#include "limb_planes.cuh"
#include "mma_row.cuh"
#include "whole_scan.cuh"

namespace {

using limb_planes::block_width;
using limb_planes::digit_row_bytes;
using limb_planes::kBlock;
using limb_planes::kMaxDegree;
using limb_planes::mma_row;
using limb_planes::NextPlanes;
using limb_planes::plane_set_words;
using limb_planes::smem_addr;
using limb_planes::tiles_per_warp;
using limb_planes::window_base;
using whole_scan::Shape;

// the consumer warps: N/(16T) own a column's outputs up to N = 512 (T = 4
// tiles of 16; at N=64, 2 warps of T = 2), and a block's 512 outputs above
constexpr int kConsumerWarps = 8;
constexpr int kProducerWarps = 4;  // one warpgroup
constexpr int kConsumers = 32 * kConsumerWarps, kProducers = 32 * kProducerWarps;
constexpr int kThreads = kConsumers + kProducers;
constexpr int kPlaneBufs = 3;
// setmaxnreg's split of the registers a thread starts with (65536 over the
// threads, in steps of 8: 168 of 384): the producers keep few, the
// consumers take the rest (224 with 4 producer warps)
constexpr int kStartRegs = 65536 / kThreads / 8 * 8;
constexpr int kProducerRegs = kProducerWarps == 4 ? 56 : 40;
constexpr int kConsumerRegs =
    (kStartRegs * kThreads - kProducerRegs * kProducers) / kConsumers / 8 * 8;
// named barriers (0 is __syncthreads)
constexpr int kBarConsumers = 1, kBarProducers = 2;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
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

// One thread: `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, counted on `bar` as one arrival that expects them.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__host__ size_t smem_bytes(const Shape& s) {
  const size_t S = s.spc, C = s.C, N = s.N, slot = s.levels * S * digit_row_bytes(s.N);
  return 4 * S * C * N                                                 // accumulators
         + 4 * kPlaneBufs * static_cast<size_t>(plane_set_words(block_width(s.N)))  // planes
         + 4 * 2 * N                                                   // two raw key rows
         + (2 * C - 1) * slot                                          // the digit ring
         + 8 * (2 * kPlaneBufs + 2 + C)  // mbarriers: full and empty, raw rows, columns
         + 4 * 2 * S;                                                  // exponents, by parity
}

// limb_planes::build_window<true> (of bw from base) for the nthr threads
// from tid, of the L kept limbs only (4 - L .. 3, the ones mma_row reads),
// each thread's 7 words ext[j - k] (j = -(base + 4w) mod 2N, base a
// multiple of 4) read as two aligned 16-byte groups and one word rather
// than as 7 words 4 apart across the warp (4-way bank conflicts).
template <int L>
__device__ __forceinline__ void build_kept_planes(const uint32_t* graw, uint32_t* planes, int N,
                                                  int bw, int base, int tid, int nthr) {
  const int cw = limb_planes::copy_words(bw), mask2 = 2 * N - 1;
  auto ext4 = [&](int x) {  // ext[x .. x+3] for x a multiple of 4
    uint4 v = *reinterpret_cast<const uint4*>(graw + (x & (N - 1)));
    if (x >= N) v = make_uint4(0u - v.x, 0u - v.y, 0u - v.z, 0u - v.w);
    return v;
  };
  for (int w = tid; w < bw / 2; w += nthr) {
    const int j = (-(base + 4 * w)) & mask2;
    const uint4 a = ext4((j - 4) & mask2), c = ext4((j - 8) & mask2);
    uint32_t e[7] = {j < N ? graw[j] : 0u - graw[j - N], a.w, a.z, a.y, a.x, c.w, c.z};
#pragma unroll
    for (int k = 0; k < 7; ++k) e[k] = (e[k] + 0x80808080u) ^ 0x80808080u;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      // limb l of e[s + j] -> byte j of limb word l
      const uint32_t lo01 = __byte_perm(e[s], e[s + 1], 0x5140);
      const uint32_t lo23 = __byte_perm(e[s + 2], e[s + 3], 0x5140);
      const uint32_t hi01 = __byte_perm(e[s], e[s + 1], 0x7362);
      const uint32_t hi23 = __byte_perm(e[s + 2], e[s + 3], 0x7362);
      const uint32_t limb[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                                __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
      uint32_t* dst = planes + s * cw + w;
#pragma unroll
      for (int l = 4 - L; l < 4; ++l) {
        dst[l * 4 * cw] = limb[l];
        if (w < 8) dst[l * 4 * cw + bw / 2] = limb[l];  // the wrap copy
      }
    }
  }
}

// Units lo..hi of the (step, c, ob, r, kc) sequence (rows when N <= 512),
// in which the producers build digit job i = st*C + p (poly p of step st
// >= 1): see the header.  A column is U = R*blocks^2 units.
__device__ __forceinline__ void job_rows(int i, int C, int R, int levels, int blocks, int& lo,
                                         int& hi) {
  const int st = i / C, p = i - st * C, U = R * blocks * blocks;
  const int e = ((st - 1) * C + p) * U + U - 1, f = st * C * U + p * levels * blocks;
  hi = min(f - 1, e + U);
  lo = min(e + kPlaneBufs, hi);
}

// L: key limbs kept (4, or 3 with limb 0 dropped); T: tiles_per_warp(N);
// kBlocked: N > kBlock, the circulant in blocks (mma_row.cuh).
template <int L, int T, bool kBlocked>
__global__ void __launch_bounds__(kThreads, 1)
pipe_kernel(const uint32_t* __restrict__ acc0, const uint32_t* __restrict__ bk,
            const int32_t* __restrict__ a_hat, uint32_t* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = s.spc, N = s.N, C = s.C, levels = s.levels, R = C * levels;
  const int CN = C * N, SN = S * N, mask2 = 2 * N - 1;
  // the blocks of a column and of a row, and their width
  const int blocks = kBlocked ? N / kBlock : 1, bw = kBlocked ? kBlock : N;
  const int ps = plane_set_words(bw), drow = digit_row_bytes(N);
  const int blk = levels * S * drow, nslots = 2 * C - 1;
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);                // [S][C][N]
  uint32_t* planes = acc + S * CN;                                   // [kPlaneBufs][16 copies]
  uint32_t* graw = planes + kPlaneBufs * ps;                         // [2][N]
  int8_t* ring = reinterpret_cast<int8_t*>(graw + 2 * N);            // [2C-1][levels][S][drow]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + nslots * blk);  // [kPlaneBufs]
  uint64_t* empty = full + kPlaneBufs;                               // [kPlaneBufs]
  uint64_t* landed = empty + kPlaneBufs;                             // [2] raw rows
  uint64_t* column = landed + 2;                                     // [C]
  int* a_s = reinterpret_cast<int*>(column + C);                     // [2][S] by step parity

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * S;
  const int nb = min(S, s.B - b0);
  const int workers = 32 * (bw / (16 * T));  // the consumer threads that own outputs
  // raw key rows (step, c, ob, r) and units (row, kc)
  const int rows = s.n_steps * C * blocks * R, units = rows * blocks, jobs = s.n_steps * C;

  // the digits of coefficients [lo, hi) (multiples of 4) of the S*N of poly
  // p at step st into its ring slot, 4 per thread of the nthr from t0
  auto digits = [&](int st, int p, int lo, int hi, int t0, int nthr) {
    int8_t* slot = ring + ((st * C + p) % nslots) * blk;
    const int* a = a_s + (st & 1) * S;
    for (int idx = lo + 4 * t0; idx < hi; idx += 4 * nthr) {
      const int bb = idx / N, i = idx - bb * N;
      whole_scan::rotate_decompose4(acc + bb * CN + p * N, i, a[bb], s, slot + bb * drow + i,
                                    S * drow);
    }
  };

  if (tid == 0) {
    for (int b = 0; b < kPlaneBufs; ++b) {
      mbar_init(full + b, kProducers);
      mbar_init(empty + b, workers);
    }
    for (int b = 0; b < 2; ++b) mbar_init(landed + b, 1);
    for (int c = 0; c < C; ++c) mbar_init(column + c, workers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int idx = tid; idx < S * CN; idx += kThreads) {
    const int bb = idx / CN;
    acc[idx] = bb < nb ? acc0[static_cast<size_t>(b0) * CN + idx] : 0u;
  }
  if (tid < S) a_s[tid] = tid < nb ? (a_hat[b0 + tid] & mask2) : 0;
  __syncthreads();
  for (int p = 0; p < C && s.n_steps > 0; ++p) digits(0, p, 0, SN, tid, kThreads);
  __syncthreads();

  if (tid >= kConsumers) {
    // producers: raw rows, planes and the next step's digits
    if constexpr (kProducerWarps % 4 == 0)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    auto load_row = [&](int q) {  // key row q = (step, c, ob, r) into raw row q & 1
      const int r = q % R, step = q / (R * blocks * C), c = (q / (R * blocks)) % C;
      bulk_load(graw + (q & 1) * N, bk + ((static_cast<size_t>(step) * R + r) * C + c) * N,
                4 * N, landed + (q & 1));
    };
    if (pt == 0) {
      if (rows > 0) load_row(0);
      if (rows > 1) load_row(1);
    }
    int job = C, lo = 0, hi = -1;
    if (job < jobs) job_rows(job, C, R, levels, blocks, lo, hi);
    for (int u = 0; u < units; ++u) {
      const int q = u / blocks, kc = u - q * blocks, b = u % kPlaneBufs;
      const int base = window_base<kBlocked>((q / R) % blocks, kc, N);
      if (kc == 0) mbar_wait(landed + (q & 1), (q >> 1) & 1);
      mbar_wait(empty + b, ((u / kPlaneBufs) & 1) ^ 1);  // consumers are past unit u-kPlaneBufs
      build_kept_planes<L>(graw + (q & 1) * N, planes + b * ps, N, bw, base, pt, kProducers);
      mbar_arrive(full + b);
      const bool in_job = job < jobs && u >= lo;
      const int st = job / C, p = job - st * C;
      if (in_job && u == lo && p == 0 && pt < S)  // step st's exponents
        a_s[(st & 1) * S + pt] =
            pt < nb ? (a_hat[static_cast<size_t>(st) * s.B + b0 + pt] & mask2) : 0;
      bar_sync(kBarProducers, kProducers);  // unit u's planes are built; the exponents visible
      if (pt == 0 && kc == blocks - 1 && q + 2 < rows) load_row(q + 2);  // raw row q is read
      if (in_job) {
        if (u == lo) mbar_wait(column + p, (st - 1) & 1);  // plane p holds step st-1's sums
        const int chunk = (SN + 4 * (hi - lo) + 3) / (4 * (hi - lo + 1)) * 4;  // ceil, by 4
        digits(st, p, (u - lo) * chunk, min(SN, (u - lo + 1) * chunk), pt, kProducers);
        if (u == hi && ++job < jobs) job_rows(job, C, R, levels, blocks, lo, hi);
      }
    }
  } else {
    // consumers: the mmas of every row, then each column's sums
    if constexpr (kProducerWarps % 4 == 0)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    if (tid >= workers) return;
    const limb_planes::Lane ln = limb_planes::lane_of<L, T, kBlocked>(N, S);
    int u = 0;
    for (int step = 0; step < s.n_steps; ++step) {
      for (int cb = 0; cb < C * blocks; ++cb) {  // pass: column c, output block ob
        const int c = cb / blocks, ob = cb - c * blocks;
        int sums[L][T][4];
#pragma unroll
        for (int l = 0; l < L; ++l)
#pragma unroll
          for (int a = 0; a < T; ++a)
#pragma unroll
            for (int i = 0; i < 4; ++i) sums[l][a][i] = 0;
        for (int ru = 0; ru < R * blocks; ++ru, ++u) {  // unit: row r, input chunk kc
          const int r = ru / blocks, kc = ru - r * blocks;
          const int p = r / levels, b = u % kPlaneBufs;
          mbar_wait(full + b, (u / kPlaneBufs) & 1);  // and so poly p's digits
          const int8_t* row = ring + ((step * C + p) % nslots) * blk + (r - p * levels) * S * drow;
          mma_row<L, T>(sums, planes + b * ps + ln.copy,
                        reinterpret_cast<const uint32_t*>(row) + ln.dig + kc * (bw / 4), bw,
                        ln.x0 >> 2, NextPlanes{nullptr, nullptr, N, 0});
          mbar_arrive(empty + b);
        }
        limb_planes::add_column<L, T>(sums, acc, CN, c * N + ob * bw, ln, S);
        if (ob == blocks - 1) mbar_arrive(column + c);
      }
    }
    bar_sync(kBarConsumers, workers);
    for (int idx = tid; idx < nb * CN; idx += workers)
      out[static_cast<size_t>(b0) * CN + idx] = acc[idx];
  }
}

template <int L, int T, bool kBlocked>
int launch(const void* acc0, const void* bk, const void* a_hat, void* out, const Shape& s,
           int* info, cudaStream_t stream) {
  const size_t smem = smem_bytes(s);
  if (smem > static_cast<size_t>(whole_scan::smem_optin()))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(pipe_kernel<L, T, kBlocked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = s.spc;
  info[1] = kThreads;
  info[2] = static_cast<int>(smem);
  info[3] = (s.B + s.spc - 1) / s.spc;
  pipe_kernel<L, T, kBlocked><<<info[3], kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(acc0), static_cast<const uint32_t*>(bk),
      static_cast<const int32_t*>(a_hat), static_cast<uint32_t*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// acc0 u32 [B, C, N], bk u32 [n, R, C, N] (canonical rows p*levels + j,
// 16-byte aligned), a_hat int32 [n, B] -> out u32 [B, C, N], carry-chain
// digits, with `spc` samples per CTA.  info (host, 4 ints) receives the
// plan: samples per CTA, threads per CTA, dynamic shared memory bytes and
// CTAs.  Returns cudaErrorInvalidValue unless N is a power of two with 64 <=
// N <= kMaxDegree (Kernel B's tiles and blocks), C >= 1, B >= 1, bk is
// 16-byte aligned,
// key_limbs is 3 or 4, spc is 1, 2, 4 or 8 and the shared memory fits the
// card's opt-in budget.
int blind_rotate_fused_pipe(const void* acc0, const void* bk, const void* a_hat, void* out,
                            int n_steps, int B, int C, int N, int levels, int log_base,
                            int ignored_bits, int key_limbs, int spc, int* info,
                            void* stream) {
  if (N < 64 || N > kMaxDegree || (N & (N - 1)) || C < 1 || B < 1 ||
      reinterpret_cast<uintptr_t>(bk) % 16 || (key_limbs != 3 && key_limbs != 4) ||
      (spc != 1 && spc != 2 && spc != 4 && spc != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{n_steps, B, C, N, levels, log_base, ignored_bits, 0, 0u, key_limbs, spc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N > kBlock)
    return key_limbs == 4 ? launch<4, 4, true>(acc0, bk, a_hat, out, s, info, st)
                          : launch<3, 4, true>(acc0, bk, a_hat, out, s, info, st);
  if (tiles_per_warp(N) == 4)
    return key_limbs == 4 ? launch<4, 4, false>(acc0, bk, a_hat, out, s, info, st)
                          : launch<3, 4, false>(acc0, bk, a_hat, out, s, info, st);
  return key_limbs == 4 ? launch<4, 2, false>(acc0, bk, a_hat, out, s, info, st)
                        : launch<3, 2, false>(acc0, bk, a_hat, out, s, info, st);
}

const char* tfhe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
