#!/usr/bin/env python3
"""Measurements of the PyTorch/CUDA port (``tfhe_tpu_torch``) on one CUDA card.

    python3 scripts/measure_torch.py     # from the root of the checkout
    python3 scripts/measure_torch.py C   # Kernel C's part alone
    python3 scripts/measure_torch.py D   # Kernel D's part alone

At default_128 (seeded keygen, random bit pairs) it measures, with CUDA events:

  * Kernel B (``blind_rotate_fused``) alone, both digit modes, at
    B = 8 .. 2048;
  * the SM clock and power draw while Kernel B runs at B=1024 (fusedb),
    sampled by ``nvidia-smi`` every 100 ms, and from them the clocks per
    int8 ``mma.sync`` m16n8k32 per busy SM sub-partition;
  * Kernel C (``blind_rotate_latency``) alone at B = 1 .. 8 (V=1) and
    B = 1 .. 4 (V=3) under the plan it picks and under every cluster size
    it takes (``CLUSTERS_C``); the SM clock while it runs at B=1, and from it the clocks
    per m16n8k32 per sub-partition; its mma and key byte counts
    (``kernel_c_counted``), the SM clocks of each phase of its step
    (``kernel_c_phase_clocks``) and where its time goes (``CUTS_C``: copies
    with no contraction, the contraction alone, the mma loop alone, no key
    loads, no digit phase, no reduction of the partial deltas or copy of the
    sums into the replicas, the step's frame alone, the key stream alone as
    it is and with every CTA taking in every key column, and 16 consumer
    warps) at [V=1, B=1], [V=1, B=8] and [V=3, B=4] (``kernel_c_report``);
  * the NTT key forms (``with_ntt_key``, ``with_ntt_lhs_key``): seconds and
    peak device memory;
  * Kernel D (``blind_rotate_nttf``) alone at B = 8 .. 2048, with its launch
    plan; the SM clock while it runs at B=1024, and from them the
    m16n8k32 per clock per busy SM; its mma count, the key bytes a CTA
    takes in and the key bytes read from L2 per gate, counted by a copy
    of the kernel (``kernel_d_counted``); the SM clocks of each
    phase of its step (``kernel_d_phase_clocks``) at B=1024 and at B=64;
    and where its time goes (``kernel_d_cuts``: copies with the forward,
    the contraction or the inverse alone, the key loads alone, no key
    loads, no exchange between the CTAs of a cluster or no reductions,
    ``CUTS_D``, at B=64 and at B=1024, and there the picked plan against
    others, ``PLANS_D``, a cluster of 1 among them; ``kernel_d_report``);
  * Kernels E, F and G (``blind_rotate_fused_pipe``, ``_wide_pipe``,
    ``_cols``) alone at B = 8 .. 2048 and Kernel B at key_limbs=3 at
    B=1024, with their launch plans;
  * where the time of Kernels B, E, F and G goes at B=1024: each kernel
    built again with its plane build, its row barrier, its digit phase, (F)
    the digit builds it runs under the next column's mmas, (G) its gather or
    (E) its producers' work, its consumers' mmas or their waits cut out of a
    copy of its sources (``CUTS``), and E with 2 or 8 producer warps in
    place of 4, timed in turns with the whole kernel;
  * one NAND gate per impl: fusedb, fused and nttf at B=1024, auto (Kernel A)
    at B=64 and B=1024, conv (Kernel H) and matmul (plain) at B=64, the
    small-batch impls fusedl, bmmpl, bmmp and fusedb at B <= 64, and nttf,
    ntt and ntts at B=64;
  * the device busy time of one fusedb and one nttf gate (B=1024), one
    auto, conv and bmmp gate (B=64) and one fusedl gate (B=1) from
    ``torch.profiler``, with the kernels that took the most of it.

The contraction kernels A and H are timed beside their library call by
``chip_smoke.py`` phase 4, with ``graph_ms`` below.  Every round's
milliseconds are kept unrounded.  The results go to
``chiprun_out/measure_torch.json`` and, as one JSON line, to the end of the
standard output.  It imports neither JAX nor ``tfhe_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "measure_torch.json"
KERNEL_B_BATCHES = (8, 64, 256, 512, 1024, 2048)
GATES = (("fusedb", 1024), ("fused", 1024), ("auto", 64), ("auto", 1024), ("conv", 64),
         ("matmul", 64),
         ("fusedl", 1), ("fusedl", 8), ("bmmpl", 1), ("bmmpl", 4), ("bmmp", 64),
         ("fusedb", 1), ("fusedb", 8), ("nttf", 1024), ("nttf", 64), ("ntt", 64), ("ntts", 64),
         ("fusedb3", 1024), ("fusedp", 1024), ("fusedwb", 1024), ("fusedc", 1024))
#: the whole-scan schedule kernels swept over KERNEL_B_BATCHES: name, wrapper
#: and options
SCHEDULES = (("kernelE_fusedp", "blind_rotate_fused_pipe", {}),
             ("kernelF_fusedwb", "blind_rotate_fused_wide_pipe", {"balanced": True}),
             ("kernelG_fusedc", "blind_rotate_fused_cols", {}))
PROFILED = (("fusedb", 1024), ("fusedb3", 1024), ("nttf", 1024), ("auto", 64), ("conv", 64),
            ("bmmp", 64), ("fusedl", 1))
#: The phases of the tensor-core whole-scan kernels B, E, F and G, cut out
#: of copies of their sources (the kernel's .cu and the shared csrc/*.cuh) to
#: time what each costs: kernel -> cut name -> (text, replacement) pairs,
#: each text found once in those sources.  A cut kernel's results are wrong
#: and only its time is read, but for EXACT_CUTS, which must equal the
#: whole kernel's.
_NO_BUILD = ("if (j0 == 0 && next.graw != nullptr)", "if (false)")  # mma_row.cuh
_NO_BARRIER = ("        cp_async_commit_wait();\n        __syncthreads();\n",
               "        cp_async_commit_wait();\n")  # B's, F's and G's unit barrier
_NO_DIGITS = ("      whole_scan::rotate_decompose(",
              "      if (idx < 0) whole_scan::rotate_decompose(")
_NO_PIPELINED_DIGITS = ("units),\n                      next_digits);", "units));")  # F's in-unit builds
_NO_GATHER = ("      reinterpret_cast<uint4*>(dig + pp * blk)[v] =",
              "      if (idx < 0) reinterpret_cast<uint4*>(dig + pp * blk)[v] =")
# Kernel E: its producers' plane build and digit jobs, its consumers' mmas,
# their waits for the planes and the producers' row loop; its producer warps
# (2: no setmaxnreg, 320 threads; 8: two warpgroups, 512 threads)
_E_NO_BUILD = ("build_kept_planes<L>(graw + (q & 1) * N",
               "if (false) build_kept_planes<L>(graw + (q & 1) * N")
_E_NO_DIGITS = ("digits(st, p, (u - lo) * chunk", "if (false) digits(st, p, (u - lo) * chunk")
_E_NO_MMA = ("mma_row<L, T>(sums, planes + b * ps",
             "if (false) mma_row<L, T>(sums, planes + b * ps")
_E_NO_WAIT = ("mbar_wait(full + b, ", "if (false) mbar_wait(full + b, ")
_E_NO_PRODUCERS = ("for (int u = 0; u < units; ++u) {", "for (int u = 0; u < 0; ++u) {")
_E_PRODUCERS = {n: ("constexpr int kProducerWarps = 4;", f"constexpr int kProducerWarps = {n};")
                for n in (2, 8)}
CUTS = {
    "B": {"no plane build": (_NO_BUILD,),
          "no plane build, no row barrier": (_NO_BUILD, _NO_BARRIER),
          "no digit phase": (_NO_DIGITS,),
          "mma loop alone": (_NO_BUILD, _NO_BARRIER, _NO_DIGITS)},
    "F": {"no plane build": (_NO_BUILD,),
          "no digit phase": (_NO_DIGITS,),
          "no pipelined digits": (_NO_PIPELINED_DIGITS,),
          "mma loop alone": (_NO_BUILD, _NO_BARRIER, _NO_DIGITS)},
    "G": {"no plane build": (_NO_BUILD,),
          "no digit phase": (_NO_DIGITS,),
          "no gather": (_NO_GATHER,),
          "mma loop alone": (_NO_BUILD, _NO_BARRIER, _NO_DIGITS, _NO_GATHER)},
    "E": {"no plane build": (_E_NO_BUILD,),
          "no digit work": (_E_NO_DIGITS,),
          "no producer work": (_E_NO_BUILD, _E_NO_DIGITS),
          "producers alone": (_E_NO_MMA,),
          "mma loop alone": (_E_NO_WAIT, _E_NO_PRODUCERS),
          "2 producer warps": (_E_PRODUCERS[2],),
          "8 producer warps": (_E_PRODUCERS[8],)},
}
EXACT_CUTS = {("E", "2 producer warps"), ("E", "8 producer warps")}
# Kernel D (csrc/ntt_kernel.cu): its forward, contraction and inverse (each
# cut with the exchange of what it makes), the key stream, the exchange
# between the CTAs of a cluster and the reductions.  Each cut keeps the
# digit phase and the cluster's other handshakes.
_D_NO_FORWARD = (
    ("  const int gid = lane >> 2, tig = lane & 3, RN2p = s.RN2p, ntl = S * RN2p / 8;",
     "  return;\n  const int gid = lane >> 2, tig = lane & 3, RN2p = s.RN2p, ntl = S * RN2p / 8;"),
    ("        exchange(dh_out, NP * s.blk_dh,", "        if (false) exchange(dh_out, NP * s.blk_dh,"))
_D_NO_CONTRACT = (
    ("  const int gid = lane >> 2, tig = lane & 3, RN2 = s.RN2, RN2p = s.RN2p, CLN2 = s.CLN2;",
     "  return;\n  const int gid = lane >> 2, tig = lane & 3, RN2 = s.RN2, RN2p = s.RN2p, "
     "CLN2 = s.CLN2;"),
    ("        exchange(ch_out, NP * s.blk_ch,", "        if (false) exchange(ch_out, NP * s.blk_ch,"))
_D_NO_INVERSE = (("  const int gid = lane >> 2, tig = lane & 3;\n",
                  "  return;\n  const int gid = lane >> 2, tig = lane & 3;\n"),)
_D_NO_KEYS = (("    if (lane == 0) produce(s, bk, keys, full, consumed);", ""),
              ("              mbar_wait(full + kb, kpar);\n", ""))
_D_NO_EXCHANGE = (("      fence_proxy_async();  // the consumers' writes of `sent`",
                   "      return;\n      fence_proxy_async();  // the consumers' writes of `sent`"),)
_D_NO_REDUCE = (("  int r = x % P;  // in (-P, P), with the sign of x",
                 "  return x;\n  int r = x % P;  // in (-P, P), with the sign of x"),)
CUTS_D = {"forward only": _D_NO_CONTRACT + _D_NO_INVERSE,
          "contraction only": _D_NO_FORWARD + _D_NO_INVERSE,
          "inverse only": _D_NO_FORWARD + _D_NO_CONTRACT,
          "key loads with no mma": _D_NO_FORWARD + _D_NO_CONTRACT + _D_NO_INVERSE,
          "no key loads": _D_NO_KEYS,
          "no exchange": _D_NO_EXCHANGE,
          "no reductions": _D_NO_REDUCE}
#: Kernel D's plans timed beside the picked one at B=1024, (1, 8): (samples
#: per CTA, split); (1, 1) is a cluster of 1 (every CTA takes in the whole
#: key), and 2 samples per CTA take their key slices in chunks of m-tiles
PLANS_D = ((1, 1), (1, 4), (2, 8))
#: Kernel D with phase timers: thread 0 of CTA 0 sums clock64() over each
#: phase of a step (PHASES_D, in order; with one CRT prime a pass, both passes) and
#: writes the sums over its first outputs, which are then wrong
PHASES_D = ("step start", "digits", "forward", "Dh exchange", "contraction", "Ch exchange",
            "inverse + lift")


def _before(anchor: str, text: str) -> tuple[str, str]:
    return anchor, text + anchor


def _after(anchor: str, text: str) -> tuple[str, str]:
    return anchor, anchor + text


_D_TIMERS = (
    _after("    int kb = 0, kpar = 0;  // the key stage to consume next, and its phase parity\n",
           "    long long clocks[7] = {}, last = clock64();\n"
           "    auto tick = [&](int phase) {\n"
           "      if (tid == 0) {\n"
           "        const long long now = clock64();\n"
           "        clocks[phase] += now - last;\n"
           "        last = now;\n"
           "      }\n"
           "    };\n"),
    _before("      // digits: rows (sample, r*N2 + j1)", "      tick(0);\n"),
    _before("        forward<S, NP, P0>(s, frags, dig, dh_out, warp, lane);", "        tick(1);\n"),
    _before("        exchange(dh_out, NP * s.blk_dh,", "        tick(2);\n"),
    _before("        uint32_t ph[NP][kMaxOwned]", "        tick(3);\n"),
    _before("        exchange(ch_out, NP * s.blk_ch,", "        tick(4);\n"),
    _before("        inverse<S, L, NP, P0>(s, frags, ch, r1, acc, warp, lane);", "        tick(5);\n"),
    _after("        if (tid == 0) bulk_commit_wait_read();\n        bar_consumers();\n",
           "        tick(6);\n"),
    _after("      out[static_cast<size_t>(b0) * CN + idx] = acc[idx];\n",
           "    if (tid == 0 && blockIdx.x == 0)\n"
           "      for (int k = 0; k < 7; ++k) {\n"
           "        out[2 * k] = static_cast<uint32_t>(clocks[k]);\n"
           "        out[2 * k + 1] = static_cast<uint32_t>(clocks[k] >> 32);\n"
           "      }\n"))
#: Kernel D with counters: the warp-wide m16n8k32 and m16n8k16 mma.sync it
#: issues and the key bytes its producers' bulk copies read, summed over
#: the launch in device memory and read back by tfhe_kernel_counts
_D_COUNTERS = (
    _after("constexpr int kBarConsumers = 1;  // named barrier (0 is __syncthreads)\n",
           "__device__ unsigned long long g_counts[3];\n"),
    _after("                                      uint32_t a3, uint32_t b0, uint32_t b1) {\n",
           "  if ((threadIdx.x & 31) == 0) atomicAdd(&g_counts[0], 1ull);\n"),
    _after("__device__ __forceinline__ void mma16(int (&c)[4], uint32_t a0, uint32_t a1, "
           "uint32_t b0) {\n",
           "  if ((threadIdx.x & 31) == 0) atomicAdd(&g_counts[1], 1ull);\n"),
    _after("__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, "
           "uint64_t* bar) {\n",
           "  atomicAdd(&g_counts[2], static_cast<unsigned long long>(bytes));\n"),
    _before("const char* tfhe_cuda_error_string(int err) {",
            "int tfhe_kernel_counts(unsigned long long* host, int reset) {\n"
            "  cudaError_t err = cudaMemcpyFromSymbol(host, g_counts, sizeof(g_counts));\n"
            "  const unsigned long long zero[3] = {};\n"
            "  if (err == cudaSuccess && reset)\n"
            "    err = cudaMemcpyToSymbol(g_counts, zero, sizeof(zero));\n"
            "  return static_cast<int>(err);\n"
            "}\n\n"))
# Kernel C (csrc/latency_kernel.cu): its contraction (the mma loop; the key
# stage still arrives and is released), its digit phase, its two exchanges
# between the CTAs of a cluster (the partial deltas reduced into each
# owner's sums, stored locally instead; the sums copied into every replica)
# and its key stream (no copies, no waits for them), each cut from a copy of
# its source; the key
# stream alone, as it is and with every CTA taking in all of a step's key
# columns (as a CTA that contracts all of them must); and 16 consumer warps
# in place of 8, or 16 or 4 n-tiles a warp, which must give the same bits.
_C_NO_MMA = ("        for (int qa = q_lo; qa < q_hi;) {", "        for (int qa = q_lo; qa < q_lo;) {")
_C_NO_DIGITS = (("  for (int base = tid; base < jobs; base += kIlp * kConsumers) {",
                 "  for (int base = tid; base < 0; base += kIlp * kConsumers) {"),)
_C_NO_ALL_GATHER = (
    ("        if (tid == 0) mbar_expect(acc_ready, s.cs * items * 4);  // every slice\n",
     "        if (false) mbar_expect(acc_ready, s.cs * items * 4);\n"),
    ("        for (int job = tid; job < s.cs * chunks; job += kConsumers) {",
     "        for (int job = tid; job < 0; job += kConsumers) {"),
    ("      if (step > 0) mbar_wait_cluster(acc_ready, (step - 1) & 1);\n", ""))
_C_NO_PARTIALS_EXCHANGE = (
    ("            red_async_add(cluster_addr(sums_s + c * nj + (j & (nj - 1)), o), sum + self,\n"
     "                          cluster_addr(delta_ready, o));\n",
     "            sums_s[c * nj + (j & (nj - 1))] = sum + self;\n"),
    ("      if (tid == 0) mbar_expect(delta_ready, s.cs * s.ks * items * 4);",
     "      if (false) mbar_expect(delta_ready, s.cs * s.ks * items * 4);"),
    ("      mbar_wait_cluster(delta_ready, step & 1);\n", ""))
_C_NO_KEYS = (("    if (lane == 0) produce(", "    if (false) produce("),
              ("      mbar_wait(full + slot, (step / s.stages) & 1);\n", ""))
_C_KEYS_ALONE = (*_C_NO_DIGITS, *_C_NO_ALL_GATHER, *_C_NO_PARTIALS_EXCHANGE, _C_NO_MMA)
_C_MMA_ALONE = (*_C_NO_DIGITS, *_C_NO_ALL_GATHER, *_C_NO_PARTIALS_EXCHANGE, *_C_NO_KEYS)
CUTS_C = {"no contraction": (_C_NO_MMA,),
          "contraction only": (*_C_NO_DIGITS, *_C_NO_ALL_GATHER, *_C_NO_PARTIALS_EXCHANGE),
          "mma loop alone": _C_MMA_ALONE,
          "no key loads": _C_NO_KEYS,
          "no digit phase": _C_NO_DIGITS,
          "no slice all-gather": _C_NO_ALL_GATHER,
          "no partials exchange": _C_NO_PARTIALS_EXCHANGE,
          "step frame alone": (*_C_KEYS_ALONE, *_C_NO_KEYS),
          "key stream alone": _C_KEYS_ALONE,
          "key stream alone, every key column": (*_C_KEYS_ALONE, (
              "  s.kw = 8 * s.cpc;", "  s.kw = 8 * s.cpc * s.cs;"), (
              " + rank * s.kw * 4;", ";")),
          "mma loop alone, no window loads": (*_C_MMA_ALONE, (
              "              v[k] = word(jd - t0);\n              v[k + 1] = word(jd - t0 - 4);\n",
              "")),
          "mma loop alone, no A loads": (*_C_MMA_ALONE, (
              "              load_a(next, q + u + 1 < qb ? q + u + 1 : q + u);\n", ""), (
              "              for (int r = 0; r < 4; ++r) a[r] = next[r];\n", "")),
          "mma loop alone, loads with no mma": (*_C_MMA_ALONE, (
              "                limb_planes::mma_s8(acc_c[n], a, v[k], v[k + 1]);",
              "                acc_c[n][0] ^= v[k] + v[k + 1] + a[n & 3];")),
          "16 consumer warps": (("constexpr int kWarps = 8;  // consumer warps",
                                 "constexpr int kWarps = 16;  // consumer warps"),),
          "16 n-tiles a warp": (
              ("constexpr int kMaxNtw = 8; ", "constexpr int kMaxNtw = 16;"),
              ("  s.ntw = tiles / kWarps;", "  s.ntw = 2 * tiles / kWarps;"),
              ("  if (s.ntw == 8) return latency_kernel<8>;",
               "  if (s.ntw == 16) return latency_kernel<16>;\n"
               "  if (s.ntw == 8) return latency_kernel<8>;")),
          "4 n-tiles a warp": (("  s.ntw = tiles / kWarps;", "  s.ntw = tiles / kWarps / 2;"),)}
EXACT_CUTS_C = {"16 consumer warps", "16 n-tiles a warp", "4 n-tiles a warp"}
#: Kernel C's cluster sizes timed beside the picked one; those a shape does
#: not fit are refused and skipped
CLUSTERS_C = (16, 8, 4, 2, 1)
#: Kernel C with phase timers: thread 0 of CTA 0 sums clock64() over each
#: phase of a step (PHASES_C, in order: the wait for every slice of the
#: step's accumulator, the digit phase, the consumers' barrier after it and
#: zeroing the sums of two steps later, the wait for the key stage, the mma loop, the recombination and the
#: reductions of the partials, the wait for every CTA's partials, the copy of
#: the sums into every replica) and writes the sums over its
#: first outputs, which are then wrong
PHASES_C = ("wait for the slices", "digit phase", "digit barrier", "key wait", "mma loop",
            "recombination", "partials exchange", "slice all-gather")
_C_TIMERS = (
    _after("  const int b = blockIdx.x / s.cs;  // the cluster's sample\n",
           "  long long clocks[8] = {}, last = clock64();\n"
           "  auto tick = [&](int phase) {\n"
           "    if (tid == 0) {\n"
           "      const long long now = clock64();\n"
           "      clocks[phase] += now - last;\n"
           "      last = now;\n"
           "    }\n"
           "  };\n"),
    _after("      if (step > 0) mbar_wait_cluster(acc_ready, (step - 1) & 1);\n", "      tick(0);\n"),
    _after(", g_lo, r0, r1, ex, at, dig);\n", "      tick(1);\n"),
    _before("      // the contraction of this step's key stage\n", "      tick(2);\n"),
    _after("      const uint32_t* st = key_w + slot * stage_words;\n", "      tick(3);\n"),
    _before("        // rows (c, l) = 4c + l of one column sit on lanes 4 apart: recombine\n",
            "        tick(4);\n"),
    _before("      // this also orders every CTA's reads of this step's replica", "      tick(5);\n"),
    _after("      mbar_wait_cluster(delta_ready, step & 1);\n", "      tick(6);\n"),
    _after("                      cluster_addr(acc_ready, d));\n        }\n      }\n", "      tick(7);\n"),
    _after("    out[static_cast<size_t>(b) * CN + (c << s.lgN) + rank * nj + jl] = result[it];\n"
           "  }\n",
           "  __syncthreads();\n"
           "  if (tid == 0 && blockIdx.x == 0)\n"
           "    for (int k = 0; k < 8; ++k) {\n"
           "      out[2 * k] = static_cast<uint32_t>(clocks[k]);\n"
           "      out[2 * k + 1] = static_cast<uint32_t>(clocks[k] >> 32);\n"
           "    }\n"))
#: Kernel C with counters, in Kernel D's slots 0 and 2 (read back by the
#: same tfhe_kernel_counts): the warp-wide m16n8k32 mma.sync it issues and
#: the key bytes its copies read, summed over the launch
_C_COUNTERS = (
    _after("constexpr int kPlanInts = 8;\n", "__device__ unsigned long long g_counts[3];\n"),
    _before("#pragma unroll\n              for (int n = 0; n < NTW; ++n) {\n"
            "                const int k = (2 * n - 2 * u) & (2 * NTW - 1);",
            "              if (lane == 0) atomicAdd(&g_counts[0], 1ull * NTW);\n"),
    _before("#pragma unroll\n            for (int n = 0; n < NTW; ++n) limb_planes::mma_s8(",
            "            if (lane == 0) atomicAdd(&g_counts[0], 1ull * NTW);\n"),
    ("      bulk_copy(dst + r * s.kws * 4,",
     "      atomicAdd(&g_counts[2], 4ull * s.kw), bulk_copy(dst + r * s.kws * 4,"),
    _D_COUNTERS[-1])
SUBPARTITIONS_PER_SM = 4  # each with its own tensor core


def log(msg: str) -> None:
    print(msg, flush=True)


def event_rounds(fn, rounds: int) -> list[float]:
    """Device ms of ``fn()`` in each of ``rounds`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def sampled_clocks(fn, calls: int) -> tuple[float, list[tuple[float, float]]]:
    """Mean device ms per call of ``fn()`` over ``calls`` calls back to back,
    and the (SM MHz, W) samples nvidia-smi took meanwhile: the port's
    ``tfhe_tpu_torch/utils/profiling.py:sampled_clocks``."""
    from tfhe_tpu_torch.utils.profiling import sampled_clocks as sample

    return sample(fn, calls)


def graph_ms(fn, launches: int, clocks: bool = True) -> tuple[float, list[tuple[float, float]]]:
    """Device ms per call of ``fn()``: ``launches`` calls captured in one CUDA
    graph, replayed back to back for at least ~0.3 s, with the SM clock
    sampled meanwhile (``sampled_clocks``) unless ``clocks`` is false.  A
    graph keeps the host's per-call cost, which is larger than a
    contraction kernel's device time at B=64, out of the measurement.
    Returns the ms and the clock samples."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    per_replay = sum(event_rounds(graph.replay, 3)) / 3
    calls = max(3, int(300 / per_replay) + 1)
    if clocks:
        ms, samples = sampled_clocks(graph.replay, calls)
    else:
        ms, samples = sum(event_rounds(graph.replay, calls)) / calls, []
    del graph
    return ms / launches, samples


def device_busy(fn) -> tuple[float, list[tuple[str, float, int]]]:
    """Device ms summed over all kernels of one ``fn()`` under
    ``torch.profiler``, and the eight kernels that took the most."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(k.key, k.self_device_time_total / 1e3, k.count) for k in prof.key_averages()
            if k.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:8]


def int8_products_per_sample_step(p) -> int:
    """Kernel D's int8 multiply-adds per sample and step as the TPU kernel
    formulates them: per prime, the forward transforms (2 byte planes of the
    table against 1-byte digits), the per-bin contraction and the inverse
    transforms (4 byte-plane products each)."""
    from tfhe_tpu_torch.ops import ntt

    plan = ntt.plan_for_params(p)
    k1 = p.glwe_dimension + 1
    rn2 = k1 * p.pbs_decomposer.levels * plan.n2
    cln2 = k1 * plan.key_limbs * plan.n2
    n1 = plan.n1
    return len(ntt.PRIMES) * (2 * rn2 * n1 * n1 + 4 * n1 * cln2 * rn2 + 4 * cln2 * n1 * n1)


def kernel_d_counted(nttk, p, acc0, bk_lhs, a_hat) -> dict:
    """Kernel D built with counters (``_D_COUNTERS``) and run once on these
    inputs under the plan it picks: the m16n8k32 and m16n8k16 ``mma.sync``
    it issues per CTA and step, the key bytes a CTA takes in per step, and
    the key bytes all CTAs read from L2 per step.  The counts do not depend
    on the data, so a few steps of the key serve."""
    import ctypes

    counted = build_cut(nttk.KERNEL, "D", "counters", _D_COUNTERS)
    read = counted._lib.tfhe_kernel_counts
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    host = (ctypes.c_ulonglong * 3)()
    whole = nttk.KERNEL
    try:
        nttk.KERNEL = counted
        with torch.cuda.device(acc0.device):
            torch.cuda.synchronize()
            if read(host, 1):
                raise RuntimeError("reading Kernel D's counters failed")
            nttk.blind_rotate_nttf(p, acc0, bk_lhs, a_hat)
            torch.cuda.synchronize()
            if read(host, 1):
                raise RuntimeError("reading Kernel D's counters failed")
    finally:
        nttk.KERNEL = whole
    plan = dict(nttk.last_plan)
    steps = bk_lhs.shape[0]
    per = plan["ctas"] * steps
    return {"plan": plan, "steps": steps, "mma_m16n8k32_per_cta_step": host[0] / per,
            "mma_m16n8k16_per_cta_step": host[1] / per, "key_bytes_per_cta_step": host[2] / per,
            "l2_key_bytes_per_step": host[2] / steps}


def cut_sources(kernel, tag: str, name: str, pairs) -> dict[str, str]:
    """``kernel``'s sources (its .cu and every csrc/*.cuh), file name ->
    text, with each (text, replacement) of ``pairs`` made; raises unless
    each text is in them exactly once."""
    from tfhe_tpu_torch.ops.cuda import _build

    srcs = {f.name: f.read_text() for f in [_build.CSRC / f"{kernel.source}.cu",
                                            *sorted(_build.CSRC.glob("*.cuh"))]}
    for old, new in pairs:
        where = [f for f, text in srcs.items() if old in text]
        if len(where) != 1 or srcs[where[0]].count(old) != 1:
            raise RuntimeError(f"cut {tag} {name!r}: {old!r} is not in the sources once")
        srcs[where[0]] = srcs[where[0]].replace(old, new)
    return srcs


def build_cut(kernel, tag: str, name: str, pairs) -> "CudaKernel":
    """A copy of ``kernel``'s sources with each (text, replacement) of
    ``pairs`` made (``cut_sources``), built into
    build/tfhe_tpu_torch/kernel_cuts/ and loaded; its ptxas report is kept."""
    import ctypes

    from tfhe_tpu_torch.ops.cuda import _build

    srcs = cut_sources(kernel, tag, name, pairs)
    cut_dir = _build.BUILD_DIR / "kernel_cuts" / f"{tag}_{name.replace(' ', '_').replace(',', '')}"
    cut_dir.mkdir(parents=True, exist_ok=True)
    for f, text in srcs.items():
        (cut_dir / f).write_text(text)
    lib = cut_dir / f"lib{kernel.source}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(cut_dir / f"{kernel.source}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the cut {tag} {name!r}:\n{proc.stderr}")
    cut = _build.CudaKernel(kernel.source, kernel.symbol, kernel.argtypes)
    cut.ptxas_report = proc.stderr
    cut._lib = ctypes.CDLL(str(lib))
    cut._fn = getattr(cut._lib, cut.symbol)
    cut._fn.argtypes, cut._fn.restype = cut.argtypes, ctypes.c_int
    cut._lib.tfhe_cuda_error_string.argtypes = [ctypes.c_int]
    cut._lib.tfhe_cuda_error_string.restype = ctypes.c_char_p
    return cut


def kernel_d_phase_clocks(nttk, p, acc0, bk_lhs, a_hat, plan=(0, 0)) -> dict:
    """Kernel D built with phase timers (``_D_TIMERS``: thread 0 of CTA 0 sums
    clock64() over each phase of a step, PHASES_D) under ``plan``: SM clocks
    per step of each phase.  Its results are wrong; only the clocks are read."""
    timed = build_cut(nttk.KERNEL, "D", "phase timers", _D_TIMERS)
    whole = nttk.KERNEL
    try:
        nttk.KERNEL = timed
        out = nttk.blind_rotate_nttf(p, acc0, bk_lhs, a_hat, plan)
    finally:
        nttk.KERNEL = whole
    w = out.reshape(-1)[:2 * len(PHASES_D)].cpu().numpy().astype(np.uint32).astype(np.int64)
    steps = bk_lhs.shape[0]
    return {name: float(lo + (hi << 32)) / steps
            for name, lo, hi in zip(PHASES_D, w[0::2], w[1::2])}


def kernel_d_cuts(nttk, p, acc0, bk_lhs, a_hat, plans) -> dict:
    """The ms of Kernel D with each of CUTS_D (copies built all at once) and
    under each of ``plans`` (samples per CTA, split), in turns with the whole kernel (whole, cuts, plans, whole),
    2 rounds each.  A cut kernel's results are wrong and only its time is
    read; each plan's result is held equal to the whole kernel's."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(CUTS_D)) as pool:
        built = dict(zip(CUTS_D, pool.map(
            lambda name: build_cut(nttk.KERNEL, "D", name, CUTS_D[name]), CUTS_D)))
    res = {f"D {name} ptxas": [ln.strip() for ln in cut.ptxas_report.splitlines()
                               if "registers" in ln or "spill" in ln]
           for name, cut in built.items()}
    whole = nttk.KERNEL
    want = nttk.blind_rotate_nttf(p, acc0, bk_lhs, a_hat)
    res["D plan"] = dict(nttk.last_plan)
    try:
        runs = [("whole", (0, 0)), *((name, (0, 0)) for name in built),
                *((f"plan {pl}", pl) for pl in plans), ("whole", (0, 0))]
        for name, plan in runs:
            nttk.KERNEL = built.get(name, whole)
            t = event_rounds(lambda: nttk.blind_rotate_nttf(p, acc0, bk_lhs, a_hat, plan), 2)
            res.setdefault(f"D {name}", []).extend(t)
            log(f"Kernel D B={acc0.shape[0]}, {name}: ms {t}, plan {nttk.last_plan}")
            if name.startswith("plan"):
                res[f"D {name} plan"] = dict(nttk.last_plan)
                if not torch.equal(nttk.blind_rotate_nttf(p, acc0, bk_lhs, a_hat, plan), want):
                    raise RuntimeError(f"Kernel D under {name} differs from the picked plan")
    finally:
        nttk.KERNEL = whole
    return res


def kernel_d_report(nttk, p, sk, rotation_inputs) -> dict:
    """Kernel D (the block-NTT whole scan) alone over the batches, clocked,
    counted, its phases and its cuts (at B=64, the plan of the
    ``d128.gates.b64.nttf`` cell, and at B=1024)."""
    res = {}
    for b in KERNEL_B_BATCHES:
        acc0, a_hat = rotation_inputs(b)
        t = event_rounds(lambda: nttk.blind_rotate_nttf(p, acc0, sk.bk_ntt_lhs, a_hat),
                         3 if b >= 256 else 5)
        res[f"kernelD_B{b}_ms"] = t
        res[f"kernelD_B{b}_plan"] = dict(nttk.last_plan)
        log(f"Kernel D B={b}: ms {t}, plan {nttk.last_plan}")
    acc0, a_hat = rotation_inputs(1024)
    ms, samples = sampled_clocks(
        lambda: nttk.blind_rotate_nttf(p, acc0, sk.bk_ntt_lhs, a_hat), 3)
    if not samples:
        raise RuntimeError("nvidia-smi gave no sample inside the Kernel D window")
    clocks = sorted(x[0] for x in samples)
    # one CTA per SM holds samples_per_cta samples for all steps; B=1024 runs
    # as waves of what the card holds at once.  The mma and key byte counts
    # are those the counting copy of the kernel took on 4 steps of the key.
    plan = dict(nttk.last_plan)
    counts = kernel_d_counted(nttk, p, acc0, sk.bk_ntt_lhs[:4], a_hat[:4])
    counted_plan = counts.pop("plan")
    if any(counted_plan[k] != plan[k] for k in ("samples_per_cta", "split", "ctas")):
        raise RuntimeError("Kernel D's counting copy picked another plan")
    at_once = plan["max_active_clusters"] * plan["split"]
    waves = -(-plan["ctas"] // at_once)
    per_sm = counts["mma_m16n8k32_per_cta_step"] * p.n * waves / (ms / 1e3)
    res["kernelD_B1024_clocked"] = {
        "ms_per_call": ms, "samples_mhz_w": samples, "sm_mhz_min": clocks[0],
        "sm_mhz_max": clocks[-1], "plan": plan, "waves": waves, "counted": counts,
        "l2_key_bytes_per_gate": counts["l2_key_bytes_per_step"] * p.n,
        "mma_m16n8k32_per_s_per_busy_sm": per_sm,
        "clocks_per_mma_per_subpartition_at_max_and_min_clock": [
            c * 1e6 * SUBPARTITIONS_PER_SM / per_sm for c in (clocks[-1], clocks[0])]}
    log(f"Kernel D B=1024 under nvidia-smi: {ms} ms per call, {len(samples)} samples, "
        f"SM clock {clocks[0]}-{clocks[-1]} MHz, plan {plan}, {waves} waves, {counts}, "
        f"{per_sm:.6e} m16n8k32/s per busy SM")
    # where Kernel D's time goes: its phases' clocks, and the cuts and plans
    for b in (1024, 64):
        acc_b, a_b = rotation_inputs(b)
        res[f"kernelD_B{b}_phase_clocks_per_step"] = kernel_d_phase_clocks(
            nttk, p, acc_b, sk.bk_ntt_lhs, a_b)
        log(f"Kernel D B={b} SM clocks per step by phase: "
            f"{res[f'kernelD_B{b}_phase_clocks_per_step']}")
    acc_b, a_b = rotation_inputs(64)
    res["kernelD_B64_cuts_ms"] = kernel_d_cuts(nttk, p, acc_b, sk.bk_ntt_lhs, a_b, ())
    res["kernelD_B1024_cuts_ms"] = kernel_d_cuts(nttk, p, acc0, sk.bk_ntt_lhs, a_hat, PLANS_D)
    return res


def kernel_c_inputs(p, sk, a_hat, v):
    """Kernel C's key and exponents for a gate's mask a_hat: V=1 (fusedl) or
    V=3 (bmmpl, the BMMP exponents of each pair of steps)."""
    from tfhe_tpu_torch.models import bootstrap as mboot

    if v == 1:
        return sk.bk_lat, a_hat[:, None, :].contiguous()
    return sk.bk_bmmp_lat, torch.stack(mboot._bmmp_exponents(p, a_hat), dim=1).contiguous()


def run_with(latk, kernel, fn):
    """``fn()`` with ``kernel`` standing in for Kernel C's library."""
    whole = latk.KERNEL
    try:
        latk.KERNEL = kernel
        return fn()
    finally:
        latk.KERNEL = whole


def kernel_c_counted(latk, p, acc0, key, a_v) -> dict:
    """Kernel C built with counters (``_C_COUNTERS``) and run once on these
    inputs under the plan it picks: the m16n8k32 ``mma.sync`` per CTA and
    step, the key bytes a CTA takes in per step and the key bytes all CTAs
    read per step.  The counts do not depend on the data, so a few
    steps of the key serve."""
    import ctypes

    counted = build_cut(latk.KERNEL, "C", "counters", _C_COUNTERS)
    read = counted._lib.tfhe_kernel_counts
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    host = (ctypes.c_ulonglong * 3)()

    def run():
        torch.cuda.synchronize()
        if read(host, 1):
            raise RuntimeError("reading Kernel C's counters failed")
        latk.blind_rotate_latency(p, acc0, key, a_v)
        torch.cuda.synchronize()
        if read(host, 1):
            raise RuntimeError("reading Kernel C's counters failed")

    run_with(latk, counted, run)
    plan = dict(latk.last_plan)
    steps = key.shape[0]
    per = plan["ctas"] * steps
    return {"plan": plan, "steps": steps, "mma_m16n8k32_per_cta_step": host[0] / per,
            "key_bytes_per_cta_step": host[2] / per,
            "l2_key_bytes_per_step": host[2] / steps}


def kernel_c_phase_clocks(latk, p, acc0, key, a_v) -> dict:
    """Kernel C built with phase timers (``_C_TIMERS``: thread 0 of CTA 0 sums
    clock64() over each phase of a step, PHASES_C): SM clocks per step of
    each phase.  Its results are wrong; only the clocks are read."""
    timed = build_cut(latk.KERNEL, "C", "phase timers", _C_TIMERS)
    out = run_with(latk, timed, lambda: latk.blind_rotate_latency(p, acc0, key, a_v))
    w = out.reshape(-1)[:2 * len(PHASES_C)].cpu().numpy().astype(np.uint32).astype(np.int64)
    return {name: float(lo + (hi << 32)) / key.shape[0]
            for name, lo, hi in zip(PHASES_C, w[0::2], w[1::2])}


def kernel_c_report(latk, p, sk, rotation_inputs) -> dict:
    """Kernel C at default_128: its time at B = 1 .. 8 (V=1) and 1 .. 4 (V=3)
    under the plan it picks and under each of CLUSTERS_C it takes (each held
    equal to the picked plan's result); the SM clock while it runs at
    [V=1, B=1] and from it the clocks per m16n8k32 per sub-partition; its
    counted mma and key bytes, its phase clocks and its cuts (CUTS_C, timed
    in turns with the whole kernel: whole, cuts, whole, 2 rounds each; the
    EXACT_CUTS_C held equal to it) at [V=1, B=1], [V=1, B=8] and [V=3, B=4]."""
    from concurrent.futures import ThreadPoolExecutor

    res = {}
    for v, batches in ((1, range(1, 9)), (3, range(1, 5))):
        for b in batches:
            acc0, a_hat = rotation_inputs(b)
            key, a_v = kernel_c_inputs(p, sk, a_hat, v)
            want = latk.blind_rotate_latency(p, acc0, key, a_v)
            res[f"kernelC_V{v}_B{b}_plan"] = dict(latk.last_plan)
            t = event_rounds(lambda: latk.blind_rotate_latency(p, acc0, key, a_v), 5)
            res[f"kernelC_V{v}_B{b}_ms"] = t
            log(f"Kernel C V={v} B={b}: ms {t}, plan {latk.last_plan}")
            for cs in CLUSTERS_C:
                try:
                    got = latk.blind_rotate_latency(p, acc0, key, a_v, cs)
                except RuntimeError:  # the cluster size does not fit this shape
                    continue
                if not torch.equal(got, want):
                    raise RuntimeError(f"Kernel C in clusters of {cs} differs at V={v} B={b}")
                t = event_rounds(lambda: latk.blind_rotate_latency(p, acc0, key, a_v, cs), 3)
                res[f"kernelC_V{v}_B{b}_cluster{cs}_ms"] = t
                log(f"Kernel C V={v} B={b} cluster {cs}: ms {t}, {latk.last_plan}")
    acc0, a_hat = rotation_inputs(1)
    key, a_v = kernel_c_inputs(p, sk, a_hat, 1)
    ms, samples = sampled_clocks(lambda: latk.blind_rotate_latency(p, acc0, key, a_v), 60)
    if not samples:
        raise RuntimeError("nvidia-smi gave no sample inside the Kernel C window")
    clocks = sorted(x[0] for x in samples)
    counts = kernel_c_counted(latk, p, acc0, key[:4], a_v[:4])
    # each CTA of the one cluster runs on its own SM for all steps
    per_sm = counts["mma_m16n8k32_per_cta_step"] * key.shape[0] / (ms / 1e3)
    res["kernelC_V1_B1_clocked"] = {
        "ms_per_call": ms, "samples_mhz_w": samples, "sm_mhz_min": clocks[0],
        "sm_mhz_max": clocks[-1], "counted": counts, "mma_m16n8k32_per_s_per_busy_sm": per_sm,
        "clocks_per_mma_per_subpartition_at_max_and_min_clock": [
            c * 1e6 * SUBPARTITIONS_PER_SM / per_sm for c in (clocks[-1], clocks[0])]}
    log(f"Kernel C V=1 B=1 under nvidia-smi: {ms} ms per call, {len(samples)} samples, SM clock "
        f"{clocks[0]}-{clocks[-1]} MHz, {counts}, {per_sm:.6e} m16n8k32/s per busy SM")
    with ThreadPoolExecutor(len(CUTS_C)) as pool:
        built = dict(zip(CUTS_C, pool.map(
            lambda name: build_cut(latk.KERNEL, "C", name, CUTS_C[name]), CUTS_C)))
    res.update({f"C {name} ptxas": [ln.strip() for ln in cut.ptxas_report.splitlines()
                                    if "registers" in ln or "spill" in ln]
                for name, cut in built.items()})
    for v, b in ((1, 1), (1, 8), (3, 4)):
        acc0, a_hat = rotation_inputs(b)
        key, a_v = kernel_c_inputs(p, sk, a_hat, v)
        tag = f"kernelC_V{v}_B{b}"
        if (v, b) != (1, 1):
            res[f"{tag}_counted"] = kernel_c_counted(latk, p, acc0, key[:4], a_v[:4])
        res[f"{tag}_phase_clocks_per_step"] = kernel_c_phase_clocks(latk, p, acc0, key, a_v)
        log(f"Kernel C V={v} B={b} SM clocks per step by phase: "
            f"{res[f'{tag}_phase_clocks_per_step']}")
        want = latk.blind_rotate_latency(p, acc0, key, a_v)
        for name in ("whole", *built, "whole"):
            def run():
                return run_with(latk, built.get(name, latk.KERNEL),
                                lambda: latk.blind_rotate_latency(p, acc0, key, a_v))
            try:
                t = event_rounds(run, 2)
            except RuntimeError as err:  # the copy's shared memory does not fit this shape
                res.setdefault(f"{tag}_cuts_ms", {})[name] = str(err)
                log(f"Kernel C V={v} B={b}, {name}: {err}")
                continue
            res.setdefault(f"{tag}_cuts_ms", {}).setdefault(name, []).extend(t)
            log(f"Kernel C V={v} B={b}, {name}: ms {t}, plan {latk.last_plan}")
            if name in EXACT_CUTS_C and not torch.equal(run(), want):
                raise RuntimeError(f"Kernel C with {name!r} differs from the whole kernel")
    return res


def kernel_cuts(brk, p, acc0, bk, a_hat) -> dict:
    """The ms of Kernels B, E, F and G with each of their CUTS (copies built
    into build/tfhe_tpu_torch/kernel_cuts/, all nvcc processes at once), in
    turns with the whole kernel (whole, cuts, whole), 2 rounds each: Kernel
    B at 'fusedb' and 'fusedb3', E at 'fusedp' and 'fusedp3', F at
    'fusedwb', G at 'fusedc'.  Each cut's ptxas report is kept, and each of
    EXACT_CUTS is held equal to the whole kernel."""
    from concurrent.futures import ThreadPoolExecutor

    from tfhe_tpu_torch.ops.decomposer import balanced_offset

    whole = {"B": brk.KERNEL, "E": brk.PIPE_KERNEL, "F": brk.WIDE_PIPE_KERNEL,
             "G": brk.COLS_KERNEL}

    def build(job):
        tag, name = job
        return job, build_cut(whole[tag], tag, name, CUTS[tag][name])

    jobs = [(tag, name) for tag, cuts in CUTS.items() for name in cuts]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(pool.map(build, jobs))
    offset = balanced_offset(p.pbs_decomposer)
    runs = (("B", "fusedb", "fused", (1, offset, 4)), ("B", "fusedb3", "fused", (1, offset, 3)),
            ("E", "fusedp", "pipe", (4,)), ("E", "fusedp3", "pipe", (3,)),
            ("F", "fusedwb", "wide_pipe", (1, offset)), ("G", "fusedc", "cols", (4,)))
    res = {f"{tag} {name} ptxas": [ln.strip() for ln in cut.ptxas_report.splitlines()
                                   if "registers" in ln or "spill" in ln]
           for (tag, name), cut in built.items()}
    for tag, mode, kind, args in runs:
        kernels = {"whole": whole[tag], **{name: built[tag, name] for name in CUTS[tag]}}
        want = brk._launch(whole[tag], kind, p, acc0, bk, a_hat, *args)
        for name in [*kernels, "whole"]:
            def run():
                return brk._launch(kernels[name], kind, p, acc0, bk, a_hat, *args)
            t = event_rounds(run, 2)
            res.setdefault(f"{mode} {name}", []).extend(t)
            log(f"Kernel {tag} {mode} B=1024, {name}: ms {t}")
            if (tag, name) in EXACT_CUTS:
                equal = torch.equal(run(), want)
                res[f"{mode} {name} equals whole"] = equal
                log(f"Kernel {tag} {mode} B=1024, {name}: equal to the whole kernel: {equal}")
                if not equal:
                    raise RuntimeError(f"Kernel {tag} with {name!r} differs from the whole kernel")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("measure_torch: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import tfhe_tpu_torch as tfhe
    from tfhe_tpu_torch.models import bootstrap as mboot
    from tfhe_tpu_torch.models import test_vector as mtv
    from tfhe_tpu_torch.ops.cuda import blind_rotate_kernel as brk
    from tfhe_tpu_torch.ops.cuda import latency_kernel as latk
    from tfhe_tpu_torch.ops.cuda import ntt_kernel as nttk
    from tfhe_tpu_torch.ops.torus import switch_modulus, to_torch_u32

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[torch.cuda.current_device()]
    log(card)
    dev = torch.device("cuda")
    p = tfhe.get_params("default_128")
    ck, sk = tfhe.keygen(p, torch.Generator().manual_seed(0), device=dev, bmmp=True)
    sk = tfhe.with_latency_key(sk)
    only_c, only_d = sys.argv[1:] == ["C"], sys.argv[1:] == ["D"]
    res_keys = {}
    for name, attach in (() if only_c else (("with_ntt_key", tfhe.with_ntt_key),
                                            ("with_ntt_lhs_key", tfhe.with_ntt_lhs_key))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        sk = attach(sk)
        torch.cuda.synchronize()
        res_keys[name] = {"s": time.perf_counter() - t0, "allocated_before_gib": before / 2**30,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"{name}: {res_keys[name]}")
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=(2, max(KERNEL_B_BATCHES)), dtype=np.uint32)
    ca = tfhe.encrypt(ck, bits[0], torch.Generator().manual_seed(1))
    cb = tfhe.encrypt(ck, bits[1], torch.Generator().manual_seed(2))
    tv = to_torch_u32(mtv.gate_test_vector(p, "nand"), dev)
    res = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
           "sms": torch.cuda.get_device_properties(0).multi_processor_count,
           "ntt_keys": res_keys}

    def rotation_inputs(b):
        approx = switch_modulus(cb[:b] * 2 + ca[:b], p.log_q, p.log_degree + 1)
        return mboot._init_acc(p, approx, tv)

    if only_c:
        res.update(kernel_c_report(latk, p, sk, rotation_inputs))
        return write(res)
    if only_d:
        res.update(kernel_d_report(nttk, p, sk, rotation_inputs))
        return write(res)
    for b in KERNEL_B_BATCHES:
        acc0, a_hat = rotation_inputs(b)
        for balanced in (True, False):
            mode = "fusedb" if balanced else "fused"
            t = event_rounds(
                lambda: brk.blind_rotate_fused(p, acc0, sk.bk_u32, a_hat, balanced),
                3 if b >= 256 else 5)
            res[f"kernelB_{mode}_B{b}_ms"] = t
            log(f"Kernel B {mode} B={b}: ms {t}")

    # SM clock during Kernel B: one CTA holds its samples for all steps on one
    # SM, so the mma.sync rate per busy SM is that CTA's m16n8k32 count (one
    # per 16 outputs, 32 input coefficients, row, column and limb, for its 8
    # samples whatever S is) over the kernel's time.
    acc0, a_hat = rotation_inputs(1024)
    ms, samples = sampled_clocks(
        lambda: brk.blind_rotate_fused(p, acc0, sk.bk_u32, a_hat, True), 3)
    k1, n = p.k + 1, p.degree
    mma_per_cta = p.n * (k1 * p.pbs_decomposer.levels) * k1 * 4 * (n // 16) * (n // 32)
    per_sm_rate = mma_per_cta / (ms / 1e3)
    clocked = {"ms_per_call": ms, "samples_mhz_w": samples, "mma_per_s_per_sm": per_sm_rate,
               "plan": dict(brk.last_plan["blind_rotate_fused"])}
    if not samples:
        raise RuntimeError("nvidia-smi gave no sample inside the Kernel B window")
    clocks = sorted(s[0] for s in samples)
    lo, hi = clocks[0], clocks[-1]
    clk_per_mma = [c * 1e6 * SUBPARTITIONS_PER_SM / per_sm_rate for c in (hi, lo)]
    clocked.update(sm_mhz_min=lo, sm_mhz_max=hi, sm_mhz_median=clocks[len(clocks) // 2],
                   power_w_max=max(s[1] for s in samples),
                   clocks_per_mma_per_subpartition_at_max_and_min_clock=clk_per_mma)
    res["kernelB_fusedb_B1024_clocked"] = clocked
    log(f"Kernel B fusedb B=1024 under nvidia-smi: {ms} ms per call, {len(samples)} samples, "
        f"SM clock {lo}-{hi} MHz, power up to {clocked['power_w_max']} W, "
        f"{per_sm_rate:.6e} mma.sync m16n8k32/s per SM, clocks per mma per sub-partition "
        f"{clk_per_mma}")

    res.update(kernel_c_report(latk, p, sk, rotation_inputs))

    res.update(kernel_d_report(nttk, p, sk, rotation_inputs))

    # Kernels E, F and G over the same batches, and Kernel B at key_limbs=3
    for b in KERNEL_B_BATCHES:
        acc0, a_hat = rotation_inputs(b)
        for name, fn, options in SCHEDULES:
            rotate = getattr(brk, fn)
            t = event_rounds(lambda: rotate(p, acc0, sk.bk_u32, a_hat, **options),
                             2 if b >= 256 else 3)
            res[f"{name}_B{b}_ms"] = t
            res[f"{name}_B{b}_plan"] = dict(brk.last_plan[fn])
            log(f"{name} B={b}: ms {t}, plan {brk.last_plan[fn]}")
    acc0, a_hat = rotation_inputs(1024)
    t = event_rounds(lambda: brk.blind_rotate_fused(p, acc0, sk.bk_u32, a_hat, True, 3), 3)
    res["kernelB_fusedb3_B1024_ms"] = t
    log(f"Kernel B fusedb3 (key_limbs=3) B=1024: ms {t}")
    res["kernels_BEFG_B1024_cuts_ms"] = kernel_cuts(brk, p, acc0, sk.bk_u32, a_hat)

    for impl, b in GATES:
        t = event_rounds(lambda: tfhe.gates.nand(sk, ca[:b], cb[:b], impl=impl),
                         1 if impl == "matmul" else 3)
        res[f"gate_{impl}_B{b}_ms"] = t
        log(f"gate {impl} B={b}: ms {t}, {b / (min(t) / 1e3)} gate bootstraps/s (best)")

    for impl, b in PROFILED:
        gate_ms = event_rounds(lambda: tfhe.gates.nand(sk, ca[:b], cb[:b], impl=impl), 1)[0]
        busy_ms, top = device_busy(lambda: tfhe.gates.nand(sk, ca[:b], cb[:b], impl=impl))
        res[f"profile_{impl}_B{b}"] = {"gate_ms": gate_ms, "device_busy_ms": busy_ms,
                                       "idle_share": 1 - busy_ms / gate_ms,
                                       "top": [list(r) for r in top]}
        log(f"profile {impl} B={b}: gate {gate_ms} ms (untraced), device busy {busy_ms} ms")
        for name, t, count in top:
            log(f"    {t:.3f} ms over {count} launches  {name[:80]}")
    return write(res)


def write(res: dict) -> int:
    """Add the peak device memory to ``res``; write it to OUT and, as one
    JSON line, to the standard output."""
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
