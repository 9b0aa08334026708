#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tfhe_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of the checkout, one card

It builds the hand-written kernels from ``tfhe_tpu_torch/csrc/`` (into
``build/tfhe_tpu_torch/``) and then runs seven phases.  It prints the whole
run's seconds at the end.  Each phase raises on
failure, so the script exits nonzero and prints no result line.

  0. require CUDA; print the card, its power limit, torch and CUDA versions;
  1. build the kernels, all nvcc processes at once (one per source, eight),
     with the build seconds and ptxas' resource report, and count the IMMA
     (integer tensor-core) instructions of Kernels A, H, B, E, F, G, C and D
     with ``cuobjdump -sass``: there must be some in each, and Kernels C and
     D must hold no IDP4A (dp4a) instruction;
  2. hold each kernel against its plain PyTorch twin (``torch.equal``) at
     nano, test_insecure and a 16-step slice of the default_128 key (Kernel C
     in both forms: V=1 and the BMMP V=3, also on the worst case, every key
     byte -128 with the largest digits, at large_2048 and large_4096, and
     under every cluster size forced, LAT_CLUSTERS; Kernel D also on an all-ones
     canonical key, the key side of its CRT range at its bound, on every
     byte 0x80 with the largest digits, at large_2048, and under every plan
     instance (samples per CTA, split) forced, NTTF_PLANS; Kernel B in
     its four modes (fused, fusedb, fused3, fusedb3) at B = 1, 3, 7, 8, 9,
     64 and 65, on random keys, keys whose every byte is 0x80 and keys whose
     every low byte is 0x80 (the truncated key's hard case); Kernel B at
     key_limbs=3 and Kernels E, F and G in all their modes, also on keys
     whose every low byte, or every byte, is 0x80; Kernels B, E, F and G
     in every mode at large_2048 (B=9) and large_4096 (B=3), where they run
     the circulant in 512 x 512 blocks, on LARGE_STEPS steps of a random
     key and one whose every byte is 0x80; Kernel H
     at B=1, 7, 64, on a key whose every byte is 0x80, and on one GGSW of
     the default_128 key at B=64 and 1024; Kernels A and H on full-range
     int8 digits at B=1, 7, 17, 64, 65, 1024, at the bmmp scan's 3R rows,
     at large_2048, on all-0x80 keys, with plans forced to no row split
     and to the largest, and with one digit buffer and 2 warps per CTA);
  3. seven paths at default_128 and the large degrees through the public
     API (keygen with the BMMP key, the latency key and both NTT key forms,
     whose seconds and peak device memory it prints; encrypt, NAND,
     decrypt), each with the launch
     counters set to 0 just before it and read just after:
       - throughput: B=1024 with impl 'fused' and 'fusedb', and B=64 with the
         default impl (Kernel A); 'auto' must equal the 'fused' rows;
       - latency: 'fusedl' at B=1 and B=8, 'bmmpl' at B=4, and an 8-bit
         ``circuits.add_uint`` at B=1 through 'fusedl'; 'fusedl' must equal
         the 'fused' rows;
       - bmmp: the BMMP scan at B=64 (Kernel A at 3R rows); 'bmmpl' must
         equal its rows;
       - block-NTT: 'nttf' (Kernel D) at B=1024 and the plain scans 'ntt' and
         'ntts' at B=64; each must equal the 'fused' rows;
       - whole-scan variants: 'fused3', 'fusedb3' (Kernel B, truncated key),
         'fusedp', 'fusedp3' (Kernel E), 'fusedw', 'fusedwb' (Kernel F),
         'fusedc', 'fusedc3' (Kernel G) at B=1024; 'fusedp', 'fusedc' and
         'fusedw' must equal the 'fused' rows, 'fusedwb' the 'fusedb' rows,
         'fusedp3' and 'fusedc3' the 'fused3' rows;
       - conv: the 'conv' scan at B=64, which must equal the 'fused' rows
         and launch Kernel H once per step (722) and Kernel A never;
       - GGSW: ``ggsw.cmux`` of 1024 GLWE encryptions of random bits against
         the key's first GGSW with impl 'conv' (Kernel H), which must equal
         impl 'matmul' and decrypt to the bits its secret bit selects;
       - the large degrees (``LARGE``): keygen at large_2048 and large_4096
         on the card, NAND at B=256 through 'pallas' and the ten whole-scan
         impls, and at B=64 through 'pallas', 'fused', 'fusedp', 'fusedw'
         and 'fusedc'; 'pallas' launches Kernel A once per step, each
         whole-scan impl its kernel once and Kernel A never; the exact
         carry-chain impls must equal 'pallas', 'fusedwb' 'fusedb', and
         'fusedp3' and 'fusedc3' 'fused3'.
     Every gate needs 0 errors and a noise margin below 0.5, the add must be
     right, and each path must have launched its kernels;
  4. time 'fusedb' at B=1024 with CUDA events, with the SM clock sampled by
     nvidia-smi meanwhile (``scripts/measure_torch.py:sampled_clocks``), then
     Kernel B against its twin at the main path's shape, then Kernels B
     ('fusedb', 'fusedb3'), E ('fusedp', 'fusedp3'), F ('fusedwb') and G
     ('fusedc') alone over the whole key at B = 8, 64, 256, 1024 and 2048,
     in turns, each with its plan, its waves, its SM clock, its twin and
     its bound, then the
     small-batch gates (with the SM clock sampled), the 8-bit add, Kernel C
     against its twin at B=1,
     B=8 (V=1) and B=4 (V=3), then
     the 'nttf' gate at B=1024 with the SM clock sampled, Kernel D against
     its twin at [B=1024, 722 steps], and the 'ntt' and 'ntts' gates at B=64,
     then the eight whole-scan variant gates at B=1024 (with the SM clock
     sampled), and Kernel B at
     key_limbs=3 and Kernels E, F and G, each timed with the SM clock
     sampled and held against its twin at [B=1024, 722 steps] and printed
     beside PERF.md's default_128 times, then Kernels B ('fused'), E
     ('fusedp'), F ('fusedw') and G ('fusedc') alone at large_2048 B=256
     and large_4096 B=64 over the whole key, each with its plan, waves, SM
     clock, twin and bound, then
     Kernel A at [R=18; B=1, 8, 64, 1024], [3R=54; B=64] and [R/2=9; B=64]
     and Kernel H at [R=18; B=64, 256, 1024] and [R/2=9; B=64], each with
     its plan, its SM clock, its twin, its library call (below) and its
     bound, timed as CUDA graphs of EP_GRAPH calls, and the 'conv' gate at
     B=64;
  5. the entry points at default_128: the CLI (``tfhe_tpu_torch/cli.py``)
     in-process with its output captured, in a temporary directory: keygen
     (it prints the seconds of the keygen and of saving the files), encrypt
     of two 8-bit strings, NAND through 'fusedp' (Kernel E launched once)
     and through 'fusedl' (Kernel C once, through the latency key form the
     loader attaches), the 8-bit add through 'fusedl' (Kernel C 19 times),
     each result decrypted to its clear answer; the keys loaded from the
     files must equal the keys keygen built in memory from the same seed
     (``torch.equal``, field for field), and each gate file the same gate
     run in-process on the loaded ciphertexts; it times loading and saving
     ``server.npz``.  Then ``python -m tfhe_tpu_torch.bench --iters 3
     --trace`` as a subprocess (which finds the kernels built): its JSON line
     is logged, and it must have run 'fusedp' at B=1024 with 0 gate errors
     and a noise margin below 0.5, name the card, and leave a trace holding
     the four ``pbs.*`` scopes; ``python -m tfhe_tpu_torch.bench_adder
     --impl fusedl --batch 1 --width 8``, with 0 wrong sums and 0 wrong
     carries; and ``python -m tfhe_tpu_torch.bench --params large_2048
     --impl fusedp --batch 256 --iters 2``, with 0 gate errors and a noise
     margin below 0.5.  The CLI's launches are added to the record's counts;
  6. the sharded and pipelined gates (``tfhe_tpu_torch/parallel``) at
     default_128, NAND, B=64 per rank, each output held bit for bit against
     the one-card 'conv' gate on the same inputs (0 gate errors, noise
     margin below 0.5), each rank's recorded collectives against
     ``parallel/traffic.py:expected_collectives`` (sizes) and
     ``expected_calls`` (one per scan step and one for the key switch, or
     one hop per pipeline tick and one final all-reduce) at its local
     batch, each gate timed once with CUDA events and the SM clock sampled
     (``utils/profiling.py:sampled_clocks``):
       (a) world 1 over NCCL in this process (``PAR_NCCL``): batch DP on
           'conv' and on 'fusedp' (the one-device gate on the rank's rows,
           Kernel E once per gate), TP ('pallas' and 'conv', model axis
           on), the coefficient split ('coeffs'), the NTT-bin split ('ntt')
           and the pipeline ('conv' and 'pallas', one stage, 2
           microbatches); Kernel A must launch 722 times per 'pallas'
           rotation and never otherwise, Kernel H 722 times per 'conv'
           rotation;
       (b) Kernels A and H at the rows of a model shard (R = 9, 6, 3)
           against their twins, then two ranks on this card over gloo
           (``PAR_GLOO``: DP, TP 'pallas' and 'conv' at model=2, that is A
           and H at 9 rows, 'coeffs' and the NTT-bin split), spawned
           through ``parallel/_testing.py:World``, each rank keeping its
           own key shard; the pipeline is not among them, because gloo
           cannot send or receive CUDA tensors.  Phase 6's launches are
           added to the record's counts.

The line before the last is the kernels' JSON record, each kernel with its
bound: the larger of its operations (int8 multiply-adds as the TPU kernel
formulates them) over the int8 tensor-core peak and its bytes (each input
read once, each output written once) over the memory rate, at the H100's
data-sheet rates.  One PyTorch call computes each of the two contraction
kernels' functions (Kernels A and H): ``torch._int_mm`` of the digits,
flattened to [B, R*N], against the key's Toeplitz limb form
``bk_to_matmul_w`` (int8 [R*N, C*4*N], built once and kept column-major,
cuBLAS's fastest layout for it); its time is their ``library_ms``, held
equal to the kernels' sums.  Their entries also carry the ``plan`` of the
B=64 launch, and the whole-scan kernels' entries that of their main-path
launch, Kernels C's and D's with the IMMA and IDP4A counts of their SASS,
and Kernels B's, E's, F's and G's under ``large`` their phase-4 times,
plans, bounds and SM clocks at large_2048 and large_4096;
Kernel C's also carries its one-cluster bound, the card's bound over the
share of the SMs one sample's cluster holds.  No
single call computes the whole-scan kernels' functions, so
theirs is null.  The last line is ``{"ok": true,
"device": {...}}``.  It imports neither JAX nor ``tfhe_tpu``.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MAIN_B = 1024  # gate batch of the main path
AUTO_B = 64  # batch of the default-impl (Kernel A) gate
SLICE_STEPS = 16  # default_128 key steps held against the twin in phase 2
BMMP_B = 64  # batch of the BMMP scan gate (Kernel A at 3R rows)
ADD_W = 8  # width of the encrypted add on the latency path
NTT_B = 64  # batch of the plain block-NTT scans 'ntt' and 'ntts'
CONV_B = 64  # batch of the 'conv' scan gate (Kernel H per step)
CMUX_B = 1024  # GLWE ciphertexts of the GGSW path's cmux (one Kernel H launch)
EP_GRAPH = 50  # contraction calls per CUDA graph when timing Kernels A and H
#: phase 5's two 8-bit operands, MSB first as the CLI's ``encrypt --bits``
#: takes them: 200 and 100
CLI_BITS = ("11001000", "01100100")
#: the pbs scopes a trace of the bench must hold
PBS_SCOPES = ("pbs.mod_switch", "pbs.blind_rotate", "pbs.sample_extract", "pbs.key_switch")
#: Kernel B's modes: (impl, balanced digits, key limbs)
KERNEL_B_MODES = (("fused", False, 4), ("fusedb", True, 4), ("fused3", False, 3),
                  ("fusedb3", True, 3))
#: batches at which phase 4 times Kernel B alone ('fusedb' and 'fusedb3')
KERNEL_B_BATCHES = (8, 64, 256, 1024, 2048)
#: H100 SXM data sheet: int8 tensor cores 1979e12 ops/s (2 per multiply-add),
#: HBM 3.35e12 bytes/s
INT8_MACS_PER_S = 1979e12 / 2
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls, after one
    warm-up call, between two CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(macs: float, nbytes: float) -> tuple[float, str]:
    """The least ms the card could take: the larger of the multiply-adds
    over the int8 peak and the bytes over the memory rate, and which."""
    ops_ms, bytes_ms = macs / INT8_MACS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs_err(got: torch.Tensor, ref: torch.Tensor) -> int:
    return int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())


def rnd_u32(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase0() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[torch.cuda.current_device()]
    log("phase 0: card")
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    return card


def phase1(kernels, tensor_core_kernels) -> None:
    log("phase 1: build (one nvcc per source, all at once)")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.load(), kernels))
    log(f"  all built in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        report = [ln.strip() for ln in k.ptxas_report.splitlines()
                  if "registers" in ln or "spill" in ln]
        log(f"  {k.source}: " + " | ".join(report))
    from tfhe_tpu_torch.ops.cuda._build import imma_count

    for k in tensor_core_kernels:
        count = imma_count(k.path)
        log(f"  {k.source}: {count} IMMA instructions (cuobjdump -sass)")
        require(count > 0, f"{k.source} holds no IMMA instruction: its sums are not on the "
                           "tensor cores")


def sass_counts(kernel) -> dict:
    """IMMA (int8 tensor-core mma) and IDP4A (CUDA-core dp4a) instructions in
    a built kernel's SASS, by ``scripts/sass_compare.py``'s reader."""
    from sass_compare import sass_lines

    sass = sass_lines(kernel.path)
    return {"imma": sum("IMMA" in ln for ln in sass), "idp4a": sum("IDP4A" in ln for ln in sass)}


def phase2(epk, brk, get_params, to_torch_u32, params, sk, dev) -> None:
    log("phase 2: kernels against their plain twins (torch.equal)")
    rng = np.random.default_rng(2)
    for name in ("nano", "test_insecure"):
        p = get_params(name)
        k1, n = p.glwe_dimension + 1, p.degree
        r = k1 * p.pbs_decomposer.levels
        for b in (1, 8, 64):
            d = torch.from_numpy(rng.integers(-8, 17, size=(r, b, n), dtype=np.int8)).to(dev)
            g = to_torch_u32(rnd_u32(rng, (r, k1, n)), dev)
            require(torch.equal(epk.ep_contract_rbn(d, g), epk.ep_contract_rbn_ref(d, g)),
                    f"ep_contract_rbn != twin at {name} B={b}")
            log(f"  ep_contract_rbn   {name:13s} B={b:<4d} equal")
    # Kernel B in its four modes: random keys, keys whose every byte or every
    # low byte is 0x80, batches in and out of 8Z (8 samples per CTA)
    cases = [("nano", b, "random") for b in (1, 3, 8)]
    cases += [("test_insecure", b, "random") for b in (1, 7, 9, 64, 65)]
    cases += [("nano", 3, "0x80"), ("test_insecure", 9, "0x80"), ("nano", 8, "low-0x80"),
              ("test_insecure", 7, "low-0x80"), (params.name, 32, "slice")]
    for name, b, kind in cases:
        p = get_params(name)
        k1, n = p.glwe_dimension + 1, p.degree
        if kind == "slice":
            bk = sk.bk_u32[:SLICE_STEPS]
        else:
            words = rnd_u32(rng, (p.lwe_dimension, k1 * p.pbs_decomposer.levels, k1, n))
            if kind == "0x80":
                words[:] = 0x80808080
            elif kind == "low-0x80":
                words = (words & np.uint32(0xFFFFFF00)) | np.uint32(0x80)
            bk = to_torch_u32(words, dev)
        steps = bk.shape[0]
        acc0 = to_torch_u32(rnd_u32(rng, (b, k1, n)), dev)
        a_hat = torch.from_numpy(
            rng.integers(0, 2 * n, size=(steps, b), dtype=np.int32)).to(dev)
        for mode, balanced, key_limbs in KERNEL_B_MODES:
            got = brk.blind_rotate_fused(p, acc0, bk, a_hat, balanced, key_limbs)
            want = brk.blind_rotate_fused_ref(p, acc0, bk, a_hat, balanced, key_limbs)
            require(torch.equal(got, want), f"blind_rotate_fused ({mode}) != twin at {name} "
                                            f"B={b} steps={steps} ({kind} key)")
        log(f"  blind_rotate_fused {kind:8s} {name:13s} B={b:<4d} steps={steps:<3d} equal in "
            f"all 4 modes; plan {brk.last_plan['blind_rotate_fused']}")
    torch.cuda.synchronize()


#: Kernel C's cluster sizes held against its twin in phase 2 at N=512, those
#: that fit the H100's shared memory, by variants
LAT_CLUSTERS = {1: (16, 8, 4, 2, 1), 3: (16, 8, 4, 2)}


def phase2_latency(latk, get_params, to_torch_u32, params, sk, dev) -> None:
    """Kernel C against its twin, in both forms (V=1 and the BMMP V=3):
    random keys at nano and test_insecure, the worst case (every key byte
    -128, digits -8 and the +B anomaly 16) at nano, test_insecure and
    default_128, large_2048 and large_4096 (both forms) at 2 steps, every
    cluster size forced at test_insecure (LAT_CLUSTERS), scans of 8 to 10
    steps on random and worst-case keys under the plans with a 1-stage key
    ring (large_4096 V=3 as picked, large_4096 V=1 and large_2048 V=3 at
    clusters of 4, test_insecure V=3 at clusters of 2), and a 16-step slice
    of the default_128 latency key."""
    rng = np.random.default_rng(4)
    cases = [(name, v, b, None, "random", 0) for name in ("nano", "test_insecure")
             for v, bs in ((1, (1, 3, 8)), (3, (1, 3, 4))) for b in bs]
    cases += [(name, v, b, steps, kind, 0) for name, v, b, steps, kind in (
        ("nano", 1, 3, None, "worst"), ("test_insecure", 1, 8, None, "worst"),
        ("test_insecure", 3, 4, None, "worst"), (params.name, 1, 1, 2, "worst"),
        ("large_2048", 1, 2, 2, "random"), ("large_2048", 3, 2, 2, "random"),
        ("large_4096", 1, 2, 2, "random"), ("large_4096", 3, 1, 2, "random"))]
    cases += [("test_insecure", v, 2, 2, kind, cs) for v, sizes in LAT_CLUSTERS.items()
              for cs in sizes for kind in ("random", "worst")]
    # scans of 8 to 10 steps, which reuse each of the kernel's three sums
    # buffers, at the plans with a 1-stage key ring
    cases += [(name, v, b, steps, kind, cs) for name, v, b, steps, cs in (
        ("large_4096", 3, 1, 9, 0), ("large_4096", 1, 1, 8, 4), ("large_2048", 3, 2, 8, 4),
        ("test_insecure", 3, 2, 10, 2)) for kind in ("random", "worst")]
    cases += [(params.name, 1, 8, "slice", "random", 0), (params.name, 3, 4, "slice", "random", 0)]
    for name, v, b, steps, kind, cluster in cases:
        p = get_params(name)
        k1, n = p.glwe_dimension + 1, p.degree
        if steps == "slice":
            bk_lat = (sk.bk_lat if v == 1 else sk.bk_bmmp_lat)[:SLICE_STEPS]
        else:
            width = 4 * latk.n_groups(p, v) * n
            bk_lat = torch.from_numpy(rng.integers(
                -128, 128, size=(steps or p.lwe_dimension, k1 * 4, width), dtype=np.int8)).to(dev)
        steps = bk_lat.shape[0]
        acc0 = to_torch_u32(rnd_u32(rng, (b, k1, n)), dev)
        a_vhat = torch.from_numpy(
            rng.integers(0, 2 * n, size=(steps, v, b), dtype=np.int32)).to(dev)
        if kind == "worst":  # rot - acc = -2*acc = 0xF8F8F800 in step 0: digits -8, +16
            bk_lat = torch.full_like(bk_lat, -128)
            acc0 = to_torch_u32(np.full((b, k1, n), 0x83838400, np.uint32), dev)
            a_vhat[0] = n
        got = latk.blind_rotate_latency(p, acc0, bk_lat, a_vhat, cluster)
        want = latk.blind_rotate_latency_ref(p, acc0, bk_lat, a_vhat)
        require(torch.equal(got, want), f"blind_rotate_latency != twin at {name} V={v} B={b} "
                                        f"steps={steps} ({kind} key, cluster {cluster})")
        require(cluster in (0, latk.last_plan["cluster"]),
                f"Kernel C ran clusters of {latk.last_plan['cluster']}, not {cluster}")
        log(f"  blind_rotate_latency V={v} {kind:6s} {name:13s} B={b:<4d} steps={steps:<3d} "
            f"equal; plan {latk.last_plan}")
    torch.cuda.synchronize()


#: Kernel D's plan instances held against its twin in phase 2: (samples per
#: CTA, split), each at a batch whose last cluster is partly empty
NTTF_PLANS = ((1, 1), (1, 2), (1, 4), (1, 8), (2, 1), (2, 2), (2, 4), (2, 8))


def phase2_nttf(nttk, ntt, get_params, to_torch_u32, params, sk, dev) -> None:
    """Kernel D against its twin: random canonical keys (turned into the lhs
    form) at nano, test_insecure (under the plans the kernel picks and, at
    2 steps, every plan instance forced, NTTF_PLANS, and 4 samples per CTA
    at nano) and large_2048 (4 key limbs, key stages of row chunks), an
    all-0xFFFFFFFF key, the worst case (every key byte 0x80 and digits -8
    and +16 in step 0), and a 16-step slice of the default_128 lhs key at
    B=32 and 1024 (the main path at [B=1024, 722 steps] is held against the
    twin in phase 4)."""
    rng = np.random.default_rng(6)
    cases = [(name, b, "random", None, (0, 0))
             for name, bs in (("nano", (1, 3, 8)), ("test_insecure", (1, 7, 64, 256)),
                              ("large_2048", (3,))) for b in bs]
    cases += [("test_insecure", spc * split + 1, "random", 2, (spc, split))
              for spc, split in NTTF_PLANS]
    cases += [("nano", 4 * split + 1, "random", None, (4, split)) for split in (1, 2, 4)]
    cases += [("large_2048", 5, "random", 2, (1, 2)),
              ("test_insecure", 7, "all-ones", None, (0, 0)),
              ("test_insecure", 9, "worst", 2, (2, 4)),
              (params.name, 32, "slice", None, (0, 0)),
              (params.name, MAIN_B, "slice", None, (0, 0))]
    for name, b, kind, steps, plan in cases:
        p = get_params(name)
        k1, n = p.glwe_dimension + 1, p.degree
        if kind == "slice":
            bk_lhs = sk.bk_ntt_lhs[:SLICE_STEPS]
        else:
            # large_2048 (4 key limbs) on 4 steps of its 722
            shape = (steps or min(p.lwe_dimension, 4), k1 * p.pbs_decomposer.levels, k1, n)
            bk = (np.full(shape, 0xFFFFFFFF, np.uint32) if kind == "all-ones"
                  else rnd_u32(rng, shape))
            bk_lhs = ntt.ntt_key_lhs_form(
                ntt.make_ep_ntt_key(to_torch_u32(bk, dev), ntt.plan_for_params(p)))
        steps = bk_lhs.shape[0]
        acc0 = to_torch_u32(rnd_u32(rng, (b, k1, n)), dev)
        a_hat = torch.from_numpy(rng.integers(0, 2 * n, size=(steps, b), dtype=np.int32)).to(dev)
        if kind == "worst":  # rot - acc = -2*acc = 0xF8F8F800 in step 0: digits -8, +16
            bk_lhs = torch.full_like(bk_lhs, -128)
            acc0 = to_torch_u32(np.full((b, k1, n), 0x83838400, np.uint32), dev)
            a_hat[0] = n
        got = nttk.blind_rotate_nttf(p, acc0, bk_lhs, a_hat, plan)
        want = nttk.blind_rotate_nttf_ref(p, acc0, bk_lhs, a_hat)
        require(torch.equal(got, want),
                f"blind_rotate_nttf != twin at {name} B={b} steps={steps} ({kind} key, "
                f"plan {plan})")
        picked = tuple(nttk.last_plan[k] for k in ("samples_per_cta", "split"))
        require(plan in ((0, 0), picked), f"Kernel D ran plan {picked}, not {plan}")
        log(f"  blind_rotate_nttf {kind:8s} {name:13s} B={b:<4d} steps={steps:<3d} equal; "
            f"plan {nttk.last_plan}")
    torch.cuda.synchronize()


def phase2_ep_batch(epk, get_params, to_torch_u32, params, sk, dev) -> None:
    """Kernel H against its twin: random GGSWs at nano and test_insecure
    (B=1, 7, 64), a GGSW whose every byte is 0x80 (where negating after the
    limb split would be wrong), and the first GGSW of the default_128 key at
    B=64 and B=1024."""
    rng = np.random.default_rng(8)
    cases = [(name, b, "random") for name in ("nano", "test_insecure") for b in (1, 7, 64)]
    cases += [("nano", 7, "0x80"), ("test_insecure", 7, "0x80"),
              (params.name, 64, "key"), (params.name, 1024, "key")]
    for name, b, kind in cases:
        p = get_params(name)
        k1, n = p.glwe_dimension + 1, p.degree
        r = k1 * p.pbs_decomposer.levels
        if kind == "key":
            g = sk.bk_u32[0]
        else:
            words = (np.full((r, k1, n), 0x80808080, np.uint32) if kind == "0x80"
                     else rnd_u32(rng, (r, k1, n)))
            g = to_torch_u32(words, dev)
        d = torch.from_numpy(rng.integers(-8, 17, size=(b, r, n), dtype=np.int8)).to(dev)
        require(torch.equal(epk.ep_contract(d, g), epk.ep_contract_ref(d, g)),
                f"ep_contract != twin at {name} B={b} ({kind} key)")
        log(f"  ep_contract {kind:6s} {name:13s} B={b:<4d} equal")
    torch.cuda.synchronize()


def phase2_ep_edges(epk, get_params, to_torch_u32, dev) -> None:
    """Kernels A and H against their twins at their edges, on full-range
    int8 digits (-128..127): test_insecure at B = 1, 7, 17, 64, 65 and 1024
    (partial and several M tiles), the bmmp scan's 3R rows, large_2048
    (C=2, N=2048) and large_4096 (N=4096, one digit buffer) at B=3, keys
    whose every byte is 0x80, plans forced to no row split (a card of 1 SM)
    and to the largest (10,000 SMs), and one digit buffer with 2 warps per
    CTA."""
    import ctypes

    from tfhe_tpu_torch.ops.cuda._build import ptr, stream_of

    rng = np.random.default_rng(10)
    kernels = {"A": (epk.ep_contract_rbn, epk.ep_contract_rbn_ref, epk.KERNEL),
               "H": (epk.ep_contract, epk.ep_contract_ref, epk.BATCH_KERNEL)}

    def check(name, b, kind, row_mult, what=""):
        p = get_params(name)
        k1, n = p.glwe_dimension + 1, p.degree
        r = k1 * p.pbs_decomposer.levels * row_mult
        words = (np.full((r, k1, n), 0x80808080, np.uint32) if kind == "0x80"
                 else rnd_u32(rng, (r, k1, n)))
        g = to_torch_u32(words, dev)
        for tag, (fn, twin, kernel) in kernels.items():
            shape = (r, b, n) if tag == "A" else (b, r, n)
            d = torch.from_numpy(rng.integers(-128, 128, size=shape, dtype=np.int8)).to(dev)
            require(torch.equal(fn(d, g), twin(d, g)),
                    f"Kernel {tag} != twin on full-range digits at {name} R={r} B={b} "
                    f"({kind} key{what})")
            plan = epk.last_plan[kernel.symbol]
            log(f"  Kernel {tag} full-range {kind:6s} {name:13s} R={r:<3d} B={b:<4d} equal{what}; "
                f"plan {plan}")
        return plan

    cases = [("test_insecure", b, "random", 1) for b in (1, 7, 17, 64, 65, 1024)]
    cases += [("test_insecure", 64, "random", 3), ("large_2048", 3, "random", 1),
              ("large_4096", 3, "random", 1),
              ("test_insecure", 7, "0x80", 1), ("test_insecure", 64, "0x80", 3)]
    for case in cases:
        check(*case)
    real_sm_count = epk.sm_count
    for sms, split in ((1, 1), (10_000, 8)):
        epk.sm_count = lambda device: sms
        epk._plan_on.cache_clear()
        try:
            plan = check("test_insecure", 64, "random", 3, f", plan forced by {sms} SMs")
        finally:
            epk.sm_count = real_sm_count
            epk._plan_on.cache_clear()
        require(plan["split"] == split, f"{sms} SMs gave the row split {plan['split']}")
    # one digit buffer and 2 warps per CTA, which ep_plan gives only at
    # large_4096 and N=32: through the C entry points with that plan
    p = get_params("test_insecure")
    k1, n, b = p.glwe_dimension + 1, p.degree, 40
    r = k1 * p.pbs_decomposer.levels
    g = to_torch_u32(rnd_u32(rng, (r, k1, n)), dev)
    info = (ctypes.c_int * 2)()
    for tag, (_, twin, kernel) in kernels.items():
        shape = (r, b, n) if tag == "A" else (b, r, n)
        d = torch.from_numpy(rng.integers(-128, 128, size=shape, dtype=np.int8)).to(dev)
        want = twin(d, g)
        for bm in (16, 32):
            out = torch.empty_like(want)
            kernel.launch(ptr(d), ptr(g), ptr(out), r, b, k1, n, bm, 2, 3, r // 3, 1, info,
                          stream_of(out))
            require(torch.equal(out, want), f"Kernel {tag} != twin with one digit buffer, "
                                            f"{bm} samples per CTA, 2 warps")
        log(f"  Kernel {tag} full-range random test_insecure R={r} B={b} equal with one digit "
            f"buffer and 2 warps (16 and 32 samples per CTA)")
    torch.cuda.synchronize()


def time_contractions(epk, sk, params, rng, dev, card, graph_ms, bk_to_matmul_w) -> dict:
    """Phase 4: Kernels A and H at the shapes of their paths on full-range
    digits, each with its plan, its SM clock, its twin's time, its library
    call (``torch._int_mm`` of the digits [B, R*N] against the key's
    Toeplitz limb form W = ``bk_to_matmul_w``, int8 [R*N, C*4*N], laid
    column-major, cuBLAS's fast layout for it, and held equal to the
    kernel's sums) and its bound.  Kernel and library are both timed as
    CUDA graphs of EP_GRAPH calls (``scripts/measure_torch.py:graph_ms``):
    at B=64 the host's cost per call is larger than the kernel's."""
    k1, n = params.k + 1, params.degree
    shapes = [("A", sk.bk_lm[0], b) for b in (1, 8, 64, 1024)] + [("A", sk.bk_bmmp_lm[0], 64)]
    shapes += [("H", sk.bk_u32[0], b) for b in (64, 256, 1024)]
    # a model=2 shard's rows (phase 6's tensor-parallel gates): R/2 = 9
    half = (k1 * params.pbs_decomposer.levels) // 2
    shapes += [("A", sk.bk_lm[0, :half], 64), ("H", sk.bk_u32[0, :half], 64)]
    w_col = {}  # (rows' data_ptr, R) -> W laid column-major
    res = {}  # (kernel, R, B) -> measurements
    for kind, rows, b in shapes:
        r = rows.shape[0]
        if (rows.data_ptr(), r) not in w_col:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w = bk_to_matmul_w(rows).t().contiguous().t()
            torch.cuda.synchronize()
            w_col[rows.data_ptr(), r] = w
            log(f"  library operand W for R={r}: {nbytes(w)} bytes, built and laid column-major "
                f"in {(time.perf_counter() - t0) * 1e3:.2f} ms")
        w = w_col[rows.data_ptr(), r]
        if kind == "A":
            d = torch.from_numpy(rng.integers(-128, 128, size=(r, b, n), dtype=np.int8)).to(dev)
            kernel, fn, twin = epk.KERNEL, epk.ep_contract_rbn, epk.ep_contract_rbn_ref
            flat = d.transpose(0, 1).reshape(b, r * n)  # a copy, made before the timing

            def as_kernel(acc, b=b):
                return acc.reshape(b, k1, 4, n).permute(1, 2, 0, 3)
        else:
            d = torch.from_numpy(rng.integers(-128, 128, size=(b, r, n), dtype=np.int8)).to(dev)
            kernel, fn, twin = epk.BATCH_KERNEL, epk.ep_contract, epk.ep_contract_ref
            flat = d.reshape(b, r * n)

            def as_kernel(acc, b=b):
                return acc.reshape(b, k1 * 4, n)
        got = fn(d, rows)
        plan = dict(epk.last_plan[kernel.symbol])
        err = max_abs_err(got, twin(d, rows))
        ms, clocked = graph_ms(lambda: fn(d, rows), EP_GRAPH)
        mhz = sorted(c for c, _ in clocked) or [float("nan")]
        plain_ms = cuda_ms(lambda: twin(d, rows), 3)
        # the library call: M = B must be > 16 for torch._int_mm, so B=1 and 8
        # pad the digits to 17 rows of which only B are the kernel's
        pad = max(0, 17 - b)
        lib_in = torch.cat([flat, flat.new_zeros(pad, r * n)]) if pad else flat
        require(torch.equal(as_kernel(torch._int_mm(lib_in, w)[:b]), got),
                f"torch._int_mm differs from Kernel {kind}'s sums at R={r} B={b}")
        lib_ms, _ = graph_ms(lambda: torch._int_mm(lib_in, w), EP_GRAPH, clocks=False)
        bound_ms, bound_by = bound(r * b * n * k1 * 4 * n,
                                   nbytes(d) + nbytes(rows) + k1 * 4 * b * n * 4)
        res[kind, r, b] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by, plan=plan,
                               sm_mhz=[mhz[0], mhz[-1]])
        log(f"  Kernel {kind} {kernel.symbol} [R={r}, B={b}, N={n}]: kernel {ms:.6f} ms "
            f"(graph of {EP_GRAPH}), SM clock {len(clocked)} samples {mhz[0]}-{mhz[-1]} MHz; "
            f"library torch._int_mm {lib_ms:.6f} ms{' (M padded to 17)' if pad else ''}; "
            f"bound {bound_ms:.6f} ms by {bound_by} (share {bound_ms / ms:.4f}); plain "
            f"{plain_ms:.4f} ms; max_abs_err {err}; plan {plan}; card: {card}")
    require(all(v["max_abs_err"] == 0 for v in res.values()),
            "a contraction kernel disagrees with its twin at its path's shapes")
    return res


#: the tensor-core whole-scan kernels phase 4 times alone over KERNEL_B_BATCHES:
#: impl -> (kernel, wrapper name, options, key limbs)
ALONE = {"fusedb": ("B", "blind_rotate_fused", {"balanced": True}, 4),
         "fusedb3": ("B", "blind_rotate_fused", {"balanced": True, "key_limbs": 3}, 3),
         "fusedp": ("E", "blind_rotate_fused_pipe", {}, 4),
         "fusedp3": ("E", "blind_rotate_fused_pipe", {"key_limbs": 3}, 3),
         "fusedwb": ("F", "blind_rotate_fused_wide_pipe", {"balanced": True}, 4),
         "fusedc": ("G", "blind_rotate_fused_cols", {}, 4)}


def waves(plan: dict, c: int, dev) -> int:
    """The waves a launch plan runs in: its clusters of c CTAs over the
    clusters the card holds at once (Kernel G), or its CTAs over the SMs
    times the CTAs whose shared memory one SM holds (an SM has 1 KB more
    than a block may opt in to, and each resident block reserves 1 KB)."""
    if "max_active_clusters" in plan:
        return -(-plan["ctas"] // c // plan["max_active_clusters"])
    props = torch.cuda.get_device_properties(dev)
    per_sm = (props.shared_memory_per_block_optin + 1024) // (plan["smem_bytes"] + 1024)
    return -(-plan["ctas"] // (props.multi_processor_count * per_sm))


def time_alone(brk, sk, params, rng, dev, card, sampled_clocks) -> dict:
    """Phase 4: Kernels B ('fusedb', 'fusedb3'), E ('fusedp', 'fusedp3'), F
    ('fusedwb') and G ('fusedc') alone over the whole key (722 steps) at
    each of KERNEL_B_BATCHES, in turns on the same random accumulators and
    exponents: each one's time (mean of 2 back to back after a warm-up,
    CUDA events) with the SM clock sampled meanwhile, its plan and waves,
    its twin's time and max_abs_err, and its bound (int8 multiply-adds of
    the kept limbs over the int8 peak, or the bytes).  Kernels of one digit
    convention and key width share one twin run (all twins are
    ``blind_rotate_fused_ref``)."""
    k1, n, steps = params.k + 1, params.degree, params.n
    r = k1 * params.pbs_decomposer.levels
    res = {}  # (impl, B) -> measurements
    for b in KERNEL_B_BATCHES:
        acc0 = torch.from_numpy(rnd_u32(rng, (b, k1, n)).view(np.int32)).to(dev)
        a_hat = torch.from_numpy(rng.integers(0, 2 * n, size=(steps, b), dtype=np.int32)).to(dev)
        twins = {}  # (balanced, key limbs) -> (twin's output, its ms)
        for impl, (kernel, fn, options, key_limbs) in ALONE.items():
            def rotate():
                return getattr(brk, fn)(params, acc0, sk.bk_u32, a_hat, **options)
            ms, clocked = sampled_clocks(rotate, 2)
            mhz = sorted(c for c, _ in clocked) or [float("nan")]
            plan = dict(brk.last_plan[fn])
            plan["waves"] = waves(plan, k1, dev)
            got = rotate()
            mode = (options.get("balanced", False), key_limbs)
            if mode not in twins:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = brk.blind_rotate_fused_ref(params, acc0, sk.bk_u32, a_hat, *mode)
                torch.cuda.synchronize()
                twins[mode] = ref, (time.perf_counter() - t0) * 1e3
            ref, plain_ms = twins[mode]
            err = max_abs_err(got, ref)
            bound_ms, bound_by = bound(r * n * k1 * n * key_limbs * steps * b,
                                       2 * nbytes(acc0) + nbytes(a_hat) + nbytes(sk.bk_u32))
            res[impl, b] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms,
                                bound_by=bound_by, plan=plan, sm_mhz=[mhz[0], mhz[-1]])
            log(f"  Kernel {kernel} {impl:7s} [B={b}, n={steps}]: kernel {ms:.3f} ms (mean of 2), "
                f"{b / (ms / 1e3):.1f} blind rotations/s; SM clock {len(clocked)} samples "
                f"{mhz[0]}-{mhz[-1]} MHz; bound {bound_ms:.3f} ms by {bound_by} (share "
                f"{bound_ms / ms:.4f}); plain {plain_ms:.1f} ms; max_abs_err {err}; plan {plan}; "
                f"card: {card}")
    require(all(v["max_abs_err"] == 0 for v in res.values()),
            "a tensor-core whole-scan kernel disagrees with its twin at a phase-4 batch")
    return res


#: the whole-scan variants: impl -> (wrapper name, options); their twins are
#: the wrapper name + "_ref"
WHOLE_SCAN = {
    "fused3": ("blind_rotate_fused", {"key_limbs": 3}),
    "fusedb3": ("blind_rotate_fused", {"key_limbs": 3, "balanced": True}),
    "fusedp": ("blind_rotate_fused_pipe", {}),
    "fusedp3": ("blind_rotate_fused_pipe", {"key_limbs": 3}),
    "fusedw": ("blind_rotate_fused_wide_pipe", {}),
    "fusedwb": ("blind_rotate_fused_wide_pipe", {"balanced": True}),
    "fusedc": ("blind_rotate_fused_cols", {}),
    "fusedc3": ("blind_rotate_fused_cols", {"key_limbs": 3}),
}


def phase2_whole_scan(brk, get_params, to_torch_u32, params, sk, dev) -> None:
    """Kernel B at key_limbs=3 and Kernels E, F and G against their twins in
    every mode: random keys at nano and test_insecure, the same with every
    low byte 0x80 (the truncated key's hard case) and with every byte 0x80
    (the limb -128, which the tensor-core kernels B, E, F and G must not
    negate), and a 16-step slice of the default_128 key."""
    rng = np.random.default_rng(7)
    cases = [(name, b, "random") for name, bs in (("nano", (1, 3, 8)),
                                                   ("test_insecure", (1, 7, 64))) for b in bs]
    cases += [("nano", 3, "low-0x80"), ("test_insecure", 7, "low-0x80"), ("nano", 9, "0x80"),
              ("test_insecure", 9, "0x80"), (params.name, 32, "slice")]
    for name, b, kind in cases:
        p = get_params(name)
        k1, n = p.glwe_dimension + 1, p.degree
        if kind == "slice":
            bk = sk.bk_u32[:SLICE_STEPS]
        else:
            words = rnd_u32(rng, (p.lwe_dimension, k1 * p.pbs_decomposer.levels, k1, n))
            if kind == "low-0x80":
                words = (words & np.uint32(0xFFFFFF00)) | np.uint32(0x80)
            elif kind == "0x80":
                words[:] = 0x80808080
            bk = to_torch_u32(words, dev)
        steps = bk.shape[0]
        acc0 = to_torch_u32(rnd_u32(rng, (b, k1, n)), dev)
        a_hat = torch.from_numpy(rng.integers(0, 2 * n, size=(steps, b), dtype=np.int32)).to(dev)
        for impl, (fn, options) in WHOLE_SCAN.items():
            got = getattr(brk, fn)(p, acc0, bk, a_hat, **options)
            want = getattr(brk, fn + "_ref")(p, acc0, bk, a_hat, **options)
            require(torch.equal(got, want),
                    f"{fn} ({impl}) != twin at {name} B={b} steps={steps} ({kind} key)")
        log(f"  whole-scan variants {kind:8s} {name:13s} B={b:<4d} steps={steps:<3d} all 8 "
            f"equal; plans {brk.last_plan}")
    torch.cuda.synchronize()


#: every mode of the whole-scan Kernels B, E, F and G: impl -> (wrapper
#: name, options); their twins are the wrapper name + "_ref"
ALL_MODES = {"fused": ("blind_rotate_fused", {}),
             "fusedb": ("blind_rotate_fused", {"balanced": True}), **WHOLE_SCAN}
#: the large-degree paths (the published degrees, uncut): parameter set ->
#: (gate batch of phases 3 and 4, the impls phase 3 runs)
LARGE = {"large_2048": (256, tuple(ALL_MODES)),
         "large_4096": (64, ("fused", "fusedp", "fusedw", "fusedc"))}
LARGE_STEPS = 4  # key steps held against the twins in phase 2 at the large degrees
#: the truncated-key impls (key_limbs=3): approximate
TRUNCATED = ("fused3", "fusedb3", "fusedp3", "fusedc3")
#: the kernels phase 4 times alone at the large degrees, all with the exact
#: key and carry-chain digits, so one twin serves them: impl -> kernel
LARGE_ALONE = {"fused": "B", "fusedp": "E", "fusedw": "F", "fusedc": "G"}
#: the default_128 times at B=1024 on the gate's inputs that PERF.md's kernel
#: table keeps (NVIDIA H100 80GB HBM3, 700.00 W, 1980 MHz): kernel -> ms
PERF_DEFAULT_128 = {"B": 128.97, "E": 112.08, "F": 138.06, "G": 186.66}


def phase2_large(brk, get_params, to_torch_u32, dev) -> None:
    """Kernels B, E, F and G in every mode against their twins at large_2048
    and large_4096, where they run the circulant in 512 x 512 blocks, on
    LARGE_STEPS steps: a random key and one whose every byte is 0x80, at
    batches whose last CTA is part-filled (B=9 at large_2048: 4 or 2 samples
    per CTA; B=3 at large_4096: 2 or 1)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(11)
    for name, b in (("large_2048", 9), ("large_4096", 3)):
        p = get_params(name)
        k1, n = p.glwe_dimension + 1, p.degree
        for kind in ("random", "0x80"):
            words = rnd_u32(rng, (LARGE_STEPS, k1 * p.pbs_decomposer.levels, k1, n))
            if kind == "0x80":
                words[:] = 0x80808080
            bk = to_torch_u32(words, dev)
            acc0 = to_torch_u32(rnd_u32(rng, (b, k1, n)), dev)
            a_hat = torch.from_numpy(
                rng.integers(0, 2 * n, size=(LARGE_STEPS, b), dtype=np.int32)).to(dev)
            for impl, (fn, options) in ALL_MODES.items():
                got = getattr(brk, fn)(p, acc0, bk, a_hat, **options)
                want = getattr(brk, fn + "_ref")(p, acc0, bk, a_hat, **options)
                require(torch.equal(got, want), f"{fn} ({impl}) != twin at {name} B={b} "
                                                f"steps={LARGE_STEPS} ({kind} key)")
            log(f"  whole-scan, every mode {kind:6s} {name} B={b} steps={LARGE_STEPS}: all "
                f"{len(ALL_MODES)} equal; plans {brk.last_plan}")
    torch.cuda.synchronize()
    log(f"  phase 2 at the large degrees: {time.perf_counter() - t_phase:.1f} s")


def phase3_large(kernels, tfhe, noise, to_numpy_u32, brk) -> tuple[dict, dict]:
    """The large-degree paths through the public API: keygen on the card,
    encrypt, NAND through the 'pallas' gate (Kernel A, once per step) and
    through each of LARGE's impls (one launch of its kernel, Kernel A
    never), decrypt; 0 gate errors and a noise margin below 0.5 for every
    impl of the exact key (the truncated key's are printed), and every
    exact carry-chain impl equal to 'pallas', 'fusedwb' to 'fusedb',
    'fusedp3' and 'fusedc3' to 'fused3'.  Returns each impl's launch counts
    by parameter set, and the keys and gate ms by parameter set."""
    log("phase 3: the large-degree paths, NAND (" + "; ".join(
        f"{name} at B={b}: pallas, {', '.join(impls)}" for name, (b, impls) in LARGE.items())
        + ")")
    t_phase = time.perf_counter()
    counts, keys = {}, {}
    for name, (b, impls) in LARGE.items():
        p = tfhe.get_params(name)
        t0 = time.perf_counter()
        ck, sk = tfhe.keygen(p, torch.Generator().manual_seed(20))
        torch.cuda.synchronize()
        log(f"  keygen {name} (n={p.n}, k={p.k}, N={p.degree}): "
            f"{time.perf_counter() - t0:.2f} s")
        rng = np.random.default_rng(21)
        bits_a, bits_b = (rng.integers(0, 2, size=b, dtype=np.uint32) for _ in "ab")
        ca = tfhe.encrypt(ck, bits_a, torch.Generator().manual_seed(22))
        cb = tfhe.encrypt(ck, bits_b, torch.Generator().manual_seed(23))
        outs, gate_ms = {}, {}
        for impl in ("pallas", *impls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[impl], got = drive(kernels, lambda: tfhe.gates.nand(sk, ca, cb, impl=impl))
            gate_ms[impl] = (time.perf_counter() - t0) * 1e3
            got = {k: v for k, v in got.items() if v}
            want = ({"ep_contract_rbn": p.n} if impl == "pallas"
                    else {ALL_MODES[impl][0]: 1})
            require(got == want, f"{name} {impl} launched {got}, not {want}")
            counts[name, impl] = got
            plan = "" if impl == "pallas" else f"; plan {brk.last_plan[ALL_MODES[impl][0]]}"
            log(f"  {name} {impl:7s} B={b}: {gate_ms[impl]:.1f} ms (one gate, host clock around "
                f"a synchronised call); launches {got}{plan}")
        # the truncated key (key_limbs=3) drops the low byte of each key
        # word: its error grows with R*N, and at large_2048 it passes the
        # margin with balanced digits ('fusedb3'), so its gates are printed
        # and held to their exact twins and partners, not to the margin
        margins = check_gates(tfhe, noise, to_numpy_u32, ck, outs, 1 - (bits_a & bits_b),
                              held=[i for i in outs if i not in TRUNCATED])
        same_as = {impl: "pallas" for impl in ("fused", "fusedp", "fusedw", "fusedc")}
        same_as.update(fusedwb="fusedb", fusedp3="fused3", fusedc3="fused3")
        for impl, other in same_as.items():
            if impl in outs:
                require(torch.equal(outs[impl], outs[other]),
                        f"{name}: {impl} differs from {other}")
        log(f"  {name}: " + ", ".join(f"{i} == {o}" for i, o in same_as.items() if i in outs)
            + " bit for bit")
        keys[name] = (p, sk, gate_ms, margins)
    log(f"  phase 3 at the large degrees: {time.perf_counter() - t_phase:.1f} s")
    return counts, keys


def time_large(brk, keys, dev, card) -> dict:
    """Phase 4 at the large degrees: Kernels B ('fused'), E ('fusedp'), F
    ('fusedw') and G ('fusedc') alone over the whole key (722 steps) at
    LARGE's batch, in turns on the same random accumulators and exponents:
    each one's time (one call after phase 3's, CUDA events) with the SM
    clock sampled meanwhile, its plan and waves, and its max_abs_err against
    the one twin they share (timed once), beside the bound."""
    from tfhe_tpu_torch.utils.profiling import sampled_clocks

    t_phase = time.perf_counter()
    res = {}  # (name, kernel) -> measurements
    rng = np.random.default_rng(12)
    for name, (p, sk, gate_ms, margins) in keys.items():
        b = LARGE[name][0]
        k1, n, steps = p.k + 1, p.degree, p.n
        r = k1 * p.pbs_decomposer.levels
        acc0 = torch.from_numpy(rnd_u32(rng, (b, k1, n)).view(np.int32)).to(dev)
        a_hat = torch.from_numpy(rng.integers(0, 2 * n, size=(steps, b), dtype=np.int32)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = brk.blind_rotate_fused_ref(p, acc0, sk.bk_u32, a_hat)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bound_ms, bound_by = bound(r * n * k1 * n * 4 * steps * b,
                                   2 * nbytes(acc0) + nbytes(a_hat) + nbytes(sk.bk_u32))
        for impl, kernel in LARGE_ALONE.items():
            fn, options = ALL_MODES[impl]
            out = []
            ms, clocked = sampled_clocks(
                lambda: out.append(getattr(brk, fn)(p, acc0, sk.bk_u32, a_hat, **options)), 1,
                warmup=False)
            mhz = sorted(c for c, _ in clocked) or [float("nan")]
            plan = dict(brk.last_plan[fn])
            plan["waves"] = waves(plan, k1, dev)
            err = max_abs_err(out[0], ref)
            # the phase-3 gates of this kernel's impls: ms, errors, max |e|/delta
            gates = {i: dict(gate_ms=gate_ms[i], errors=margins[i][0], noise=margins[i][1])
                     for i in gate_ms if i != "pallas" and ALL_MODES[i][0] == fn}
            res[name, kernel] = dict(batch=b, ms=ms, plain_ms=plain_ms, max_abs_err=err,
                                     bound_ms=bound_ms, bound_by=bound_by, plan=plan,
                                     sm_mhz=[mhz[0], mhz[-1]], gates=gates)
            log(f"  Kernel {kernel} {impl:6s} {name} [B={b}, n={steps}]: kernel {ms:.2f} ms, "
                f"{b / (ms / 1e3):.1f} blind rotations/s; SM clock {len(clocked)} samples "
                f"{mhz[0]}-{mhz[-1]} MHz; bound {bound_ms:.3f} ms by {bound_by} (share "
                f"{bound_ms / ms:.4f}); plain {plain_ms:.1f} ms; max_abs_err {err}; plan {plan}; "
                f"card: {card}")
        del ref
    require(all(v["max_abs_err"] == 0 for v in res.values()),
            "a whole-scan kernel disagrees with its twin at a large degree")
    log(f"  phase 4 at the large degrees: {time.perf_counter() - t_phase:.1f} s")
    return res


def phase5_large(card) -> None:
    """The bench at large_2048 through 'fusedp' (Kernel E in blocks), B=256,
    as a subprocess: its JSON line is logged, and it must name the card and
    have 0 gate errors with a noise margin below 0.5."""
    t0 = time.perf_counter()
    line = run_module("tfhe_tpu_torch.bench", "--params", "large_2048", "--impl", "fusedp",
                      "--batch", "256", "--iters", "2")
    log(f"  bench line (large_2048): {json.dumps(line)}")
    b = line["breakdown"]
    require(b["impl"] == "fusedp" and b["batch"] == 256,
            f"the large_2048 bench ran {b['impl']} at B={b['batch']}, not fusedp at 256")
    require(b["gate_errors"] == 0 and b["noise_max_over_delta"] < 0.5,
            f"the large_2048 bench's gates: {b['gate_errors']} errors, noise "
            f"{b['noise_max_over_delta']}")
    require(b["card"] == card.split(",")[0].strip(), f"the bench names the card {b['card']}")
    log(f"  phase 5, the large_2048 bench: {time.perf_counter() - t0:.1f} s")


def drive(kernels, fn):
    """Run ``fn()`` with every launch counter set to 0 just before it; return
    its result and the counts read just after it."""
    for k in kernels:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.symbol: k.launches for k in kernels}


def check_gates(tfhe, noise, to_numpy_u32, ck, outs, want, held=None) -> dict:
    """0 gate errors and a noise margin below 0.5 for every output batch
    (only for the impls in ``held`` when it is given; the others' errors
    and margins are printed).  Returns impl -> (errors, max |e|/delta)."""
    res = {}
    for impl, out in outs.items():
        got = to_numpy_u32(tfhe.decrypt(ck, out))
        ref = want[: got.shape[0]]
        errors = int((got != ref).sum())
        rep = noise.measure(ck, out, ref)
        res[impl] = (errors, rep.max_abs_over_delta)
        log(f"  impl={impl:9s} B={got.shape[0]:<5d} gate errors {errors}/{got.shape[0]}, "
            f"noise_max_over_delta={rep.max_abs_over_delta}"
            + ("" if held is None or impl in held else " (not held to the margin)"))
        if held is None or impl in held:
            require(errors == 0, f"{errors} gate errors with impl={impl}")
            require(rep.max_abs_over_delta < 0.5,
                    f"noise margin {rep.max_abs_over_delta} >= 0.5 with impl={impl}")
    return res


def run_module(module: str, *argv: str) -> dict:
    """Run ``python -m module argv`` from the checkout's root, log its
    stderr, and return the JSON object of its last stdout line; raise if it
    fails."""
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    for line in proc.stderr.strip().splitlines():
        log(f"    | {line}")
    require(proc.returncode == 0, f"python -m {module} exited {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase5(kernels, tfhe, ser, cli, sk, ck, params, pipe, lat, card) -> dict:
    """The entry points at default_128 on the card: the CLI in-process under
    ``drive`` (keygen, encrypt of two 8-bit strings, NAND through 'fusedp'
    and through 'fusedl', the 8-bit add through 'fusedl', decrypt), the
    loaded keys against the ones keygen built in memory from the same seed,
    each gate file against the same gate run in-process on the loaded
    ciphertexts; then ``python -m tfhe_tpu_torch.bench --iters 3 --trace``
    and ``python -m tfhe_tpu_torch.bench_adder --impl fusedl --batch 1
    --width 8`` as subprocesses.  Returns the CLI's launch counts."""
    log(f"phase 5: entry points at {params.name} (the CLI in-process, the bench and the adder "
        "bench as subprocesses)")
    t_phase = time.perf_counter()
    launched = {k.symbol: 0 for k in kernels}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        client, server = tmp / "keys" / "client.npz", tmp / "keys" / "server.npz"

        def cli_run(*argv) -> str:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli.main([str(a) for a in argv])
            log(f"  cli {argv[0]}: {out.getvalue().strip()}")
            return out.getvalue().strip()

        cli_run("keygen", "--params", params.name, "--out", tmp / "keys")
        log(f"  server.npz: {server.stat().st_size} bytes (np.savez_compressed)")
        for name, bits, seed in (("a", CLI_BITS[0], 1), ("b", CLI_BITS[1], 2)):
            cli_run("encrypt", "--client", client, "--bits", bits, "--out", tmp / f"{name}.npz",
                    "--seed", seed)
        nand_bits = "".join(str(1 - (int(x) & int(y))) for x, y in zip(*CLI_BITS))
        sum_bits = format((int(CLI_BITS[0], 2) + int(CLI_BITS[1], 2)) % 256, "08b")
        runs = [(f"nand_{impl}", impl, ("gate", "--op", "nand"), {kernel.symbol: 1}, nand_bits)
                for impl, kernel in (("fusedp", pipe), ("fusedl", lat))]
        runs.append(("add_fusedl", "fusedl", ("add",), {lat.symbol: 19}, sum_bits))
        for name, impl, command, want_launches, want_bits in runs:
            _, counts = drive(kernels, lambda: cli_run(
                *command, "--server", server, "--lhs", tmp / "a.npz", "--rhs", tmp / "b.npz",
                "--out", tmp / f"{name}.npz", "--impl", impl))
            launches = {k: v for k, v in counts.items() if v}
            log(f"  {name}: launches {launches}")
            require(launches == want_launches,
                    f"the CLI's {name} launched {launches}, not {want_launches}")
            for k, v in counts.items():
                launched[k] += v
            got = cli_run("decrypt", "--client", client, "--in", tmp / f"{name}.npz")
            require(got == want_bits, f"the CLI's {name} decrypted to {got}, not {want_bits}")

        # the loaded keys against the ones keygen built in memory from the same
        # seed (the BMMP draws come after every other draw, so sk's other
        # fields are the CLI's key)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sk_file = ser.load_server_key(server)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ser.save_server_key(tmp / "server_again.npz", sk_file)
        save_s = time.perf_counter() - t0
        ck_file = ser.load_client_key(client)
        for f in ("bk_u32", "bk_lm", "ksk_u32", "ksk_mat"):
            require(torch.equal(getattr(sk_file, f), getattr(sk, f)),
                    f"server.npz's {f} differs from the key built in memory")
        require(sk_file.bk_bmmp_lm is None and sk_file.params == params,
                "server.npz's key is not the CLI's non-BMMP default_128 key")
        require(torch.equal(ck_file.lwe_sk, ck.lwe_sk) and torch.equal(ck_file.glwe_sk, ck.glwe_sk),
                "client.npz's keys differ from the keys built in memory")
        log(f"  server.npz loaded in {load_s:.3f} s and saved again in {save_s:.3f} s; the "
            "loaded keys equal the keys keygen built in memory (torch.equal, every field)")
        (ca, _), (cb, _) = (ser.load_ciphertexts(tmp / f"{n}.npz") for n in ("a", "b"))
        gates = {}
        for impl in ("fusedp", "fusedl"):
            gates[impl], _ = ser.load_ciphertexts(tmp / f"nand_{impl}.npz")
            # the CLI computes gate(op, rhs, lhs): index = 2*lhs + rhs
            want = tfhe.gates.nand(tfhe.with_key_form(sk_file, impl), cb, ca, impl=impl)
            require(torch.equal(gates[impl], want),
                    f"the CLI's nand_{impl}.npz differs from the in-process gate")
        require(torch.equal(gates["fusedp"], gates["fusedl"]),
                "the CLI's fusedp and fusedl gates differ")
        log("  each CLI gate file equals the in-process gate on the loaded ciphertexts bit for "
            "bit, and fusedp's equals fusedl's")

        line = run_module("tfhe_tpu_torch.bench", "--iters", "3", "--trace", tmp / "trace")
        log(f"  bench line: {json.dumps(line)}")
        b = line["breakdown"]
        traces = [p.read_text() for p in (tmp / "trace").glob("*.json")]
        require(b["impl"] == "fusedp" and b["batch"] == 1024,
                f"the bench ran {b['impl']} at B={b['batch']}, not fusedp at 1024")
        require(b["gate_errors"] == 0 and b["noise_max_over_delta"] < 0.5,
                f"the bench's gates: {b['gate_errors']} errors, noise {b['noise_max_over_delta']}")
        require(b["card"] == card.split(",")[0].strip(), f"the bench names the card {b['card']}")
        require(len(traces) == 1 and all(f'"{n}"' in traces[0] for n in PBS_SCOPES),
                "the bench's trace does not hold the four pbs scopes")
        kernel_events = traces[0].count('"cat": "kernel"')
        log(f"  bench: fusedp at B=1024, {line['value']} gate bootstraps/s, 0 gate errors; its "
            f"trace holds {', '.join(PBS_SCOPES)} and {kernel_events} CUDA kernel events")

        adder = run_module("tfhe_tpu_torch.bench_adder", "--impl", "fusedl", "--batch", "1",
                           "--width", "8", "--out", tmp / "adder.json")
        log(f"  adder line: {json.dumps(adder)}")
        require(adder["wrong_sums"] == 0 and adder["wrong_carries"] == 0,
                f"the adder bench: {adder['wrong_sums']} wrong sums, "
                f"{adder['wrong_carries']} wrong carries")
    log(f"  phase 5: {time.perf_counter() - t_phase:.1f} s")
    return launched


#: phase 6: ciphertexts per rank, and the pipeline's microbatches at one stage
PAR_B = 64
PAR_M = 2
#: phase 6 (a), world 1 over NCCL in this process: mode -> (gate, impl,
#: use_model_axis, traffic mode); every model axis is of size 1 there
PAR_NCCL = {
    "dp_conv": ("sharded", "conv", None, "dp"),
    "dp_fusedp": ("sharded", "fusedp", None, "dp"),
    "tp_pallas": ("sharded", "pallas", True, "tp"),
    "tp_conv": ("sharded", "conv", True, "tp"),
    "coeffs": ("sharded", "coeffs", True, "coeffs"),
    "ntt_bins": ("sharded", "ntt", True, "ntt"),
    "pp_conv": ("pipeline", "conv", None, "pp"),
    "pp_pallas": ("pipeline", "pallas", None, "pp"),
}
#: phase 6 (b), two ranks on the one card over gloo: mode -> (mesh, impl,
#: use_model_axis, traffic mode).  NCCL refuses two ranks on one card, and
#: gloo carries all_reduce and all_gather on CUDA tensors but not send/recv:
#: ``scripts/gloo_cuda_probe.py`` on an H100 (torch 2.11) gave "Bad address"
#: for both of them, the card's pointer read as host memory.  So the
#: pipeline's hop runs in (a) only.
PAR_GLOO = {
    "dp_conv": ([2, 1], "conv", None, "dp"),
    "tp_pallas": ([1, 2], "pallas", True, "tp"),
    "tp_conv": ([1, 2], "conv", True, "tp"),
    "coeffs": ([1, 2], "coeffs", True, "coeffs"),
    "ntt_bins": ([1, 2], "ntt", True, "ntt"),
}


#: why a mode of (a) is not in (b)
PAR_NOT_GLOO = {
    "dp_fusedp": "batch DP calls no collective, and (b)'s dp_conv runs its path",
    "pp_conv": "gloo cannot send/recv CUDA tensors (scripts/gloo_cuda_probe.py)",
    "pp_pallas": "gloo cannot send/recv CUDA tensors (scripts/gloo_cuda_probe.py)",
}


def want_launches(impl: str, calls: int, steps: int) -> dict:
    """Kernels A's, H's and E's launches for ``calls`` rotations of
    ``impl``: A or H once per step for 'pallas' or 'conv', E once per
    rotation for 'fusedp', none for the plain impls."""
    return {"ep_contract_rbn": steps * calls if impl == "pallas" else 0,
            "ep_contract": steps * calls if impl == "conv" else 0,
            "blind_rotate_fused_pipe": calls if impl == "fusedp" else 0}


def phase6(kernels, epk, tfhe, noise, to_numpy_u32, ck, sk, params, ca, cb, want, card,
           dev) -> dict:
    """The sharded and pipelined gates (``tfhe_tpu_torch/parallel``) at
    default_128, NAND, B=64 per rank, each held bit for bit against the
    one-card 'conv' gate on the same inputs: (a) world 1 over NCCL in this
    process, every mode; (b) two ranks on this card over gloo, spawned,
    each holding its own key shard, the modes of ``PAR_GLOO``, after
    Kernels A and H are held against their twins at the rows a model shard
    gives them.  Returns the launches of Kernels A, H and E in both parts,
    summed over ranks."""
    import torch.distributed as dist

    from tfhe_tpu_torch.parallel import (make_mesh, make_pipeline_mesh, make_pipelined_gate,
                                         make_sharded_gate)
    from tfhe_tpu_torch.parallel._testing import World
    from tfhe_tpu_torch.parallel.traffic import expected_calls, expected_collectives
    from tfhe_tpu_torch.utils.profiling import sampled_clocks

    log(f"phase 6: sharded and pipelined gates (tfhe_tpu_torch/parallel) at {params.name}, "
        f"NAND, B={PAR_B} per rank, each against the one-card conv gate")
    for mode in PAR_NCCL:
        where = "(a) world 1 over NCCL" + (" and (b) 2 ranks over gloo" if mode in PAR_GLOO else
                                           f", not (b): {PAR_NOT_GLOO[mode]}")
        log(f"  {mode:9s} runs in {where}")
    steps = params.n
    rows = (params.k + 1) * params.pbs_decomposer.levels
    ref = tfhe.gates.nand(sk, ca[:PAR_M * PAR_B], cb[:PAR_M * PAR_B], impl="conv")
    queue = [c[:PAR_M * PAR_B].reshape(PAR_M, PAR_B, -1) for c in (ca, cb)]
    totals = dict.fromkeys(want_launches("conv", 0, 0), 0)

    def check(mode, impl, out, counts, payloads, calls, traffic_mode, pipeline, rank=""):
        rows_out = out.reshape(-1, out.shape[-1])
        require(torch.equal(rows_out, ref[:rows_out.shape[0]]),
                f"phase 6 {mode}{rank} differs from the one-card conv gate")
        check_gates(tfhe, noise, to_numpy_u32, ck, {f"{mode}{rank}": rows_out}, want)
        gates = PAR_M if pipeline else 1
        got = {k: counts[k] for k in totals}
        require(got == want_launches(impl, gates, steps),
                f"phase 6 {mode}{rank}: Kernels A/H/E launched {got}, want "
                f"{want_launches(impl, gates, steps)}")
        m = PAR_M if pipeline else 0
        model = expected_collectives(params, traffic_mode, PAR_B, m)
        require(payloads == model, f"phase 6 {mode}{rank}: recorded collectives {payloads} != "
                                   f"the traffic model {model}")
        model_calls = expected_calls(params, traffic_mode, PAR_B, m)  # one stage
        require(calls == model_calls, f"phase 6 {mode}{rank}: recorded calls {calls} != "
                                      f"the traffic model {model_calls}")
        for k in totals:
            totals[k] += got[k]

    log("  (a) world 1 over NCCL, in this process")
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    mesh, pmesh = make_mesh(1, 1, device=dev), make_pipeline_mesh(1, 1, device=dev)
    dist.barrier()  # NCCL makes its communicator at the first collective
    log(f"  NCCL init (the process group, both meshes, a first barrier): "
        f"{time.perf_counter() - t0:.3f} s")
    for mode, (kind, impl, use_model_axis, traffic_mode) in PAR_NCCL.items():
        pipeline = kind == "pipeline"
        if pipeline:
            gate = make_pipelined_gate(pmesh, params, "nand", impl=impl)
            args = queue
        else:
            gate = make_sharded_gate(mesh, params, "nand", impl=impl,
                                     use_model_axis=use_model_axis)
            args = (ca[:PAR_B], cb[:PAR_B])
        out, counts = drive(kernels, lambda: gate(*args, sk))
        check(mode, impl, out, counts, gate.recorder.payloads(), gate.recorder.calls(),
              traffic_mode, pipeline)
        ms, clocked = sampled_clocks(lambda: gate(*args, sk), 1, warmup=False)
        mhz = sorted(m for m, _ in clocked)
        log(f"  (a) {mode:9s} world 1: {ms:.3f} ms per gate ({PAR_M if pipeline else 1} x "
            f"B={PAR_B}); SM clock {len(mhz)} samples {mhz[:1] + mhz[-1:]} MHz; equal to conv, "
            f"launches {counts}, collectives {gate.recorder.calls()}; card: {card}")
    dist.destroy_process_group()

    log("  Kernels A and H at the rows a model shard gives them (R = 18/model), B=64, "
        "against their twins")
    rng = np.random.default_rng(61)
    for model in (2, 3, 6):
        r = rows // model
        for fn, twin, symbol, key, layout in (
                (epk.ep_contract_rbn, epk.ep_contract_rbn_ref, "ep_contract_rbn", sk.bk_lm, "rbn"),
                (epk.ep_contract, epk.ep_contract_ref, "ep_contract", sk.bk_u32, "batch")):
            shape = (r, PAR_B, params.degree) if layout == "rbn" else (PAR_B, r, params.degree)
            for lo, hi in ((-8, 17), (-128, 128)):
                d = torch.from_numpy(rng.integers(lo, hi, size=shape, dtype=np.int8)).to(dev)
                g = key[0, r * (model - 1):].contiguous()  # the last shard's rows
                err = max_abs_err(fn(d, g), twin(d, g))
                require(err == 0, f"{symbol} differs from its twin at R={r}")
            plan = epk.last_plan[symbol]
            log(f"  {symbol} R={r} (model={model}): equal to the twin on gate-range and "
                f"full-range digits; split {plan['split']}, rows per split "
                f"{plan['rows_per_split']}, {plan['ctas']} CTAs")

    log("  (b) two ranks on this card over gloo, spawned; each rank builds the key from "
        "seed 0 and keeps its own shard")
    inputs = {"ct0": to_numpy_u32(ca[:PAR_B]), "ct1": to_numpy_u32(cb[:PAR_B]),
              "ct0_dp_conv": to_numpy_u32(ca[:2 * PAR_B]),
              "ct1_dp_conv": to_numpy_u32(cb[:2 * PAR_B])}
    cases = [dict(kind="sharded", name=mode, shape=shape, impl=impl,
                  use_model_axis=use_model_axis, time=True)
             for mode, (shape, impl, use_model_axis, _) in PAR_GLOO.items()]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = World(dict(world=2, backend="gloo", device="cuda:0", params=params.name,
                         key_seed=0, cases=cases), tmp, inputs).wait(900)
    log(f"  (b) world of 2 ran in {time.perf_counter() - t0:.1f} s; gloo init "
        f"{[round(r['init_s'], 3) for r in res['ranks']]} s per rank")
    for mode, (shape, impl, _, traffic_mode) in PAR_GLOO.items():
        out = torch.from_numpy(res["outputs"][mode].view(np.int32)).to(dev)
        for i, rank in enumerate(res["ranks"]):
            payloads = {k: set(v) for k, v in rank[mode]["payloads"].items()}
            calls = {k: {int(b): c for b, c in v.items()} for k, v in rank[mode]["calls"].items()}
            require(rank[mode]["batch_local"] == PAR_B,
                    f"phase 6 {mode} rank {i} held {rank[mode]['batch_local']} ciphertexts")
            check(mode, impl, out, rank[mode]["launches"], payloads, calls, traffic_mode, False,
                  f" rank {i}")
        mhz = sorted(res["ranks"][0][mode]["sm_clock_samples"])
        log(f"  (b) {mode:9s} world 2 mesh {shape}: "
            f"{max(r[mode]['ms'] for r in res['ranks']):.3f} ms per gate (the slower rank; "
            f"ranks {[round(r[mode]['ms'], 3) for r in res['ranks']]}); SM clock {len(mhz)} "
            f"samples {[m for m, _ in mhz[:1] + mhz[-1:]]} MHz; equal to conv; launches per "
            f"rank {[r[mode]['launches'] for r in res['ranks']]}; collectives "
            f"{res['ranks'][0][mode]['calls']}; card: {card}")
    return totals


def main() -> int:
    t_start = time.perf_counter()
    card = phase0()
    sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]
    from measure_torch import graph_ms, int8_products_per_sample_step
    from measure_torch import sampled_clocks
    import tfhe_tpu_torch as tfhe
    from tfhe_tpu_torch.models import bootstrap as mboot
    from tfhe_tpu_torch.models import ggsw as mggsw
    from tfhe_tpu_torch.models import glwe as mglwe
    from tfhe_tpu_torch.models import keyswitch as mks
    from tfhe_tpu_torch.models.keys import ntt_build_peak_bytes, ntt_form_bytes
    from tfhe_tpu_torch.models import test_vector as mtv
    from tfhe_tpu_torch.ops.cuda import blind_rotate_kernel as brk
    from tfhe_tpu_torch.ops.cuda import ep_kernel as epk
    from tfhe_tpu_torch.ops import ntt, sampling
    from tfhe_tpu_torch.ops.cuda import latency_kernel as latk
    from tfhe_tpu_torch.ops.cuda import ntt_kernel as nttk
    from tfhe_tpu_torch.ops.cuda._build import smem_budget
    from tfhe_tpu_torch.ops.poly import bk_to_matmul_w
    from tfhe_tpu_torch.ops.torus import decode, switch_modulus, to_numpy_u32, to_torch_u32
    from tfhe_tpu_torch import cli
    from tfhe_tpu_torch.utils import noise
    from tfhe_tpu_torch.utils import serialization as ser

    dev = torch.device("cuda")
    kernels = (epk.KERNEL, brk.KERNEL, latk.KERNEL, nttk.KERNEL, brk.PIPE_KERNEL,
               brk.WIDE_PIPE_KERNEL, brk.COLS_KERNEL, epk.BATCH_KERNEL)
    phase1(kernels, (epk.KERNEL, epk.BATCH_KERNEL, brk.KERNEL, brk.PIPE_KERNEL,
                     brk.WIDE_PIPE_KERNEL, brk.COLS_KERNEL))
    sass = {}
    for tag, kernel in (("C", latk.KERNEL), ("D", nttk.KERNEL)):
        sass[tag] = sass_counts(kernel)
        log(f"  {kernel.source}: {sass[tag]['imma']} IMMA, {sass[tag]['idp4a']} IDP4A "
            "instructions (sass_compare.sass_lines)")
        require(sass[tag]["imma"] > 0 and sass[tag]["idp4a"] == 0,
                f"Kernel {tag}'s products are not all on the tensor cores (IMMA, no IDP4A)")
    t0 = time.perf_counter()
    budget = smem_budget(dev)
    budget_us = (time.perf_counter() - t0) * 1e6
    log(f"shared-memory budget (opt-in per block): {budget} bytes, read in {budget_us:.1f} us")

    params = tfhe.get_params("default_128")
    t0 = time.perf_counter()
    ck, sk = tfhe.keygen(params, torch.Generator().manual_seed(0), bmmp=True)
    require(sk.device.type == "cuda", f"keygen put the keys on {sk.device}")
    sk = tfhe.with_latency_key(sk)
    torch.cuda.synchronize()
    log(f"keygen {params.name} (n={params.n}, k={params.k}, N={params.degree}) with the BMMP "
        f"and latency keys: {time.perf_counter() - t0:.2f} s")
    for name, attach in (("with_ntt_key", tfhe.with_ntt_key),
                         ("with_ntt_lhs_key", tfhe.with_ntt_lhs_key)):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        # the guard counts the forms the key holds, the new form and a chunk's workspace
        held = nbytes(*(f for f in (sk.bk_ntt, sk.bk_ntt_lhs) if f is not None))
        guard = ntt_build_peak_bytes(sk)
        t0 = time.perf_counter()
        sk = attach(sk)
        torch.cuda.synchronize()
        counted = held + torch.cuda.max_memory_allocated() - before
        log(f"{name}: {time.perf_counter() - t0:.3f} s; device memory allocated before "
            f"{before / 2**30:.3f} GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
            f"held forms + peak rise {counted / 2**30:.3f} GiB against the guard's "
            f"{guard / 2**30:.3f} GiB (one form is {ntt_form_bytes(params) / 2**30:.3f} GiB)")
        require(counted <= guard, f"{name} peaked above what its memory guard counts")
    phase2(epk, brk, tfhe.get_params, to_torch_u32, params, sk, dev)
    phase2_latency(latk, tfhe.get_params, to_torch_u32, params, sk, dev)
    phase2_nttf(nttk, ntt, tfhe.get_params, to_torch_u32, params, sk, dev)
    phase2_whole_scan(brk, tfhe.get_params, to_torch_u32, params, sk, dev)
    phase2_large(brk, tfhe.get_params, to_torch_u32, dev)
    phase2_ep_batch(epk, tfhe.get_params, to_torch_u32, params, sk, dev)
    phase2_ep_edges(epk, tfhe.get_params, to_torch_u32, dev)

    log(f"phase 3: main paths, {params.name} NAND")
    rng = np.random.default_rng(3)
    bits_a = rng.integers(0, 2, size=MAIN_B, dtype=np.uint32)
    bits_b = rng.integers(0, 2, size=MAIN_B, dtype=np.uint32)
    want = 1 - (bits_a & bits_b)
    ca = tfhe.encrypt(ck, bits_a, torch.Generator().manual_seed(1))
    cb = tfhe.encrypt(ck, bits_b, torch.Generator().manual_seed(2))

    def nand(impl, b):
        return tfhe.gates.nand(sk, ca[:b], cb[:b], impl=impl)

    log(f"  throughput path: fused and fusedb at B={MAIN_B}, auto at B={AUTO_B}")
    outs, launches = drive(kernels, lambda: {
        "fused": nand("fused", MAIN_B), "fusedb": nand("fusedb", MAIN_B),
        "auto": nand("auto", AUTO_B)})
    check_gates(tfhe, noise, to_numpy_u32, ck, outs, want)
    outs_tp = outs
    require(torch.equal(outs["auto"], outs["fused"][:AUTO_B]),
            "auto (pallas, Kernel A) output differs from the fused (Kernel B) rows")
    log(f"  auto (pallas) == fused[:{AUTO_B}] bit for bit; launches: {launches}")
    require(launches["ep_contract_rbn"] > 0 and launches["blind_rotate_fused"] > 0,
            f"a kernel of the throughput path was not launched: {launches}")
    fused_rows = outs["fused"]

    add_a, add_b = 200, 100
    xa = tfhe.circuits.encrypt_uint(ck, [add_a], ADD_W, torch.Generator().manual_seed(4))
    xb = tfhe.circuits.encrypt_uint(ck, [add_b], ADD_W, torch.Generator().manual_seed(5))
    log(f"  latency path: fusedl at B=1 and B=8, bmmpl at B=4, {ADD_W}-bit add at B=1")
    (outs, added), lat_launches = drive(kernels, lambda: (
        {"fusedl": nand("fusedl", 1), "fusedl/8": nand("fusedl", 8),
         "bmmpl": nand("bmmpl", 4)},
        tfhe.circuits.add_uint(sk, xa, xb, impl="fusedl")))
    log(f"  Kernel C plan at the last launch: {latk.last_plan}")
    check_gates(tfhe, noise, to_numpy_u32, ck, outs, want)
    for key, b in (("fusedl", 1), ("fusedl/8", 8)):
        require(torch.equal(outs[key], fused_rows[:b]),
                f"fusedl (Kernel C) at B={b} differs from the fused (Kernel B) rows")
    total = int(to_numpy_u32(tfhe.circuits.decrypt_uint(ck, added))[0])
    log(f"  fusedl == fused rows at B=1 and B=8 bit for bit; {add_a} + {add_b} mod 2^{ADD_W} "
        f"= {total} (encrypted add); launches: {lat_launches}")
    require(total == (add_a + add_b) % (1 << ADD_W), f"encrypted add gave {total}")
    require(lat_launches["blind_rotate_latency"] > 0,
            f"Kernel C was not launched on the latency path: {lat_launches}")

    log(f"  bmmp path: the BMMP scan at B={BMMP_B}")
    bmmp_out, bmmp_launches = drive(kernels, lambda: nand("bmmp", BMMP_B))
    check_gates(tfhe, noise, to_numpy_u32, ck, {"bmmp": bmmp_out}, want)
    require(torch.equal(outs["bmmpl"], bmmp_out[:4]),
            "bmmpl (Kernel C, V=3) output differs from the bmmp (Kernel A) rows")
    log(f"  bmmpl == bmmp[:4] bit for bit; launches: {bmmp_launches}")
    require(bmmp_launches["ep_contract_rbn"] > 0,
            f"Kernel A was not launched on the bmmp path: {bmmp_launches}")
    log(f"  block-NTT path: nttf at B={MAIN_B}, ntt and ntts at B={NTT_B}")
    ntt_outs, ntt_launches = drive(kernels, lambda: {
        "nttf": nand("nttf", MAIN_B), "ntt": nand("ntt", NTT_B), "ntts": nand("ntts", NTT_B)})
    check_gates(tfhe, noise, to_numpy_u32, ck, ntt_outs, want)
    for impl, out in ntt_outs.items():
        require(torch.equal(out, fused_rows[:out.shape[0]]),
                f"{impl} output differs from the fused (Kernel B) rows")
    log(f"  nttf == fused, ntt == ntts == fused[:{NTT_B}] bit for bit; launches: {ntt_launches}")
    require(ntt_launches["blind_rotate_nttf"] > 0,
            f"Kernel D was not launched on the block-NTT path: {ntt_launches}")
    log(f"  whole-scan variants path: {', '.join(WHOLE_SCAN)} at B={MAIN_B}")
    ws_outs, ws_launches = drive(kernels, lambda: {
        impl: nand(impl, MAIN_B) for impl in WHOLE_SCAN})
    check_gates(tfhe, noise, to_numpy_u32, ck, ws_outs, want)
    same_as = {"fusedp": fused_rows, "fusedc": fused_rows, "fusedw": fused_rows,
               "fusedwb": outs_tp["fusedb"], "fusedp3": ws_outs["fused3"],
               "fusedc3": ws_outs["fused3"]}
    for impl, rows in same_as.items():
        require(torch.equal(ws_outs[impl], rows), f"{impl} output differs from its partner rows")
    log(f"  fusedp == fusedc == fusedw == fused, fusedwb == fusedb, fusedp3 == fusedc3 == fused3 "
        f"bit for bit; launches: {ws_launches}; plans {brk.last_plan}")
    for k in (brk.KERNEL, brk.PIPE_KERNEL, brk.WIDE_PIPE_KERNEL, brk.COLS_KERNEL):
        require(ws_launches[k.symbol] > 0,
                f"{k.symbol} was not launched on the whole-scan variants path: {ws_launches}")

    log(f"  conv path: the 'conv' scan at B={CONV_B}")
    conv_out, conv_launches = drive(kernels, lambda: nand("conv", CONV_B))
    check_gates(tfhe, noise, to_numpy_u32, ck, {"conv": conv_out}, want)
    require(torch.equal(conv_out, fused_rows[:CONV_B]),
            "conv (Kernel H) output differs from the fused (Kernel B) rows")
    log(f"  conv == fused[:{CONV_B}] bit for bit; launches: {conv_launches}")
    require(conv_launches["ep_contract"] == params.n and conv_launches["ep_contract_rbn"] == 0,
            f"the conv scan did not launch Kernel H once per step and Kernel A never: "
            f"{conv_launches}")

    log(f"  GGSW path: ggsw.cmux of {CMUX_B} GLWE ciphertexts against the key's first GGSW")
    gen = torch.Generator(device=dev).manual_seed(9)
    sk_t = mglwe.sk_toeplitz(ck.glwe_sk)
    glwe_bits = sampling.binary(gen, (2, CMUX_B, params.degree))
    c0, c1 = (mglwe.encrypt(sk_t, glwe_bits[i] * params.delta,
                            sampling.uniform_u32(gen, (CMUX_B, params.k, params.degree)),
                            sampling.gaussian_torus(gen, params.glwe_std_dev,
                                                    (CMUX_B, params.degree)))
              for i in (0, 1))
    cmux_out, cmux_launches = drive(
        kernels, lambda: mggsw.cmux(sk.bk_u32[0], c0, c1, params, impl="conv"))
    require(torch.equal(cmux_out, mggsw.cmux(sk.bk_u32[0], c0, c1, params, impl="matmul")),
            "ggsw.cmux impl='conv' (Kernel H) differs from impl='matmul'")
    selected = int(ck.lwe_sk[0])
    decoded = decode(mglwe.decrypt(sk_t, cmux_out), params.log_q, params.log_p,
                     params.padding_bits)
    cmux_errors = int((decoded != glwe_bits[selected]).sum())
    log(f"  cmux conv == matmul bit for bit; decrypts to c{selected}'s bits with {cmux_errors} "
        f"errors of {decoded.numel()}; launches: {cmux_launches}")
    require(cmux_errors == 0, f"cmux decrypted with {cmux_errors} wrong coefficients")
    require(cmux_launches["ep_contract"] > 0,
            f"Kernel H was not launched on the GGSW path: {cmux_launches}")
    for k, v in lat_launches.items():
        launches[k] += (v + bmmp_launches[k] + ntt_launches[k] + conv_launches[k]
                        + cmux_launches[k])
    large_counts, large_keys = phase3_large(kernels, tfhe, noise, to_numpy_u32, brk)
    # Kernel B's record counts 'fused' and 'fusedb' (its 'k3' entry the
    # truncated key's), E's, F's and G's every mode, Kernel A's the pallas
    # gates
    for (_, impl), got in large_counts.items():
        for k, v in got.items():
            main = k == "ep_contract_rbn" or impl in ("fused", "fusedb")
            (launches if main else ws_launches)[k] += v

    log(f"phase 4: timing, fusedb NAND at B={MAIN_B} (CUDA events)")
    tv = to_torch_u32(mtv.gate_test_vector(params, "nand"), dev)
    # cards of one name and power limit have run the same kernel at different
    # clocks, so the gate time carries the SM clock it ran at
    fusedb_ms, clocked = sampled_clocks(lambda: tfhe.gates.nand(sk, ca, cb, impl="fusedb"), 3)
    mhz = sorted(c for c, _ in clocked) or [float("nan")]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ct_in = cb * 2 + ca
    events[0].record()
    approx = switch_modulus(ct_in, params.log_q, params.log_degree + 1)
    events[1].record()
    acc = mboot.blind_rotate(params, approx, sk, tv, impl="fusedb")
    events[2].record()
    ext = mboot.sample_extract0(acc)
    events[3].record()
    mks.key_switch(ext, params.k * params.degree, params.ks_decomposer, sk.ksk_mat)
    events[4].record()
    events[4].synchronize()
    stages = dict(zip(("modswitch", "blind_rotate", "sample_extract", "key_switch"),
                      (events[i].elapsed_time(events[i + 1]) for i in range(4))))
    log(f"  fusedb B={MAIN_B}: {fusedb_ms} ms per gate (mean of 3 back to back); "
        f"{MAIN_B / (fusedb_ms / 1e3):.1f} gate bootstraps/s; stages ms {stages}; card: {card}")
    log(f"  SM clock during those gates (nvidia-smi, 100 ms): {len(clocked)} samples, "
        f"{mhz[0]}-{mhz[-1]} MHz, median {mhz[len(mhz) // 2]} MHz")

    # each kernel against its twin at the main paths' shapes
    acc0, a_hat = mboot._init_acc(params, approx, tv)
    bk_ms = cuda_ms(lambda: brk.blind_rotate_fused(params, acc0, sk.bk_u32, a_hat, True), 2)
    got = brk.blind_rotate_fused(params, acc0, sk.bk_u32, a_hat, balanced=True)
    bk_plan = dict(brk.last_plan["blind_rotate_fused"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = brk.blind_rotate_fused_ref(params, acc0, sk.bk_u32, a_hat, balanced=True)
    torch.cuda.synchronize()
    bk_plain_ms = (time.perf_counter() - t0) * 1e3
    bk_err = max_abs_err(got, ref)
    log(f"  blind_rotate_fused fusedb [B={MAIN_B}, n={params.n}]: kernel {bk_ms:.2f} ms, "
        f"plain {bk_plain_ms:.2f} ms, max_abs_err {bk_err}; plan {bk_plan}; card: {card}")
    require(bk_err == 0, "Kernel B disagrees with its twin at the main path's shape")
    log(f"phase 4: Kernels B (fusedb, fusedb3), E (fusedp, fusedp3), F (fusedwb) and G (fusedc) "
        f"alone at B = "
        f"{', '.join(map(str, KERNEL_B_BATCHES))} (CUDA events)")
    alone = time_alone(brk, sk, params, rng, dev, card, sampled_clocks)

    log("phase 4: small-batch gates (CUDA events; mean of 30 after one warm-up, "
        "2 for fusedb and bmmp, so that nvidia-smi samples the clock meanwhile)")
    for impl, b in (("fusedl", 1), ("fusedl", 8), ("bmmpl", 1), ("bmmpl", 4),
                    ("bmmp", BMMP_B), ("fusedb", 1), ("fusedb", 8)):
        ms, clocked = sampled_clocks(lambda: nand(impl, b), 2 if impl in ("fusedb", "bmmp") else 30)
        mhz = sorted(c for c, _ in clocked) or [float("nan")]
        log(f"  gate {impl:6s} B={b:<3d} {ms:.3f} ms; SM clock {len(clocked)} samples "
            f"{mhz[0]}-{mhz[-1]} MHz; card: {card}")
    add_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tfhe.circuits.add_uint(sk, xa, xb, impl="fusedl")
        torch.cuda.synchronize()
        add_s.append(time.perf_counter() - t0)
    log(f"  {ADD_W}-bit add at B=1 through fusedl ({2 * ADD_W + 3} PBS calls): wall s "
        f"{add_s}; card: {card}")

    lat = {}
    for v, b in ((1, 1), (1, 8), (3, 4)):
        app = approx[:b]
        a0, ah = mboot._init_acc(params, app, tv)
        if v == 1:
            key, a_v = sk.bk_lat, ah[:, None, :].contiguous()
        else:
            key = sk.bk_bmmp_lat
            a_v = torch.stack(mboot._bmmp_exponents(params, ah), dim=1).contiguous()
        ms = cuda_ms(lambda: latk.blind_rotate_latency(params, a0, key, a_v), 3)
        got = latk.blind_rotate_latency(params, a0, key, a_v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = latk.blind_rotate_latency_ref(params, a0, key, a_v)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(got, ref)
        lat[v, b] = (ms, plain_ms, err, dict(latk.last_plan))
        log(f"  blind_rotate_latency V={v} B={b} [{key.shape[0]} steps]: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.2f} ms, max_abs_err {err}; plan {latk.last_plan}; card: {card}")
    require(all(e == 0 for _, _, e, _ in lat.values()),
            "Kernel C disagrees with its twin at the main path's shapes")
    lat_ms, lat_plain_ms, _, plan_c = lat[1, 1]

    log(f"phase 4: block-NTT, nttf NAND at B={MAIN_B} (CUDA events)")
    nttf_ms, clocked = sampled_clocks(lambda: tfhe.gates.nand(sk, ca, cb, impl="nttf"), 3)
    mhz = sorted(c for c, _ in clocked) or [float("nan")]
    log(f"  nttf B={MAIN_B}: {nttf_ms} ms per gate (mean of 3 back to back); "
        f"{MAIN_B / (nttf_ms / 1e3):.1f} gate bootstraps/s; SM clock {len(clocked)} samples, "
        f"{mhz[0]}-{mhz[-1]} MHz; card: {card}")
    nd_ms = cuda_ms(lambda: nttk.blind_rotate_nttf(params, acc0, sk.bk_ntt_lhs, a_hat), 2)
    plan_d = dict(nttk.last_plan)
    got = nttk.blind_rotate_nttf(params, acc0, sk.bk_ntt_lhs, a_hat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = nttk.blind_rotate_nttf_ref(params, acc0, sk.bk_ntt_lhs, a_hat)
    torch.cuda.synchronize()
    nd_plain_ms = (time.perf_counter() - t0) * 1e3
    nd_err = max_abs_err(got, ref)
    log(f"  blind_rotate_nttf [B={MAIN_B}, n={params.n}]: kernel {nd_ms:.2f} ms, plain "
        f"{nd_plain_ms:.2f} ms, max_abs_err {nd_err}; plan {plan_d}; card: {card}")
    require(nd_err == 0, "Kernel D disagrees with its twin at the main path's shape")
    for impl in ("ntt", "ntts"):
        ms = cuda_ms(lambda: nand(impl, NTT_B), 2)
        log(f"  gate {impl:6s} B={NTT_B:<3d} {ms:.3f} ms; card: {card}")

    log(f"phase 4: whole-scan variants at B={MAIN_B} (CUDA events; mean of 2 after a warm-up)")
    for impl in WHOLE_SCAN:
        ms, clocked = sampled_clocks(lambda: nand(impl, MAIN_B), 2)
        mhz = sorted(c for c, _ in clocked) or [float("nan")]
        log(f"  gate {impl:7s} B={MAIN_B} {ms:.3f} ms, {MAIN_B / (ms / 1e3):.1f} gate "
            f"bootstraps/s; SM clock {len(clocked)} samples {mhz[0]}-{mhz[-1]} MHz; card: {card}")
    ws = {}  # record name -> (ms, plain ms, max_abs_err, key limbs)
    for name, impl in (("blind_rotate_fused_k3", "fusedb3"), ("blind_rotate_fused_pipe", "fusedp"),
                       ("blind_rotate_fused_wide_pipe", "fusedwb"),
                       ("blind_rotate_fused_cols", "fusedc")):
        fn, options = WHOLE_SCAN[impl]
        rotate, twin = getattr(brk, fn), getattr(brk, fn + "_ref")
        ms, clocked = sampled_clocks(lambda: rotate(params, acc0, sk.bk_u32, a_hat, **options), 2)
        mhz = sorted(c for c, _ in clocked) or [float("nan")]
        plan = dict(brk.last_plan[fn])
        plan["waves"] = waves(plan, params.k + 1, dev)
        got = rotate(params, acc0, sk.bk_u32, a_hat, **options)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = twin(params, acc0, sk.bk_u32, a_hat, **options)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(got, ref)
        ws[name] = (ms, plain_ms, err, options.get("key_limbs", 4), plan)
        log(f"  {fn} ({impl}) [B={MAIN_B}, n={params.n}]: kernel {ms:.2f} ms (mean of 2 back "
            f"to back), plain {plain_ms:.2f} ms, max_abs_err {err}; SM clock {len(clocked)} "
            f"samples, {mhz[0]}-{mhz[-1]} MHz; plan {plan}; card: {card}")
    require(all(e == 0 for _, _, e, *_ in ws.values()),
            "a whole-scan kernel disagrees with its twin at the main path's shape")
    now = {"B": bk_ms, "E": ws["blind_rotate_fused_pipe"][0],
           "F": ws["blind_rotate_fused_wide_pipe"][0], "G": ws["blind_rotate_fused_cols"][0]}
    log(f"  default_128 at B={MAIN_B} on the gate's inputs beside PERF.md's: "
        + "; ".join(f"{k} {now[k]:.2f} ms against {v} ({now[k] / v - 1:+.2%})"
                    for k, v in PERF_DEFAULT_128.items()))
    log("phase 4: Kernels B (fused), E (fusedp), F (fusedw) and G (fusedc) alone at "
        + ", ".join(f"{name} B={b}" for name, (b, _) in LARGE.items()) + " (CUDA events)")
    large = time_large(brk, large_keys, dev, card)

    log(f"phase 4: the contraction kernels A and H beside their library call and bound, "
        f"and the conv gate at B={CONV_B} (CUDA events)")
    k1, n = params.k + 1, params.degree
    r = k1 * params.pbs_decomposer.levels
    steps = params.n
    ep = time_contractions(epk, sk, params, rng, dev, card, graph_ms, bk_to_matmul_w)
    ep_a, ep_h = ep["A", r, AUTO_B], ep["H", r, CONV_B]
    conv_ms = cuda_ms(lambda: nand("conv", CONV_B), 2)
    log(f"  gate conv   B={CONV_B:<3d} {conv_ms:.3f} ms (mean of 2 after a warm-up); card: {card}")

    cli_launches = phase5(kernels, tfhe, ser, cli, sk, ck, params, brk.PIPE_KERNEL, latk.KERNEL,
                          card)
    phase5_large(card)
    for k, v in cli_launches.items():
        launches[k] += v
        ws_launches[k] += v
    t_phase = time.perf_counter()
    for k, v in phase6(kernels, epk, tfhe, noise, to_numpy_u32, ck, sk, params, ca, cb, want,
                       card, torch.device("cuda", torch.cuda.current_device())).items():
        launches[k] += v
        ws_launches[k] += v
    log(f"  phase 6: {time.perf_counter() - t_phase:.1f} s")

    # bounds at the shapes the timings above ran
    acc_bytes = 2 * nbytes(acc0) + nbytes(a_hat)  # acc in and out, exponents
    bk_bound = bound(r * n * k1 * n * 4 * steps * MAIN_B, acc_bytes + nbytes(sk.bk_u32))
    b1 = 2 * nbytes(acc0[:1]) + nbytes(a_hat[:, :1])
    lat_bound = bound(k1 * 4 * sk.bk_lat.shape[-1] * n * steps, b1 + nbytes(sk.bk_lat))
    # one sample runs on one cluster: the card's bound over the SMs it holds
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lat_cluster_bound = lat_bound[0] * sms / plan_c["cluster"]
    plan_c.update(sass["C"])
    nd_bound = bound(int8_products_per_sample_step(params) * steps * MAIN_B,
                     acc_bytes + nbytes(sk.bk_ntt_lhs))
    plan_d.update(sass["D"])

    record = {"kernels": [
        {"name": "ep_contract_rbn", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/ep_kernel.cu",
         "replaces": "tfhe_tpu/ops/pallas/ep_kernel.py:128",
         "launches": launches["ep_contract_rbn"],
         "max_abs_err": max(v["max_abs_err"] for (kind, *_), v in ep.items() if kind == "A"),
         "ms": ep_a["ms"], "plain_ms": ep_a["plain_ms"], "bound_ms": ep_a["bound_ms"],
         "bound_by": ep_a["bound_by"], "library_ms": ep_a["library_ms"], "plan": ep_a["plan"]},
        {"name": "ep_contract", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/ep_batch_kernel.cu",
         "replaces": "tfhe_tpu/ops/pallas/ep_kernel.py:66",
         "launches": launches["ep_contract"],
         "max_abs_err": max(v["max_abs_err"] for (kind, *_), v in ep.items() if kind == "H"),
         "ms": ep_h["ms"], "plain_ms": ep_h["plain_ms"], "bound_ms": ep_h["bound_ms"],
         "bound_by": ep_h["bound_by"], "library_ms": ep_h["library_ms"], "plan": ep_h["plan"]},
        {"name": "blind_rotate_fused", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate_kernel.cu",
         "replaces": "tfhe_tpu/ops/pallas/blind_rotate_kernel.py:862",
         "launches": launches["blind_rotate_fused"],
         "max_abs_err": max([bk_err] + [v["max_abs_err"] for (impl, _), v in alone.items()
                                        if ALONE[impl][0] == "B"]
                            + [v["max_abs_err"] for (_, kn), v in large.items() if kn == "B"]),
         "ms": bk_ms, "plain_ms": bk_plain_ms, "bound_ms": bk_bound[0],
         "bound_by": bk_bound[1], "library_ms": None, "plan": bk_plan,
         "large": {name: v for (name, kernel), v in large.items() if kernel == "B"}},
        {"name": "blind_rotate_latency", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/latency_kernel.cu",
         "replaces": "tfhe_tpu/ops/pallas/latency_kernel.py:220",
         "launches": launches["blind_rotate_latency"],
         "max_abs_err": max(e for _, _, e, _ in lat.values()),
         "ms": lat_ms, "plain_ms": lat_plain_ms, "bound_ms": lat_bound[0],
         "one_cluster_bound_ms": lat_cluster_bound, "bound_by": lat_bound[1],
         "library_ms": None, "plan": plan_c},
        {"name": "blind_rotate_nttf", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/ntt_kernel.cu",
         "replaces": "tfhe_tpu/ops/pallas/ntt_kernel.py:211",
         "launches": launches["blind_rotate_nttf"], "max_abs_err": nd_err,
         "ms": nd_ms, "plain_ms": nd_plain_ms, "bound_ms": nd_bound[0],
         "bound_by": nd_bound[1], "library_ms": None, "plan": plan_d},
    ]}
    # the whole-scan variants: Kernel B at key_limbs=3 (its launches on the
    # variants path are fused3's and fusedb3's), Kernels E, F and G
    for name, symbol, source, line, kernel in (
            ("blind_rotate_fused_k3", "blind_rotate_fused", "blind_rotate_kernel", 862, None),
            ("blind_rotate_fused_pipe", "blind_rotate_fused_pipe", "pipe_kernel", 793, "E"),
            ("blind_rotate_fused_wide_pipe", "blind_rotate_fused_wide_pipe",
             "wide_pipe_kernel", 723, "F"),
            ("blind_rotate_fused_cols", "blind_rotate_fused_cols", "cols_kernel", 664, "G")):
        ms, plain_ms, err, key_limbs, plan = ws[name]
        err = max([err] + [v["max_abs_err"] for (impl, _), v in alone.items()
                           if ALONE[impl][0] == kernel]
                  + [v["max_abs_err"] for (_, kn), v in large.items() if kn == kernel])
        b = bound(r * n * k1 * n * key_limbs * steps * MAIN_B, acc_bytes + nbytes(sk.bk_u32))
        entry = {
            "name": name, "route": "cuda", "source": f"tfhe_tpu_torch/csrc/{source}.cu",
            "replaces": f"tfhe_tpu/ops/pallas/blind_rotate_kernel.py:{line}",
            "launches": ws_launches[symbol], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
            "plan": plan}
        if kernel is not None:
            entry["large"] = {nm: v for (nm, kn), v in large.items() if kn == kernel}
        record["kernels"].append(entry)
    log(f"whole run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
