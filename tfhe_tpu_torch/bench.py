"""The benchmark: gate bootstraps/s on one card (port of ``bench.py``).

    python -m tfhe_tpu_torch.bench                  # default_128 NAND on the card
    python -m tfhe_tpu_torch.bench --latency --trace traces/
    python -m tfhe_tpu_torch.bench --params nano --device cpu --batch 4   # the CPU twins

Workload: batched NAND gate bootstrapping at ``default_128`` (n=722, k=2,
N=512, l_pbs=6, l_ks=5).  The north-star target is >=1000 gate
bootstraps/sec/chip, the baseline of ``vs_baseline``.

Prints ONE JSON line on stdout, in ``bench.py``'s format:
  {"metric": ..., "value": N, "unit": "bootstraps/s", "vs_baseline": N/1000,
   "breakdown": {bench.py's keys, plus the device, the card's name, power
   limit and SM clock, the key form's and the first call's seconds}}
Diagnostics go to stderr.  Correctness (--check) is ON by default: the
decrypted gate outputs and the noise margin of the same run ride along.

Its ``auto`` is its own, as ``bench.py``'s is: on the card it picks
``fusedp`` (Kernel E), the fastest exact impl measured on the card (PERF.md),
whose digits are the reference's, at B=1024 (one wave of Kernel E); on the
CPU it picks ``conv`` at B=64, as ``bench.py`` does off the TPU.  The
library's ``resolve_impl('auto')`` stays ``pallas``.

Timing: CUDA events, one warm-up call, then ``--iters`` calls back to back
with one sync, best of 3 rounds (``utils/profiling.py:time_best``), with the
SM clock sampled by nvidia-smi during the rounds.  The first call, which
builds the impl's kernel at first use, is reported apart (``first_call_s``),
and so is the build of the key form the impl reads (``keyform_s``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import tfhe_tpu_torch as tfhe
from tfhe_tpu_torch.models import keyswitch as mks
from tfhe_tpu_torch.models import lwe as mlwe
from tfhe_tpu_torch.models import test_vector as mtv
from tfhe_tpu_torch.models.bootstrap import IMPLS, VALID_IMPLS, blind_rotate, pbs, sample_extract0
from tfhe_tpu_torch.ops.torus import switch_modulus, to_numpy_u32
from tfhe_tpu_torch.utils import noise as unoise
from tfhe_tpu_torch.utils.profiling import (
    capture_trace, card_name_and_power_limit, clock_samples, synchronize, time_best,
)

BASELINE_BOOTSTRAPS_PER_SEC = 1000.0
#: the small batches ``--latency`` times, up to ``--batch``
LATENCY_BATCHES = (1, 4, 8, 16, 64, 256)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def resolve_bench_impl(impl: str, on_card: bool) -> str:
    """The bench's own 'auto': 'fusedp' on the card, 'conv' on the CPU."""
    if impl != "auto":
        return impl
    if on_card:
        log("note: --impl auto selected 'fusedp' (Kernel E, the fastest exact impl "
            "measured on the card; reference carry-chain digits, bit for bit equal to "
            "'fused'). The library's own 'auto' resolves to 'pallas' (Kernel A).")
        return "fusedp"
    return "conv"


def default_batch(impl: str, on_card: bool) -> int:
    """The impl's batch cap, else 1024 on the card and 64 on the CPU."""
    return IMPLS[impl].batch_cap or (1024 if on_card else 64)


def card_fields(device: torch.device) -> dict:
    """The card's name and power limit (nvidia-smi), or nulls on the CPU."""
    if device.type != "cuda":
        return {"card": None, "power_limit": None}
    with torch.cuda.device(device):
        name, limit = card_name_and_power_limit()
    return {"card": name, "power_limit": limit}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m tfhe_tpu_torch.bench")
    ap.add_argument("--params", default="default_128")
    ap.add_argument("--batch", type=int, default=0, help="0 = default for impl")
    ap.add_argument("--impl", default="auto", choices=list(VALID_IMPLS))
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--no-check", action="store_true",
                    help="skip the same-run correctness/noise verification")
    ap.add_argument("--no-stages", action="store_true",
                    help="skip the per-stage breakdown timings")
    ap.add_argument("--trace", default="",
                    help="capture a torch profiler trace of one gate call to this dir")
    ap.add_argument("--latency", action="store_true",
                    help="also measure gate latency at small batches "
                         f"{LATENCY_BATCHES} up to --batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the kernels' twins)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise SystemExit("bench: no CUDA card (torch.cuda.is_available() is false); "
                             "pass --device cpu to run the kernels' twins")
        device = torch.device("cuda", torch.cuda.current_device() if device.index is None
                              else device.index)
        torch.cuda.set_device(device)
    params = tfhe.get_params(args.params)
    impl = resolve_bench_impl(args.impl, on_card)
    batch = args.batch or default_batch(impl, on_card)
    iters = args.iters
    card = card_fields(device)
    log(f"device: {device} ({card['card']}, {card['power_limit']}), params: {params.name}, "
        f"impl: {impl}, batch: {batch}")

    rec = IMPLS[impl]
    t0 = time.perf_counter()
    ck, sk = tfhe.keygen(params, 0, device=device, bmmp=rec.bmmp)
    synchronize(sk.bk_u32)
    keygen_s = time.perf_counter() - t0
    bk_mb = sk.bk_u32.numel() * 4 / 1e6
    log(f"keygen: {keygen_s:.1f}s  bk={bk_mb:.1f}MB")
    t0 = time.perf_counter()
    sk = tfhe.with_key_form(sk, impl)
    synchronize(sk.bk_u32)
    keyform_s = time.perf_counter() - t0
    log(f"key form for {impl}: {keyform_s:.2f}s")

    tv = mtv.on_device(params, device, "gate", "nand")

    def gate(ct0, ct1):
        ct_in = mlwe.add(mlwe.scalar_mul(ct1, 2), ct0)
        return pbs(params, ct_in, sk, tv, impl=impl)

    rng = np.random.default_rng(0)
    lhs = rng.integers(0, 2, size=batch).astype(np.uint32)
    rhs = rng.integers(0, 2, size=batch).astype(np.uint32)
    ct1 = tfhe.encrypt(ck, lhs, 1)
    ct0 = tfhe.encrypt(ck, rhs, 2)
    synchronize(ct0, ct1)

    t0 = time.perf_counter()
    out = gate(ct0, ct1)
    synchronize(out)
    first_call_s = time.perf_counter() - t0
    log(f"first call (kernel build at first use + run): {first_call_s:.1f}s")
    if on_card:
        with clock_samples() as clocked:
            best, out = time_best(lambda: gate(ct0, ct1), iters, device)
        mhz = sorted(c for c, _ in clocked)
    else:
        best, out = time_best(lambda: gate(ct0, ct1), iters, device)
        mhz = []
    rate = batch / best
    clock = (f"SM clock {len(mhz)} samples {mhz[:1] + mhz[-1:]} MHz" if on_card
             else "no SM clock on the CPU")
    log(f"end-to-end: best {best*1e3:.3f}ms -> {rate:.1f} bootstraps/s; {clock}")

    breakdown = {
        "impl": impl,
        # balanced closed-form digits: exact mod-2^32, digit convention
        # differs from the reference trace (DIVERGENCES.md #3)
        "digit_convention": "balanced-exact" if rec.digits == "balanced" else "reference",
        # truncated-key modes drop the low key byte: approximate
        "approx_truncated_key": rec.truncated,
        "batch": batch,
        "keygen_s": round(keygen_s, 2),
        "bk_mbytes": round(bk_mb, 1),
        "gate_ms": round(best * 1e3, 3),
        "per_rotation_step_us": round(best * 1e6 / params.lwe_dimension, 2),
        # exact int8 MACs of the blind rotation (4 limbs x R rows x C cols);
        # BMMP impls run n/2 steps of 3R rows = 1.5x the MACs and 3x the key
        # bytes per (twice-as-long) step
        "int8_tops": round(
            (1.5 if rec.bmmp else 1.0)
            * 2 * batch * params.lwe_dimension
            * (params.glwe_dimension + 1) ** 2 * params.pbs_decomposer.levels
            * 4 * params.degree ** 2 / best / 1e12, 1),
        "bk_bytes_per_step": (3 if rec.bmmp else 1)
        * (params.glwe_dimension + 1) ** 2
        * params.pbs_decomposer.levels * params.degree * 4,
        "device": str(device),
        **card,
        "sm_clock_mhz": [mhz[0], mhz[len(mhz) // 2], mhz[-1]] if mhz else None,
        "sm_clock_samples": len(mhz),
        "iters": iters,
        "keyform_s": keyform_s,
        "first_call_s": first_call_s,
    }

    if not args.no_stages:
        # stage-by-stage timings, each stage alone (sums slightly above the
        # end-to-end time: inter-stage values go through memory)
        def lin():
            return switch_modulus(mlwe.add(mlwe.scalar_mul(ct1, 2), ct0),
                                  params.log_q, params.log_degree + 1)

        fast_iters = max(iters, 24)
        t_lin, approx = time_best(lin, fast_iters, device)
        t_rot, acc = time_best(lambda: blind_rotate(params, approx, sk, tv, impl=impl),
                               iters, device)
        t_ext, extracted = time_best(lambda: sample_extract0(acc), fast_iters, device)
        t_ks, _ = time_best(lambda: mks.key_switch(
            extracted, params.glwe_dimension * params.degree, params.ks_decomposer,
            sk.ksk_mat), fast_iters, device)
        breakdown["stages_ms"] = {
            "linear+modswitch": round(t_lin * 1e3, 3),
            "blind_rotate": round(t_rot * 1e3, 3),
            "sample_extract": round(t_ext * 1e3, 3),
            "key_switch": round(t_ks * 1e3, 3),
        }
        non_rot = t_lin + t_ext + t_ks
        breakdown["non_rotation_pct"] = round(100 * non_rot / (non_rot + t_rot), 2)
        log(f"stages: {breakdown['stages_ms']} "
            f"(non-rotation {breakdown['non_rotation_pct']}%)")

    if args.latency:
        # small-batch gate latency: the time of ONE call when there are few
        # gates to evaluate; amortised over 64 calls with one sync, and synced
        # per call (what a caller waiting on each gate pays)
        lat = {}
        lat_sync = {}
        for b in LATENCY_BATCHES:
            if b > batch:
                continue
            c0b, c1b = ct0[:b], ct1[:b]
            try:
                t, _ = time_best(lambda: gate(c0b, c1b), max(iters, 64), device)
            except ValueError as e:  # refused before any launch, e.g. fusedl at B > 8
                lat[str(b)] = "refused: ValueError"
                log(f"latency batch={b}: refused ({e})")
                continue
            ts = float("inf")
            for _ in range(max(iters, 8)):
                t0 = time.perf_counter()
                synchronize(gate(c0b, c1b))
                ts = min(ts, time.perf_counter() - t0)
            lat[str(b)] = round(t * 1e3, 3)
            lat_sync[str(b)] = round(ts * 1e3, 3)
            log(f"latency batch={b}: {t*1e3:.3f}ms amortized, {ts*1e3:.3f}ms per-call-synced")
        breakdown["latency_ms"] = lat
        breakdown["latency_synced_ms"] = lat_sync

    if args.trace:
        with capture_trace(args.trace):
            synchronize(gate(ct0, ct1))
        log(f"profiler trace written to {args.trace}")

    if not args.no_check:
        got = to_numpy_u32(tfhe.decrypt(ck, out))
        want = 1 - (lhs & rhs)
        errs = int((got != want).sum())
        rep = unoise.measure(ck, out, want)
        breakdown["gate_errors"] = errs
        breakdown["noise_max_over_delta"] = round(rep.max_abs_over_delta, 4)
        breakdown["noise_mean_over_delta"] = round(rep.mean_abs_over_delta, 4)
        log(f"check: {errs}/{batch} gate errors; {rep}")

    print(json.dumps({
        "metric": "gate bootstraps/sec/chip (default_128 NAND, batched PBS)",
        "value": round(rate, 2),
        "unit": "bootstraps/s",
        "vs_baseline": round(rate / BASELINE_BOOTSTRAPS_PER_SEC, 3),
        "breakdown": breakdown,
    }), flush=True)


if __name__ == "__main__":
    main()
