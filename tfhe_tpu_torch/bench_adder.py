"""Depth bench: B parallel W-bit encrypted ripple-carry adds (port of
``scripts/bench_adder.py``).

    python -m tfhe_tpu_torch.bench_adder                       # default_128, fusedb, B=256, W=8
    python -m tfhe_tpu_torch.bench_adder --impl fusedl --batch 1 --width 8
    python -m tfhe_tpu_torch.bench_adder --params nano --device cpu --batch 2 --width 4

Runs B parallel W-bit encrypted additions through the gate layer
(models/circuits.py: same-depth gates batched into wide PBS calls), times
them (CUDA events on the card, best of 3 rounds after a warm-up), counts
wrong sums and wrong carry-outs apart, and noise-meters every traced stage
against its expected cleartext: per-depth noise must stay flat, because each
gate output is a fresh bootstrap.  The key form ``--impl`` reads is attached
after keygen and timed apart (``keyform_s``).

Prints one JSON line on stdout (the reference script's keys, with
``wrong_carries`` beside ``wrong_sums``) and writes it to ``--out``
(default ``chiprun_out/adder.json``).  Diagnostics go to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

import tfhe_tpu_torch as tfhe
from tfhe_tpu_torch.bench import card_fields
from tfhe_tpu_torch.models import circuits as mcirc
from tfhe_tpu_torch.models.bootstrap import IMPLS, VALID_IMPLS, resolve_impl
from tfhe_tpu_torch.ops.torus import to_numpy_u32
from tfhe_tpu_torch.utils import noise as unoise
from tfhe_tpu_torch.utils.profiling import synchronize, time_best


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m tfhe_tpu_torch.bench_adder")
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--impl", default="fusedb", choices=list(VALID_IMPLS))
    ap.add_argument("--params", default="default_128")
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "adder.json"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the kernels' twins)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_adder: no CUDA card (torch.cuda.is_available() is false); "
                         "pass --device cpu to run the kernels' twins")
    params = tfhe.get_params(args.params)
    w, batch, impl = args.width, args.batch, args.impl
    card = card_fields(device)
    log(f"device: {device} ({card['card']}, {card['power_limit']}), params: {params.name}, "
        f"impl: {impl}, width: {w}, batch: {batch}")

    t0 = time.perf_counter()
    bmmp = IMPLS[resolve_impl(impl, device)].bmmp
    ck, sk = tfhe.keygen(params, 0, device=device, bmmp=bmmp)
    synchronize(sk.bk_u32)
    log(f"keygen: {time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    sk = tfhe.with_key_form(sk, impl)
    synchronize(sk.bk_u32)
    keyform_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    a_int = rng.integers(0, 1 << w, size=batch).astype(np.uint32)
    b_int = rng.integers(0, 1 << w, size=batch).astype(np.uint32)
    a_bits = mcirc.encrypt_uint(ck, a_int, w, 1)
    b_bits = mcirc.encrypt_uint(ck, b_int, w, 2)

    def add():
        return mcirc.ripple_carry_add(sk, a_bits, b_bits, impl=impl)

    t0 = time.perf_counter()
    s_bits, cout = add()
    synchronize(s_bits, cout)
    first_call_s = time.perf_counter() - t0
    log(f"first call (kernel build at first use + run): {first_call_s:.1f}s")
    best, (s_bits, cout) = time_best(add, args.iters, device)

    boots_per_add = 5 * w if params.log_p == 2 else 2 * w
    adds_per_s = batch / best
    boots_per_s = adds_per_s * boots_per_add
    log(f"{w}-bit add x{batch}: best {best*1e3:.3f}ms -> "
        f"{adds_per_s:.1f} adds/s = {boots_per_s:.0f} bootstraps/s")

    # correctness: the W sum bits and the carry-out, counted apart
    got = to_numpy_u32(mcirc.decrypt_uint(ck, s_bits))
    wrong_sums = int((got != ((a_int + b_int) & ((1 << w) - 1))).sum())
    cout_got = to_numpy_u32(tfhe.decrypt(ck, cout))
    wrong_carries = int((cout_got != ((a_int + b_int) >> w)).sum())
    log(f"check: {wrong_sums}/{batch} wrong sums, {wrong_carries}/{batch} wrong carries")

    # per-depth noise metering: run once more with the trace hook and
    # decrypt every stage against its cleartext
    trace = []
    mcirc.ripple_carry_add(sk, a_bits, b_bits, impl=impl, trace=trace)
    per_depth = {}
    for label, depth, cts, clear_fn in trace:
        wantc = np.asarray(clear_fn(a_int, b_int, 0), np.uint32)
        flat = cts.reshape(-1, cts.shape[-1])
        rep = unoise.measure(ck, flat, wantc.reshape(-1))
        per_depth[label] = dict(
            depth=depth, max_e_over_delta=round(rep.max_abs_over_delta, 4),
            mean_e_over_delta=round(rep.mean_abs_over_delta, 4),
            failures=rep.failures)
        log(f"  depth {depth:>2} {label:>10}: max|e|/D="
            f"{rep.max_abs_over_delta:.4f} mean={rep.mean_abs_over_delta:.4f}")
    max_by_depth = {}
    for v in per_depth.values():
        max_by_depth[v["depth"]] = max(max_by_depth.get(v["depth"], 0.0), v["max_e_over_delta"])
    flat_noise = max(max_by_depth.values()) < 0.5 and (
        max(max_by_depth.values()) < 2.5 * min(max_by_depth.values()))

    artifact = dict(
        metric=f"{w}-bit encrypted ripple-carry adds/s (batched, depth "
               f"{max(v['depth'] for v in per_depth.values())})",
        params=params.name, impl=impl, width=w, batch=batch,
        add_ms=round(best * 1e3, 3),
        adds_per_s=round(adds_per_s, 1),
        bootstraps_per_add=boots_per_add,
        bootstraps_per_s=round(boots_per_s, 1),
        wrong_sums=wrong_sums,
        wrong_carries=wrong_carries,
        per_stage_noise=per_depth,
        max_noise_by_depth={str(k): round(v, 4) for k, v in sorted(max_by_depth.items())},
        noise_flat_across_depth=bool(flat_noise),
        device=str(device), **card,
        first_call_s=first_call_s, keyform_s=keyform_s,
        note="every gate output is a fresh bootstrap: |e|/Delta must not "
             "grow with circuit depth (it is the per-PBS output noise + one "
             "linear 2x+1 combination, independent of depth)",
    )
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(artifact, fh, indent=1)
    log(f"wrote {args.out}")
    print(json.dumps(artifact), flush=True)


if __name__ == "__main__":
    main()
