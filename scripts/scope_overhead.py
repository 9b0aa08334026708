#!/usr/bin/env python3
"""What the four ``pbs.*`` profiling scopes cost on the card.

    python3 scripts/scope_overhead.py        # one CUDA card, ~1 min

``models/bootstrap.py:pbs`` runs its four stages inside
``torch.profiler.record_function`` ranges (``utils/profiling.py:scope``),
which do host work even with no profiler running.  This script times, at
default_128, the 'fusedl' NAND gate at B=1 (the small-batch path, where the
host's work shows) and the 'fusedp' NAND gate at B=1024, with the scopes as
shipped ("on") and with ``bootstrap.scope`` replaced by a null context
("off"), in turns (off, on, on, off).  Each turn is the mean of CALLS gates
back to back after a warm-up, timed with CUDA events while nvidia-smi
samples the SM clock (``utils/profiling.py:sampled_clocks``).  It also
times one empty ``scope`` enter and exit on the host.  It prints one JSON
line (every number unrounded) and writes ``chiprun_out/scope_overhead.json``.
It imports neither JAX nor ``tfhe_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "scope_overhead.json"
#: impl -> (batch, gates per turn)
GATES = {"fusedl": (1, 30), "fusedp": (1024, 5)}
TURNS = ("off", "on", "on", "off")
EMPTY_SCOPES = 100_000


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("scope_overhead: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import tfhe_tpu_torch as tfhe
    from tfhe_tpu_torch.models import bootstrap as mboot
    from tfhe_tpu_torch.utils.profiling import card_name_and_power_limit, sampled_clocks, scope

    card = card_name_and_power_limit()
    params = tfhe.get_params("default_128")
    ck, sk = tfhe.keygen(params, 0)
    sk = tfhe.with_latency_key(sk)
    rng = np.random.default_rng(3)
    bits = [rng.integers(0, 2, size=1024, dtype=np.uint32) for _ in range(2)]
    ca, cb = (tfhe.encrypt(ck, b, seed) for b, seed in zip(bits, (1, 2)))

    t0 = time.perf_counter()
    for _ in range(EMPTY_SCOPES):
        with scope("pbs.empty"):
            pass
    empty_us = (time.perf_counter() - t0) / EMPTY_SCOPES * 1e6

    shipped = mboot.scope
    turns = {impl: [] for impl in GATES}
    try:
        for turn in TURNS:
            mboot.scope = shipped if turn == "on" else (lambda name: contextlib.nullcontext())
            for impl, (b, calls) in GATES.items():
                ms, clocked = sampled_clocks(
                    lambda: tfhe.gates.nand(sk, ca[:b], cb[:b], impl=impl), calls)
                mhz = sorted(c for c, _ in clocked)
                turns[impl].append({"scopes": turn, "ms": ms, "calls": calls,
                                    "sm_mhz": [mhz[0], mhz[-1]] if mhz else None})
                print(f"{impl} B={b} scopes {turn}: {ms} ms (mean of {calls}); SM clock "
                      f"{mhz[:1] + mhz[-1:]} MHz", file=sys.stderr, flush=True)
    finally:
        mboot.scope = shipped
    result = {"card": card[0], "power_limit": card[1], "empty_scope_us": empty_us,
              "gates": {impl: {"batch": GATES[impl][0], "turns": t} for impl, t in turns.items()}}
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
