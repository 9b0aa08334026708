#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tfhe_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of the checkout, one card

It builds the hand-written kernels from ``tfhe_tpu_torch/csrc/`` (into
``build/tfhe_tpu_torch/``) and then runs five phases.  Each phase raises on
failure, so the script exits nonzero and prints no result line.

  0. require CUDA; print the card, its power limit, torch and CUDA versions;
  1. build the kernels, with the build seconds and ptxas' resource report;
  2. hold each kernel against its plain PyTorch twin (``torch.equal``) at
     nano, test_insecure and a 16-step slice of the default_128 key;
  3. the main path at default_128 through the public API (keygen, encrypt,
     NAND, decrypt) at B=1024 with impl 'fused' and 'fusedb', and at B=64
     with the default impl (Kernel A).  It requires 0 gate errors, a noise
     margin below 0.5, the 'auto' output equal to the 'fused' rows, and that
     both kernels' launch counters grew during this phase;
  4. time 'fusedb' at B=1024 with CUDA events, then each kernel against its
     twin at the main path's shapes.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  It imports neither JAX nor ``tfhe_tpu``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MAIN_B = 1024  # gate batch of the main path
AUTO_B = 64  # batch of the default-impl (Kernel A) gate
SLICE_STEPS = 16  # default_128 key steps held against the twin in phase 2


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


def phase1(kernels) -> None:
    log("phase 1: build")
    for k in kernels:
        t0 = time.perf_counter()
        k.load()
        report = [ln.strip() for ln in k.ptxas_report.splitlines()
                  if "registers" in ln or "spill" in ln]
        log(f"  {k.source}: {time.perf_counter() - t0:.1f} s; " + " | ".join(report))


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
    cases = [("nano", b, None) for b in (1, 3, 8)]
    cases += [("test_insecure", b, None) for b in (1, 7, 64)]
    cases += [(params.name, 32, sk.bk_u32[:SLICE_STEPS])]
    for name, b, bk in cases:
        p = get_params(name)
        k1, n = p.glwe_dimension + 1, p.degree
        if bk is None:
            bk = to_torch_u32(rnd_u32(rng, (p.lwe_dimension, k1 * p.pbs_decomposer.levels,
                                            k1, n)), dev)
        steps = bk.shape[0]
        acc0 = to_torch_u32(rnd_u32(rng, (b, k1, n)), dev)
        a_hat = torch.from_numpy(
            rng.integers(0, 2 * n, size=(steps, b), dtype=np.int32)).to(dev)
        for balanced in (False, True):
            got = brk.blind_rotate_fused(p, acc0, bk, a_hat, balanced=balanced)
            want = brk.blind_rotate_fused_ref(p, acc0, bk, a_hat, balanced=balanced)
            mode = "fusedb" if balanced else "fused"
            require(torch.equal(got, want),
                    f"blind_rotate_fused ({mode}) != twin at {name} B={b} steps={steps}")
            log(f"  blind_rotate_fused {mode:6s} {name:13s} B={b:<4d} steps={steps:<3d} equal")
    torch.cuda.synchronize()


def main() -> int:
    card = phase0()
    sys.path.insert(0, str(ROOT))
    import tfhe_tpu_torch as tfhe
    from tfhe_tpu_torch.models import bootstrap as mboot
    from tfhe_tpu_torch.models import keyswitch as mks
    from tfhe_tpu_torch.models import test_vector as mtv
    from tfhe_tpu_torch.ops.cuda import blind_rotate_kernel as brk
    from tfhe_tpu_torch.ops.cuda import ep_kernel as epk
    from tfhe_tpu_torch.ops.torus import switch_modulus, to_numpy_u32, to_torch_u32
    from tfhe_tpu_torch.utils import noise

    dev = torch.device("cuda")
    phase1((epk.KERNEL, brk.KERNEL))

    params = tfhe.get_params("default_128")
    t0 = time.perf_counter()
    ck, sk = tfhe.keygen(params, torch.Generator().manual_seed(0), device=dev)
    torch.cuda.synchronize()
    log(f"keygen {params.name} (n={params.n}, k={params.k}, N={params.degree}): "
        f"{time.perf_counter() - t0:.2f} s")
    phase2(epk, brk, tfhe.get_params, to_torch_u32, params, sk, dev)

    log(f"phase 3: main path, {params.name} NAND, B={MAIN_B}")
    rng = np.random.default_rng(3)
    bits_a = rng.integers(0, 2, size=MAIN_B, dtype=np.uint32)
    bits_b = rng.integers(0, 2, size=MAIN_B, dtype=np.uint32)
    want = 1 - (bits_a & bits_b)
    epk.KERNEL.launches = brk.KERNEL.launches = 0
    ca = tfhe.encrypt(ck, bits_a, torch.Generator().manual_seed(1))
    cb = tfhe.encrypt(ck, bits_b, torch.Generator().manual_seed(2))
    outs = {impl: tfhe.gates.nand(sk, ca, cb, impl=impl) for impl in ("fused", "fusedb")}
    outs["auto"] = tfhe.gates.nand(sk, ca[:AUTO_B], cb[:AUTO_B])
    torch.cuda.synchronize()
    launches = {"ep_contract_rbn": epk.KERNEL.launches, "blind_rotate_fused": brk.KERNEL.launches}
    for impl, out in outs.items():
        got = to_numpy_u32(tfhe.decrypt(ck, out))
        ref = want[: got.shape[0]]
        errors = int((got != ref).sum())
        rep = noise.measure(ck, out, ref)
        log(f"  impl={impl:6s} B={got.shape[0]:<5d} gate errors {errors}/{got.shape[0]}, "
            f"noise_max_over_delta={rep.max_abs_over_delta}")
        require(errors == 0, f"{errors} gate errors with impl={impl}")
        require(rep.max_abs_over_delta < 0.5, f"noise margin {rep.max_abs_over_delta} >= 0.5")
    require(torch.equal(outs["auto"], outs["fused"][:AUTO_B]),
            "auto (pallas, Kernel A) output differs from the fused (Kernel B) rows")
    log(f"  auto (pallas) == fused[:{AUTO_B}] bit for bit; launches in this phase: {launches}")
    require(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")

    log(f"phase 4: timing, fusedb NAND at B={MAIN_B} (CUDA events)")
    tv = to_torch_u32(mtv.gate_test_vector(params, "nand"), dev)
    tfhe.gates.nand(sk, ca, cb, impl="fusedb")
    rounds = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tfhe.gates.nand(sk, ca, cb, impl="fusedb")
        end.record()
        end.synchronize()
        rounds.append(start.elapsed_time(end))
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
    mean_ms = sum(rounds) / len(rounds)
    log(f"  fusedb B={MAIN_B}: rounds ms {rounds}; {MAIN_B / (mean_ms / 1e3):.1f} "
        f"gate bootstraps/s (mean), {MAIN_B / (min(rounds) / 1e3):.1f} (best); "
        f"stages ms {stages}; card: {card}")

    # each kernel against its twin at the main path's shapes
    acc0, a_hat = mboot._init_acc(params, approx, tv)
    bk_ms = cuda_ms(lambda: brk.blind_rotate_fused(params, acc0, sk.bk_u32, a_hat, True), 2)
    got = brk.blind_rotate_fused(params, acc0, sk.bk_u32, a_hat, balanced=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = brk.blind_rotate_fused_ref(params, acc0, sk.bk_u32, a_hat, balanced=True)
    torch.cuda.synchronize()
    bk_plain_ms = (time.perf_counter() - t0) * 1e3
    bk_err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
    r = (params.k + 1) * params.pbs_decomposer.levels
    digits = torch.from_numpy(
        rng.integers(-8, 17, size=(r, AUTO_B, params.degree), dtype=np.int8)).to(dev)
    rows = sk.bk_lm[0]
    ep_ms = cuda_ms(lambda: epk.ep_contract_rbn(digits, rows), 20)
    ep_plain_ms = cuda_ms(lambda: epk.ep_contract_rbn_ref(digits, rows), 5)
    ep_err = int((epk.ep_contract_rbn(digits, rows).to(torch.int64)
                  - epk.ep_contract_rbn_ref(digits, rows).to(torch.int64)).abs().max())
    log(f"  ep_contract_rbn [R={r}, B={AUTO_B}, N={params.degree}]: kernel {ep_ms:.4f} ms, "
        f"plain {ep_plain_ms:.4f} ms, max_abs_err {ep_err}; card: {card}")
    log(f"  blind_rotate_fused fusedb [B={MAIN_B}, n={params.n}]: kernel {bk_ms:.2f} ms, "
        f"plain {bk_plain_ms:.2f} ms, max_abs_err {bk_err}; card: {card}")
    require(ep_err == 0 and bk_err == 0, "a kernel disagrees with its twin at main-path shapes")

    record = {"kernels": [
        {"name": "ep_contract_rbn", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/ep_kernel.cu",
         "replaces": "tfhe_tpu/ops/pallas/ep_kernel.py:128",
         "launches": launches["ep_contract_rbn"], "max_abs_err": ep_err,
         "ms": ep_ms, "plain_ms": ep_plain_ms},
        {"name": "blind_rotate_fused", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate_kernel.cu",
         "replaces": "tfhe_tpu/ops/pallas/blind_rotate_kernel.py:862",
         "launches": launches["blind_rotate_fused"], "max_abs_err": bk_err,
         "ms": bk_ms, "plain_ms": bk_plain_ms},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
