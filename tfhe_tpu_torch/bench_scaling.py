"""Scaling bench of the sharded and pipelined gates (port of
``scripts/bench_scaling.py``).

    torchrun --nproc-per-node=<cards> -m tfhe_tpu_torch.bench_scaling
    python -m tfhe_tpu_torch.bench_scaling                 # spawns its own ranks
    python -m tfhe_tpu_torch.bench_scaling --device cpu --params test_insecure

Under torchrun it runs at the launcher's world size; otherwise it spawns
its ranks itself at every world size 1, 2, 4, ... up to ``--world``
(default: the visible cards, clamped to them, since NCCL takes one rank per
card; on the CPU, gloo ranks, 2 by default).  At each world size it times
four modes on NAND gates:

  * ``dp`` — batch data parallelism, mesh (world, 1);
  * ``tp`` — key rows over ``model`` (the largest model size of the world
    that divides the GGSW and KSK rows), the u32 delta all-reduced per step;
  * ``host`` — the (host, batch, model) mesh, host = world / LOCAL_WORLD_SIZE;
  * ``pp`` — the pipeline over (batch, stage), ``MICROBATCHES`` deep.

Every rank holds ``--batch-per-rank`` ciphertexts of each microbatch; every
output is gathered and held against the one-device gate of the same impl
(bits equal, 0 gate errors).  Rank 0 prints one JSON line: the card's name
and power limit, and per mode and world size the gate ms (on the card the
mean of ``--iters`` calls back to back between CUDA events after a warm-up,
``utils/profiling.py:sampled_clocks``; on the CPU the best of 3 rounds), the
SM clock sampled meanwhile, ``us_per_sample_step`` (card-microseconds per
sample per rotation step: gate us x ranks / (samples x n)) and the recorded
collectives' bytes and calls.
With ``--link-gbps`` it adds ``parallel/traffic.py:predict_efficiency`` at
that link rate.  It writes a file only with ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

#: the impls every mode runs (the pipeline stages' ``rotate_chunk`` impls)
IMPLS = ("conv", "matmul", "pallas", "ntt")
MODES = ("dp", "tp", "host", "pp")
#: the pipeline's queue depth (``scripts/bench_scaling.py``'s)
MICROBATCHES = 4
#: the seed of the key and of the ciphertexts' bits
SEED = 0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def model_size(params, world: int) -> int:
    """The largest divisor of ``world`` that divides the GGSW rows and the
    KSK rows (1 when none above 1 does)."""
    rows = (params.glwe_dimension + 1) * params.pbs_decomposer.levels
    k_rows = params.glwe_dimension * params.degree * params.ks_decomposer.levels
    return max(m for m in range(1, world + 1)
               if world % m == 0 and rows % m == 0 and k_rows % m == 0)


def stage_count(params, world: int) -> int:
    """The largest divisor of ``world`` that divides the n rotation steps."""
    return max(s for s in range(1, world + 1)
               if world % s == 0 and params.lwe_dimension % s == 0)


def run_rank(rank: int, world: int, args, store: str | None) -> list[dict]:
    """One rank's modes at this world size; returns rank 0's results."""
    import tfhe_tpu_torch as tfhe
    from tfhe_tpu_torch.models.keys import with_key_form
    from tfhe_tpu_torch.ops.torus import to_numpy_u32
    from tfhe_tpu_torch.parallel import mesh as pmesh
    from tfhe_tpu_torch.parallel.pipeline import make_pipelined_gate
    from tfhe_tpu_torch.parallel.sharded import make_sharded_gate
    from tfhe_tpu_torch.utils.profiling import sampled_clocks, time_best

    local = int(os.environ.get("LOCAL_RANK", rank))
    if args.device == "cuda":
        device = torch.device("cuda", local % torch.cuda.device_count())
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)  # one core per CPU rank
    if not dist.is_initialized():
        dist.init_process_group(_backend(args), init_method=f"file://{store}", rank=rank,
                                world_size=world)
    params = tfhe.get_params(args.params)
    ck, sk = tfhe.keygen(params, torch.Generator().manual_seed(SEED), device=device)
    sk = with_key_form(sk, args.impl)
    n = params.lwe_dimension
    m_tp = model_size(params, world)
    stages = stage_count(params, world)
    results = []
    for mode in MODES:
        if mode == "pp":
            mesh = pmesh.make_pipeline_mesh(stage=stages, device=device)
            gate = make_pipelined_gate(mesh, params, "nand", impl=args.impl)
            shape = (MICROBATCHES, args.batch_per_rank * world // stages)
        else:
            if mode == "dp":
                mesh = pmesh.make_mesh(model=1, device=device)
            elif mode == "tp":
                mesh = pmesh.make_mesh(model=m_tp, device=device)
            else:
                mesh = pmesh.make_host_mesh(model=m_tp, device=device)
            gate = make_sharded_gate(mesh, params, "nand", impl=args.impl,
                                     use_model_axis=True if mode == "tp" else None)
            shape = (args.batch_per_rank * world // m_tp if mode != "dp"
                     else args.batch_per_rank * world,)
        rng = np.random.default_rng(SEED + 1)
        bits = rng.integers(0, 2, size=(2,) + shape)
        cts = [tfhe.encrypt(ck, bits[i].reshape(-1), torch.Generator().manual_seed(10 + i))
               .reshape(shape + (-1,)) for i in (0, 1)]
        clocks = []
        if device.type == "cuda":
            ms, clocked = sampled_clocks(lambda: gate(cts[0], cts[1], sk), args.iters)
            clocks = [mhz for mhz, _ in clocked]
        else:
            ms = time_best(lambda: gate(cts[0], cts[1], sk), args.iters, device)[0] * 1e3
        out = gate(cts[0], cts[1], sk)
        samples = int(np.prod(shape))
        row = dict(mode=mode, world=world, mesh=mesh.shape, batch=samples,
                   batch_local=int(out.shape[len(shape) - 1]),
                   gate_ms=ms, us_per_sample_step=ms * 1e3 * world / (samples * n),
                   sm_clock_mhz=sorted(clocks)[len(clocks) // 2] if clocks else None,
                   collective_bytes={k: sorted(v) for k, v in gate.recorder.payloads().items()},
                   collective_calls=gate.recorder.calls())
        out = pmesh.gather_batch(mesh, out, dim=len(shape) - 1)
        if rank == 0:
            flat = [c.reshape(-1, c.shape[-1]) for c in cts]
            want = tfhe.gates.nand(sk, flat[0], flat[1], impl=args.impl)
            got = out.reshape(-1, out.shape[-1])
            errors = int((to_numpy_u32(tfhe.decrypt(ck, got))
                          != 1 - (bits[0] & bits[1]).reshape(-1)).sum())
            if errors or not torch.equal(got, want):
                raise RuntimeError(f"{mode} at world {world}: {errors} gate errors, equal to "
                                   f"the one-device gate: {torch.equal(got, want)}")
            row.update(gate_errors=0, equal_to_one_device=True)
            log(f"{mode} world={world} mesh={mesh.shape}: {ms:.3f} ms per gate, "
                f"{row['us_per_sample_step']:.4f} card-us per sample-step, "
                f"collectives {row['collective_bytes']}")
        results.append(row)
    dist.barrier()
    return results


def _backend(args) -> str:
    return "nccl" if args.device == "cuda" else "gloo"


def _spawned(rank: int, world: int, args, workdir: str) -> None:
    results = run_rank(rank, world, args, os.path.join(workdir, "store"))
    dist.destroy_process_group()
    if rank == 0:
        Path(workdir, "results.json").write_text(json.dumps(results))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", default="default_128")
    ap.add_argument("--impl", default="conv", choices=IMPLS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--world", type=int, default=None,
                    help="largest world size to spawn (default: the visible cards, 2 on the CPU)")
    ap.add_argument("--batch-per-rank", type=int, default=64)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--link-gbps", type=float, default=None,
                    help="add predict_efficiency at this link rate (GB/s each way)")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench_scaling: no CUDA card (pass --device cpu for the CPU)")

    if "RANK" in os.environ:  # under torchrun: this world only
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        dist.init_process_group(_backend(args))
        results = run_rank(rank, world, args, None)
        dist.destroy_process_group()
        if rank != 0:
            return 0
    else:
        cards = torch.cuda.device_count() if on_card else 0
        most = args.world or (cards if on_card else 2)
        if on_card and most > cards:
            log(f"NCCL takes one rank per card: world clamped from {most} to {cards}")
            most = cards
        results = []
        world = 1
        while world <= most:
            with tempfile.TemporaryDirectory() as workdir:
                torch.multiprocessing.spawn(_spawned, args=(world, args, workdir), nprocs=world)
                results += json.loads(Path(workdir, "results.json").read_text())
            world *= 2

    from tfhe_tpu_torch.params import get_params
    from tfhe_tpu_torch.parallel.traffic import predict_efficiency

    card, limit = "cpu", None
    if on_card:
        from tfhe_tpu_torch.utils.profiling import card_name_and_power_limit

        card, limit = card_name_and_power_limit()
    if args.link_gbps is not None:
        params = get_params(args.params)
        one = {r["mode"]: r["us_per_sample_step"] for r in results if r["world"] == 1}
        for r in results:
            d, model_mode = {"tp": (r["mesh"].get("model", 1), "tp"),
                             "host": (r["mesh"].get("model", 1), "tp"),
                             "pp": (r["mesh"].get("stage", 1), "pp")}.get(
                                 r["mode"], (r["world"], "dp"))
            if d == 1:
                model_mode = "dp"
            r["predicted_efficiency"] = predict_efficiency(
                params, model_mode, d, link_gbps=args.link_gbps,
                us_per_sample_step=one.get("dp", r["us_per_sample_step"]),
                m_microbatches=MICROBATCHES)
    line = json.dumps(dict(card=card, power_limit=limit, torch=torch.__version__,
                           backend=_backend(args), params=args.params, impl=args.impl,
                           link_gbps=args.link_gbps, results=results))
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
