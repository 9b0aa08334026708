"""A world of ranks that runs the ``parallel/`` gates on given inputs, for the
tests and the card checks of the sharded and pipelined gates.

``World(spec, workdir)`` starts one process per rank::

    python -m tfhe_tpu_torch.parallel._testing WORKDIR/spec.json RANK

and ``World.wait()`` collects what they wrote.  This module imports neither
JAX nor the tests' conftest, so the ranks start from a plain import of the
port.  Every rank joins the process group through a file in ``workdir``
(``spec["backend"]``: gloo or nccl), takes its device from
``spec["device"]`` ("cpu", "cuda:0", or "cuda:rank" for one card per rank),
builds the server key (from the canonical arrays of ``workdir/inputs.npz``,
or with ``keygen`` from ``spec["key_seed"]``) and runs ``spec["cases"]``
in order, every rank the same list:

  * ``{"kind": "sharded", "name", "shape": [batch, model] or [host, batch,
    model], "impl", "use_model_axis"}`` — ``make_sharded_gate`` on the
    global batches ``ct0_<name>``/``ct1_<name>`` of the inputs, or
    ``ct0``/``ct1`` where the case has none of its own;
  * ``{"kind": "pipeline", "name", "shape": [batch, stage], "impl"}`` —
    ``make_pipelined_gate`` on the queues ``q0_<name>``/``q1_<name>``;
  * ``{"kind": "refuse", "name", "shape", "impl", "replace": {...},
    "use_model_axis"}`` — ``make_mesh`` and ``make_sharded_gate`` on
    ``params.replace(**replace)``, expected to raise: the exception's type
    is recorded;
  * ``{"kind": "placement", "name", "shape": [host, batch, model],
    "params", "hbm_bytes", "budget_frac"}`` — ``plan_key_placement``;
  * ``{"kind": "wraparound", "name", "values": [per rank]}`` — the int32
    u32 deltas of each rank all-reduced over a (1, world) mesh's ``model``
    axis by ``sharded._psum_delta``.

A gate case may carry ``"time": true``: its gate is then run once more,
timed with CUDA events after a barrier, with the SM clock sampled
(``utils/profiling.py:sampled_clocks``).  Each rank runs with one thread.
It writes ``result_<rank>.json`` (per case: the recorded collectives' sizes
and calls, Kernels A's, H's and E's launches during the first call, the
ms; and ``init_s``, the seconds the rank took to join the process group);
rank 0 writes the gathered outputs to ``out.npz``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def _server_key(spec: dict, inputs, params, device):
    import tfhe_tpu_torch as tfhe

    if "key_seed" in spec:
        _, sk = tfhe.keygen(params, torch.Generator().manual_seed(spec["key_seed"]),
                            device=device)
    else:
        _, sk = tfhe.keys_from_numpy(params, inputs["lwe_sk"], inputs["glwe_sk"],
                                     inputs["bk_u32"], inputs["ksk_u32"], device=device)
    if any(c.get("impl") == "ntt" and c["kind"] in ("sharded", "pipeline")
           for c in spec["cases"]):
        sk = tfhe.with_ntt_key(sk)
    return sk


def _run_case(case: dict, spec: dict, rank: int, params, sk, inputs, device) -> tuple[dict, object]:
    from tfhe_tpu_torch.ops.cuda import blind_rotate_kernel as brk
    from tfhe_tpu_torch.ops.cuda import ep_kernel as epk
    from tfhe_tpu_torch.parallel import mesh as pmesh
    from tfhe_tpu_torch.parallel import sharded
    from tfhe_tpu_torch.parallel.pipeline import make_pipelined_gate
    from tfhe_tpu_torch.parallel.traffic import CollectiveRecorder

    kind, shape = case["kind"], case.get("shape")
    if kind == "refuse":
        try:
            mesh = pmesh.make_mesh(*shape, device=device)
            sharded.make_sharded_gate(mesh, params.replace(**case.get("replace", {})), "nand",
                                      impl=case["impl"],
                                      use_model_axis=case.get("use_model_axis"))
        except Exception as e:  # the test reads which type was raised
            return {"raised": type(e).__name__, "message": str(e)}, None
        return {"raised": None}, None
    if kind == "placement":
        from tfhe_tpu_torch.params import get_params

        mesh = pmesh.make_host_mesh(*shape, device=device)
        p = pmesh.plan_key_placement(get_params(case["params"]), mesh,
                                     hbm_bytes=case["hbm_bytes"],
                                     budget_frac=case["budget_frac"])
        return {"placement": [p.shard_bk_rows, p.bk_bytes, p.per_device_key_bytes]}, None
    if kind == "wraparound":
        mesh = pmesh.make_mesh(1, spec["world"], device=device)
        axis = sharded.ModelAxis(mesh.get_group(pmesh.MODEL_AXIS), mesh.index(pmesh.MODEL_AXIS),
                                 spec["world"], CollectiveRecorder())
        t = torch.tensor(case["values"][rank], dtype=torch.int32, device=device)
        return {"sum": sharded._psum_delta(t, axis).tolist()}, None
    if kind == "sharded":
        make = pmesh.make_host_mesh if len(shape) == 3 else pmesh.make_mesh
        mesh = make(*shape, device=device)
        gate = sharded.make_sharded_gate(mesh, params, "nand", impl=case["impl"],
                                         use_model_axis=case.get("use_model_axis"))
        own = f"ct0_{case['name']}" in inputs
        args = tuple(inputs[f"{ct}_{case['name']}" if own else ct] for ct in ("ct0", "ct1"))
        dim = 0
    else:
        mesh = pmesh.make_pipeline_mesh(*shape, device=device)
        gate = make_pipelined_gate(mesh, params, "nand", impl=case["impl"])
        args, dim = (inputs[f"q0_{case['name']}"], inputs[f"q1_{case['name']}"]), 1
    ct0, ct1 = (torch.from_numpy(a.view(np.int32)).to(device) for a in args)
    kernels = (epk.KERNEL, epk.BATCH_KERNEL, brk.PIPE_KERNEL)
    before = [k.launches for k in kernels]
    out = gate(ct0, ct1, sk)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    result = {
        "launches": {k.symbol: k.launches - b for k, b in zip(kernels, before)},
        "payloads": {kind_: sorted(v) for kind_, v in gate.recorder.payloads().items()},
        "calls": gate.recorder.calls(),
        "batch_local": int(out.shape[dim]),
    }
    if case.get("time"):
        import torch.distributed as dist

        from tfhe_tpu_torch.utils.profiling import sampled_clocks

        result["ms"], result["sm_clock_samples"] = sampled_clocks(
            lambda: gate(ct0, ct1, sk), 1, warmup=False, before=dist.barrier)
    return result, pmesh.gather_batch(mesh, out, dim=dim)


def rank_main(spec_path: str, rank: int) -> int:
    import torch.distributed as dist

    from tfhe_tpu_torch.params import get_params

    spec = json.loads(Path(spec_path).read_text())
    workdir = Path(spec_path).parent
    torch.set_num_threads(1)
    device = torch.device(spec["device"].replace("rank", str(rank)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    t0 = time.perf_counter()
    dist.init_process_group(spec["backend"], init_method=f"file://{workdir / 'store'}",
                            rank=rank, world_size=spec["world"])
    results = {"init_s": time.perf_counter() - t0}
    try:
        inputs_path = workdir / "inputs.npz"
        inputs = dict(np.load(inputs_path)) if inputs_path.exists() else {}
        params = get_params(spec["params"])
        sk = (_server_key(spec, inputs, params, device)
              if any(c["kind"] in ("sharded", "pipeline") for c in spec["cases"]) else None)
        outputs = {}
        for case in spec["cases"]:
            results[case["name"]], out = _run_case(case, spec, rank, params, sk, inputs, device)
            if out is not None:
                outputs[case["name"]] = out.cpu().numpy().view(np.uint32)
        (workdir / f"result_{rank}.json").write_text(json.dumps(results))
        if rank == 0:
            np.savez(workdir / "out.npz", **outputs)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


class World:
    """The ranks of one spec, started at once; ``wait`` collects them."""

    def __init__(self, spec: dict, workdir, inputs: dict | None = None):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        if inputs is not None:
            np.savez(self.workdir / "inputs.npz", **inputs)
        spec_path = self.workdir / "spec.json"
        spec_path.write_text(json.dumps(spec))
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        self.procs = [
            subprocess.Popen([sys.executable, "-m", "tfhe_tpu_torch.parallel._testing",
                              str(spec_path), str(r)], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(spec["world"])]

    def wait(self, timeout: float) -> dict:
        """Wait for every rank (at most ``timeout`` seconds in all); return
        ``{"ranks": [each rank's results], "outputs": rank 0's outputs}``.
        Raises RuntimeError, with the ranks' output, if one fails or the time
        runs out; every rank is ended either way."""
        deadline = time.monotonic() + timeout
        logs, failed = [], False
        try:
            for p in self.procs:
                try:
                    out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                    failed = True
                logs.append(out)
                failed = failed or p.returncode != 0
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            tails = "\n".join(f"--- rank {r} (rc {p.returncode}):\n{log[-3000:]}"
                              for r, (p, log) in enumerate(zip(self.procs, logs)))
            raise RuntimeError(f"a rank of the world failed or timed out:\n{tails}")
        ranks = [json.loads((self.workdir / f"result_{r}.json").read_text())
                 for r in range(len(self.procs))]
        with np.load(self.workdir / "out.npz") as f:
            outputs = dict(f)
        return {"ranks": ranks, "outputs": outputs}


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1], int(sys.argv[2])))
