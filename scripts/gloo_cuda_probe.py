#!/usr/bin/env python3
"""Which gloo collectives carry CUDA tensors: two ranks on one card.

    python3 scripts/gloo_cuda_probe.py      # needs one CUDA card

For each operation the sharded gates and the pipeline use, it starts two
processes on ``cuda:0`` joined over gloo, runs the operation once on int32
tensors of the card and checks the result against the plain answer.  Each
operation runs in its own pair of processes under a time limit, so one that
fails or hangs does not stop the rest.  It also runs each collective at
world 1 over NCCL, in-process, the way ``chip_smoke.py`` phase 6 does.
It prints one line per operation and a JSON object last:
``{"gloo_cuda": {op: "ok" | reason}, "nccl_world1": {...}, "torch": ...}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import torch

OPS = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "send_recv",
       "batch_isend_irecv")


def run(op: str, group, rank: int, world: int, dev) -> bool:
    """Run ``op`` once over ``group`` and return whether the result is right."""
    import torch.distributed as dist

    x = torch.arange(4, dtype=torch.int32, device=dev) + 10 * rank
    if op == "all_reduce":
        t = x.clone()
        dist.all_reduce(t, group=group)
        return t.tolist() == [sum(i + 10 * r for r in range(world)) for i in range(4)]
    if op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts).tolist() == [i + 10 * r for r in range(world) for i in range(4)]
    if op == "all_gather_into_tensor":
        out = torch.empty(4 * world, dtype=torch.int32, device=dev)
        dist.all_gather_into_tensor(out, x, group=group)
        return out.tolist() == [i + 10 * r for r in range(world) for i in range(4)]
    if op == "broadcast":
        t = x.clone()
        dist.broadcast(t, src=0, group=group)
        return t.tolist() == list(range(4))
    if world == 1:
        return True  # no peer to send to
    peer = 1 - rank
    got = torch.zeros_like(x)
    if op == "send_recv":
        if rank == 0:
            dist.send(x, dst=peer, group=group)
            dist.recv(got, src=peer, group=group)
        else:
            dist.recv(got, src=peer, group=group)
            dist.send(x, dst=peer, group=group)
    else:
        ops = [dist.P2POp(dist.irecv, got, peer, group), dist.P2POp(dist.isend, x, peer, group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    torch.cuda.synchronize()
    return got.tolist() == [i + 10 * peer for i in range(4)]


def child(op: str, rank: int, store: str) -> int:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    try:
        ok = run(op, None, rank, 2, torch.device("cuda:0"))
    finally:
        dist.destroy_process_group()
    return 0 if ok else 3


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gloo_cuda_probe: needs a CUDA card")
    gloo = {}
    for op in OPS:
        with tempfile.TemporaryDirectory() as tmp:
            store = os.path.join(tmp, "store")
            procs = [subprocess.Popen([sys.executable, __file__, op, str(r), store],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for r in range(2)]
            outs, codes = [], []
            for p in procs:
                try:
                    out, _ = p.communicate(timeout=120)
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                outs.append(out)
                codes.append(p.returncode)
        if codes == [0, 0]:
            gloo[op] = "ok"
        else:
            last = [ln for o in outs for ln in o.strip().splitlines() if "Error" in ln]
            gloo[op] = f"rc {codes}: {last[-1][:300] if last else 'wrong result or no message'}"
        print(f"gloo, 2 ranks on cuda:0, {op}: {gloo[op]}", flush=True)

    import torch.distributed as dist

    nccl = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda:0"))
    for op in OPS:
        nccl[op] = "ok" if run(op, None, 0, 1, torch.device("cuda:0")) else "wrong result"
        print(f"nccl, world 1, {op}: {nccl[op]}", flush=True)
    dist.destroy_process_group()
    print(json.dumps({"gloo_cuda": gloo, "nccl_world1": nccl, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4:
        sys.exit(child(sys.argv[1], int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
