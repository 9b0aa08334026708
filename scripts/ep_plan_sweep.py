#!/usr/bin/env python3
"""Launch plans of the contraction kernels A and H on one CUDA card.

    python3 scripts/ep_plan_sweep.py     # from the root of the checkout

At default_128's shapes (R=18 rows at B = 64, 256, 1024, and the bmmp scan's
3R=54 rows at B=64), on full-range digits and the key's first GGSW shape, it
times Kernel H's C entry point under every plan it takes with 4 warps per
CTA (16 or 32 samples per CTA, each row split of at most 8 CTAs), as CUDA
graphs of 50 calls (``measure_torch.py:graph_ms``), checks each result
against the twin, and marks the plan ``ops/cuda/ep_kernel.py:ep_plan``
picks.  It also times 50 back-to-back wrapper calls without a graph at B=64,
where the host's cost per call shows.  The results go to
``chiprun_out/ep_plan_sweep.json``.  It imports neither JAX nor ``tfhe_tpu``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "ep_plan_sweep.json"
SHAPES = ((18, 64), (18, 256), (18, 1024), (54, 64))  # (rows, batch)
GRAPH = 50


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ep_plan_sweep: needs a CUDA card")
    sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]
    from measure_torch import event_rounds, graph_ms
    from tfhe_tpu_torch.ops.cuda import ep_kernel as epk
    from tfhe_tpu_torch.ops.cuda._build import ptr, sm_count, smem_budget, stream_of
    from tfhe_tpu_torch.ops.torus import to_torch_u32

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[torch.cuda.current_device()]
    print(card, flush=True)
    dev = torch.device("cuda")
    c, n = 3, 512
    rng = np.random.default_rng(11)
    info = (ctypes.c_int * 2)()
    res = {"card": card, "shapes": {}}
    for r, b in SHAPES:
        d = torch.from_numpy(rng.integers(-128, 128, size=(b, r, n), dtype=np.int8)).to(dev)
        g = to_torch_u32(rng.integers(0, 1 << 32, size=(r, c, n), dtype=np.uint32), dev)
        want = epk.ep_contract_ref(d, g)
        picked = epk.ep_plan(b, r, c, n, sm_count(dev), smem_budget(dev))
        rows = []
        for bm in (16, 32):
            for split in range(1, epk.MAX_SPLIT + 1):
                rows_per = -(-r // split)
                if -(-r // rows_per) != split:
                    continue
                out = torch.empty((b, c * 4, n), dtype=torch.int32, device=dev)

                def call(bm=bm, split=split, rows_per=rows_per, out=out):
                    epk.BATCH_KERNEL.launch(ptr(d), ptr(g), ptr(out), r, b, c, n, bm, 4, split,
                                            rows_per, 2, info, stream_of(out))

                call()
                if not torch.equal(out, want):
                    raise AssertionError(f"plan bm={bm} split={split} differs from the twin")
                ms, _ = graph_ms(call, GRAPH, clocks=False)
                rows.append({"samples_per_cta": bm, "split": split, "ctas": info[1], "ms": ms,
                             "picked": (bm, split) == (picked["samples_per_cta"],
                                                       picked["split"])})
        rows.sort(key=lambda x: x["ms"])
        res["shapes"][f"R{r}_B{b}"] = rows
        print(f"R={r} B={b}:", flush=True)
        for x in rows:
            print(f"  {x['ms']:.6f} ms  {x['samples_per_cta']} samples per CTA, split "
                  f"{x['split']}, {x['ctas']} CTAs{'  <- ep_plan' if x['picked'] else ''}",
                  flush=True)
    d = torch.from_numpy(rng.integers(-128, 128, size=(64, 18, n), dtype=np.int8)).to(dev)
    g = to_torch_u32(rng.integers(0, 1 << 32, size=(18, c, n), dtype=np.uint32), dev)
    loop = event_rounds(lambda: [epk.ep_contract(d, g) for _ in range(GRAPH)], 3)
    res["wrapper_loop_ms_per_call_B64"] = [t / GRAPH for t in loop]
    print(f"wrapper in a Python loop, B=64: ms per call {res['wrapper_loop_ms_per_call_B64']}; "
          f"in a CUDA graph: {graph_ms(lambda: epk.ep_contract(d, g), GRAPH, clocks=False)[0]}",
          flush=True)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
