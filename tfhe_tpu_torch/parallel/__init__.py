"""Multi-card gate bootstrapping on ``torch.distributed`` (port of
``tfhe_tpu/parallel``): device meshes (``mesh.py``), batch-, row-,
coefficient- and NTT-bin-sharded gates (``sharded.py``), the pipelined gate
(``pipeline.py``) and the collective-traffic recorder and model
(``traffic.py``).

One process per rank, each with its own device.  On the CPU, gloo ranks
with ``device="cpu"``::

    import torch.distributed as dist
    from tfhe_tpu_torch.parallel import make_mesh, make_sharded_gate, gather_batch
    dist.init_process_group("gloo", init_method="file:///tmp/store", rank=r, world_size=8)
    mesh = make_mesh(batch=4, model=2, device="cpu")
    gate = make_sharded_gate(mesh, params, "nand", impl="conv")
    out = gather_batch(mesh, gate(ct0, ct1, server_key))   # == the one-device gate

On cards: ``torchrun --nproc-per-node=<cards> -m tfhe_tpu_torch.bench_scaling``.
"""

from tfhe_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    HOST_AXIS,
    MODEL_AXIS,
    STAGE_AXIS,
    KeyPlacement,
    Mesh,
    gather_batch,
    local_batch,
    make_host_mesh,
    make_mesh,
    make_pipeline_mesh,
    plan_key_placement,
)
from tfhe_tpu_torch.parallel.pipeline import PIPELINE_IMPLS, make_pipelined_gate
from tfhe_tpu_torch.parallel.sharded import SHARDED_IMPLS, make_sharded_gate
from tfhe_tpu_torch.parallel.traffic import (
    CollectiveRecorder,
    expected_calls,
    expected_collectives,
)

__all__ = [
    "BATCH_AXIS",
    "HOST_AXIS",
    "MODEL_AXIS",
    "STAGE_AXIS",
    "PIPELINE_IMPLS",
    "SHARDED_IMPLS",
    "CollectiveRecorder",
    "KeyPlacement",
    "Mesh",
    "expected_calls",
    "expected_collectives",
    "gather_batch",
    "local_batch",
    "make_host_mesh",
    "make_mesh",
    "make_pipeline_mesh",
    "make_pipelined_gate",
    "make_sharded_gate",
    "plan_key_placement",
]
