"""Device meshes for multi-card TFHE on ``torch.distributed`` (port of
``tfhe_tpu/parallel/mesh.py``).

One process per rank, each joined to the default process group
(``torch.distributed.init_process_group``) before it builds a mesh.  A mesh
is a ``torch.distributed.DeviceMesh`` with named dims, standing for JAX's
``Mesh``, plus the ``torch.device`` on which this rank keeps its tensors.
Each axis's collectives run on ``mesh.get_group(name)``.

Axes:
  * ``host`` — ranks of different machines: batch shards ride it together
    with ``batch``; keys are replicated per host (or row-sharded over
    ``model`` under memory pressure, ``plan_key_placement``), so no
    collective crosses hosts in the batch-parallel path.
  * ``batch`` — independent ciphertexts (data parallelism): no steady-state
    collective.
  * ``model`` — the (k+1)*levels GGSW rows of the external product and the
    KSK rows (tensor parallelism): partial u32 deltas are all-reduced per
    CMUX step.  Must divide (k+1)*levels and k*N*l_ks.
  * ``stage`` — pipeline-parallel blind rotation (``parallel/pipeline.py``).

The ``DeviceMesh`` is built for the process group's backend (``cpu`` for
gloo, ``cuda`` for NCCL), apart from the tensors' device: gloo ranks may
keep their tensors on a card, and ranks that share one card must not let
the mesh pick a card for each of them.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tfhe_tpu_torch.params import TfheParams

HOST_AXIS = "host"
BATCH_AXIS = "batch"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named ``DeviceMesh`` and the device of this rank's tensors."""

    device_mesh: DeviceMesh
    device: torch.device

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.device_mesh.mesh_dim_names

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as JAX's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.device_mesh.shape))

    def get_group(self, axis: str) -> dist.ProcessGroup:
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (JAX's ``lax.axis_index``)."""
        return self.device_mesh.get_local_rank(axis)


def _rank_device(device) -> torch.device:
    """The rank's device: ``device`` if given ("cuda" alone is the current
    card), else ``cuda:LOCAL_RANK``."""
    if device is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _world() -> int:
    """The world's size; the process group must already be joined."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def _build(sizes: tuple[int, ...], names: tuple[str, ...], device) -> Mesh:
    """A mesh of ``sizes`` over the whole world, for this rank's ``device``."""
    device = _rank_device(device)
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(f"a mesh of {dict(zip(names, sizes))} needs {math.prod(sizes)} ranks, "
                         f"the world has {world}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(mesh_type, sizes, mesh_dim_names=names), device)


def _split(world: int, known: int, given: int | None, what: str) -> int:
    """``given``, or the world over ``known`` ranks."""
    if given is not None:
        return given
    if world % known:
        raise ValueError(f"{what}: {known} does not divide the world of {world}")
    return world // known


def make_mesh(batch: int | None = None, model: int = 1, device=None) -> Mesh:
    """A (batch, model) mesh over every rank (``mesh.py:33-40``); ``batch``
    defaults to world // model."""
    batch = _split(_world(), model, batch, "make_mesh")
    return _build((batch, model), (BATCH_AXIS, MODEL_AXIS), device)


def make_pipeline_mesh(batch: int | None = None, stage: int = 1, device=None) -> Mesh:
    """A (batch, stage) mesh for the pipelined gate (``mesh.py:43-51``): data
    parallelism over ciphertexts x pipeline stages over rotation steps."""
    batch = _split(_world(), stage, batch, "make_pipeline_mesh")
    return _build((batch, stage), (BATCH_AXIS, STAGE_AXIS), device)


def make_host_mesh(host: int | None = None, batch: int | None = None, model: int = 1,
                   device=None) -> Mesh:
    """A (host, batch, model) mesh (``mesh.py:54-89``).  ``host`` defaults to
    world // LOCAL_WORLD_SIZE (the launcher's ranks per machine; one host
    when it is not set).

    torchrun numbers ranks machine-major, so the row-major layout already
    keeps every ``batch`` and ``model`` group inside one machine: the
    counterpart of ``mesh_utils.create_hybrid_device_mesh``."""
    world = _world()
    if host is None:
        host = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    batch = _split(world, host * model, batch, "make_host_mesh")
    return _build((host, batch, model), (HOST_AXIS, BATCH_AXIS, MODEL_AXIS), device)


@dataclasses.dataclass(frozen=True)
class KeyPlacement:
    """BK/KSK placement decision for a mesh."""

    shard_bk_rows: bool  #: shard BK rows over ``model`` instead of replicating
    bk_bytes: int  #: canonical BK size
    per_device_key_bytes: int  #: resident key bytes per device after placement
    reason: str


def plan_key_placement(params: TfheParams, mesh: Mesh, hbm_bytes: int | None = None,
                       budget_frac: float = 0.25) -> KeyPlacement:
    """Replicate the keys per (host, batch) group unless they exceed
    ``budget_frac`` of a rank's device memory, then shard BK/KSK rows over
    ``model`` (``mesh.py:92-137``).

    ``hbm_bytes`` defaults to the total memory of the rank's card
    (``torch.cuda.get_device_properties``); a CPU mesh must pass it."""
    if hbm_bytes is None:
        if mesh.device.type != "cuda":
            raise ValueError("plan_key_placement reads the card's memory: pass hbm_bytes "
                             f"for a mesh on {mesh.device}")
        hbm_bytes = torch.cuda.get_device_properties(mesh.device).total_memory
    k, n, deg = params.glwe_dimension, params.lwe_dimension, params.degree
    rows = (k + 1) * params.pbs_decomposer.levels
    bk_bytes = n * rows * (k + 1) * deg * 4
    ksk_bytes = k * deg * params.ks_decomposer.levels * (n + 1) * 4
    total = bk_bytes + ksk_bytes
    model_n = mesh.shape.get(MODEL_AXIS, 1)
    budget = int(hbm_bytes * budget_frac)
    if total <= budget or model_n <= 1:
        return KeyPlacement(
            shard_bk_rows=False,
            bk_bytes=bk_bytes,
            per_device_key_bytes=total,
            reason=f"replicated: keys {total/1e6:.0f}MB <= budget {budget/1e6:.0f}MB"
            if total <= budget
            else "replicated: no model axis to shard over",
        )
    return KeyPlacement(
        shard_bk_rows=True,
        bk_bytes=bk_bytes,
        per_device_key_bytes=total // model_n,
        reason=f"row-sharded over model={model_n}: keys {total/1e6:.0f}MB "
        f"> budget {budget/1e6:.0f}MB",
    )


def _batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """The axes a ciphertext batch shards over, major first."""
    return (HOST_AXIS, BATCH_AXIS) if HOST_AXIS in mesh.axis_names else (BATCH_AXIS,)


def local_batch(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows of a global batch: ``dim`` cut into equal blocks over
    (``host``, ``batch``), host-major (JAX's ``batch_sharding``)."""
    shards, index = 1, 0
    for axis in _batch_axes(mesh):
        shards, index = shards * mesh.shape[axis], index * mesh.shape[axis] + mesh.index(axis)
    if x.shape[dim] % shards:
        raise ValueError(f"a batch of {x.shape[dim]} does not split over {shards} batch shards")
    rows = x.shape[dim] // shards
    return x.narrow(dim, index * rows, rows)


def gather_batch(mesh: Mesh, x_local: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The global batch from every rank's rows (the inverse of
    ``local_batch``), on every rank, gathered on ``x_local``'s device."""
    x = x_local
    for axis in reversed(_batch_axes(mesh)):  # minor axis first
        parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
        x = torch.cat(parts, dim=dim)
    return x
