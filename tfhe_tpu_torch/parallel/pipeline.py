"""Pipeline-parallel blind rotation (port of ``tfhe_tpu/parallel/pipeline.py``).

The n-step CMUX rotation is serial per ciphertext (src/bootstrapping.rs:90-105)
but it stages cleanly: stage s of S holds the key for steps
[s*n/S, (s+1)*n/S), and microbatches of ciphertexts flow through the stages,
the GLWE accumulator hopping from stage s to s+1 after each tick.  With M
microbatches the pipe runs M+S-1 ticks of n/S-step chunks
(``models/bootstrap.py:rotate_chunk``), so utilization is M/(M+S-1), and
each rank stores 1/S of the key: the stage axis is the memory-relief axis,
batch the throughput axis.

A (batch, stage) mesh: data parallelism over the ciphertexts of every
microbatch x stages over rotation steps.  Each tick's hop is one
``batch_isend_irecv`` on the ``stage`` group (JAX's ``ppermute``), its
receive posted with its send, and a final all-reduce replicates the output
queue stage-wide (JAX's ``psum``); both go through the gate's
``CollectiveRecorder``.  Bit-identical to the single-device scan.
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch.models import lwe as mlwe
from tfhe_tpu_torch.models import test_vector as mtv
from tfhe_tpu_torch.models.bootstrap import (
    CHUNK_IMPLS, IMPLS, _init_acc, rotate_chunk, sample_extract0,
)
from tfhe_tpu_torch.models.keys import ServerKey
from tfhe_tpu_torch.models.keyswitch import key_switch
from tfhe_tpu_torch.ops.torus import switch_modulus, u32
from tfhe_tpu_torch.parallel.mesh import STAGE_AXIS, Mesh, local_batch
from tfhe_tpu_torch.parallel.traffic import CollectiveRecorder
from tfhe_tpu_torch.params import TfheParams

#: the per-stage rotation impls (``rotate_chunk``'s)
PIPELINE_IMPLS = CHUNK_IMPLS


def stage_key(sk: ServerKey, impl: str, stage: int, n_stages: int) -> torch.Tensor:
    """The key of stage ``stage``'s steps, copied from the field ``impl``
    reads (``IMPLS[impl].key``)."""
    bk = sk.form(IMPLS[impl].key)
    chunk = bk.shape[0] // n_stages
    return bk[stage * chunk:(stage + 1) * chunk].clone()


def _pipelined_gate_local(params: TfheParams, impl: str, mesh: Mesh, recorder, tv_encoded,
                          ct0, ct1, bk_local, ksk_mat) -> torch.Tensor:
    """One rank's part (``pipeline.py:39-93``): ct0/ct1 u32[M, B_local, n+1],
    ``bk_local`` this stage's key slice, ``ksk_mat`` the whole KSK."""
    n_stages = mesh.shape[STAGE_AXIS]
    s = mesh.index(STAGE_AXIS)
    group = mesh.get_group(STAGE_AXIS)
    chunk = params.lwe_dimension // n_stages
    m = ct0.shape[0]

    ct_in = mlwe.add(mlwe.scalar_mul(ct1, 2), ct0)
    approx = switch_modulus(ct_in, params.log_q, params.log_degree + 1)
    inits = [_init_acc(params, approx[i], tv_encoded) for i in range(m)]  # acc0, a_hat [n, B]
    out = torch.zeros((m,) + inits[0][0].shape, dtype=torch.int32, device=ct0.device)

    def holds(t: int, stage: int) -> bool:
        """Whether ``stage`` works on a microbatch at tick ``t``."""
        return 0 <= t - stage < m

    acc = None  # the accumulator handed over by the previous stage
    for t in range(m + n_stages - 1):
        acc_new = None
        if holds(t, s):
            mb = t - s
            acc0, a_hat = inits[mb]
            acc_new = rotate_chunk(params, acc0 if s == 0 else acc, bk_local,
                                   a_hat[s * chunk:(s + 1) * chunk], impl)
            if s == n_stages - 1:
                out[mb] = acc_new  # the last stage banks the finished rotation
        # hop: the next stage works on this microbatch at tick t + 1
        send_to = s + 1 if s < n_stages - 1 and holds(t, s) else None
        recv_from = s - 1 if s > 0 and holds(t + 1, s) else None
        acc = recorder.permute(acc_new, inits[0][0], group, send_to, recv_from)

    # results live on the last stage only; the all-reduce replicates them
    # stage-wide (every other stage adds exact zeros)
    out = recorder.all_reduce(out, group)
    extracted = sample_extract0(out)  # [M, B, kN+1]
    return key_switch(extracted, params.glwe_dimension * params.degree, params.ks_decomposer,
                      ksk_mat)


def make_pipelined_gate(mesh: Mesh, params: TfheParams, gate: str, impl: str = "conv"):
    """Build a pipeline-parallel gate over a (batch, stage) mesh
    (``pipeline.py:96-136``): ``fn(ct0, ct1, server_key) -> ct_out``.

    Every rank passes the same GLOBAL microbatch queues ct0/ct1
    u32[M, B, n+1]; ``fn`` cuts this rank's rows of each microbatch with
    ``local_batch`` (dim 1) and returns its rows u32[M, B_local, n+1] of the
    output queue.  The stage's key slice is cut once per server key.
    ``fn.recorder`` holds the last call's collectives.  Raises ValueError for
    an impl outside ``PIPELINE_IMPLS`` or a stage count that does not divide n.
    """
    if impl not in PIPELINE_IMPLS:
        raise ValueError(f"unknown pipeline impl {impl!r}; valid: {PIPELINE_IMPLS}")
    if STAGE_AXIS not in mesh.shape:
        raise ValueError(f"a pipelined gate needs a mesh with a {STAGE_AXIS!r} axis, got "
                         f"{mesh.shape}")
    n_stages = mesh.shape[STAGE_AXIS]
    if params.lwe_dimension % n_stages:
        raise ValueError(f"stage={n_stages} does not divide the n={params.lwe_dimension} "
                         "rotation steps")
    recorder = CollectiveRecorder()
    tv = mtv.on_device(params, mesh.device, "gate", gate)
    held: dict = {}  # the server key last seen and this stage's slice of it

    def call(ct0, ct1, sk: ServerKey) -> torch.Tensor:
        if held.get("sk") is not sk:
            held.update(sk=sk, bk=stage_key(sk, impl, mesh.index(STAGE_AXIS), n_stages))
        recorder.reset()
        return _pipelined_gate_local(params, impl, mesh, recorder, tv,
                                     local_batch(mesh, u32(ct0), dim=1),
                                     local_batch(mesh, u32(ct1), dim=1), held["bk"], sk.ksk_mat)

    call.recorder = recorder
    return call
