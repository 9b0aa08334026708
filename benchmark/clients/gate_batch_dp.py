"""Batches of independent 2-input gates split over the cards of one host:
a server that copies its client's key to every card and cuts each batch
into one share a card (data parallelism).

Traffic keys: those of ``gate_batch`` (``batch`` is the global batch, which
the cards split evenly).  Set-up encrypts the pool on rank 0's card alone.
A request, on every rank: the global ``ct0``/``ct1`` broadcast from rank 0,
the gate of ``tfhe_tpu_torch.parallel.sharded.make_sharded_gate`` on the
(batch, model) = (cards, 1) mesh without its model axis (each rank's gate is
the one-card gate on its rows; one per gate kind, built in set-up), and
``parallel.mesh.gather_batch`` of the rows; rank 0 keeps the global output.

The check, on rank 0 once the other ranks have ended, is ``gate_batch``'s:
every output decrypted, and ``check_requests`` requests recomputed word for
word, so every rank's rows are compared.
"""

from __future__ import annotations

import random

import torch
import torch.distributed as dist

from benchmark.benchlib.runner import program_params
from benchmark.clients import gate_batch
from tfhe_tpu_torch.parallel.mesh import BATCH_AXIS, gather_batch
from tfhe_tpu_torch.parallel.sharded import make_sharded_gate


#: the traffic keys a CPU test overrides (``benchmark/tests/cells.py``)
SMALL = {"batch": 8, "pool": 2}


class Client(gate_batch.Client):
    #: this client runs on a mesh of cards (``Context.mesh``)
    accepts_mesh = True

    def __init__(self, ctx):
        if ctx.mesh is None:
            raise ValueError("gate_batch_dp runs on a mesh of cards: its cell takes chips > 1")
        if ctx.rank == 0:
            super().__init__(ctx)
        else:  # the inputs come from rank 0, request by request
            self.ctx = ctx
            traffic = ctx.cell.traffic
            self.batch, self.pool, self.gates = traffic["batch"], traffic["pool"], traffic["gates"]
            self.rng = random.Random(ctx.seed)
            self.kinds = []
            shape = (self.batch, ctx.p.n + 1)
            self.in0 = torch.empty(shape, dtype=torch.int32, device=ctx.device)
            self.in1 = torch.empty(shape, dtype=torch.int32, device=ctx.device)
        self.cards = ctx.mesh.shape[BATCH_AXIS]
        params = program_params(ctx.p)
        self.gate_fns = {name: make_sharded_gate(ctx.mesh, params, name, impl=ctx.impl,
                                                 use_model_axis=False)
                         for name in self.gates}

    def serve(self, request):
        slot, name = request
        ct0, ct1 = (self.in0[slot], self.in1[slot]) if self.ctx.rank == 0 else (self.in0,
                                                                               self.in1)
        dist.broadcast(ct0, src=0)
        dist.broadcast(ct1, src=0)
        rows = self.gate_fns[name](ct0, ct1, self.ctx.sk)
        return gather_batch(self.ctx.mesh, rows)

    def pbs_batches(self, request) -> list[int]:
        return [self.batch // self.cards] * self.cards

    def release_program_state(self) -> None:
        super().release_program_state()
        self.gate_fns = None
