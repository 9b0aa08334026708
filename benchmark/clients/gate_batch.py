"""Batches of independent 2-input gates: a server with a backlog.

Traffic keys: ``batch`` (gates per request), ``gates`` (the gate names a
request's kind is drawn from, uniformly, by the seed) and ``pool`` (input
pairs encrypted in set-up; request i reads pair i mod pool).  A request is
one call of ``tfhe_tpu_torch.models.boolean.gate`` on the cell's impl: one
PBS over ``batch`` ciphertexts.

The check decrypts every output of the window against the gate's truth
table (``wrong_bits``) and recomputes ``check_requests`` requests drawn by
the seed with the reference, word for word (``diff_words``).
"""

from __future__ import annotations

import random

import torch

import tfhe_tpu_torch as tfhe
from benchmark.reference import tfhe_ref as ref


#: the traffic keys a CPU test overrides (``benchmark/tests/cells.py``)
SMALL = {"batch": 4, "pool": 2}


class Client:
    def __init__(self, ctx):
        self.ctx = ctx
        traffic = ctx.cell.traffic
        self.batch, self.pool, self.gates = traffic["batch"], traffic["pool"], traffic["gates"]
        p = ctx.p
        # lhs is ct1 and rhs is ct0: the gate reads 2*ct1 + ct0
        self.lhs = ref.bits(ctx.gen, (self.pool, self.batch))
        self.rhs = ref.bits(ctx.gen, (self.pool, self.batch))
        self.ct1 = ref.encrypt_bits(p, ctx.gen, ctx.lwe_sk, self.lhs)
        self.ct0 = ref.encrypt_bits(p, ctx.gen, ctx.lwe_sk, self.rhs)
        self.in1 = ref.to_carrier(self.ct1).contiguous()
        self.in0 = ref.to_carrier(self.ct0).contiguous()
        self.rng = random.Random(ctx.seed)
        self.kinds: list[str] = []

    def request(self, i: int) -> tuple[int, str]:
        while len(self.kinds) <= i:
            self.kinds.append(self.gates[self.rng.randrange(len(self.gates))])
        return i % self.pool, self.kinds[i]

    def warm_request(self) -> tuple[int, str]:
        return 0, self.gates[0]

    def serve(self, request):
        slot, name = request
        return tfhe.gates.gate(self.ctx.sk, name, self.in0[slot], self.in1[slot],
                               impl=self.ctx.impl)

    def units(self, request) -> int:
        return self.batch

    def pbs_batches(self, request) -> list[int]:
        return [self.batch]

    def release_program_state(self) -> None:
        self.in0 = self.in1 = None

    def check(self, keys, served, rng: random.Random):
        p, limits = self.ctx.p, self.ctx.cell.workload["limits"]
        wrong_bits, noise, bad = 0, 0.0, set()
        for i, s in enumerate(served):
            slot, name = s.request
            want = ref.GATES[name](self.lhs[slot], self.rhs[slot])
            got = ref.from_carrier(s.outputs)
            wrong = int((ref.decrypt(p, self.ctx.lwe_sk, got) != want).sum())
            wrong_bits += wrong
            if wrong:
                bad.add(i)
            noise = max(noise, float(ref.noise_over_delta(p, self.ctx.lwe_sk, got, want).max()))
        picked = sorted(rng.sample(range(len(served)),
                                   min(self.ctx.cell.workload["check_requests"], len(served))))
        slots = [served[i].request[0] for i in picked]
        names = [served[i].request[1] for i in picked for _ in range(self.batch)]
        want = ref.gate(p, keys, names, torch.cat([self.ct0[s] for s in slots]),
                        torch.cat([self.ct1[s] for s in slots]))
        got = torch.cat([ref.from_carrier(served[i].outputs) for i in picked])
        diff = (want != got).reshape(len(picked), -1).sum(-1).tolist()
        bad.update(i for i, d in zip(picked, diff) if d)
        numbers = {"wrong_bits": (wrong_bits, limits["wrong_bits"]),
                   "diff_words": (sum(diff), limits["diff_words"])}
        info = {"outputs_decrypted": len(served) * self.batch,
                "noise_max_over_delta": noise, "checked_requests": len(picked),
                "checked_words": int(got.numel())}
        return numbers, info, len(bad)
