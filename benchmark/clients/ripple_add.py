"""Encrypted additions of W-bit integers, one after another: a circuit with a
serial chain.

Traffic keys: ``width`` (W), ``batch`` (additions per request) and ``pool``
(operand pairs drawn by the seed and encrypted bit by bit in set-up; request
i adds pair i mod pool).  A request is one call of
``tfhe_tpu_torch.models.circuits.ripple_carry_add`` on the cell's impl:
2W + 3 PBS calls, three over W*batch ciphertexts and 2W over batch.  The
client takes configurations of log_p = 2 alone (2-input gates).

The check decrypts the sum bits and the carry out of every addition of the
window against the integers' sum (``wrong_bits``) and recomputes
``check_requests`` additions drawn by the seed with the reference, word for
word (``diff_words``).
"""

from __future__ import annotations

import random

import torch

import tfhe_tpu_torch as tfhe
from benchmark.reference import tfhe_ref as ref


#: the traffic keys a CPU test overrides (``benchmark/tests/cells.py``)
SMALL = {"width": 4, "batch": 2, "pool": 3}


class Client:
    def __init__(self, ctx):
        if ctx.p.log_p != 2:
            raise ValueError(f"ripple_add takes log_p = 2, not {ctx.p.log_p}")
        self.ctx = ctx
        traffic = ctx.cell.traffic
        self.width, self.batch, self.pool = traffic["width"], traffic["batch"], traffic["pool"]
        p, w = ctx.p, self.width
        shape = (self.pool, self.batch)
        self.a = torch.randint(0, 1 << w, shape, generator=ctx.gen, device=ctx.device)
        self.b = torch.randint(0, 1 << w, shape, generator=ctx.gen, device=ctx.device)
        shifts = torch.arange(w, device=ctx.device)[None, :, None]
        self.ca = ref.encrypt_bits(p, ctx.gen, ctx.lwe_sk, (self.a[:, None] >> shifts) & 1)
        self.cb = ref.encrypt_bits(p, ctx.gen, ctx.lwe_sk, (self.b[:, None] >> shifts) & 1)
        self.in_a = ref.to_carrier(self.ca).contiguous()  # [pool, W, batch, n+1]
        self.in_b = ref.to_carrier(self.cb).contiguous()

    def request(self, i: int) -> int:
        return i % self.pool

    def warm_request(self) -> int:
        return 0

    def serve(self, slot):
        return tfhe.circuits.ripple_carry_add(self.ctx.sk, self.in_a[slot], self.in_b[slot],
                                              impl=self.ctx.impl)

    def pbs_batches(self, slot) -> list[int]:
        w, b = self.width, self.batch
        return [w * b] * 2 + [b] * (2 * w) + [w * b]

    def units(self, slot) -> int:
        return sum(self.pbs_batches(slot))

    def release_program_state(self) -> None:
        self.in_a = self.in_b = None

    def check(self, keys, served, rng: random.Random):
        p, limits, w = self.ctx.p, self.ctx.cell.workload["limits"], self.width
        shifts = torch.arange(w + 1, device=self.ctx.device)[:, None]
        wrong_bits, noise, bad = 0, 0.0, set()
        for i, s in enumerate(served):
            total = self.a[s.request] + self.b[s.request]
            want = (total[None] >> shifts) & 1  # [W+1, batch]: the sum bits, then the carry
            got = torch.cat([ref.from_carrier(s.outputs[0]),
                             ref.from_carrier(s.outputs[1])[None]])
            wrong = int((ref.decrypt(p, self.ctx.lwe_sk, got) != want).sum())
            wrong_bits += wrong
            if wrong:
                bad.add(i)
            noise = max(noise, float(ref.noise_over_delta(p, self.ctx.lwe_sk, got, want).max()))
        picked = sorted(rng.sample(range(len(served)),
                                   min(self.ctx.cell.workload["check_requests"], len(served))))
        slots = [served[i].request for i in picked]
        s_ref, c_ref = ref.ripple_add(p, keys, torch.cat([self.ca[s] for s in slots], dim=1),
                                      torch.cat([self.cb[s] for s in slots], dim=1))
        got_s = torch.cat([ref.from_carrier(served[i].outputs[0]) for i in picked], dim=1)
        got_c = torch.cat([ref.from_carrier(served[i].outputs[1]) for i in picked])
        b = self.batch
        diff = [int((s_ref[:, j * b:(j + 1) * b] != got_s[:, j * b:(j + 1) * b]).sum()
                    + (c_ref[j * b:(j + 1) * b] != got_c[j * b:(j + 1) * b]).sum())
                for j in range(len(picked))]
        bad.update(i for i, d in zip(picked, diff) if d)
        numbers = {"wrong_bits": (wrong_bits, limits["wrong_bits"]),
                   "diff_words": (sum(diff), limits["diff_words"])}
        info = {"outputs_decrypted": len(served) * (w + 1) * b,
                "noise_max_over_delta": noise, "checked_requests": len(picked),
                "checked_words": int(got_s.numel() + got_c.numel())}
        return numbers, info, len(bad)
