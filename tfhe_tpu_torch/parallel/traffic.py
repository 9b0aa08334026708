"""Collective traffic: a recorder of every collective the sharded gates call,
and the closed-form payload and efficiency model (port of
``tfhe_tpu/parallel/traffic.py``).

The JAX package reads the collectives out of the compiled gate's HLO
(``extract_collectives``).  PyTorch runs eagerly and has no such module, so
here every collective of ``parallel/sharded.py`` and
``parallel/pipeline.py`` goes through a ``CollectiveRecorder``, which runs
it and records its kind, dtype, shape and result bytes.  The kind names are
JAX's (``all-reduce``, ``all-gather``, ``collective-permute``), so the
records compare with ``expected_collectives`` as the HLO audit's did.

Model (unoverlapped, conservative): the CMUX scan is step-serial, so
per-step collectives serialize with compute, eff = t_comp / (t_comp +
t_wire) with t_wire = payload_bytes_per_sample_step(D) / link rate.  Ring
all-reduce moves 2*(D-1)/D x payload per card, all-gather receives
(D-1)/D x the full result, a permute hop moves its payload once per stage
boundary (amortized over the n rotation steps a sample spends in the pipe).
No link rate is built in: the caller passes the one it has.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from tfhe_tpu_torch.params import TfheParams


@dataclass(frozen=True)
class Collective:
    kind: str  # all-reduce | all-gather | collective-permute
    dtype: str
    shape: tuple
    bytes: int  # result payload bytes


class CollectiveRecorder:
    """Runs the sharded modules' collectives and records their payloads.

    Convention: the HLO audit it replaces saw a while loop's body once, so
    each distinct payload (kind, dtype, shape) is recorded once however many
    steps repeat it; ``collectives`` maps it to the number of calls, which
    ``calls()`` sums per kind and size for ``expected_calls``.  The
    bytes are the result's: the whole gathered tensor for an all-gather, the
    hopped tensor for a permute.  A permute is recorded whenever the program
    runs it, also on a rank whose part moves nothing (the last stage sends
    nothing, the first receives nothing), as every rank's HLO holds it.
    """

    def __init__(self):
        self.collectives: dict[Collective, int] = {}

    def reset(self) -> None:
        self.collectives.clear()

    def payloads(self) -> dict[str, set[int]]:
        """Kind -> the set of result bytes, ``expected_collectives``' form."""
        return {kind: set(calls) for kind, calls in self.calls().items()}

    def calls(self) -> dict[str, dict[int, int]]:
        """Kind -> result bytes -> calls, ``expected_calls``' form (payloads
        of one kind and size summed)."""
        out: dict[str, dict[int, int]] = {}
        for c, n in self.collectives.items():
            sizes = out.setdefault(c.kind, {})
            sizes[c.bytes] = sizes.get(c.bytes, 0) + n
        return out

    def _record(self, kind: str, result: torch.Tensor) -> None:
        c = Collective(kind, str(result.dtype).removeprefix("torch."), tuple(result.shape),
                       result.numel() * result.element_size())
        self.collectives[c] = self.collectives.get(c, 0) + 1

    def all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        """SUM ``t`` in place over ``group`` and return it.  For int32 this
        is wrapping u32 addition: two's-complement sums wrap mod 2^32."""
        dist.all_reduce(t, group=group)
        self._record("all-reduce", t)
        return t

    def all_gather(self, t: torch.Tensor, group, dim: int) -> torch.Tensor:
        """Concatenate every rank's ``t`` along ``dim``, in group-rank order."""
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        out = torch.cat(parts, dim=dim)
        self._record("all-gather", out)
        return out

    def permute(self, t: torch.Tensor | None, like: torch.Tensor, group, send_to: int | None,
                recv_from: int | None) -> torch.Tensor:
        """One hop of a point-to-point permute (JAX's ``ppermute``): send ``t``
        to group rank ``send_to`` and receive a tensor shaped as ``like`` from
        ``recv_from`` (each None for no peer), posted together in one
        ``batch_isend_irecv``.  Returns what was received, or zeros."""
        got = torch.zeros_like(like)
        ops = []
        if recv_from is not None:
            ops.append(dist.P2POp(dist.irecv, got, dist.get_global_rank(group, recv_from),
                                  group))
        if send_to is not None:
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  dist.get_global_rank(group, send_to), group))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        self._record("collective-permute", like)
        return got


def _collectives(params: TfheParams, mode: str, batch_local: int, m_microbatches: int,
                 n_stages: int) -> list[tuple[str, int, int]]:
    """(kind, result bytes, calls per gate) of each collective of ``mode``."""
    k1 = params.glwe_dimension + 1
    n_deg = params.degree
    n_steps = params.lwe_dimension
    delta = batch_local * k1 * n_deg * 4  # u32 [B_local, k+1, N]
    ks = batch_local * (params.lwe_dimension + 1) * 4  # u32 [B_local, n+1]
    if mode == "dp":
        return []
    if mode == "tp":
        return [("all-reduce", delta, n_steps), ("all-reduce", ks, 1)]
    if mode == "coeffs":
        return [("all-gather", delta, n_steps), ("all-reduce", ks, 1)]
    if mode == "ntt":
        from tfhe_tpu_torch.ops.ntt import PRIMES, plan_for_params

        plan = plan_for_params(params)
        cln2 = k1 * plan.key_limbs * plan.n2
        planes = len(PRIMES) * 3 * batch_local * cln2 * plan.n1 * 4
        return [("all-reduce", planes, n_steps), ("all-reduce", ks, 1)]
    if mode == "pp":
        if m_microbatches <= 0:
            raise ValueError("pp mode needs m_microbatches")
        final = m_microbatches * delta  # one all-reduce replicating the out queue
        return [("collective-permute", delta, m_microbatches + n_stages - 1),
                ("all-reduce", final, 1)]
    raise ValueError(f"unknown mode {mode!r}")


def expected_collectives(params: TfheParams, mode: str, batch_local: int,
                         m_microbatches: int = 0) -> dict[str, set[int]]:
    """Closed-form per-mode collective payloads: result bytes by kind.

    mode: 'tp' (BK rows + KSK rows sharded, per-step u32 delta all-reduce),
    'coeffs' (per-step u32 delta all-gather over the coefficient axis),
    'ntt' (NTT bins sharded: per-step raw INTT limb-plane all-reduce),
    'pp' (pipeline: per-tick accumulator permute hop + one final
    result-replicating all-reduce), 'dp' (none).
    """
    out: dict[str, set[int]] = {}
    for kind, size, _ in _collectives(params, mode, batch_local, m_microbatches, 1):
        out.setdefault(kind, set()).add(size)
    return out


def expected_calls(params: TfheParams, mode: str, batch_local: int, m_microbatches: int = 0,
                   n_stages: int = 1) -> dict[str, dict[int, int]]:
    """The calls behind ``expected_collectives`` in one gate: kind -> result
    bytes -> calls (payloads of one kind and size summed), as
    ``CollectiveRecorder.calls`` counts them.  The scan makes one delta
    all-reduce ('tp'), all-gather ('coeffs') or plane all-reduce ('ntt') per
    each of its n steps, then the key switch one all-reduce; the pipeline
    one hop per tick, M+S-1 ticks, then one all-reduce."""
    out: dict[str, dict[int, int]] = {}
    for kind, size, calls in _collectives(params, mode, batch_local, m_microbatches, n_stages):
        sizes = out.setdefault(kind, {})
        sizes[size] = sizes.get(size, 0) + calls
    return out


def wire_bytes_per_sample_step(params: TfheParams, mode: str, d: int) -> float:
    """Per-card wire bytes per sample per rotation step at model-axis (or
    stage-axis) size ``d``, from the same payload model."""
    per = expected_collectives(params, mode, batch_local=1, m_microbatches=1)
    n_steps = params.lwe_dimension
    if mode == "dp":
        return 0.0
    if mode == "tp":
        payload = max(per["all-reduce"])  # the per-step delta all-reduce
        return 2 * (d - 1) / d * payload
    if mode == "coeffs":
        payload = max(per["all-gather"])
        return (d - 1) / d * payload
    if mode == "ntt":
        payload = max(per["all-reduce"])
        return 2 * (d - 1) / d * payload
    if mode == "pp":
        # one [k+1, N] u32 hop per stage boundary per sample, amortized over
        # the n steps the sample spends in the pipe
        payload = max(per["collective-permute"])
        return payload * (d - 1) / n_steps
    raise ValueError(f"unknown mode {mode!r}")


def predict_efficiency(params: TfheParams, mode: str, d: int, *, link_gbps: float,
                       us_per_sample_step: float, m_microbatches: int = 32) -> float:
    """Unoverlapped scaling-efficiency prediction (against one card) for
    ``d`` cards on one link of ``link_gbps`` GB/s each way.  The caller
    gives the link rate; for NVLink on an H100 the data sheet states 450 GB/s
    each way (a specification, not a measurement of this code).

    Model-sharded modes (tp/coeffs/ntt) split each sample-step's compute D
    ways, so the per-sample-step wall is t/D + w(D) and the efficiency
    T_1/(D*T_D) = t/(t + D*w).  The pipeline keeps each card busy on its own
    microbatch while accumulators hop, so the hop time is a serial tax per
    sample (eff = t/(t + w)) times the M/(M+D-1) fill bubble."""
    if mode == "dp":
        return 1.0  # no steady-state collective; load balance only
    t_comp = us_per_sample_step  # us
    t_wire = wire_bytes_per_sample_step(params, mode, d) / (link_gbps * 1e3)
    if mode == "pp":
        return (t_comp / (t_comp + t_wire)
                * m_microbatches / (m_microbatches + d - 1))
    return t_comp / (t_comp + d * t_wire)
