"""Noise budget metering (port of ``tfhe_tpu/utils/noise.py``).

Decrypt-and-measure the centered error of a ciphertext batch and report the
margin |e|/Delta, which must stay well below 0.5 (past it, decoded bits flip).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tfhe_tpu_torch.models import lwe as mlwe
from tfhe_tpu_torch.models.keys import ClientKey
from tfhe_tpu_torch.ops.torus import encode as t_encode
from tfhe_tpu_torch.ops.torus import to_numpy_u32


@dataclass(frozen=True)
class NoiseReport:
    max_abs_over_delta: float
    mean_abs_over_delta: float
    failures: int  # samples past the Delta/2 decode threshold
    count: int

    def __str__(self):
        return (
            f"noise margin: max |e|/Delta = {self.max_abs_over_delta:.4f}, "
            f"mean = {self.mean_abs_over_delta:.4f}, "
            f"failures = {self.failures}/{self.count}"
        )


def centered_error(ck: ClientKey, cts, messages) -> np.ndarray:
    """Signed error to the NEAREST valid encoding of each message.

    Valid encodings of m repeat every p*Delta = 2^(log_q - padding_bits), so
    the distance is reduced mod p*Delta and centered.  The int32 carriers are
    read back as uint32 before the int64 arithmetic.
    """
    p = ck.params
    period = 1 << (p.log_q - p.padding_bits)
    pt = to_numpy_u32(mlwe.decrypt(ck.lwe_sk, cts))
    expected = to_numpy_u32(
        t_encode(np.asarray(messages, np.uint32), p.log_q, p.log_p, p.padding_bits))
    diff = (pt.astype(np.int64) - expected.astype(np.int64)) % period
    return np.where(diff >= period // 2, diff - period, diff)


def measure(ck: ClientKey, cts, messages) -> NoiseReport:
    """Noise margin of a ciphertext batch against its known messages."""
    e = centered_error(ck, cts, messages)
    rel = np.abs(e) / float(ck.params.delta)
    return NoiseReport(
        max_abs_over_delta=float(rel.max()),
        mean_abs_over_delta=float(rel.mean()),
        failures=int((rel >= 0.5).sum()),
        count=int(rel.size),
    )
