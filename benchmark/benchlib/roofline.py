"""The blind rotation's roofline: the least time the card could take for the
work every impl must do, from the shapes alone.

Work: the schoolbook external products, 4 int8 limbs of each key word times
each digit, R*C*N^2 multiply-adds a step, n steps a ciphertext, 2 operations
a multiply-add: 2 * 4 * R * C * N^2 * n * B.  (The arithmetic of
``tfhe_tpu_torch/bench.py``'s ``int8_tops``, copied here so that the
yardstick stays put.)  Bytes: the bootstrapping key, the accumulators in and
out and the mask exponents, each counted once.  The bound is the larger of
work over the int8 peak and bytes over the memory bandwidth.

An impl that does less than the schoolbook work (an NTT or FFT path) can read
above 100% against it; the count would then have to be replaced.
"""

from __future__ import annotations

#: published dense peaks of each card the benchmark knows (NVIDIA's H100 SXM
#: data sheet: 1,979 int8 TOP/s without sparsity, 3.35 TB/s of HBM3)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops_per_s": 1979e12, "bytes_per_s": 3.35e12},
}


def schoolbook_ops(p, batch: int) -> int:
    """int8 operations of a blind rotation of ``batch`` ciphertexts."""
    return 2 * 4 * p.rows * (p.k + 1) * p.degree ** 2 * p.n * batch


def rotation_bytes(p, batch: int) -> int:
    """Bytes a blind rotation of ``batch`` ciphertexts moves at least."""
    words = p.n * p.rows * (p.k + 1) * p.degree  # the key
    words += 2 * batch * (p.k + 1) * p.degree  # the accumulator in and out
    words += batch * p.n  # the mask exponents
    return 4 * words


def bound_seconds(p, batch: int, card: str) -> float | None:
    """The least seconds of a blind rotation of ``batch`` ciphertexts on
    ``card``, or None for a card without a row in ``PEAKS``."""
    peak = PEAKS.get(card)
    if peak is None:
        return None
    return max(schoolbook_ops(p, batch) / peak["int8_ops_per_s"],
               rotation_bytes(p, batch) / peak["bytes_per_s"])
