"""Test-vector (LUT) polynomial construction (reference: src/test_vector.rs).

The tables are host-side NumPy, tiny, built on each call.  The PBS
consumes the *encoded* polynomial (tv << (log_q - log_p - padding)), exactly
as src/bootstrapping.rs:82-86 encodes it before the blind rotation.

``on_device`` keeps each encoded test vector as an int32 tensor on each
device that asks for it, in a bounded LRU keyed by (params, device, kind,
arguments), the module's one cache: the gates, the bench and the sharded and
pipelined gates take their test vector from it, so a gate copies nothing to
the card once its kind has been seen there.  A miss makes the tensor and,
on a card, copies it there from pageable memory inside
``card_wait("pbs")`` (a copy that waits until the card has drained); the
program's counters (``utils/profiling.py``) count the misses under
``pbs.test_vector_uploads`` and the hits under ``pbs.test_vector_hits``.
The tensors are shared by every caller and must not be written to.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tfhe_tpu_torch.ops.torus import to_torch_u32
from tfhe_tpu_torch.params import TfheParams
from tfhe_tpu_torch.utils.profiling import card_wait, count


def construct_test_from_lut(params: TfheParams, lut) -> np.ndarray:
    """LUT (len 2^log_p) -> test-vector polynomial u32[N]
    (src/test_vector.rs:38-67): repeat each value N/2^log_p times, negate the
    first half-block (mod p) and rotate left by half a block so negative noise
    around 0 decodes to the right entry."""
    p_mod = 1 << params.log_p
    lut = list(lut)
    assert len(lut) == p_mod
    repetition = params.degree // p_mod
    tv = np.repeat(np.asarray(lut, dtype=np.uint32), repetition)
    half = repetition // 2
    head = tv[:half].copy()
    nz = head != 0
    head[nz] = np.uint32(p_mod) - head[nz]
    tv[:half] = head
    return np.roll(tv, -half)


def encode_tv(params: TfheParams, tv: np.ndarray) -> np.ndarray:
    """Encode the LUT outputs onto the torus (src/glwe.rs:140-152)."""
    shift = params.log_q - (params.log_p + params.padding_bits)
    assert np.all(tv < (1 << params.log_p))
    return (tv.astype(np.uint32) << np.uint32(shift)).astype(np.uint32)


#: 2-input gate truth functions, generalizing src/boolean.rs:9-53's AND/OR to
#: the full suite (notes/Boolean Gates.md:2-11)
GATE_FNS = {
    "and": lambda l, r: l & r,
    "or": lambda l, r: l | r,
    "xor": lambda l, r: l ^ r,
    "nand": lambda l, r: 1 - (l & r),
    "nor": lambda l, r: 1 - (l | r),
    "xnor": lambda l, r: 1 - (l ^ r),
    "andny": lambda l, r: (1 - l) & r,  # not(l) and r
    "andyn": lambda l, r: l & (1 - r),
    "orny": lambda l, r: ((1 - l) | r) & 1,
    "oryn": lambda l, r: (l | (1 - r)) & 1,
}


def gate_test_vector(params: TfheParams, gate: str) -> np.ndarray:
    """Encoded test vector for a named 2-input gate: input index i decodes as
    (lhs, rhs) = (bit1(i), bit0(i)) (src/test_vector.rs:5-20)."""
    f = GATE_FNS[gate]
    lut = [f((i >> 1) & 1, i & 1) for i in range(1 << params.log_p)]
    return encode_tv(params, construct_test_from_lut(params, lut))


def lut_test_vector(params: TfheParams, lut: tuple) -> np.ndarray:
    """Encoded test vector for an arbitrary LUT over the 2^log_p cleartext
    space (generic programmable bootstrapping)."""
    return encode_tv(params, construct_test_from_lut(params, list(lut)))


#: 3-input gate truth functions over index i = 4*c2 + 2*c1 + c0
#: (notes/Boolean Gates.md:7-11); require log_p >= 3
GATE3_FNS = {
    "mux": lambda s, a, b: a if s else b,  # s ? a : b — ONE PBS instead of 3
    "maj": lambda a, b, c: (a & b) | (a & c) | (b & c),
    "and3": lambda a, b, c: a & b & c,
    "or3": lambda a, b, c: a | b | c,
    "xor3": lambda a, b, c: a ^ b ^ c,
}


def gate3_test_vector(params: TfheParams, gate: str) -> np.ndarray:
    """Encoded test vector for a named 3-input gate: index i decodes as
    (bit2, bit1, bit0)."""
    assert params.log_p >= 3, "3-input gates need log_p >= 3"
    f = GATE3_FNS[gate]
    lut = [f((i >> 2) & 1, (i >> 1) & 1, i & 1) for i in range(1 << params.log_p)]
    return encode_tv(params, construct_test_from_lut(params, lut))


def identity_test_vector(params: TfheParams) -> np.ndarray:
    """Encoded identity LUT (src/test_vector.rs:23-35)."""
    lut = list(range(1 << params.log_p))
    return encode_tv(params, construct_test_from_lut(params, lut))


#: the encoder of each kind of test vector ``on_device`` takes, and its arguments
#: after the params: a gate's name, the LUT as a tuple of ints, a 3-input gate's
#: name, none
ENCODERS = {
    "gate": gate_test_vector,
    "lut": lut_test_vector,
    "gate3": gate3_test_vector,
    "identity": identity_test_vector,
}
#: the most tensors ``on_device`` keeps (2 KB each at N = 512)
DEVICE_CACHE_SIZE = 256


@lru_cache(maxsize=DEVICE_CACHE_SIZE)
def _on_device(params: TfheParams, device: torch.device, kind: str, args: tuple) -> torch.Tensor:
    count("pbs.test_vector_uploads")
    tv = to_torch_u32(ENCODERS[kind](params, *args))
    if device.type != "cpu":
        with card_wait("pbs"):
            tv = tv.to(device)
    return tv


def on_device(params: TfheParams, device: torch.device, kind: str, *args) -> torch.Tensor:
    """The encoded test vector ``ENCODERS[kind](params, *args)`` as an int32
    tensor on ``device``, made and copied there on the first call for that
    key and kept for the later ones (module docstring).  Read-only."""
    misses = _on_device.cache_info().misses
    tv = _on_device(params, device, kind, args)
    if _on_device.cache_info().misses == misses:  # the cache held it
        count("pbs.test_vector_hits")
    return tv


def clear_device_cache() -> None:
    """Drop every tensor ``on_device`` keeps."""
    _on_device.cache_clear()
