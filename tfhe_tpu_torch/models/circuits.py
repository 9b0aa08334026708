"""Composed boolean circuits: full adder + ripple-carry adder, batched (port of
``tfhe_tpu/models/circuits.py``).

Every gate output is a fresh bootstrap, so circuits of any depth stay
correct (the reference's composition pattern, src/boolean.rs:9-53).  Gates
at the same circuit depth share a LUT and run as ONE batched PBS over
[W*B] ciphertexts.  A W-bit ripple-carry add of B pairs costs

  * log_p == 2 (``default_128``): 2 wide calls (XOR and AND halves), 2 narrow
    calls per carry step and 1 wide call (the sums) -> 2W + 3 PBS calls;
  * log_p >= 3 (``default_128_3in``): one ``maj`` call per carry + one wide
    ``xor3`` for all sums -> W + 1 calls.

With ``impl='fusedl'`` a wide call carries W*B ciphertexts, so W=8 fits the
latency path's cap of 8 at B=1 only.

Bit layout: little-endian u32[W, B, n+1] (bit i of sample j = ``bits[i, j]``).
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch.models import boolean as mbool
from tfhe_tpu_torch.models.keys import ClientKey, ServerKey
from tfhe_tpu_torch.ops.torus import encode as t_encode
from tfhe_tpu_torch.ops.torus import shr, u32
from tfhe_tpu_torch.utils.profiling import scope


def encrypt_uint(ck: ClientKey, values, width: int,
                 generator: torch.Generator | int = 0) -> torch.Tensor:
    """Encrypt integers < 2^width as little-endian bit batches u32[width, B, n+1]."""
    vals = u32(values, ck.device)
    bits = torch.stack([shr(vals, i) & 1 for i in range(width)])
    return mbool.encrypt(ck, bits, generator)


def decrypt_uint(ck: ClientKey, bits) -> torch.Tensor:
    """Decrypt u32[W, B, n+1] bit batches back to integers u32[B]."""
    msgs = mbool.decrypt(ck, bits).to(torch.int64)  # [W, B]
    weights = (1 << torch.arange(msgs.shape[0], device=msgs.device))[:, None]
    return u32((msgs * weights).sum(dim=0))


def trivial_bit(params, batch_shape, value: int, device=None) -> torch.Tensor:
    """Noiseless trivial LWE of a known bit (mask 0, body = encode(value))."""
    ct = torch.zeros(tuple(batch_shape) + (params.lwe_dimension + 1,), dtype=torch.int32,
                     device=device)
    ct[..., -1] = int(t_encode(value, params.log_q, params.log_p, params.padding_bits))
    return ct


def full_adder(sk: ServerKey, a, b, cin, impl: str = "auto"):
    """(sum, carry_out) of single bits a + b + cin.

    log_p >= 3 params: 2 bootstraps (``xor3``, ``maj``), depth 1.
    log_p == 2 params: 5 bootstraps (x = a^b; s = x^cin; g = ab; h = x&cin;
    cout = g|h), depth 3.
    """
    if sk.params.log_p >= 3:
        s = mbool.gate3(sk, "xor3", a, b, cin, impl=impl)
        cout = mbool.gate3(sk, "maj", a, b, cin, impl=impl)
        return s, cout
    x = mbool.gate(sk, "xor", a, b, impl=impl)
    g = mbool.gate(sk, "and", a, b, impl=impl)
    s = mbool.gate(sk, "xor", x, cin, impl=impl)
    h = mbool.gate(sk, "and", x, cin, impl=impl)
    cout = mbool.gate(sk, "or", g, h, impl=impl)
    return s, cout


def ripple_carry_add(sk: ServerKey, a_bits, b_bits, cin=None,
                     impl: str = "auto", trace: list | None = None):
    """W-bit ripple-carry addition of encrypted integers, batched.

    a_bits/b_bits: u32[W, B, n+1] little-endian bit batches; ``cin``
    defaults to a trivial 0.  Returns (sum_bits u32[W, B, n+1], carry_out
    u32[B, n+1]).  Same-depth gates are batched into single wide PBS calls
    (module docstring); the carry chain is the serial axis.  The add runs in
    a ``circuits.ripple_carry_add`` scope, the root span of its gates.

    ``trace`` (optional list) collects (label, depth, cts, clear_fn) tuples
    for per-depth noise metering: ``clear_fn(a_clear, b_clear, cin_clear)``
    returns the expected cleartexts for that stage's outputs.
    """
    w, batch = a_bits.shape[0], a_bits.shape[1]
    with scope("circuits.ripple_carry_add", width=w, batch=batch, impl=impl):
        p = sk.params
        c = trivial_bit(p, (batch,), 0, a_bits.device) if cin is None else cin

        def note(label, depth, cts, clear_fn):
            if trace is not None:
                trace.append((label, depth, cts, clear_fn))

        def flat(x):
            return x.reshape((w * batch,) + x.shape[2:])

        def unflat(x):
            return x.reshape((w, batch) + x.shape[1:])

        if p.log_p >= 3:
            # carry chain: c_{i+1} = maj(a_i, b_i, c_i), one PBS per bit
            carries = [c]
            for i in range(w):
                c = mbool.gate3(sk, "maj", a_bits[i], b_bits[i], c, impl=impl)
                note(f"carry[{i}]", i + 1, c,
                     lambda a, b, c0, i=i: _clear_carry(a, b, c0, i + 1))
                carries.append(c)
            # all W sums in one wide xor3 call at their respective depths
            s = unflat(mbool.gate3(sk, "xor3", flat(a_bits), flat(b_bits),
                                   flat(torch.stack(carries[:w])), impl=impl))
            note("sums", w + 1, s,
                 lambda a, b, c0: [_clear_sum(a, b, c0, i) for i in range(w)])
            return s, carries[w]

        # log_p == 2: wide XOR + AND over all bits at once, then the carry chain
        x = unflat(mbool.gate(sk, "xor", flat(a_bits), flat(b_bits), impl=impl))
        g = unflat(mbool.gate(sk, "and", flat(a_bits), flat(b_bits), impl=impl))
        note("halves.x", 1, x, lambda a, b, c0: [
            ((a >> i) ^ (b >> i)) & 1 for i in range(w)])
        note("halves.g", 1, g, lambda a, b, c0: [
            ((a >> i) & (b >> i)) & 1 for i in range(w)])
        carries = [c]
        for i in range(w):
            h = mbool.gate(sk, "and", x[i], c, impl=impl)
            c = mbool.gate(sk, "or", g[i], h, impl=impl)
            note(f"carry[{i}]", i + 2, c,
                 lambda a, b, c0, i=i: _clear_carry(a, b, c0, i + 1))
            carries.append(c)
        s = unflat(mbool.gate(sk, "xor", flat(x), flat(torch.stack(carries[:w])), impl=impl))
        note("sums", w + 2, s,
             lambda a, b, c0: [_clear_sum(a, b, c0, i) for i in range(w)])
        return s, carries[w]


def _clear_carry(a, b, c0, i):
    """Clear carry INTO bit i of a + b + c0 (numpy/int arrays)."""
    mask = (1 << i) - 1
    return (((a & mask) + (b & mask) + c0) >> i) & 1


def _clear_sum(a, b, c0, i):
    return ((a + b + c0) >> i) & 1


def add_uint(sk: ServerKey, a_bits, b_bits, impl: str = "auto"):
    """W-bit modular addition (carry-out dropped)."""
    s, _ = ripple_carry_add(sk, a_bits, b_bits, impl=impl)
    return s
