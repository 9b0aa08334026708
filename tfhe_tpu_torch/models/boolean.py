"""Boolean gate layer (port of ``tfhe_tpu/models/boolean.py``; reference:
src/boolean.rs), batched.

Every 2-input gate is one linear combination ct_in = 2*ct1 + ct0 followed by
one PBS with the gate's LUT (src/boolean.rs:18-27).  NOT is noise-free linear
(no PBS); MUX composes AND/OR gates.  All gates take u32[B, n+1] ciphertext
batches on the server key's device.
"""

from __future__ import annotations

import torch

from tfhe_tpu_torch.models import bootstrap as mboot
from tfhe_tpu_torch.models import lwe as mlwe
from tfhe_tpu_torch.models import test_vector as mtv
from tfhe_tpu_torch.models.keys import ClientKey, ServerKey
from tfhe_tpu_torch.ops import sampling
from tfhe_tpu_torch.ops.torus import decode as t_decode
from tfhe_tpu_torch.ops.torus import encode as t_encode
from tfhe_tpu_torch.ops.torus import u32
from tfhe_tpu_torch.utils.profiling import scope

# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------


def encrypt(ck: ClientKey, messages, generator: torch.Generator | int = 0) -> torch.Tensor:
    """Encrypt a batch of cleartexts (0..2^log_p) -> u32[B, n+1] on the key's
    device.  Masks and noise come from ``generator`` (or a CPU generator
    seeded with the given int)."""
    p = ck.params
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    msgs = u32(messages, ck.device)
    a = sampling.uniform_u32(generator, msgs.shape + (p.lwe_dimension,)).to(ck.device)
    e = sampling.gaussian_torus(generator, p.lwe_std_dev, msgs.shape).to(ck.device)
    pt = t_encode(msgs, p.log_q, p.log_p, p.padding_bits)
    return mlwe.encrypt(ck.lwe_sk, pt, a, e)


def decrypt(ck: ClientKey, cts) -> torch.Tensor:
    """Decrypt a batch -> cleartexts u32[B]."""
    p = ck.params
    return t_decode(mlwe.decrypt(ck.lwe_sk, cts), p.log_q, p.log_p, p.padding_bits)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------


def _pbs_with_tv(sk: ServerKey, ct_in, tv_key: tuple, impl: str) -> torch.Tensor:
    """The PBS of one gate, inside its ``pbs.gate`` scope: the test vector
    ``tv_key`` = (kind, *args) comes from the device cache in
    ``pbs.test_vector`` (``test_vector.on_device``: copied to the key's
    device the first time only, so a gate that hits the cache does not wait
    for the card), then ``bootstrap.pbs`` runs."""
    with scope("pbs.test_vector"):
        tv = mtv.on_device(sk.params, sk.device, *tv_key)
    return mboot.pbs(sk.params, ct_in, sk, tv, impl=impl)


def gate(sk: ServerKey, name: str, ct0, ct1, impl: str = "auto") -> torch.Tensor:
    """Named 2-input gate: ct_in = 2*ct1 + ct0, one PBS (src/boolean.rs:9-53)."""
    with scope("pbs.gate", gate=name, impl=impl):
        with scope("pbs.lincomb"):
            ct_in = mlwe.add(mlwe.scalar_mul(ct1, 2), ct0)
        return _pbs_with_tv(sk, ct_in, ("gate", name), impl)


def apply_lut(sk: ServerKey, ct, lut, impl: str = "auto") -> torch.Tensor:
    """Generic programmable bootstrap: ct already encodes the LUT index
    (0..2^log_p); ``lut`` maps each index to an output cleartext."""
    with scope("pbs.gate", gate="lut", impl=impl):
        return _pbs_with_tv(sk, ct, ("lut", tuple(int(x) for x in lut)), impl)


def gate3(sk: ServerKey, name: str, ct2, ct1, ct0, impl: str = "auto") -> torch.Tensor:
    """Named 3-input gate: ct_in = 4*ct2 + 2*ct1 + ct0, one PBS
    (notes/Boolean Gates.md:7-11).  Requires a log_p>=3 parameter set."""
    with scope("pbs.gate", gate=name, impl=impl):
        with scope("pbs.lincomb"):
            ct_in = mlwe.add(mlwe.add(mlwe.scalar_mul(ct2, 4), mlwe.scalar_mul(ct1, 2)), ct0)
        return _pbs_with_tv(sk, ct_in, ("gate3", name), impl)


def mux3(sk: ServerKey, sel, a, b, impl: str = "auto") -> torch.Tensor:
    """Single-PBS MUX on log_p>=3 params (vs the 3-PBS 2-input composition)."""
    return gate3(sk, "mux", sel, a, b, impl=impl)


def bootstrap_identity(sk: ServerKey, ct, impl: str = "auto") -> torch.Tensor:
    """Noise-refreshing identity bootstrap (src/bootstrapping.rs tests)."""
    with scope("pbs.gate", gate="identity", impl=impl):
        return _pbs_with_tv(sk, ct, ("identity",), impl)


def not_(sk_or_params, ct) -> torch.Tensor:
    """NOT: linear, noise-free — trivial(1) - ct.  No PBS needed."""
    p = sk_or_params.params if hasattr(sk_or_params, "params") else sk_or_params
    ct = u32(ct)
    trivial = torch.zeros_like(ct)
    trivial[..., -1] = int(t_encode(1, p.log_q, p.log_p, p.padding_bits))
    return trivial - ct


def mux(sk: ServerKey, sel, a, b, impl: str = "auto") -> torch.Tensor:
    """MUX(sel, a, b) = sel ? a : b = OR(AND(sel, a), AND(NOT sel, b)).

    Three PBS; the ANDNY gate folds the NOT into its LUT.
    """
    t = gate(sk, "and", a, sel, impl=impl)
    f = gate(sk, "andny", b, sel, impl=impl)
    return gate(sk, "or", f, t, impl=impl)


def _named(name):
    def f(sk: ServerKey, ct0, ct1, impl: str = "auto"):
        return gate(sk, name, ct0, ct1, impl=impl)

    f.__name__ = name
    f.__doc__ = f"{name.upper()} gate via gate bootstrapping."
    return f


and_ = _named("and")
or_ = _named("or")
xor = _named("xor")
nand = _named("nand")
nor = _named("nor")
xnor = _named("xnor")
andny = _named("andny")
andyn = _named("andyn")
