"""Client/server keys and key generation (port of ``tfhe_tpu/models/keys.py``).

Keys are dataclasses of int32 tensors carrying u32 (see ``ops/torus.py``), all
on one device:

  * ``ServerKey.bk_u32`` — canonical GGSW tensor u32[n, R, k+1, N] (Kernel B
    and the plain scan read it);
  * ``ServerKey.bk_lm``  — the same rows level-major (r' = level*(k+1)+poly),
    for the per-step external-product kernel (impl='pallas');
  * ``ServerKey.ksk_mat`` — KSK as int8 limbs [kN*l_ks, (n+1)*4];
  * ``ServerKey.bk_bmmp_lm`` — optional BMMP key triples (``keygen(bmmp=True)``);
  * ``ServerKey.bk_lat`` / ``bk_bmmp_lat`` — optional latency-kernel key
    operands, attached by ``with_latency_key``;
  * ``ServerKey.bk_ntt`` / ``bk_ntt_lhs`` — optional NTT-domain key forms for
    the block-NTT impls, attached by ``with_ntt_key`` / ``with_ntt_lhs_key``.

Keys land on the card (``device="cuda"``) unless the caller asks for another
device.

Key generation is split into a deterministic core with explicit mask/noise
tensors (bit-comparable with the JAX package) and a sampling wrapper.
``keys_from_numpy`` takes the JAX package's canonical arrays (the ``.npz``
fields of ``tfhe_tpu/utils/serialization.py``) so both packages compute with
the same key.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from tfhe_tpu_torch.models import ggsw as mggsw
from tfhe_tpu_torch.models import glwe as mglwe
from tfhe_tpu_torch.models import keyswitch as mks
from tfhe_tpu_torch.models.bootstrap import IMPLS
from tfhe_tpu_torch.ops import sampling
from tfhe_tpu_torch.ops.cuda.ntt_kernel import lhs_key_shape
from tfhe_tpu_torch.ops.ntt import make_ep_ntt_key, ntt_key_lhs_form, plan_for_params
from tfhe_tpu_torch.ops.poly import level_major_row_perm
from tfhe_tpu_torch.ops.torus import u32
from tfhe_tpu_torch.params import TfheParams


@dataclass(frozen=True)
class ClientKey:
    """Secret keys (src/lwe.rs:50-60, src/glwe.rs:172-182)."""

    lwe_sk: torch.Tensor  # u32[n] binary
    glwe_sk: torch.Tensor  # u32[k, N] binary
    params: TfheParams

    @property
    def device(self) -> torch.device:
        return self.lwe_sk.device

    def to(self, device) -> "ClientKey":
        return dataclasses.replace(
            self, lwe_sk=self.lwe_sk.to(device), glwe_sk=self.glwe_sk.to(device))


@dataclass(frozen=True)
class ServerKey:
    """Bootstrapping key + key-switching key (src/bootstrapping.rs:18-21)."""

    bk_u32: torch.Tensor  # u32[n, R, k+1, N] (canonical GGSW row order)
    bk_lm: torch.Tensor  # u32[n, R, k+1, N], rows level-major
    ksk_u32: torch.Tensor  # u32[kN*l_ks, n+1]
    ksk_mat: torch.Tensor  # int8[kN*l_ks, (n+1)*4]
    params: TfheParams
    #: optional BMMP key (notes/BMMP Bootstrapping.md:15-25): per secret-bit
    #: pair i, the level-major rows of GGSW(s s'), GGSW(s(1-s')),
    #: GGSW((1-s)s') concatenated -> u32[n/2, 3R, k+1, N].  None unless
    #: keygen(..., bmmp=True).
    bk_bmmp_lm: torch.Tensor | None = None
    #: optional latency-kernel key operands (``ops/cuda/latency_kernel.py``),
    #: int8[steps, (k+1)*4, 4*G*N], attached by ``with_latency_key``
    bk_lat: torch.Tensor | None = None
    bk_bmmp_lat: torch.Tensor | None = None
    #: optional NTT-domain key for impl='ntt' (``ops/ntt.py:make_ep_ntt_key``
    #: of every step): int8[n, P, 2, N1, R*N2, C*L*N2], attached by
    #: ``with_ntt_key``
    bk_ntt: torch.Tensor | None = None
    #: optional lhs form of it for impl='nttf' (Kernel D):
    #: int8[n, P, N1, 2*C*L*N2, R*N2], attached by ``with_ntt_lhs_key``
    bk_ntt_lhs: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.bk_u32.device

    def to(self, device) -> "ServerKey":
        """The same key with every tensor field on ``device`` (None stays None)."""
        moved = {f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)

    def form(self, field: str) -> torch.Tensor:
        """The key tensor ``field`` (an impl's ``bootstrap.IMPLS[impl].key``);
        ``ValueError`` naming the call that attaches it when the key lacks it."""
        bk = getattr(self, field)
        if bk is None:
            made = (f"{KEY_FORMS[field][0].__name__}(server_key)" if field in KEY_FORMS
                    else "keygen or server_key_from_numpy")
            raise ValueError(f"this impl needs the key form {field}: {made}")
        return bk


def _server_key_from_canonical(params: TfheParams, bk_u32, ksk_u32,
                               bk_bmmp_lm=None) -> ServerKey:
    """Derive the contraction layouts from the canonical tensors."""
    perm = level_major_row_perm(params.glwe_dimension + 1, params.pbs_decomposer.levels)
    bk_lm = bk_u32[:, torch.as_tensor(perm, device=bk_u32.device)].contiguous()
    return ServerKey(bk_u32=bk_u32.contiguous(), bk_lm=bk_lm, ksk_u32=ksk_u32,
                     ksk_mat=mks.ksk_to_matmul(ksk_u32), params=params,
                     bk_bmmp_lm=bk_bmmp_lm)


def _bmmp_key(params: TfheParams, sk_t, lwe_sk, bmmp_a, bmmp_e) -> torch.Tensor:
    """The BMMP triples GGSW(ss'), GGSW(s(1-s')), GGSW((1-s)s') of every
    secret-bit pair, level-major rows, -> u32[n/2, 3R, k+1, N]
    (``tfhe_tpu/models/keys.py:95-106``)."""
    s0, s1 = lwe_sk[0::2], lwe_sk[1::2]
    trip = torch.stack([s0 * s1, s0 * (1 - s1), (1 - s0) * s1], dim=1).reshape(-1)
    bmmp_u32 = mggsw.encrypt(sk_t, trip, params, bmmp_a, bmmp_e)  # [3n/2, R, k+1, N]
    perm = level_major_row_perm(params.glwe_dimension + 1, params.pbs_decomposer.levels)
    bmmp_lm = bmmp_u32[:, torch.as_tensor(perm, device=bmmp_u32.device)]
    r, k1, n = bmmp_lm.shape[1:]
    return bmmp_lm.reshape(trip.shape[0] // 3, 3 * r, k1, n).contiguous()


def make_server_key(params: TfheParams, lwe_sk, glwe_sk, bk_a, bk_e, ksk_a,
                    ksk_e, bmmp_a=None, bmmp_e=None) -> ServerKey:
    """Deterministic keygen core (src/bootstrapping.rs:23-56), on the device of
    ``bk_a``.

    bk_a: u32[n, R, k, N]; bk_e: u32[n, R, N];
    ksk_a: u32[kN*l_ks, n]; ksk_e: u32[kN*l_ks];
    bmmp_a: u32[3n/2, R, k, N], bmmp_e: u32[3n/2, R, N] (optional: the BMMP
    triples' masks and noise).
    """
    bk_a = u32(bk_a)
    device = bk_a.device
    lwe_sk = u32(lwe_sk, device)
    glwe_sk = u32(glwe_sk, device)
    sk_t = mglwe.sk_toeplitz(glwe_sk)
    bk_u32 = mggsw.encrypt(sk_t, lwe_sk, params, bk_a, u32(bk_e, device))
    ksk_u32 = mks.generate_ksk(glwe_sk.reshape(-1), lwe_sk, params.ks_decomposer,
                               u32(ksk_a, device), u32(ksk_e, device))
    bk_bmmp_lm = None
    if bmmp_a is not None:
        bk_bmmp_lm = _bmmp_key(params, sk_t, lwe_sk, u32(bmmp_a, device),
                               u32(bmmp_e, device))
    return _server_key_from_canonical(params, bk_u32, ksk_u32, bk_bmmp_lm)


def server_key_from_numpy(params: TfheParams, bk_u32, ksk_u32, device="cuda",
                          bk_bmmp_lm=None) -> ServerKey:
    """Build the port's server key on ``device`` (the card unless the caller
    asks for another) from the canonical u32 arrays alone, with the BMMP key
    ``bk_bmmp_lm`` when given: what a server holds, which has no secret key
    (the ``.npz`` server file of ``utils/serialization.py``)."""
    bmmp = None if bk_bmmp_lm is None else u32(bk_bmmp_lm, device)
    return _server_key_from_canonical(params, u32(bk_u32, device), u32(ksk_u32, device), bmmp)


def keys_from_numpy(params: TfheParams, lwe_sk, glwe_sk, bk_u32, ksk_u32,
                    device="cuda", bk_bmmp_lm=None) -> tuple[ClientKey, ServerKey]:
    """Build the port's keys on ``device`` (the card unless the caller asks
    for another) from canonical u32 arrays (the JAX package's
    ``ClientKey``/``ServerKey`` fields, or its ``.npz`` wire format), with the
    JAX package's BMMP key ``bk_bmmp_lm`` when given."""
    ck = ClientKey(lwe_sk=u32(lwe_sk, device), glwe_sk=u32(glwe_sk, device),
                   params=params)
    return ck, server_key_from_numpy(params, bk_u32, ksk_u32, device, bk_bmmp_lm)


def with_latency_key(sk: ServerKey) -> ServerKey:
    """Attach the latency-kernel key operands for ``impl='fusedl'`` (and
    ``impl='bmmpl'`` when the BMMP triples exist), built once at key load;
    those impls refuse a key without them."""
    from tfhe_tpu_torch.ops.cuda.latency_kernel import (
        bk_latency_operand,
        bk_latency_operand_bmmp,
    )

    bk_bmmp_lat = (None if sk.bk_bmmp_lm is None
                   else bk_latency_operand_bmmp(sk.bk_bmmp_lm, sk.params))
    return dataclasses.replace(sk, bk_lat=bk_latency_operand(sk.bk_u32),
                               bk_bmmp_lat=bk_bmmp_lat)


#: device-memory budget for the NTT key forms, the JAX package's 12 GiB
#: (``tfhe_tpu/models/keys.py:with_ntt_key``), checked against the peak of a
#: build (``ntt_build_peak_bytes``)
NTT_KEY_BUDGET_BYTES = 12 << 30
#: steps per chunk when building an NTT key form (the JAX package's
#: ``lax.map(batch_size=64)``), so the transients stay near one chunk
_NTT_CHUNK_STEPS = 64
#: a chunk's workspace, in multiples of the chunk's share of the form: the
#: chunk's own output, its int16 residues and their byte planes
#: (``ops/ntt.py:make_ep_ntt_key``).  Measured 3.82 at default_128 on an H100
#: (``chip_smoke.py`` holds every build's peak against this count), rounded up
_NTT_CHUNK_WORKSPACE = 5


def ntt_form_bytes(params: TfheParams) -> int:
    """Bytes of one whole-key NTT form (``bk_ntt`` or ``bk_ntt_lhs``)."""
    return math.prod(lhs_key_shape(params, plan_for_params(params), params.lwe_dimension))


def ntt_build_peak_bytes(sk: ServerKey) -> int:
    """The device memory that building one more NTT key form on ``sk``
    holds at its peak, beyond the canonical keys: every form ``sk`` already
    holds (the caller's reference keeps them alive), the new form, and one
    chunk's workspace."""
    form = ntt_form_bytes(sk.params)
    held = sum(getattr(sk, f) is not None for f in ("bk_ntt", "bk_ntt_lhs"))
    n = sk.params.lwe_dimension
    chunk = form * min(_NTT_CHUNK_STEPS, n) // n
    return (held + 1) * form + _NTT_CHUNK_WORKSPACE * chunk


def _check_ntt_budget(sk: ServerKey, what: str) -> None:
    """Raise unless building ``what`` next to the forms ``sk`` holds stays
    within ``NTT_KEY_BUDGET_BYTES`` at its peak."""
    peak = ntt_build_peak_bytes(sk)
    if peak > NTT_KEY_BUDGET_BYTES:
        held = [f for f in ("bk_ntt", "bk_ntt_lhs") if getattr(sk, f) is not None]
        form = ntt_form_bytes(sk.params)
        raise ValueError(
            f"building {what} next to {held or 'no other form'} peaks at "
            f"{peak / 2**30:.2f} GiB ({len(held) + 1} NTT key form(s) of "
            f"{form / 2**30:.2f} GiB and one chunk's workspace), over the "
            f"{NTT_KEY_BUDGET_BYTES / 2**30:.2f} GiB budget; use impl='ntts', "
            "drop the other form first, or a larger-N1 plan (ops.ntt.set_plan_n1)")


def _build_in_chunks(src: torch.Tensor, fn, shape: tuple) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.int8, device=src.device)
    for lo in range(0, src.shape[0], _NTT_CHUNK_STEPS):
        out[lo:lo + _NTT_CHUNK_STEPS] = fn(src[lo:lo + _NTT_CHUNK_STEPS])
    return out


def with_ntt_key(sk: ServerKey) -> ServerKey:
    """Attach the NTT-domain key ``bk_ntt`` for ``impl='ntt'`` (and for
    ``with_ntt_lhs_key`` to convert from), built once at key load from
    ``bk_u32`` in chunks of steps (counterpart of
    ``tfhe_tpu/models/keys.py:with_ntt_key``)."""
    _check_ntt_budget(sk, "bk_ntt")
    plan = plan_for_params(sk.params)
    steps, primes, bins, two_cln2, rn2 = lhs_key_shape(sk.params, plan, sk.params.lwe_dimension)
    shape = (steps, primes, 2, bins, rn2, two_cln2 // 2)
    bk_ntt = _build_in_chunks(sk.bk_u32, lambda c: make_ep_ntt_key(c, plan), shape)
    return dataclasses.replace(sk, bk_ntt=bk_ntt)


def with_ntt_lhs_key(sk: ServerKey, drop_rhs: bool = False) -> ServerKey:
    """Attach the lhs-form NTT key ``bk_ntt_lhs`` for ``impl='nttf'``
    (Kernel D), built once at key load: a relayout of ``bk_ntt`` when the key
    holds it, else straight from ``bk_u32`` per chunk without the other form.
    ``drop_rhs=True`` leaves ``bk_ntt`` out of the returned key (it then
    serves only 'nttf'); while converting, both forms are alive, and the
    budget counts them."""
    _check_ntt_budget(sk, "bk_ntt_lhs")
    plan = plan_for_params(sk.params)
    if sk.bk_ntt is not None:
        src, fn = sk.bk_ntt, ntt_key_lhs_form
    else:
        src, fn = sk.bk_u32, lambda c: ntt_key_lhs_form(make_ep_ntt_key(c, plan))
    lhs = _build_in_chunks(src, fn, lhs_key_shape(sk.params, plan, sk.params.lwe_dimension))
    return dataclasses.replace(sk, bk_ntt_lhs=lhs, bk_ntt=None if drop_rhs else sk.bk_ntt)


#: each optional key form an impl reads, the call that attaches it and the
#: options ``with_key_form`` gives that call (the lhs NTT form alone, for 'nttf')
KEY_FORMS = {
    "bk_lat": (with_latency_key, {}),
    "bk_bmmp_lat": (with_latency_key, {}),
    "bk_ntt": (with_ntt_key, {}),
    "bk_ntt_lhs": (with_ntt_lhs_key, {"drop_rhs": True}),
}


def with_key_form(sk: ServerKey, impl: str) -> ServerKey:
    """``sk`` with the derived key form ``impl`` reads attached
    (``bootstrap.IMPLS[impl].key`` in ``KEY_FORMS``).  An impl that reads the
    canonical keys, or a name outside the table, gets ``sk`` back.  (The JAX
    package derives these forms inside the call; the port builds them once,
    at key load.)"""
    rec = IMPLS.get(impl)
    if rec is None or rec.key not in KEY_FORMS:
        return sk
    attach, options = KEY_FORMS[rec.key]
    return attach(sk, **options)


def keygen(params: TfheParams, generator: torch.Generator | int = 0,
           device="cuda", bmmp: bool = False) -> tuple[ClientKey, ServerKey]:
    """Sample secret keys and derive the server key (src/utils.rs:238-243 +
    src/bootstrapping.rs:23-56).  Randomness comes from ``generator`` (or a
    CPU generator seeded with the given int); the draws are moved to
    ``device``, the card unless the caller asks for another, so one seed
    gives the same key bits on every device.  ``bmmp=True`` also makes the
    BMMP key triples for the halved-depth rotation; their masks and noise are
    drawn after every other draw, so the other keys equal those of
    ``bmmp=False``."""
    k, n, N = params.glwe_dimension, params.lwe_dimension, params.degree
    if bmmp and n % 2:
        raise ValueError(f"BMMP pairs secret bits; lwe_dimension must be even, got {n}")
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    dp, ks = params.pbs_decomposer, params.ks_decomposer
    rows = (k + 1) * dp.levels
    kn = k * N
    lwe_sk = sampling.binary(generator, (n,)).to(device)
    glwe_sk = sampling.binary(generator, (k, N)).to(device)
    bk_a = sampling.uniform_u32(generator, (n, rows, k, N)).to(device)
    bk_e = sampling.gaussian_torus(generator, params.glwe_std_dev, (n, rows, N)).to(device)
    ksk_a = sampling.uniform_u32(generator, (kn * ks.levels, n)).to(device)
    ksk_e = sampling.gaussian_torus(generator, params.lwe_std_dev, (kn * ks.levels,)).to(device)
    bmmp_a = bmmp_e = None
    if bmmp:
        bmmp_a = sampling.uniform_u32(generator, (3 * n // 2, rows, k, N)).to(device)
        bmmp_e = sampling.gaussian_torus(generator, params.glwe_std_dev,
                                         (3 * n // 2, rows, N)).to(device)
    ck = ClientKey(lwe_sk=lwe_sk, glwe_sk=glwe_sk, params=params)
    sk = make_server_key(params, lwe_sk, glwe_sk, bk_a, bk_e, ksk_a, ksk_e, bmmp_a, bmmp_e)
    return ck, sk
