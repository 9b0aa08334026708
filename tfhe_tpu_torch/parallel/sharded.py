"""Sharded gate bootstrapping: batch-parallel and key-row (model) parallel
(port of ``tfhe_tpu/parallel/sharded.py``).

Mapping of TFHE onto the mesh:

  * ciphertext batch -> ``batch`` (and ``host``): data parallelism, no
    collective.  Without a model axis each rank runs the one-device gate
    (``models/boolean.py:gate``) on its rows, so every impl of
    ``models/bootstrap.py:VALID_IMPLS`` runs there, the whole-scan kernels
    included;
  * BK rows R = (k+1)*levels and KSK rows K = k*N*l_ks -> ``model``: each
    rank contracts its key rows against its slice of the digits, recombines
    its limb sums into a partial wrapping-u32 delta locally, and the deltas
    are all-reduced.  Integer addition is associative and the recombination
    is linear, so the sharded gate gives the single-device gate's bits;
    combining before the collective moves 4x fewer bytes than the raw limb
    sums would.
  * ``coeffs`` shards the N output coefficients instead (the key stays
    whole on every rank; an all-gather reassembles the delta), ``ntt`` the
    NTT bins (the raw limb planes are all-reduced, then combined).

Where JAX wraps one local body in ``shard_map`` and XLA inserts the
collectives, here every rank runs that local body itself and calls each
collective where XLA would have put it, through the gate's
``CollectiveRecorder`` (``parallel/traffic.py``).

With a model axis, the per-step contraction of ``conv`` is Kernel H
(``ops/cuda/ep_kernel.py:ep_contract``) and of ``pallas`` Kernel A
(``ep_contract_rbn``), each at R/model rows; on CPU tensors they run their
plain twins.
"""

from __future__ import annotations

import dataclasses

import torch

from tfhe_tpu_torch.models import boolean
from tfhe_tpu_torch.models import glwe as mglwe
from tfhe_tpu_torch.models import lwe as mlwe
from tfhe_tpu_torch.models import test_vector as mtv
from tfhe_tpu_torch.models.bootstrap import IMPLS, VALID_IMPLS, _init_acc, sample_extract0
from tfhe_tpu_torch.models.ggsw import EP_CONTRACTIONS
from tfhe_tpu_torch.models.keys import ServerKey
from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops.cuda.ep_kernel import ep_contract_rbn
from tfhe_tpu_torch.ops.decomposer import decompose_signed, decompose_signed_planes
from tfhe_tpu_torch.ops.poly import (
    ep_combine,
    ep_combine_planes,
    ep_contract_matmul_cols,
    monomial_mul,
)
from tfhe_tpu_torch.ops.torus import (
    NUM_LIMBS,
    combine_limb_accs,
    int_matmul,
    switch_modulus,
    u32,
)
from tfhe_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, local_batch, plan_key_placement
from tfhe_tpu_torch.parallel.traffic import CollectiveRecorder
from tfhe_tpu_torch.params import TfheParams

#: the blind-rotation impls with a model-sharded form; without a model axis
#: a sharded gate takes any impl of ``VALID_IMPLS``, and 'coeffs' (the
#: coefficient split of nothing) runs as 'matmul'
SHARDED_IMPLS = ("conv", "matmul", "pallas", "coeffs", "ntt")


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the ``model`` axis, and the recorder its
    collectives go through."""

    group: object  # torch.distributed.ProcessGroup
    index: int
    size: int
    recorder: CollectiveRecorder


@dataclasses.dataclass(frozen=True)
class KeyShard:
    """One rank's share of a server key for one impl: ``bk`` holds this
    rank's ``bk_u32`` rows (conv, matmul), ``bk_lm`` rows (pallas), the whole
    ``bk_u32`` (coeffs) or this rank's ``bk_ntt`` bins (ntt); ``ksk_mat`` its
    KSK rows."""

    bk: torch.Tensor
    ksk_mat: torch.Tensor


def _psum_delta(delta_u32: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """All-reduce a partial u32 CMUX (or key-switch) delta over ``model``
    (``sharded.py:47-63``).  The recombination is linear in the raw limb
    sums, so summing the combined int32-carried u32 deltas is bit-identical
    to summing the sums, with 4x fewer bytes; int32 addition wraps as u32
    addition does."""
    return axis.recorder.all_reduce(delta_u32, axis.group)


def _rows(t: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """This rank's equal block of ``t`` along ``dim``."""
    size = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * size, size)


def _blind_rotate_local(params: TfheParams, approx_ct, bk, tv_encoded, impl: str,
                        axis: ModelAxis) -> torch.Tensor:
    """This rank's CMUX scan (``sharded.py:66-189``): ``bk`` is its key shard,
    digits are cut to its rows (or coefficients, or bins) and the partial
    results reduced over ``model`` each step."""
    k1 = params.glwe_dimension + 1
    dp = params.pbs_decomposer
    acc, a_hat = _init_acc(params, approx_ct, tv_encoded)

    if impl == "pallas":
        # transpose-free layout, level-major rows (ServerKey.bk_lm); the
        # row slice of the [R, B, N] digits stays contiguous for Kernel A
        acc_t = acc.transpose(0, 1).contiguous()  # [k+1, B, N]
        for bk_i, a_i in zip(bk, a_hat):
            rot = monomial_mul(acc_t, a_i[None, :])
            digits = decompose_signed_planes(rot - acc_t, dp)
            digits = _rows(digits.reshape((dp.levels * k1,) + digits.shape[2:]), 0, axis)
            acc_t = acc_t + _psum_delta(ep_combine_planes(ep_contract_rbn(digits, bk_i)), axis)
        return acc_t.transpose(0, 1).contiguous()

    if impl == "ntt":
        # each rank owns N1/model contiguous NTT bins: forward NTT, per-bin
        # products and partial inverse are local; the raw int32 limb planes
        # (linear in the bins) are all-reduced, then combined and lifted
        plan = ntt.plan_for_params(params)
        bins = bk.shape[3]  # bk [n, P, 2, bins, R*N2, C*L*N2]
        start = axis.index * bins
        for bk_i, a_i in zip(bk, a_hat):
            digits = mglwe.decompose(mglwe.mul_monomial(acc, a_i) - acc, dp)
            planes = ntt.ep_contract_ntt_partial(digits, bk_i, plan, k1, start, bins)
            planes = axis.recorder.all_reduce(planes, axis.group)
            acc = acc + ntt.ep_finish_ntt(planes, plan, k1)
        return acc

    if impl == "coeffs":
        # the N output coefficients over ``model``: the key stays whole (every
        # output reads every coefficient of g), each rank builds its column
        # slice of the sign-Toeplitz operand and combines its columns to u32
        # before the all-gather (4x fewer bytes than the raw limb sums)
        chunk = params.degree // axis.size
        for bk_i, a_i in zip(bk, a_hat):
            digits = mglwe.decompose(mglwe.mul_monomial(acc, a_i) - acc, dp)
            raw = ep_contract_matmul_cols(digits, bk_i, axis.index * chunk, chunk)
            acc = acc + axis.recorder.all_gather(ep_combine(raw, k1), axis.group, dim=-1)
        return acc

    # conv, matmul: batch-major digits [B, R, N] cut to this rank's rows
    # (a copy: the column slice is not contiguous, and Kernel H reads rows)
    contract = EP_CONTRACTIONS[impl]
    for bk_i, a_i in zip(bk, a_hat):
        digits = mglwe.decompose(mglwe.mul_monomial(acc, a_i) - acc, dp)
        digits = _rows(digits, 1, axis).contiguous()
        acc = acc + _psum_delta(ep_combine(contract(digits, bk_i), k1), axis)
    return acc


def _key_switch_local(params: TfheParams, ct, ksk_local, axis: ModelAxis):
    """Key switch with the KSK rows over ``model`` (``sharded.py:192-208``):
    each rank's partial sum is combined to u32 first, then all-reduced."""
    ks = params.ks_decomposer
    from_n = params.glwe_dimension * params.degree
    lead = ct.shape[:-1]
    digits = decompose_signed(ct[..., :from_n], ks).reshape(lead + (from_n * ks.levels,))
    acc = int_matmul(_rows(digits, -1, axis), ksk_local)
    to_n1 = ksk_local.shape[1] // NUM_LIMBS
    out = -_psum_delta(combine_limb_accs(acc.reshape(lead + (to_n1, NUM_LIMBS))), axis)
    out[..., -1] += ct[..., from_n]
    return out


def _gate_local(params: TfheParams, impl: str, axis: ModelAxis, tv_encoded, ct0, ct1,
                key: KeyShard) -> torch.Tensor:
    ct_in = mlwe.add(mlwe.scalar_mul(ct1, 2), ct0)
    approx = switch_modulus(ct_in, params.log_q, params.log_degree + 1)
    acc = _blind_rotate_local(params, approx, key.bk, tv_encoded, impl, axis)
    return _key_switch_local(params, sample_extract0(acc), key.ksk_mat, axis)


#: the dim of each key field that ``model`` cuts: the GGSW rows, or the NTT bins
_SHARD_DIM = {"bk_u32": 1, "bk_lm": 1, "bk_ntt": 3}


def shard_server_key(sk: ServerKey, impl: str, axis: ModelAxis) -> KeyShard:
    """This rank's share of ``sk`` for ``impl``: the rows (bins for 'ntt')
    of its ``model`` coordinate, copied once.  'coeffs' keeps the whole BK
    and shards only the KSK."""
    if impl == "coeffs":
        bk = sk.bk_u32
    else:
        field = IMPLS[impl].key
        bk = _rows(sk.form(field), _SHARD_DIM[field], axis)
    return KeyShard(bk=bk.contiguous(), ksk_mat=_rows(sk.ksk_mat, 0, axis).contiguous())


def _check_divisible(params: TfheParams, impl: str, model_n: int) -> None:
    """Refuse a ``model`` size that does not divide what it shards
    (``sharded.py:258-270``, as ValueError)."""
    rows = (params.glwe_dimension + 1) * params.pbs_decomposer.levels
    if impl == "coeffs":
        what, count = "the degree N", params.degree
    elif impl == "ntt":
        what, count = "the NTT bins N1", ntt.plan_for_params(params).n1
    else:
        what, count = "the GGSW rows (k+1)*levels", rows
    k_rows = params.glwe_dimension * params.degree * params.ks_decomposer.levels
    for name, n in ((what, count), ("the KSK rows k*N*l_ks", k_rows)):
        if n % model_n:
            raise ValueError(f"model={model_n} does not divide {name} = {n} (impl={impl!r})")


def make_sharded_gate(mesh: Mesh, params: TfheParams, gate: str, impl: str = "conv",
                      use_model_axis: bool | str | None = None):
    """Build a sharded gate ``fn(ct0, ct1, server_key) -> ct_out``
    (``sharded.py:223-316``).

    Every rank calls ``fn`` with the same GLOBAL batches ct0/ct1 u32[B, n+1];
    it cuts this rank's rows with ``local_batch`` and returns this rank's
    output rows u32[B_local, n+1] (``gather_batch`` assembles the global
    output).  BK/KSK rows shard over ``model`` when ``use_model_axis`` is
    True; None shards whenever the mesh's model axis is > 1; "policy" asks
    ``plan_key_placement`` (the rank's card's memory).  With the model axis
    the key is cut once per server key and kept for the calls that follow
    with that key; without it each rank runs the one-device gate on its rows
    with the whole key.  ``fn.recorder`` holds the last call's collectives.

    Raises ValueError for an impl outside ``SHARDED_IMPLS`` with the model
    axis (outside ``VALID_IMPLS`` and 'coeffs' without it) and for a model
    size that does not divide what it shards.
    """
    if impl not in SHARDED_IMPLS + VALID_IMPLS:
        raise ValueError(f"unknown sharded impl {impl!r}; valid: {SHARDED_IMPLS} with the "
                         f"model axis, {VALID_IMPLS} and 'coeffs' without it")
    if MODEL_AXIS not in mesh.shape:
        raise ValueError(f"a sharded gate needs a mesh with a {MODEL_AXIS!r} axis, got "
                         f"{mesh.shape}")
    model_n = mesh.shape[MODEL_AXIS]
    if use_model_axis == "policy":
        use_model_axis = plan_key_placement(params, mesh).shard_bk_rows
    if use_model_axis is None:
        use_model_axis = model_n > 1
    if use_model_axis not in (True, False):
        raise ValueError(f"use_model_axis is True, False, None or 'policy', got "
                         f"{use_model_axis!r}")
    recorder = CollectiveRecorder()

    if not use_model_axis:  # batch DP: no collective
        one_device = "matmul" if impl == "coeffs" else impl

        def call_dp(ct0, ct1, sk: ServerKey) -> torch.Tensor:
            recorder.reset()
            return boolean.gate(sk, gate, local_batch(mesh, u32(ct0)),
                                local_batch(mesh, u32(ct1)), impl=one_device)

        call_dp.recorder = recorder
        return call_dp

    if impl not in SHARDED_IMPLS:
        raise ValueError(f"impl {impl!r} has no model-sharded form; valid with the model "
                         f"axis: {SHARDED_IMPLS}")
    _check_divisible(params, impl, model_n)
    axis = ModelAxis(mesh.get_group(MODEL_AXIS), mesh.index(MODEL_AXIS), model_n, recorder)
    tv = mtv.on_device(params, mesh.device, "gate", gate)
    held: dict = {}  # the server key last seen and this rank's share of it

    def call(ct0, ct1, sk: ServerKey) -> torch.Tensor:
        if held.get("sk") is not sk:
            held.update(sk=sk, key=shard_server_key(sk, impl, axis))
        recorder.reset()
        return _gate_local(params, impl, axis, tv, local_batch(mesh, u32(ct0)),
                           local_batch(mesh, u32(ct1)), held["key"])

    call.recorder = recorder
    return call
