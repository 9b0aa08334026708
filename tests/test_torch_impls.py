"""The table of blind-rotation impls (``models/bootstrap.py:IMPLS``): what
each record states, the refusal of a key without the field an impl reads
(before anything runs, naming the call that attaches that field), and
``with_key_form`` attaching that field and no other.

CPU cases at ``nano``.  The file imports neither JAX nor tfhe_tpu:

    python -m pytest tests/test_torch_impls.py -q -o addopts= --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

import tfhe_tpu_torch as tfhe
from tfhe_tpu_torch.models import bootstrap as mboot
from tfhe_tpu_torch.models.keys import ServerKey
from tfhe_tpu_torch.ops.cuda import latency_kernel as latk
from tfhe_tpu_torch.ops.torus import to_torch_u32

LAT, LAT_BMMP = latk.MAX_LATENCY_BATCH, latk.MAX_LATENCY_BATCH_BMMP
#: each impl's (key field, batch cap, digits, truncated key), written out
WANT = {
    "conv": ("bk_u32", None, "carry", False),
    "matmul": ("bk_u32", None, "carry", False),
    "pallas": ("bk_lm", None, "carry", False),
    "fused": ("bk_u32", None, "carry", False),
    "fused3": ("bk_u32", None, "carry", True),
    "fusedb": ("bk_u32", None, "balanced", False),
    "fusedb3": ("bk_u32", None, "balanced", True),
    "fusedc": ("bk_u32", None, "carry", False),
    "fusedc3": ("bk_u32", None, "carry", True),
    "fusedp": ("bk_u32", None, "carry", False),
    "fusedp3": ("bk_u32", None, "carry", True),
    "fusedw": ("bk_u32", None, "carry", False),
    "fusedwb": ("bk_u32", None, "balanced", False),
    "bmmp": ("bk_bmmp_lm", None, "carry", False),
    "ntt": ("bk_ntt", None, "carry", False),
    "ntts": ("bk_u32", None, "carry", False),
    "nttf": ("bk_ntt_lhs", None, "carry", False),
    "fusedl": ("bk_lat", LAT, "carry", False),
    "bmmpl": ("bk_bmmp_lat", LAT_BMMP, "carry", False),
}
#: the words a refusal names for a key without each field
ATTACHED_BY = {
    "bk_u32": "keygen", "bk_lm": "keygen", "bk_bmmp_lm": "BMMP key",
    "bk_lat": "with_latency_key", "bk_bmmp_lat": "with_latency_key",
    "bk_ntt": "with_ntt_key", "bk_ntt_lhs": "with_ntt_lhs_key",
}
#: the fields ``with_key_form`` builds from the canonical keys
DERIVED = ("bk_lat", "bk_bmmp_lat", "bk_ntt", "bk_ntt_lhs")


@pytest.fixture(scope="module")
def nano():
    """The parameters, a server key with the BMMP triples and both latency
    operands (no NTT form), and one more ciphertext than the largest cap,
    mod-switched to 2N."""
    params = tfhe.get_params("nano")
    ck, sk = tfhe.keygen(params, 5, device="cpu", bmmp=True)
    rng = np.random.default_rng(23)
    approx = rng.integers(0, 2 * params.degree, size=(LAT + 1, params.lwe_dimension + 1))
    return params, tfhe.with_latency_key(sk), to_torch_u32(approx)


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape and torch.equal(a, b)
    return a is None and b is None or a == b


@pytest.mark.parametrize("impl", list(WANT))
def test_an_impl_record_states_its_field_cap_and_digits(nano, monkeypatch, impl):
    """The record's facts, in the table's order; a key without the field is
    refused before anything runs, the BMMP impls' also without the triples,
    and a capped impl above its cap; ``with_key_form`` attaches that field
    alone."""
    params, sk, approx = nano
    assert mboot.VALID_IMPLS == ("auto", *mboot.IMPLS) == ("auto", *WANT)
    rec = mboot.IMPLS[impl]
    field, cap, digits, truncated = WANT[impl]
    assert (rec.key, rec.batch_cap, rec.digits, rec.truncated) == WANT[impl]
    assert rec.bmmp == field.startswith("bk_bmmp")
    tv = torch.zeros(params.degree, dtype=torch.int32)
    few = approx[:min(cap or LAT, 2)]
    with monkeypatch.context() as m:
        m.setattr(mboot, "_init_acc", lambda *a: pytest.fail("ran past the checks"))
        with pytest.raises(ValueError, match=ATTACHED_BY[field]):
            mboot.blind_rotate(params, few, dataclasses.replace(sk, **{field: None}), tv,
                               impl=impl)
        if rec.bmmp:
            no_triples = dataclasses.replace(sk, bk_bmmp_lm=None, bk_bmmp_lat=None)
            with pytest.raises(ValueError, match="BMMP key"):
                mboot.blind_rotate(params, few, no_triples, tv, impl=impl)
        if cap:
            with pytest.raises(ValueError, match=f"B <= {cap}"):
                mboot.blind_rotate(params, approx[:cap + 1], sk, tv, impl=impl)

    bare = dataclasses.replace(sk, **{field: None}) if field in DERIVED else sk
    formed = tfhe.with_key_form(bare, impl)
    changed = {f.name for f in dataclasses.fields(ServerKey)
               if not _same(getattr(bare, f.name), getattr(formed, f.name))}
    assert changed == ({field} if field in DERIVED else set())
    if field not in DERIVED:
        assert formed is bare
    assert mboot.blind_rotate(params, few, formed, tv, impl=impl).shape == (
        few.shape[0], params.glwe_dimension + 1, params.degree)
