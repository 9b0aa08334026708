"""Programmable bootstrapping (port of ``tfhe_tpu/models/bootstrap.py``;
reference: src/bootstrapping.rs).

Pipeline (src/bootstrapping.rs:58-120):
  1. modulus-switch the LWE ciphertext from q=2^32 to 2N;
  2. acc = trivial-GLWE(v(X)) * X^(-b_hat);
  3. n CMUX steps, acc += EP(digits(acc * X^a_i - acc), BK_i), the whole
     batch advancing together;
  4. sample-extract coefficient 0 -> LWE of dimension k*N;
  5. key-switch back to dimension n.

Each blind-rotation impl string is one record of ``IMPLS``: the rotation it
runs, the ``ServerKey`` field that rotation reads, its batch cap, its digit
convention and whether its key is truncated.  ``blind_rotate``,
``keys.with_key_form``, the benches and ``parallel/`` read those facts
there.  Every impl is exact mod 2^32 but the truncated-key ones (``*3``: the
low byte of each sign-twisted key word dropped, approximate, it spends part
of the gate's noise margin); at one digit convention and key width every
impl gives the same bits.  A key without the field an impl reads raises
``ValueError`` naming the call that attaches it.

On CPU tensors the kernel backends run their kernels' plain twins.  They
play the role of the JAX package's ``*_interpret`` impls (the Pallas kernel
run on the CPU), which have no counterpart here.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from functools import partial

import torch

from tfhe_tpu_torch.models import glwe as mglwe
from tfhe_tpu_torch.models import keyswitch as mks
from tfhe_tpu_torch.models.ggsw import EP_CONTRACTIONS
from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops.cuda import blind_rotate_kernel as brk
from tfhe_tpu_torch.ops.cuda import latency_kernel as latk
from tfhe_tpu_torch.ops.cuda import ntt_kernel as nttk
from tfhe_tpu_torch.ops.cuda.ep_kernel import ep_contract_rbn
from tfhe_tpu_torch.ops.decomposer import decompose_signed_planes
from tfhe_tpu_torch.ops.poly import ep_combine, ep_combine_planes, monomial_mul
from tfhe_tpu_torch.ops.torus import switch_modulus, u32
from tfhe_tpu_torch.params import TfheParams
from tfhe_tpu_torch.utils.profiling import count, scope


def sample_extract(glwe_ct, index=0) -> torch.Tensor:
    """Extract coefficient ``index`` as an LWE of dimension k*N
    (src/bootstrapping.rs:122-156, general form).

    a'[i*N + j] = a_i[(index - j) mod N], negated where j > index; b' =
    b[index].  ``index`` is an int or an int tensor broadcastable over the
    batch.
    """
    ct = u32(glwe_ct)
    n = ct.shape[-1]
    k = ct.shape[-2] - 1
    h = torch.as_tensor(index, device=ct.device).to(torch.int64)
    h = torch.broadcast_to(h, ct.shape[:-2])[..., None]  # [..., 1]
    j = torch.arange(n, device=ct.device)
    idx = torch.remainder(h - j, n)  # [..., N]
    a = ct[..., :k, :]
    w = torch.gather(a, -1, idx[..., None, :].expand(a.shape))
    w = torch.where((j > h)[..., None, :], -w, w)
    b = torch.gather(ct[..., k, :], -1, h)
    return torch.cat([w.reshape(ct.shape[:-2] + (k * n,)), b], dim=-1)


def sample_extract0(glwe_ct) -> torch.Tensor:
    """Coefficient-0 specialisation (the PBS hot path): a'[i*N+j] is a_i[0]
    followed by the negated reversal of a_i[1:]."""
    ct = u32(glwe_ct)
    k = ct.shape[-2] - 1
    a = ct[..., :k, :]
    w = torch.cat([a[..., :1], -torch.flip(a[..., 1:], dims=(-1,))], dim=-1)
    flat = w.reshape(ct.shape[:-2] + (k * ct.shape[-1],))
    return torch.cat([flat, ct[..., k, :1]], dim=-1)


def _init_acc(params: TfheParams, approx_ct, tv_encoded):
    """acc0 = trivial(v(X)) * X^(-b_hat), batched (src/bootstrapping.rs:79-86);
    returns acc0 u32[B, k+1, N] and a_hat int32[n, B]."""
    approx_ct = u32(approx_ct)
    n_dim = params.lwe_dimension
    b_hat = approx_ct[..., n_dim]
    tv = u32(tv_encoded, approx_ct.device)
    acc0 = mglwe.trivial_encrypt(tv.expand(approx_ct.shape[:-1] + tv.shape),
                                 params.glwe_dimension)
    acc0 = mglwe.mul_monomial(acc0, -b_hat)
    a_hat = approx_ct[..., :n_dim].movedim(-1, 0).contiguous()  # [n, B]
    return acc0, a_hat


def rotate_chunk_batch_major(params: TfheParams, acc, bk_chunk, a_chunk,
                             impl: str) -> torch.Tensor:
    """CMUX steps over a key chunk with the batch-major contraction of
    ``impl`` ('conv': Kernel H, its twin on CPU tensors; 'matmul': plain):
    acc u32[B, k+1, N], bk_chunk u32[steps, R, k+1, N] (canonical rows),
    a_chunk int32[steps, B]."""
    contract = EP_CONTRACTIONS[impl]
    k1 = params.glwe_dimension + 1
    for bk_i, a_i in zip(bk_chunk, a_chunk):
        rot = mglwe.mul_monomial(acc, a_i)  # acc * X^{a_i}
        digits = mglwe.decompose(rot - acc, params.pbs_decomposer)  # [B, R, N]
        acc = acc + ep_combine(contract(digits, bk_i), k1)
    return acc


def rotate_chunk_pallas(params: TfheParams, acc, bk_lm_chunk, a_chunk) -> torch.Tensor:
    """CMUX steps through Kernel A with the [B, k+1, N] acc interface (the
    loop runs in the kernel's [k+1, B, N] layout).  ``bk_lm_chunk`` is a slice
    of ``ServerKey.bk_lm`` (level-major rows)."""
    k1 = params.glwe_dimension + 1
    levels = params.pbs_decomposer.levels
    acc_t = acc.transpose(0, 1).contiguous()  # [k+1, B, N]
    for bk_i, a_i in zip(bk_lm_chunk, a_chunk):
        rot = monomial_mul(acc_t, a_i[None, :])
        digits = decompose_signed_planes(rot - acc_t, params.pbs_decomposer)
        digits = digits.reshape((levels * k1,) + digits.shape[2:])  # [R, B, N]
        acc_t = acc_t + ep_combine_planes(ep_contract_rbn(digits, bk_i))
    return acc_t.transpose(0, 1).contiguous()


def rotate_chunk_ntt(params: TfheParams, acc, bk_chunk, a_chunk, stream: bool = False):
    """Block-NTT CMUX steps over a key chunk ([B, k+1, N] acc).  ``bk_chunk``
    is a slice of ``ServerKey.bk_ntt``, or with ``stream=True`` of the
    canonical ``bk_u32``, each step's rows then transformed inside the loop
    (the transform is batch-independent, and the resident form is not needed:
    at N >= 2048 it would not fit)."""
    k1 = params.glwe_dimension + 1
    plan = ntt.plan_for_params(params)
    for bk_i, a_i in zip(bk_chunk, a_chunk):
        if stream:
            bk_i = ntt.make_ep_ntt_key(bk_i, plan)
        rot = mglwe.mul_monomial(acc, a_i)
        digits = mglwe.decompose(rot - acc, params.pbs_decomposer)  # [B, R, N]
        acc = acc + ntt.ep_contract_ntt(digits, bk_i, plan, k1)
    return acc


def _bmmp_exponents(params: TfheParams, a_hat):
    """The BMMP pair exponents (a+a' mod 2N, a, a'), each int32[n/2, B]."""
    a0, a1 = a_hat[0::2], a_hat[1::2]
    return torch.remainder(a0 + a1, 2 * params.degree), a0, a1


def _blind_rotate_bmmp(params: TfheParams, acc0, bk_bmmp_lm, a_hat) -> torch.Tensor:
    """BMMP halved-depth rotation (notes/BMMP Bootstrapping.md:15-25):

        acc *= X^(a s + a' s')
             = acc + EP(G(ss'), (X^(a+a')-1)acc)
                   + EP(G(s(1-s')), (X^a-1)acc)
                   + EP(G((1-s)s'), (X^(a')-1)acc)

    n/2 steps; the three external products share one Kernel A contraction
    over [3R, B, N] level-major digit rows against the step's key triple."""
    k1 = params.glwe_dimension + 1
    levels = params.pbs_decomposer.levels
    acc = acc0.transpose(0, 1).contiguous()  # [k+1, B, N]
    for bk_i, *exps in zip(bk_bmmp_lm, *_bmmp_exponents(params, a_hat)):
        blocks = []
        for e in exps:  # order matches the key triple (ss', s(1-s'), (1-s)s')
            digs = decompose_signed_planes(monomial_mul(acc, e[None, :]) - acc,
                                           params.pbs_decomposer)
            blocks.append(digs.reshape((levels * k1,) + digs.shape[2:]))
        acc = acc + ep_combine_planes(ep_contract_rbn(torch.cat(blocks), bk_i))
    return acc.transpose(0, 1).contiguous()


def _rotate_latency(params: TfheParams, acc0, bk_lat, a_hat) -> torch.Tensor:
    """Kernel C at V=1: the masks as the one variant."""
    return latk.blind_rotate_latency(params, acc0, bk_lat, a_hat[:, None, :])


def _rotate_latency_bmmp(params: TfheParams, acc0, bk_lat, a_hat) -> torch.Tensor:
    """Kernel C at V=3: the BMMP pair exponents as the three variants."""
    a_v = torch.stack(_bmmp_exponents(params, a_hat), dim=1).contiguous()
    return latk.blind_rotate_latency(params, acc0, bk_lat, a_v)


@dataclass(frozen=True)
class Impl:
    """One blind-rotation impl.  ``rotate(params, acc0, bk, a_hat)`` runs it
    (acc0 u32[B, k+1, N], a_hat int32[n, B] -> the final accumulator) on
    ``bk``, the ``ServerKey`` field named ``key``; ``batch_cap`` is the most
    ciphertexts a call takes (None: any); ``digits`` is 'carry' (the
    reference's carry chain) or 'balanced' (the closed form, DIVERGENCES.md
    #3); ``truncated`` says whether the key's low byte is dropped."""

    rotate: Callable[..., torch.Tensor]
    key: str = "bk_u32"
    batch_cap: int | None = None
    digits: str = "carry"
    truncated: bool = False

    @property
    def bmmp(self) -> bool:
        """Whether it runs the BMMP halved-depth scan, on the triples of
        ``keygen(..., bmmp=True)``."""
        return self.key.startswith("bk_bmmp")


def _whole_scan(rotate, digits: str = "carry", truncated: bool = False) -> Impl:
    """An impl of Kernel B, E, F or G: the wrapper on ``bk_u32`` with the
    options its digits and key width ask for."""
    options = {"balanced": True} if digits == "balanced" else {}
    if truncated:
        options["key_limbs"] = 3
    return Impl(partial(rotate, **options), digits=digits, truncated=truncated)


#: every blind-rotation impl, in the JAX package's order
IMPLS: dict[str, Impl] = {
    # per-step scans: Kernel H on batch-major digits (JAX's 'conv' reads
    # ``bk_conv``; Kernel H stages the sign-twisted limbs itself, so the port
    # has no such field), the plain Toeplitz matmul (runs anywhere: the
    # explicit reference), Kernel A on level-major digit rows
    "conv": Impl(partial(rotate_chunk_batch_major, impl="conv")),
    "matmul": Impl(partial(rotate_chunk_batch_major, impl="matmul")),
    "pallas": Impl(rotate_chunk_pallas, "bk_lm"),
    # the whole rotation in one launch: Kernel B ('fused*'), G ('fusedc*'),
    # E ('fusedp*'), F ('fusedw*'); BMMP: n/2 steps of Kernel A at 3R rows
    "fused": _whole_scan(brk.blind_rotate_fused),
    "fused3": _whole_scan(brk.blind_rotate_fused, truncated=True),
    "fusedb": _whole_scan(brk.blind_rotate_fused, "balanced"),
    "fusedb3": _whole_scan(brk.blind_rotate_fused, "balanced", truncated=True),
    "fusedc": _whole_scan(brk.blind_rotate_fused_cols),
    "fusedc3": _whole_scan(brk.blind_rotate_fused_cols, truncated=True),
    "fusedp": _whole_scan(brk.blind_rotate_fused_pipe),
    "fusedp3": _whole_scan(brk.blind_rotate_fused_pipe, truncated=True),
    "fusedw": _whole_scan(brk.blind_rotate_fused_wide_pipe),
    "fusedwb": _whole_scan(brk.blind_rotate_fused_wide_pipe, "balanced"),
    "bmmp": Impl(_blind_rotate_bmmp, "bk_bmmp_lm"),
    # block NTT: per step against the resident form or against each step's
    # key transformed in the loop, plain PyTorch as JAX runs them through
    # XLA; the whole rotation in Kernel D
    "ntt": Impl(rotate_chunk_ntt, "bk_ntt"),
    "ntts": Impl(partial(rotate_chunk_ntt, stream=True)),
    "nttf": Impl(nttk.blind_rotate_nttf, "bk_ntt_lhs"),
    # the small-batch path: the whole rotation in Kernel C
    "fusedl": Impl(_rotate_latency, "bk_lat", latk.MAX_LATENCY_BATCH),
    "bmmpl": Impl(_rotate_latency_bmmp, "bk_bmmp_lat", latk.MAX_LATENCY_BATCH_BMMP),
}
#: every impl string ``blind_rotate`` accepts: the JAX package's, in its
#: order, less the ``*_interpret`` modes
VALID_IMPLS = ("auto", *IMPLS)
#: the impls whose rotation runs on a pipeline stage's chunk of steps
CHUNK_IMPLS = ("conv", "matmul", "pallas", "ntt")


def resolve_impl(impl: str, device) -> str:
    """'auto' -> 'pallas' for CUDA tensors, 'matmul' on the CPU
    (as ``tfhe_tpu``'s 'auto' picks its per-step kernel on the accelerator)."""
    if impl not in VALID_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; valid: {VALID_IMPLS}")
    if impl != "auto":
        return impl
    return "pallas" if torch.device(device).type == "cuda" else "matmul"


def rotate_chunk(params: TfheParams, acc, bk_chunk, a_chunk, impl: str) -> torch.Tensor:
    """The rotation of ``impl`` over a chunk of steps, [B, k+1, N] acc in and
    out (the chunk the pipeline stages run).  ``bk_chunk`` is the matching
    slice of the impl's key field (``IMPLS[impl].key``).  An impl outside
    ``CHUNK_IMPLS`` raises ``ValueError``."""
    if impl not in CHUNK_IMPLS:
        raise ValueError(f"rotate_chunk runs {CHUNK_IMPLS}, got {impl!r}")
    return IMPLS[impl].rotate(params, acc, bk_chunk, a_chunk)


def blind_rotate(params: TfheParams, approx_ct, server_key, tv_encoded,
                 impl: str = "auto") -> torch.Tensor:
    """n-step CMUX loop (src/bootstrapping.rs:79-105); batched, by the
    record ``IMPLS[impl]``.

    approx_ct: u32[B, n+1] already mod-switched to 2N; tv_encoded: u32[N]
    (the *encoded* test vector, src/bootstrapping.rs:82-86).  An unknown
    impl, a batch above the impl's cap, a key without the BMMP triples or
    without the impl's key field raise ``ValueError`` before anything is
    launched.
    """
    approx_ct = u32(approx_ct)
    rec = IMPLS[resolve_impl(impl, approx_ct.device)]
    if rec.batch_cap is not None:  # Kernel C: 3 variants a step for the BMMP triples
        latk.check_batch(approx_ct.shape[0], 3 if rec.bmmp else 1)
    if rec.bmmp and server_key.bk_bmmp_lm is None:
        raise ValueError("this impl needs the BMMP key: keygen(..., bmmp=True), or "
                         "keys_from_numpy(..., bk_bmmp_lm=...)")
    bk = server_key.form(rec.key)
    acc0, a_hat = _init_acc(params, approx_ct, tv_encoded)
    return rec.rotate(params, acc0, bk, a_hat)


def pbs(params: TfheParams, ct, server_key, tv_encoded, impl: str = "auto") -> torch.Tensor:
    """Full programmable bootstrap (src/bootstrapping.rs:58-120); batched.

    ct: u32[B, n+1]; server_key: models.keys.ServerKey; tv_encoded: u32[N].
    Each stage runs in a named scope (``utils/profiling.py:scope``), as in
    the JAX package, so a captured trace shows it; the call and its
    ciphertexts are counted (``pbs.calls``, ``pbs.ciphertexts``).
    """
    ct = u32(ct)
    count("pbs.calls")
    count("pbs.ciphertexts", ct.shape[0])
    with scope("pbs.mod_switch"):
        approx = switch_modulus(ct, params.log_q, params.log_degree + 1)
    with scope("pbs.blind_rotate"):
        acc = blind_rotate(params, approx, server_key, tv_encoded, impl=impl)
    with scope("pbs.sample_extract"):
        extracted = sample_extract0(acc)
    with scope("pbs.key_switch"):
        return mks.key_switch(extracted, params.glwe_dimension * params.degree,
                              params.ks_decomposer, server_key.ksk_mat)
