"""Programmable bootstrapping (port of ``tfhe_tpu/models/bootstrap.py``;
reference: src/bootstrapping.rs).

Pipeline (src/bootstrapping.rs:58-120):
  1. modulus-switch the LWE ciphertext from q=2^32 to 2N;
  2. acc = trivial-GLWE(v(X)) * X^(-b_hat);
  3. n CMUX steps, acc += EP(digits(acc * X^a_i - acc), BK_i), the whole
     batch advancing together;
  4. sample-extract coefficient 0 -> LWE of dimension k*N;
  5. key-switch back to dimension n.

Blind-rotation backends, all exact mod 2^32 but the truncated-key modes
(``*3``):

  * ``conv`` — the scan of JAX's ``conv`` backend (``rotate_chunk_xla``): a
    Python loop over the steps, batch-major digits [B, R, N], and each
    step's contraction in Kernel H (``ops/cuda/ep_kernel.py:ep_contract``)
    against the step's canonical ``bk_u32`` rows.  JAX's ``conv`` reads
    ``ServerKey.bk_conv`` (int8, kernel-reversed limbs of the key); Kernel H
    stages the sign-twisted limbs itself, so the port's ``ServerKey`` has no
    ``bk_conv`` (80 MB at default_128) and the pipeline stages pass
    ``bk_u32`` slices for 'conv'.
  * ``matmul`` — the same scan with the plain Toeplitz matmul contraction
    (``rotate_chunk_xla``'s other branch).  Runs anywhere: the explicit
    reference.
  * ``pallas`` — the same loop with the transpose-free [k+1, B, N]
    accumulator, level-major digit rows and ``ServerKey.bk_lm``; each step's
    contraction is Kernel A (``ops/cuda/ep_kernel.py``).  Default on CUDA.
  * ``fused`` / ``fusedb`` — the whole rotation in one launch of Kernel B
    (``ops/cuda/blind_rotate_kernel.py``), with the reference carry-chain
    digits or the closed-form balanced digits (DIVERGENCES.md #3);
    ``fused3`` / ``fusedb3`` the same with the truncated key (the low byte
    of each sign-twisted key word dropped: approximate, it spends part of
    the gate's noise margin).
  * ``fusedp`` / ``fusedp3`` — Kernel E, the software-pipelined whole scan
    (carry-chain digits, exact or truncated key); ``fusedw`` / ``fusedwb`` —
    Kernel F, the wide-contraction pipelined scan (exact key, carry-chain or
    balanced digits); ``fusedc`` / ``fusedc3`` — Kernel G, the column-split
    scan on thread-block clusters (carry-chain digits, exact or truncated
    key).  All in ``ops/cuda/blind_rotate_kernel.py``; at one digit
    convention and key width every whole-scan impl gives the same bits.
  * ``bmmp`` — the BMMP halved-depth scan (n/2 steps against the
    ``keygen(bmmp=True)`` triples); each step's contraction is Kernel A.
  * ``fusedl`` / ``bmmpl`` — the small-batch latency path (B <= 8, resp.
    B <= 4 for the BMMP form): the whole rotation in one launch of Kernel C
    (``ops/cuda/latency_kernel.py``), carry-chain digits.
  * ``ntt`` / ``ntts`` — the block-NTT scan (``ops/ntt.py``): per step, one
    NTT-domain contraction, against the resident ``ServerKey.bk_ntt``
    (``with_ntt_key``) or, streaming, against each step's key transformed
    from ``bk_u32`` inside the loop.  Plain PyTorch, as the JAX package runs
    them through XLA.
  * ``nttf`` — the whole block-NTT rotation in one launch of Kernel D
    (``ops/cuda/ntt_kernel.py``) on ``ServerKey.bk_ntt_lhs``
    (``with_ntt_lhs_key``), any batch in one launch.

The block-NTT impls use the reference carry-chain digits, so 'ntt', 'ntts'
and 'nttf' equal 'fused' bit for bit.  An impl whose key form is missing
raises ``ValueError`` naming the function that attaches it.

On CPU tensors the kernel backends run their kernels' plain twins.  They
play the role of the JAX package's ``*_interpret`` impls (the Pallas kernel
run on the CPU), which have no counterpart here.
"""

from __future__ import annotations

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

#: every backend string ``blind_rotate`` accepts: the JAX package's, in its
#: order, less the ``*_interpret`` modes
VALID_IMPLS = ("auto", "conv", "matmul", "pallas", "fused", "fused3", "fusedb", "fusedb3",
               "fusedc", "fusedc3", "fusedp", "fusedp3", "fusedw", "fusedwb",
               "bmmp", "ntt", "ntts", "nttf", "fusedl", "bmmpl")

#: the whole-scan impls: their wrapper and its options
_WHOLE_SCAN = {
    "fused": (brk.blind_rotate_fused, {}),
    "fused3": (brk.blind_rotate_fused, {"key_limbs": 3}),
    "fusedb": (brk.blind_rotate_fused, {"balanced": True}),
    "fusedb3": (brk.blind_rotate_fused, {"balanced": True, "key_limbs": 3}),
    "fusedc": (brk.blind_rotate_fused_cols, {}),
    "fusedc3": (brk.blind_rotate_fused_cols, {"key_limbs": 3}),
    "fusedp": (brk.blind_rotate_fused_pipe, {}),
    "fusedp3": (brk.blind_rotate_fused_pipe, {"key_limbs": 3}),
    "fusedw": (brk.blind_rotate_fused_wide_pipe, {}),
    "fusedwb": (brk.blind_rotate_fused_wide_pipe, {"balanced": True}),
}


def resolve_impl(impl: str, device) -> str:
    """'auto' -> 'pallas' for CUDA tensors, 'matmul' on the CPU
    (as ``tfhe_tpu``'s 'auto' picks its per-step kernel on the accelerator)."""
    if impl not in VALID_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; valid: {VALID_IMPLS}")
    if impl != "auto":
        return impl
    return "pallas" if torch.device(device).type == "cuda" else "matmul"


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


def rotate_chunk(params: TfheParams, acc, bk_chunk, a_chunk, impl: str) -> torch.Tensor:
    """Backend-generic rotation chunk, [B, k+1, N] acc in and out (the chunk
    the pipeline stages run).  ``bk_chunk`` is the matching key form: a slice
    of ``bk_u32`` for 'matmul' and 'conv', of ``bk_lm`` for 'pallas', of
    ``bk_ntt`` for 'ntt'.  Any other impl raises ``ValueError``."""
    if impl == "pallas":
        return rotate_chunk_pallas(params, acc, bk_chunk, a_chunk)
    if impl == "ntt":
        return rotate_chunk_ntt(params, acc, bk_chunk, a_chunk)
    if impl in EP_CONTRACTIONS:
        return rotate_chunk_batch_major(params, acc, bk_chunk, a_chunk, impl)
    raise ValueError(f"rotate_chunk runs 'matmul', 'conv', 'pallas' or 'ntt', got {impl!r}")


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


def _require_bmmp_key(server_key) -> None:
    if server_key.bk_bmmp_lm is None:
        raise ValueError("this impl needs the BMMP key: keygen(..., bmmp=True), or "
                         "keys_from_numpy(..., bk_bmmp_lm=...)")


def _require_latency_key(bk_lat) -> torch.Tensor:
    if bk_lat is None:
        raise ValueError("this impl needs the latency key operand: with_latency_key(server_key)")
    return bk_lat


def _require_ntt_key(bk, attach: str) -> torch.Tensor:
    if bk is None:
        raise ValueError(f"this impl needs an NTT key form: {attach}(server_key)")
    return bk


def blind_rotate(params: TfheParams, approx_ct, server_key, tv_encoded,
                 impl: str = "auto") -> torch.Tensor:
    """n-step CMUX loop (src/bootstrapping.rs:79-105); batched.

    approx_ct: u32[B, n+1] already mod-switched to 2N; tv_encoded: u32[N]
    (the *encoded* test vector, src/bootstrapping.rs:82-86).
    """
    approx_ct = u32(approx_ct)
    impl = resolve_impl(impl, approx_ct.device)
    if impl in ("fusedl", "bmmpl"):  # before anything is launched
        latk.check_batch(approx_ct.shape[0], 1 if impl == "fusedl" else 3)
    if impl in ("bmmp", "bmmpl"):
        _require_bmmp_key(server_key)
    acc0, a_hat = _init_acc(params, approx_ct, tv_encoded)
    if impl in _WHOLE_SCAN:
        rotate, options = _WHOLE_SCAN[impl]
        return rotate(params, acc0, server_key.bk_u32, a_hat, **options)
    if impl == "fusedl":
        bk_lat = _require_latency_key(server_key.bk_lat)
        return latk.blind_rotate_latency(params, acc0, bk_lat, a_hat[:, None, :])
    if impl == "bmmpl":
        bk_lat = _require_latency_key(server_key.bk_bmmp_lat)
        a_v = torch.stack(_bmmp_exponents(params, a_hat), dim=1).contiguous()
        return latk.blind_rotate_latency(params, acc0, bk_lat, a_v)
    if impl == "bmmp":
        return _blind_rotate_bmmp(params, acc0, server_key.bk_bmmp_lm, a_hat)
    if impl == "nttf":
        bk_lhs = _require_ntt_key(server_key.bk_ntt_lhs, "with_ntt_lhs_key")
        return nttk.blind_rotate_nttf(params, acc0, bk_lhs, a_hat)
    if impl == "ntt":
        bk_ntt = _require_ntt_key(server_key.bk_ntt, "with_ntt_key")
        return rotate_chunk_ntt(params, acc0, bk_ntt, a_hat)
    if impl == "ntts":
        return rotate_chunk_ntt(params, acc0, server_key.bk_u32, a_hat, stream=True)
    if impl == "pallas":
        return rotate_chunk_pallas(params, acc0, server_key.bk_lm, a_hat)
    return rotate_chunk_batch_major(params, acc0, server_key.bk_u32, a_hat, impl)


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
