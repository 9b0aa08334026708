"""Parameter sets for the TFHE framework (PyTorch port).

A copy of ``tfhe_tpu/params.py``, this paragraph aside: importing ``tfhe_tpu.params`` runs
``tfhe_tpu/__init__.py``, which imports the JAX models, and the port must run
where JAX is not installed.  ``tests/test_torch_ops.py`` holds the two
registries equal.

Mirrors the reference parameter layer (reference: src/lib.rs:23-124) as frozen
dataclasses plus a named registry.  The reference hard-codes two sets selected
at compile time (src/lib.rs:76-123); here they are the named entries
``test_insecure`` (lwe_dimension=4, fast, NOT secure) and ``default_128``
(lwe_dimension=722, the classic TFHE boolean-gate family).

Naming note: the reference field ``glwe_poly_degree`` actually stores log2(N)
(it is used as ``1 << glwe_poly_degree`` at src/lib.rs:60); we call it
``log_degree`` to avoid the confusion.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class DecomposerParams:
    """Signed gadget decomposition config (reference: src/decomposer.rs:2-16)."""

    log_base: int
    levels: int
    log_q: int

    @property
    def base(self) -> int:
        return 1 << self.log_base

    @property
    def l_full(self) -> int:
        """Total digit count log_q/log_base (reference: src/ggsw.rs:90-91)."""
        return self.log_q // self.log_base

    @property
    def ignored_bits(self) -> int:
        """LSBs dropped by rounding (reference: src/decomposer.rs:28)."""
        return self.log_q - self.log_base * self.levels

    def __post_init__(self):
        assert self.log_q % self.log_base == 0, "log_base must divide log_q"
        assert 1 <= self.levels <= self.l_full
        # int8 MXU path requires digits (in [-B/2, B]) to fit in int8.
        assert self.base <= 64, "int8 limb kernels require base <= 64"


@dataclass(frozen=True)
class LweParams:
    """LWE view (reference: src/lwe.rs:26-34)."""

    lwe_dimension: int
    padding_bits: int
    log_q: int
    log_p: int
    std_dev: float


@dataclass(frozen=True)
class GlweParams:
    """GLWE view (reference: src/glwe.rs:112-128)."""

    glwe_dimension: int
    log_degree: int
    padding_bits: int
    log_q: int
    log_p: int
    std_dev: float

    @property
    def degree(self) -> int:
        return 1 << self.log_degree


@dataclass(frozen=True)
class GgswParams:
    """GGSW view (reference: src/ggsw.rs:26-29)."""

    glwe_params: GlweParams
    decomposer_params: DecomposerParams

    @property
    def rows(self) -> int:
        """(k+1) * levels GLWE rows per GGSW ciphertext."""
        return (self.glwe_params.glwe_dimension + 1) * self.decomposer_params.levels


@dataclass(frozen=True)
class TfheParams:
    """Root parameter struct (reference: src/lib.rs:23-34)."""

    glwe_dimension: int  # k
    log_degree: int  # log2(N)  (reference calls this glwe_poly_degree)
    lwe_dimension: int  # n
    padding_bits: int
    log_p: int
    log_q: int
    ks_decomposer: DecomposerParams
    pbs_decomposer: DecomposerParams
    lwe_std_dev: float
    glwe_std_dev: float
    name: str = ""

    # ---- derived views (reference: src/lib.rs:37-73) ----

    @property
    def degree(self) -> int:
        return 1 << self.log_degree

    @property
    def k(self) -> int:
        return self.glwe_dimension

    @property
    def n(self) -> int:
        return self.lwe_dimension

    @property
    def delta(self) -> int:
        """Encoding scale 2^(log_q - log_p - padding_bits) (src/lwe.rs:83-88)."""
        return 1 << (self.log_q - self.log_p - self.padding_bits)

    def glwe_params(self) -> GlweParams:
        return GlweParams(
            glwe_dimension=self.glwe_dimension,
            log_degree=self.log_degree,
            padding_bits=self.padding_bits,
            log_q=self.log_q,
            log_p=self.log_p,
            std_dev=self.glwe_std_dev,
        )

    def lwe_params(self) -> LweParams:
        return LweParams(
            lwe_dimension=self.lwe_dimension,
            padding_bits=self.padding_bits,
            log_q=self.log_q,
            log_p=self.log_p,
            std_dev=self.lwe_std_dev,
        )

    def lwe_params_post_pbs(self) -> LweParams:
        """LWE params after sample extraction: dimension k*N (src/lib.rs:58-66)."""
        return LweParams(
            lwe_dimension=self.degree * self.glwe_dimension,
            padding_bits=self.padding_bits,
            log_q=self.log_q,
            log_p=self.log_p,
            std_dev=self.lwe_std_dev,
        )

    def ggsw_params(self) -> GgswParams:
        return GgswParams(
            glwe_params=self.glwe_params(),
            decomposer_params=self.pbs_decomposer,
        )

    def replace(self, **kw) -> "TfheParams":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        validate(self)


def validate(p: TfheParams) -> None:
    """Assert the int-exactness preconditions of every contraction path.

    The framework's exactness argument (ops/torus.py:76-87) is that all u32
    wrapping contractions run as int8 x int8 -> int32 MXU matmuls whose
    accumulators never overflow.  The registry sets satisfy these by
    construction; a user-built ``TfheParams`` is rejected here at
    construction time instead of silently producing wrong ciphertexts.
    Raises ``ValueError`` with the violated bound.
    """
    if p.log_q != 32:
        raise ValueError(f"log_q must be 32 (u32 torus); got {p.log_q}")
    if p.log_p + p.padding_bits >= p.log_q:
        raise ValueError("log_p + padding_bits must be < log_q")
    if p.log_p < 1 or p.padding_bits < 0:
        raise ValueError("need log_p >= 1 and padding_bits >= 0")
    if p.glwe_dimension < 1 or p.lwe_dimension < 1 or p.log_degree < 1:
        raise ValueError("dimensions must be positive")
    n, k = p.degree, p.glwe_dimension
    for tag, dp, rows in (
        # external product: digits [B, R*N] x Toeplitz limbs [R*N, N];
        # int32 accumulates R*N products of |digit|<=base/2 by |limb|<=128
        ("pbs", p.pbs_decomposer, (k + 1) * p.pbs_decomposer.levels * n),
        # key switch: digits [B, kN*l] x KSK limbs [kN*l, (n+1)*4]
        ("ks", p.ks_decomposer, k * n * p.ks_decomposer.levels),
    ):
        if dp.log_q != p.log_q:
            raise ValueError(f"{tag} decomposer log_q {dp.log_q} != {p.log_q}")
        # signed digits must fit the (log_base+2)-bit int8 sign-extension
        # trick used by the fused kernels (blind_rotate_kernel.py)
        if dp.log_base + 2 > 8:
            raise ValueError(
                f"{tag} decomposer log_base {dp.log_base} > 6: digits do not "
                "fit the int8 MXU path")
        # digits reach +base (not base/2) at the +B carry anomaly
        # (src/decomposer.rs:42-80; see docs/ARCHITECTURE.md section 4)
        worst = rows * dp.base * 128
        if worst >= 1 << 31:
            raise ValueError(
                f"{tag} contraction bound violated: {rows} accumulated "
                f"products x max digit {dp.base} x limb 128 = {worst} "
                f">= 2^31; int32 accumulation would overflow")
    # keygen / encryption matvec (ops/torus.py:wrapping_matvec_u32_small):
    # K=N limb products against binary Toeplitz entries (|w| <= 1)
    if n * 128 >= 1 << 31:
        raise ValueError(f"degree {n} too large for exact limb matvec")


def _mk(name: str, *, k: int, log_degree: int, n: int, log_p: int = 2) -> TfheParams:
    return TfheParams(
        glwe_dimension=k,
        log_degree=log_degree,
        lwe_dimension=n,
        padding_bits=1,
        log_p=log_p,
        log_q=32,
        ks_decomposer=DecomposerParams(log_base=4, levels=5, log_q=32),
        pbs_decomposer=DecomposerParams(log_base=4, levels=6, log_q=32),
        lwe_std_dev=0.000013071021089943935,
        glwe_std_dev=0.00000004990272175010415,
        name=name,
    )


#: Named registry.  ``test_insecure`` reproduces the reference #[cfg(test)]
#: default (src/lib.rs:77-99); ``default_128`` reproduces the non-test default
#: (src/lib.rs:101-123).  ``nano`` is an even smaller profile of ours for
#: sub-second CI and multi-chip dry runs (no reference counterpart).
PARAMS: dict[str, TfheParams] = {
    "test_insecure": _mk("test_insecure", k=2, log_degree=9, n=4),
    "default_128": _mk("default_128", k=2, log_degree=9, n=722),
    "nano": _mk("nano", k=1, log_degree=6, n=4),
    # log_p=3 profiles for 3-input gates (4c2+2c1+c0 encoding,
    # notes/Boolean Gates.md:7-11); message space Z_8, same lattice dims
    "test_insecure_3in": _mk("test_insecure_3in", k=2, log_degree=9, n=4, log_p=3),
    "nano_3in": _mk("nano_3in", k=1, log_degree=6, n=4, log_p=3),
    "default_128_3in": _mk("default_128_3in", k=2, log_degree=9, n=722, log_p=3),
    # large-degree profiles (k=1, N=2048/4096): the block-NTT tier's target
    # regime (NOTES_NTT.md) — Toeplitz cost grows as N^2 while block-NTT's
    # merged contraction grows ~N*N2; same noise family as default_128 (noise
    # margin validated by the bench's same-run check).  No reference
    # counterpart (the reference is fixed at N=512, src/lib.rs:101-123).
    "large_2048": _mk("large_2048", k=1, log_degree=11, n=722),
    "large_4096": _mk("large_4096", k=1, log_degree=12, n=722),
}


def get_params(name: str) -> TfheParams:
    return PARAMS[name]
