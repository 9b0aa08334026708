"""The plain reference of the benchmark: TFHE boolean gates and the ripple-carry
adder, written from the scheme's definition in plain PyTorch.

It imports nothing of the program under test.  Every torus value is an int64
tensor in [0, 2^32); every product that could pass 2^53 is split into 16-bit
halves and run as a float64 matmul, exact because every partial sum is an
integer below 2^53.  It runs on whatever device its tensors are on.

What it computes, after the reference TFHE implementation
(github.com/Janmajayamall/tfhe-research, src/):

  * keys: the bootstrapping key (one GGSW of each LWE secret bit under the
    GLWE secret, ``bootstrapping.rs``) and the key-switching key (``key_switching.rs``),
    from the secrets, masks and noise that ``draw_keys`` draws;
  * a gate: ct = 2*ct1 + ct0, then the programmable bootstrap: switch the
    modulus to 2N, rotate the gate's test vector by the ciphertext's mask
    (n CMUX steps, each an external product of the signed gadget digits,
    carry-chain convention of ``decomposer.rs``, with one GGSW), extract
    coefficient 0 and switch the key back to dimension n;
  * the W-bit ripple-carry adder: gates of one circuit depth evaluated
    together, as the program's adder batches them; one PBS per gate, so the
    output of every gate is exact whatever the batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

MASK = (1 << 32) - 1
_HALF16 = 1 << 16

#: the 2-input gates, f(lhs, rhs) on bits; lhs is ct1, rhs is ct0 (the LUT
#: index 2*ct1 + ct0 reads as (lhs, rhs) = (bit 1, bit 0))
GATES = {
    "and": lambda l, r: l & r,
    "or": lambda l, r: l | r,
    "xor": lambda l, r: l ^ r,
    "nand": lambda l, r: 1 - (l & r),
    "nor": lambda l, r: 1 - (l | r),
    "xnor": lambda l, r: 1 - (l ^ r),
    "andny": lambda l, r: (1 - l) & r,
    "andyn": lambda l, r: l & (1 - r),
}

@dataclass(frozen=True)
class Params:
    """A TFHE parameter set as a configuration file states it."""

    name: str
    glwe_dimension: int
    log_degree: int
    lwe_dimension: int
    padding_bits: int
    log_p: int
    log_q: int
    ks_log_base: int
    ks_levels: int
    pbs_log_base: int
    pbs_levels: int
    lwe_std_dev: float
    glwe_std_dev: float
    #: the convention of the blind rotation's digits: "carry" or "balanced"
    pbs_digits: str = "carry"

    @property
    def k(self) -> int:
        return self.glwe_dimension

    @property
    def n(self) -> int:
        return self.lwe_dimension

    @property
    def degree(self) -> int:
        return 1 << self.log_degree

    @property
    def rows(self) -> int:
        """R = (k+1) * pbs_levels rows of a GGSW."""
        return (self.k + 1) * self.pbs_levels

    @property
    def delta_shift(self) -> int:
        return self.log_q - self.log_p - self.padding_bits


PARAM_KEYS = ("glwe_dimension", "log_degree", "lwe_dimension", "padding_bits", "log_p",
              "log_q", "ks_log_base", "ks_levels", "pbs_log_base", "pbs_levels",
              "lwe_std_dev", "glwe_std_dev")


def params_from_config(name: str, cfg: dict) -> Params:
    p = Params(name=name, pbs_digits=cfg.get("pbs_digits", "carry"),
               **{key: cfg[key] for key in PARAM_KEYS})
    if p.log_q != 32:
        raise ValueError(f"{name}: the reference works on the 32-bit torus, log_q={p.log_q}")
    if p.pbs_digits not in DIGITS:
        raise ValueError(f"{name}: pbs_digits {p.pbs_digits!r} is none of {sorted(DIGITS)}")
    return p


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


def to_carrier(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same bits (the program's carrier)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def from_carrier(x: torch.Tensor) -> torch.Tensor:
    """int32 carrying u32 -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & MASK


def _halves(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u32 (int64) -> its low and high 16 bits as float64."""
    return (x & 0xFFFF).to(torch.float64), (x >> 16).to(torch.float64)


def _exact_matmul(x_u32: torch.Tensor, w_small: torch.Tensor) -> torch.Tensor:
    """x[..., K] @ w[K, M] mod 2^32 for u32 x and small signed w (float64)."""
    lo, hi = _halves(x_u32)
    s_lo = torch.matmul(lo, w_small).to(torch.int64)
    s_hi = torch.matmul(hi, w_small).to(torch.int64)
    return (s_lo + s_hi * _HALF16) & MASK


def _negacyclic_toeplitz(s: torch.Tensor) -> torch.Tensor:
    """Small poly s[..., N] -> float64 [..., N(m), N(o)] with T[m, o] =
    s[o - m] for m <= o and -s[o - m + N] otherwise, so that a @ T is the
    product a * s mod X^N + 1."""
    n = s.shape[-1]
    m = torch.arange(n, device=s.device)[:, None]
    o = torch.arange(n, device=s.device)[None, :]
    t = s[..., (o - m) % n].to(torch.float64)
    return torch.where(m <= o, t, -t)


def monomial_mul(poly: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """poly[..., N] * X^exp mod X^N + 1; exp int64 broadcastable to poly.shape[:-1].
    Coefficient i is ext[(i - exp) mod 2N] of the extension ext = (poly, -poly)."""
    n = poly.shape[-1]
    ext = torch.cat([poly, (-poly) & MASK], dim=-1)
    idx = (torch.arange(n, device=poly.device) - exp[..., None]) % (2 * n)
    return torch.gather(ext, -1, idx.expand(poly.shape))


def gadget_shifts(log_base: int, levels: int) -> list[int]:
    """The bit position of each level's weight, most significant first:
    level j weighs 2^(32 - log_base*(j+1))."""
    return [32 - log_base * (j + 1) for j in range(levels)]


def _rounded(v: torch.Tensor, log_base: int, levels: int) -> torch.Tensor:
    """v with the bits below the kept levels rounded off, half up, mod 2^32."""
    ignored = 32 - log_base * levels
    if not ignored:
        return v
    return (((v + (1 << (ignored - 1))) & MASK) >> ignored) << ignored


def decompose(v: torch.Tensor, log_base: int, levels: int) -> torch.Tensor:
    """Signed gadget digits of u32 values, MSB-first: int64[..., levels].

    Rounds the ignored low bits half up, then walks the kept base-2^log_base
    positions from the lowest with a carry: a digit with its top bit set
    becomes digit - B and carries 1 (decomposer.rs).  A digit B - 1 that
    meets a carry is B and carries nothing, so digits lie in [-B/2, B/2) or
    are B.  The positions below the kept ones hold only rounded-off bits:
    digits 0 that carry nothing."""
    half = 1 << (log_base - 1)
    v = _rounded(v, log_base, levels)
    shifts = torch.tensor(gadget_shifts(log_base, levels)[::-1], device=v.device)
    x = (v[..., None] >> shifts) & ((1 << log_base) - 1)  # the kept positions, LSB first
    res, top, carry = [], [], 0
    for j in range(levels):
        r = x[..., j] + carry
        t = r & half
        carry = t >> (log_base - 1)
        res.append(r)
        top.append(t)
    digits = torch.stack(res, dim=-1) - 2 * torch.stack(top, dim=-1)
    return digits.flip(-1)


def decompose_balanced(v: torch.Tensor, log_base: int, levels: int) -> torch.Tensor:
    """Balanced gadget digits of u32 values, MSB-first: int64[..., levels].

    Rounds the ignored low bits half up as ``decompose`` does; the kept part
    w is then written in base B = 2^log_base with every digit in [-B/2, B/2):
    from the lowest level up, d = ((w + B/2) mod B) - B/2 and w = (w - d) / B;
    what is left after the top level is dropped (it weighs 2^32).  So
    sum_j d_j 2^(32 - log_base*(j+1)) is the rounded value mod 2^32."""
    base, half = 1 << log_base, 1 << (log_base - 1)
    w = _rounded(v, log_base, levels) >> (32 - log_base * levels)
    digits = []
    for _ in range(levels):
        d = ((w + half) % base) - half
        digits.append(d)
        w = (w - d) >> log_base
    return torch.stack(digits[::-1], dim=-1)


#: the PBS digit conventions by the name a configuration gives them
DIGITS = {"carry": decompose, "balanced": decompose_balanced}


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


@dataclass
class Draws:
    """The secrets, masks and noise of one key set, drawn by the benchmark
    from its seed (int64 tensors; masks and noise as u32)."""

    lwe_sk: torch.Tensor  # [n] bits
    glwe_sk: torch.Tensor  # [k, N] bits
    bk_a: torch.Tensor  # [n, R, k, N]
    bk_e: torch.Tensor  # [n, R, N]
    ksk_a: torch.Tensor  # [k*N*ks_levels, n]
    ksk_e: torch.Tensor  # [k*N*ks_levels]


def uniform_u32(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(0, 1 << 32, tuple(shape), dtype=torch.int64, generator=gen,
                         device=gen.device)


def gaussian_u32(gen: torch.Generator, std_dev: float, shape) -> torch.Tensor:
    """round(z * std_dev * 2^32) mod 2^32 for a standard normal z."""
    z = torch.randn(tuple(shape), dtype=torch.float64, generator=gen, device=gen.device)
    return torch.round(z * (std_dev * 2.0**32)).to(torch.int64) & MASK


def bits(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(0, 2, tuple(shape), dtype=torch.int64, generator=gen,
                         device=gen.device)


def draw_keys(p: Params, gen: torch.Generator) -> Draws:
    k, n, N = p.k, p.n, p.degree
    ksk_rows = k * N * p.ks_levels
    return Draws(
        lwe_sk=bits(gen, (n,)),
        glwe_sk=bits(gen, (k, N)),
        bk_a=uniform_u32(gen, (n, p.rows, k, N)),
        bk_e=gaussian_u32(gen, p.glwe_std_dev, (n, p.rows, N)),
        ksk_a=uniform_u32(gen, (ksk_rows, n)),
        ksk_e=gaussian_u32(gen, p.lwe_std_dev, (ksk_rows,)),
    )


@dataclass
class Keys:
    """The reference's own bootstrapping and key-switching keys."""

    bk: torch.Tensor  # [n, R, k+1, N]: GGSW of each LWE secret bit
    ksk: torch.Tensor  # [k*N*ks_levels, n+1]: LWE rows under the LWE secret


def _glwe_mask_dot(a: torch.Tensor, glwe_sk: torch.Tensor, rows_per_block: int = 4096):
    """sum_j a_j * S_j mod X^N + 1 for a[..., k, N]; in blocks of rows."""
    k, N = glwe_sk.shape
    t = _negacyclic_toeplitz(glwe_sk).reshape(k * N, N)
    flat = a.reshape(-1, k * N)
    out = torch.cat([_exact_matmul(flat[i:i + rows_per_block], t)
                     for i in range(0, flat.shape[0], rows_per_block)])
    return out.reshape(a.shape[:-2] + (N,))


def derive_keys(p: Params, d: Draws) -> Keys:
    k, N = p.k, p.degree
    # GGSW(s_i): row (c * levels + j) is GLWE(0) plus s_i * 2^(32 - b*(j+1))
    # on coefficient 0 of its polynomial c
    body = (_glwe_mask_dot(d.bk_a, d.glwe_sk) + d.bk_e) & MASK  # [n, R, N]
    bk = torch.cat([d.bk_a, body[:, :, None, :]], dim=2)  # [n, R, k+1, N]
    for c in range(k + 1):
        for j, shift in enumerate(gadget_shifts(p.pbs_log_base, p.pbs_levels)):
            r = c * p.pbs_levels + j
            bk[:, r, c, 0] = (bk[:, r, c, 0] + (d.lwe_sk << shift)) & MASK
    # KSK: row (t * levels + j) encrypts glwe_sk[t] * 2^(32 - b*(j+1))
    shifts = torch.tensor(gadget_shifts(p.ks_log_base, p.ks_levels), device=d.ksk_a.device)
    factors = (d.glwe_sk.reshape(-1, 1) << shifts).reshape(-1)
    ksk = lwe_encrypt_raw(d.lwe_sk, factors, d.ksk_a, d.ksk_e)
    return Keys(bk=bk, ksk=ksk)


# ---------------------------------------------------------------------------
# LWE
# ---------------------------------------------------------------------------


def lwe_encrypt_raw(lwe_sk, pt, a, e) -> torch.Tensor:
    """(a, <a, s> + e + pt) mod 2^32."""
    b = ((a * lwe_sk).sum(-1) + e + pt) & MASK
    return torch.cat([a, b[..., None]], dim=-1)


def encrypt_bits(p: Params, gen: torch.Generator, lwe_sk, messages) -> torch.Tensor:
    """LWE encryptions of cleartexts in [0, 2^log_p) with fresh masks and noise."""
    m = messages.to(torch.int64)
    a = uniform_u32(gen, m.shape + (p.n,))
    e = gaussian_u32(gen, p.lwe_std_dev, m.shape)
    return lwe_encrypt_raw(lwe_sk, m << p.delta_shift, a, e)


def phase(lwe_sk, ct, rows_per_block: int = 1 << 16) -> torch.Tensor:
    """b - <a, s> mod 2^32 of ciphertexts [..., n+1], in blocks of rows."""
    flat = ct.reshape(-1, ct.shape[-1])
    out = torch.cat([(flat[i:i + rows_per_block, -1]
                      - (flat[i:i + rows_per_block, :-1] * lwe_sk).sum(-1)) & MASK
                     for i in range(0, flat.shape[0], rows_per_block)])
    return out.reshape(ct.shape[:-1])


def decrypt(p: Params, lwe_sk, ct) -> torch.Tensor:
    """Cleartexts: round(phase / Delta) mod 2^log_p."""
    s = p.delta_shift
    return (((phase(lwe_sk, ct) + (1 << (s - 1))) & MASK) >> s) & ((1 << p.log_p) - 1)


def noise_over_delta(p: Params, lwe_sk, ct, messages) -> torch.Tensor:
    """|phase - m * Delta| / Delta, centred, for known cleartexts."""
    period = 1 << (p.log_q - p.padding_bits)
    diff = (phase(lwe_sk, ct) - (messages.to(torch.int64) << p.delta_shift)) % period
    diff = torch.where(diff >= period // 2, diff - period, diff)
    return diff.abs().to(torch.float64) / float(1 << p.delta_shift)


# ---------------------------------------------------------------------------
# the programmable bootstrap
# ---------------------------------------------------------------------------


def test_vector(p: Params, lut) -> torch.Tensor:
    """The encoded test vector of a LUT over [0, 2^log_p) (test_vector.rs):
    each entry repeated N / 2^log_p times, the first half-block negated mod
    2^log_p, then the whole rotated left by half a block."""
    p_mod = 1 << p.log_p
    rep = p.degree // p_mod
    tv = torch.tensor(lut, dtype=torch.int64).repeat_interleave(rep)
    half = rep // 2
    tv[:half] = torch.where(tv[:half] != 0, p_mod - tv[:half], tv[:half])
    return torch.roll(tv, -half) << p.delta_shift


def gate_lut(p: Params, name: str) -> list[int]:
    f = GATES[name]
    return [f((i >> 1) & 1, i & 1) for i in range(1 << p.log_p)]


def _key_toeplitz_index(p: Params, cols: slice, device) -> torch.Tensor:
    """Flat indices that expand a step's key into the float64 contraction
    matrix W[(r, m), (half, c, o)] = +-half(K[r, c, (o - m) mod N]) for the
    output coefficients o in ``cols``; the source is
    stack(lo, hi, -lo, -hi) of the step's key [R, C, N]."""
    R, C, N = p.rows, p.k + 1, p.degree
    o = torch.arange(N, device=device)[cols]
    m = torch.arange(N, device=device)
    diff = o[None, :] - m[:, None]  # [N(m), cols]
    neg = (diff < 0).to(torch.int64)  # the wrapped terms carry a minus sign
    coef = diff % N
    r = torch.arange(R, device=device)[:, None, None, None, None]
    half = torch.arange(2, device=device)[None, None, :, None, None]
    c = torch.arange(C, device=device)[None, None, None, :, None]
    neg, coef = neg[None, :, None, None, :], coef[None, :, None, None, :]
    src = (((neg * 2 + half) * R + r) * C + c) * N + coef
    return src.reshape(R * N, -1)


def blind_rotate(p: Params, bk: torch.Tensor, acc: torch.Tensor, a_hat: torch.Tensor,
                 cols_per_block: int = 1024) -> torch.Tensor:
    """n CMUX steps: acc += EP(digits(acc * X^a_i - acc), BK_i), on acc[B, k+1, N]
    (u32) with a_hat[B, n] in [0, 2N), the digits in ``p.pbs_digits``.  The
    external product contracts the digit rows [B, R*N] with the step's key
    expanded to its negacyclic Toeplitz form, built per step,
    ``cols_per_block`` output coefficients at a time."""
    B, C, N = acc.shape
    R = p.rows
    blocks = [slice(o, min(o + cols_per_block, N)) for o in range(0, N, cols_per_block)]
    index = [_key_toeplitz_index(p, blk, acc.device) for blk in blocks]
    lo, hi = _halves(bk)
    src = torch.stack([lo, hi, -lo, -hi], dim=1).reshape(p.n, -1)  # each step's key, signed
    del lo, hi
    digits_of = DIGITS[p.pbs_digits]
    for i in range(p.n):
        rot = monomial_mul(acc, a_hat[:, i, None])
        digits = digits_of((rot - acc) & MASK, p.pbs_log_base, p.pbs_levels)  # [B, C, N, L]
        d = digits.transpose(2, 3).reshape(B, R * N).to(torch.float64)  # rows c*L + j
        delta = []
        for idx in index:
            s = torch.matmul(d, src[i][idx]).to(torch.int64)  # [B, 2*C*cols]
            s = s.reshape(B, 2, C, -1)
            delta.append(s[:, 0] + s[:, 1] * _HALF16)
        acc = (acc + torch.cat(delta, dim=-1)) & MASK
    return acc


def sample_extract(acc: torch.Tensor) -> torch.Tensor:
    """Coefficient 0 of GLWE [B, k+1, N] as an LWE of dimension k*N:
    a'[c*N + j] = a_c[0] for j = 0 and -a_c[N - j] otherwise, b' = b[0]."""
    a = acc[:, :-1, :]
    w = torch.cat([a[..., :1], (-torch.flip(a[..., 1:], dims=(-1,))) & MASK], dim=-1)
    return torch.cat([w.reshape(acc.shape[0], -1), acc[:, -1, :1]], dim=-1)


def key_switch(p: Params, ksk: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """(0, .., 0, b) - sum_t sum_j digit_j(a_t) * KSK[t * levels + j] mod 2^32."""
    kn = ct.shape[-1] - 1
    d = decompose(ct[:, :kn], p.ks_log_base, p.ks_levels).reshape(ct.shape[0], -1)
    lo, hi = _halves(ksk)
    dd = d.to(torch.float64)
    acc = torch.matmul(dd, lo).to(torch.int64) + torch.matmul(dd, hi).to(torch.int64) * _HALF16
    out = (-acc) & MASK
    out[:, -1] = (out[:, -1] + ct[:, -1]) & MASK
    return out


def pbs(p: Params, keys: Keys, ct: torch.Tensor, tv: torch.Tensor) -> torch.Tensor:
    """The programmable bootstrap of ct[B, n+1] with test vectors tv[B, N] (or [N])."""
    B, N = ct.shape[0], p.degree
    shift = p.log_q - (p.log_degree + 1)
    approx = ((ct + (1 << (shift - 1))) >> shift) & (2 * N - 1)  # round to Z_2N
    tv = tv.to(ct.device).expand(B, N)
    acc = torch.zeros(B, p.k + 1, N, dtype=torch.int64, device=ct.device)
    acc[:, -1] = monomial_mul(tv, -approx[:, -1])
    acc = blind_rotate(p, keys.bk, acc, approx[:, :-1])
    return key_switch(p, keys.ksk, sample_extract(acc))


def gate(p: Params, keys: Keys, names, ct0: torch.Tensor, ct1: torch.Tensor) -> torch.Tensor:
    """Named 2-input gates on ct0, ct1 [B, n+1]: one gate name for all, or one per row."""
    ct = (2 * ct1 + ct0) & MASK
    return pbs(p, keys, ct, _tvs(p, names, ct.shape[0], ct.device))


def _tvs(p: Params, names, batch: int, device) -> torch.Tensor:
    if isinstance(names, str):
        return test_vector(p, gate_lut(p, names)).to(device)
    table = {nm: test_vector(p, gate_lut(p, nm)) for nm in set(names)}
    assert len(names) == batch
    return torch.stack([table[nm] for nm in names]).to(device)


def ripple_add(p: Params, keys: Keys, a_bits: torch.Tensor, b_bits: torch.Tensor):
    """W-bit ripple-carry addition of a_bits, b_bits [W, B, n+1] (little-endian),
    carry in 0: returns (sum bits [W, B, n+1], carry out [B, n+1]).

    At log_p = 2: x = a ^ b and g = a & b over all bits, then per bit
    h = x_i & c, c = g_i | h, and the sums x ^ c over all bits.  Each gate is called as the program's adder calls it: gate(name, ct0, ct1)
    reads 2*ct1 + ct0."""
    w, batch = a_bits.shape[:2]

    def flat(x):
        return x.reshape((w * batch,) + x.shape[2:])

    c = torch.zeros(batch, p.n + 1, dtype=torch.int64, device=a_bits.device)  # trivial 0
    carries = [c]
    x = gate(p, keys, "xor", flat(a_bits), flat(b_bits)).reshape(a_bits.shape)
    g = gate(p, keys, "and", flat(a_bits), flat(b_bits)).reshape(a_bits.shape)
    for i in range(w):
        h = gate(p, keys, "and", x[i], c)
        c = gate(p, keys, "or", g[i], h)
        carries.append(c)
    s = gate(p, keys, "xor", flat(x), flat(torch.stack(carries[:w])))
    return s.reshape(a_bits.shape), carries[w]
