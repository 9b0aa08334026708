"""Seeded randomness for keys, masks and noise (port of
``tfhe_tpu/ops/sampling.py``; reference: src/utils.rs:36-109).

Every sampler draws from an explicit ``torch.Generator`` on the generator's
own device; nothing reads torch's global RNG.  The bits differ from JAX's
threefry for the same seed, so the parity tests inject numpy randomness into
the deterministic cores (``models/keys.py:make_server_key``) instead.
u32 results are int32 tensors (see ``ops/torus.py``).
"""

from __future__ import annotations

import torch


def uniform_u32(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform torus elements (src/utils.rs:96-109)."""
    return torch.randint(-(1 << 31), 1 << 31, tuple(shape), dtype=torch.int32,
                         generator=gen, device=gen.device)


def binary(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform bits for binary secret keys (src/utils.rs:68-94)."""
    return torch.randint(0, 2, tuple(shape), dtype=torch.int32, generator=gen,
                         device=gen.device)


def gaussian_torus(gen: torch.Generator, std_dev: float, shape) -> torch.Tensor:
    """Centered gaussian noise mapped to the torus (src/utils.rs:36-54):
    round(z * sigma * 2^32), two's complement in the int32 carrier."""
    z = torch.randn(tuple(shape), dtype=torch.float32, generator=gen,
                    device=gen.device)
    return torch.round(z * (std_dev * 2.0**32)).to(torch.int32)
