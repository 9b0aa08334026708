"""The import guard: the benchmark measures the PyTorch port alone.

A module counts by its top-level name, the part before the first dot,
compared whole: ``tfhe_tpu_torch`` begins with ``tfhe_tpu`` and is the
program, ``tfhe_tpu`` is the JAX package and must not be loaded.
"""

from __future__ import annotations

import sys

#: top-level module names no run may load: JAX, its libraries and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tfhe_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def check_imports(where: str) -> None:
    """Exit with status 3, naming them on standard error, when a forbidden
    module is loaded."""
    found = forbidden_modules()
    if found:
        print(f"benchmark: {where}: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
