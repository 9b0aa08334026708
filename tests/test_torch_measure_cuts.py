"""The cut copies of ``scripts/measure_torch.py`` still apply to the kernel
sources.

Each cut is a list of (text, replacement) pairs made on a copy of a
kernel's sources before it is built on the card; a text that an edit of
the kernel moved or removed makes the measurement fail only there.  These
tests make every cut's replacements on the CPU, without building.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import measure_torch as mt  # noqa: E402

from tfhe_tpu_torch.ops.cuda import blind_rotate_kernel as brk  # noqa: E402
from tfhe_tpu_torch.ops.cuda import latency_kernel as latk  # noqa: E402
from tfhe_tpu_torch.ops.cuda import ntt_kernel as nttk  # noqa: E402

KERNELS = {"B": brk.KERNEL, "E": brk.PIPE_KERNEL, "F": brk.WIDE_PIPE_KERNEL,
           "G": brk.COLS_KERNEL, "D": nttk.KERNEL, "C": latk.KERNEL}
CASES = [(tag, name, pairs) for tag, cuts in mt.CUTS.items() for name, pairs in cuts.items()]
CASES += [("D", name, pairs) for name, pairs in mt.CUTS_D.items()]
CASES += [("D", "phase timers", mt._D_TIMERS), ("D", "counters", mt._D_COUNTERS)]
CASES += [("C", name, pairs) for name, pairs in mt.CUTS_C.items()]
CASES += [("C", "phase timers", mt._C_TIMERS), ("C", "counters", mt._C_COUNTERS)]


@pytest.mark.parametrize("tag,name,pairs", CASES, ids=[f"{t}-{n}" for t, n, _ in CASES])
def test_cut_applies_once(tag, name, pairs):
    """Every text of the cut is in the kernel's sources exactly once, and
    the cut changes the kernel's .cu or a header it includes."""
    kernel = KERNELS[tag]
    whole = mt.cut_sources(kernel, tag, name, ())
    cut = mt.cut_sources(kernel, tag, name, pairs)
    assert cut != whole
    changed = [f for f in cut if cut[f] != whole[f]]
    main = f"{kernel.source}.cu"
    assert all(f == main or f"#include \"{f}\"" in whole[main] for f in changed)
