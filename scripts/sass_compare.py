#!/usr/bin/env python3
"""Compare the machine code of kernels built from two source trees.

    python3 scripts/sass_compare.py OTHER_CSRC NAME [NAME ...]

For each NAME, builds ``tfhe_tpu_torch/csrc/NAME.cu`` of this checkout and
``OTHER_CSRC/NAME.cu`` (for example the csrc directory of an unpacked
parent commit) with the port's nvcc flags, all at once, into
``build/tfhe_tpu_torch/sass_compare/``, and prints for each: the SASS
instruction count of both (``cuobjdump -sass``, addresses and encodings
stripped), their IMMA counts, the registers ptxas reports, and whether the
instruction streams are identical, then the same for each kernel function
of OTHER's library beside its counterpart here (names compared without
the per-file hash of the anonymous namespace and without a last template
argument ``false`` this checkout added, as the whole-scan kernels' N <=
512 instances gained ``kBlocked``), and the functions only this checkout
has.  Exits 1 if any pair differs.  Needs the CUDA toolkit (the card
machine), not a card.
"""

from __future__ import annotations

import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sass_lines(lib: Path) -> list[str]:
    """The SASS instructions of a built library (``cuobjdump -sass``), with
    their addresses and encodings stripped."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    addr = re.compile(r"/\*[0-9a-f]{4,}\*/")  # 5 digits past 64 KiB of code
    return [re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", ln).strip()
            for ln in sass.splitlines() if addr.search(ln)]


def functions(lib: Path) -> dict[str, list[str]]:
    """Each kernel function's SASS instructions in a built library, by its
    mangled name less the anonymous namespace's per-file hash and a last
    template argument ``false`` (``Lb0E``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    addr = re.compile(r"/\*[0-9a-f]{4,}\*/")
    res, name = {}, None
    for ln in sass.splitlines():
        head = re.search(r"Function : (\S+)", ln)
        if head:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", head.group(1)).replace("ELb0EE", "EE")
            res[name] = []
        elif name is not None and addr.search(ln):
            res[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", ln).strip())
    return res


def sass_of(src: Path, lib: Path) -> tuple[list[str], list[str]]:
    """Build ``src`` into ``lib``; return its SASS instructions and the
    register counts ptxas reported."""
    from tfhe_tpu_torch.ops.cuda import _build

    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return sass_lines(lib), re.findall(r"Used (\d+) registers", proc.stderr)


def main() -> int:
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    sys.path.insert(0, str(ROOT))
    from tfhe_tpu_torch.ops.cuda import _build

    other, names = Path(sys.argv[1]).resolve(), sys.argv[2:]
    out = _build.BUILD_DIR / "sass_compare"
    out.mkdir(parents=True, exist_ok=True)
    jobs = [(tag, src / f"{name}.cu", out / f"{tag}_{name}.so") for name in names
            for tag, src in (("this", _build.CSRC), ("other", other))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        res = list(pool.map(lambda job: sass_of(job[1], job[2]), jobs))
    differ = 0
    for i, name in enumerate(names):
        (mine, regs_mine), (theirs, regs_theirs) = res[2 * i], res[2 * i + 1]
        same = mine == theirs
        differ += not same
        print(f"{name}: {len(mine)} / {len(theirs)} instructions (this / other), IMMA "
              f"{sum('IMMA' in ln for ln in mine)} / {sum('IMMA' in ln for ln in theirs)}, "
              f"registers {regs_mine} / {regs_theirs}: "
              f"{'identical SASS' if same else 'SASS DIFFERS'}", flush=True)
        mine_f, theirs_f = (functions(out / f"{tag}_{name}.so") for tag in ("this", "other"))
        for fn, body in sorted(theirs_f.items()):
            here = mine_f.get(fn)
            print(f"  {fn}: {len(here) if here is not None else 'none'} / {len(body)} "
                  f"instructions: {'identical' if here == body else 'differs'}", flush=True)
        for fn in sorted(set(mine_f) - set(theirs_f)):
            print(f"  {fn}: {len(mine_f[fn])} instructions, "
                  f"{sum('IMMA' in ln for ln in mine_f[fn])} IMMA, only in this checkout",
                  flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
