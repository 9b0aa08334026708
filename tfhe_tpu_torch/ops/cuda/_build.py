"""Build and load the hand-written CUDA kernels under ``tfhe_tpu_torch/csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is compiled
by ``nvcc`` for Hopper (``sm_90a``) into ``build/tfhe_tpu_torch/`` at the root
of the checkout (git-ignored), named by a hash of the source and flags so a
stale library is never reused, and loaded with ``ctypes``.  Nothing here runs
when a module is imported: the CPU tests import every module and have no
``nvcc``.

Every C entry point takes its pointers and the CUDA stream as ``void*``,
launches on that stream without synchronising, and returns
``cudaGetLastError()``; ``CudaKernel.launch`` raises if that is not 0 and
counts the launches that succeeded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "tfhe_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): cannot build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the
    library's path and the compiler's resource report (empty if cached).
    The library is named by the source, the shared headers and the flags."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(src.read_bytes() + headers + flags).hexdigest()
    lib = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stderr


def imma_count(lib: Path) -> int:
    """The IMMA (integer tensor-core mma) instructions in a built library,
    from ``cuobjdump -sass`` of the toolkit that built it."""
    sass = subprocess.run([str(Path(_nvcc()).with_name("cuobjdump")), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    return sum("IMMA" in ln for ln in sass.splitlines())


class CudaKernel:
    """One C entry point of one ``csrc`` source, loaded at first launch.

    ``launches`` counts the launches that returned no error.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.ptxas_report = ""
        self.path = None  # the built library, once loaded
        self._fn = None
        self._lib = None

    def load(self):
        if self._fn is None:
            self.path, self.ptxas_report = build(self.source)
            self._lib = ctypes.CDLL(str(self.path))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err_str = self._lib.tfhe_cuda_error_string
            err_str.argtypes = [ctypes.c_int]
            err_str.restype = ctypes.c_char_p
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        err = self.load()(*args)
        if err != 0:
            msg = self._lib.tfhe_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error {err} ({msg})")
        self.launches += 1


#: the samples-per-CTA choices of the whole-scan kernels, largest first
SAMPLES_PER_CTA = (8, 4, 2, 1)


@functools.lru_cache(maxsize=None)
def smem_budget(device) -> int:
    """The opt-in shared memory per block of CUDA ``device`` in bytes: the
    most a kernel may ask for (232448 on an H100).  The counterpart of the
    JAX package's ``_probe_vmem_budget``, which asks the TPU compiler
    whether a scoped VMEM budget compiles; here the runtime states it
    (cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The streaming multiprocessors of CUDA ``device`` (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def pick_samples_per_cta(smem_bytes, budget: int, choices=SAMPLES_PER_CTA) -> int | None:
    """The largest S of ``choices`` (tried in order) whose ``smem_bytes(S)``
    fits ``budget``, or None when none does."""
    return next((s for s in choices if smem_bytes(s) <= budget), None)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda_operand(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                       device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
