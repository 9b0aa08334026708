"""Every whole-scan kernel wrapper launches inside its tensors' device context.

The C entry points of Kernels B, E, F, G (``ops/cuda/blind_rotate_kernel.py``),
C (``ops/cuda/latency_kernel.py``) and D (``ops/cuda/ntt_kernel.py``) read the
current CUDA device (its shared-memory budget, ``cudaFuncSetAttribute``, the
stream's device), so each wrapper must make the tensors' card current around
the launch, as Kernels A and H do (``ops/cuda/ep_kernel.py``).  Without a card
this is checked with tensors that report ``cuda:1``, a recording
``torch.cuda.device`` and each kernel's ``launch`` replaced by a probe that
records the device current when it runs and how many arguments it got.  The two-card runs of the same
wrappers are in ``tests/test_torch_cuda.py``.
"""

import contextlib

import pytest
import torch

from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops.cuda import blind_rotate_kernel as brk
from tfhe_tpu_torch.ops.cuda import latency_kernel as latk
from tfhe_tpu_torch.ops.cuda import ntt_kernel as nttk
from tfhe_tpu_torch.params import get_params

SECOND = torch.device("cuda", 1)


class OnSecondCard(torch.Tensor):
    """A CPU tensor that reports ``cuda:1`` as its device."""

    @property
    def device(self):
        return SECOND


def fake(shape, dtype):
    return torch.zeros(shape, dtype=dtype).as_subclass(OnSecondCard)


def whole_scan_case(fn, **options):
    p = get_params("test_insecure")
    k1, n, steps, b = p.glwe_dimension + 1, p.degree, 2, 3
    bk = fake((steps, k1 * p.pbs_decomposer.levels, k1, n), torch.int32)
    args = (p, fake((b, k1, n), torch.int32), bk, fake((steps, b), torch.int32))
    return lambda: fn(*args, **options)


def latency_case():
    p = get_params("test_insecure")
    k1, n, steps, b = p.glwe_dimension + 1, p.degree, 2, 1
    width = 4 * latk.n_groups(p, 1) * n
    args = (p, fake((b, k1, n), torch.int32), fake((steps, k1 * 4, width), torch.int8),
            fake((steps, 1, b), torch.int32))
    return lambda: latk.blind_rotate_latency(*args)


def nttf_case():
    p = get_params("test_insecure")
    k1, n, steps, b = p.glwe_dimension + 1, p.degree, 2, 3
    key = fake(nttk.lhs_key_shape(p, ntt.plan_for_params(p), steps), torch.int8)
    args = (p, fake((b, k1, n), torch.int32), key, fake((steps, b), torch.int32))
    return lambda: nttk.blind_rotate_nttf(*args)


CASES = {
    "B": (brk.KERNEL, lambda: whole_scan_case(brk.blind_rotate_fused, balanced=True)),
    "E": (brk.PIPE_KERNEL, lambda: whole_scan_case(brk.blind_rotate_fused_pipe)),
    "F": (brk.WIDE_PIPE_KERNEL, lambda: whole_scan_case(brk.blind_rotate_fused_wide_pipe)),
    "G": (brk.COLS_KERNEL, lambda: whole_scan_case(brk.blind_rotate_fused_cols)),
    "C": (latk.KERNEL, latency_case),
    "D": (nttk.KERNEL, nttf_case),
}


@pytest.mark.parametrize("kernel_name", list(CASES))
def test_wrappers_launch_inside_the_tensors_device_context(monkeypatch, kernel_name):
    kernel, case = CASES[kernel_name]
    current = [torch.device("cuda", 0)]
    seen = []

    @contextlib.contextmanager
    def device_context(dev):
        before = current[0]
        current[0] = torch.device(dev)
        try:
            yield
        finally:
            current[0] = before

    monkeypatch.setattr(torch.cuda, "device", device_context)
    monkeypatch.setattr(kernel, "launch",
                        lambda *args: seen.append((current[0], len(args))))
    for module in (brk, latk, nttk):
        monkeypatch.setattr(module, "stream_of", lambda t: None)
    monkeypatch.setattr(brk, "smem_budget", lambda dev: 232448)
    monkeypatch.setattr(nttk, "kernel_tables", lambda n1, dev: torch.zeros(1))
    out = case()()
    assert [dev for dev, _ in seen] == [SECOND], \
        f"Kernel {kernel_name} launched on {seen}, not inside {SECOND}"
    assert seen[0][1] == len(kernel.argtypes)  # one argument per parameter of the C entry point
    assert current[0] == torch.device("cuda", 0)  # the context was left again
    assert out.device == SECOND
