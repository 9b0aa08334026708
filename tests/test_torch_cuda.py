"""The CUDA kernels of tfhe_tpu_torch against their plain twins, on the card.

Every case needs a CUDA device and skips without one.  The file imports
neither JAX nor tfhe_tpu, so it also runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q -o addopts= --noconftest

(``--noconftest`` skips tests/conftest.py, which imports JAX.)
"""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops.cuda import blind_rotate_kernel as brk
from tfhe_tpu_torch.ops.cuda import ep_kernel as epk
from tfhe_tpu_torch.ops.torus import to_torch_u32
from tfhe_tpu_torch.params import get_params


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def rnd_u32(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch", [("nano", 1), ("nano", 8), ("test_insecure", 64)])
def test_ep_kernel_matches_twin_on_card(cuda_device, name, batch):
    p = get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    r = k1 * p.pbs_decomposer.levels
    rng = np.random.default_rng(40 + batch)
    d = torch.from_numpy(rng.integers(-8, 17, size=(r, batch, n), dtype=np.int8)).to(cuda_device)
    g = to_torch_u32(rnd_u32(rng, (r, k1, n)), cuda_device)
    before = epk.KERNEL.launches
    got = epk.ep_contract_rbn(d, g)
    torch.cuda.synchronize()
    assert epk.KERNEL.launches == before + 1
    assert torch.equal(got, epk.ep_contract_rbn_ref(d, g))


@pytest.mark.cuda
@pytest.mark.parametrize("balanced", [False, True], ids=["fused", "fusedb"])
@pytest.mark.parametrize("name,batch", [("nano", 3), ("test_insecure", 7)])
def test_blind_rotate_kernel_matches_twin_on_card(cuda_device, name, batch, balanced):
    p = get_params(name)
    k1, n = p.glwe_dimension + 1, p.degree
    rng = np.random.default_rng(50 + batch)
    acc0 = to_torch_u32(rnd_u32(rng, (batch, k1, n)), cuda_device)
    bk = to_torch_u32(rnd_u32(rng, (p.lwe_dimension, k1 * p.pbs_decomposer.levels, k1, n)),
                      cuda_device)
    a_hat = torch.from_numpy(
        rng.integers(0, 2 * n, size=(p.lwe_dimension, batch), dtype=np.int32)).to(cuda_device)
    before = brk.KERNEL.launches
    got = brk.blind_rotate_fused(p, acc0, bk, a_hat, balanced=balanced)
    torch.cuda.synchronize()
    assert brk.KERNEL.launches == before + 1
    assert torch.equal(got, brk.blind_rotate_fused_ref(p, acc0, bk, a_hat, balanced=balanced))


@pytest.mark.cuda
def test_kernels_refuse_unsupported_shapes_on_card(cuda_device):
    """The C entry points check the shapes their thread tiles allow, and the
    wrappers raise on the refusal without counting a launch."""
    p = get_params("nano")
    rng = np.random.default_rng(60)
    d = torch.from_numpy(rng.integers(-8, 17, size=(2, 1, 12), dtype=np.int8)).to(cuda_device)
    g = to_torch_u32(rnd_u32(rng, (2, 2, 12)), cuda_device)
    before = epk.KERNEL.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        epk.ep_contract_rbn(d, g)  # N=12 is not a power of two
    assert epk.KERNEL.launches == before
    k1, n = 3, 1024  # (k+1)*N/8 = 384 threads > 256
    acc0 = to_torch_u32(rnd_u32(rng, (1, k1, n)), cuda_device)
    bk = to_torch_u32(rnd_u32(rng, (1, k1 * p.pbs_decomposer.levels, k1, n)), cuda_device)
    a_hat = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    before = brk.KERNEL.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        brk.blind_rotate_fused(p, acc0, bk, a_hat)
    assert brk.KERNEL.launches == before
