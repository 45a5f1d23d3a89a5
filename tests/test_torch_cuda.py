"""On-card checks of the port's CUDA kernels (marker ``cuda``).

Skipped where there is no Hopper card; run them on one with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors at ragged shapes, the wrappers' refusals are checked, and every
launch is seen on its counter.  Tolerance: 4 eps sqrt(k) times the largest
plain entry for an f32 sum of k products in two orders; 1e-4 for the 24
Newton-Schulz steps.
"""

import math

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import covariance as tcov
from repro_torch.kernels import procrustes_align as tpa
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.cuda
EPS32 = 2.0 ** -23


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the port's kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _hold(got, want, k):
    tol = 4 * EPS32 * math.sqrt(k) * want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol, (err, tol)


def _stack(dev, m, d, r, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.linalg.qr(torch.randn(d, r, generator=g, device=dev))[0]
    noise = torch.randn(m, d, r, generator=g, device=dev) * (0.1 / math.sqrt(d))
    return torch.linalg.qr(base[None] + noise)[0].contiguous()


@pytest.mark.parametrize("n,d", [(257, 205), (64, 64), (1000, 300), (0, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("symmetric", [False, True])
def test_gram_kernel(dev, n, d, dtype, symmetric):
    x = torch.randn(n, d, device=dev).to(dtype)
    before = tcov.gram.launches
    got = tcov.gram(x, symmetric=symmetric)
    torch.cuda.synchronize()
    assert tcov.gram.launches == before + 1
    _hold(got, tref.gram(x), max(n, 1))


def test_gram_kernel_stack(dev):
    x = torch.randn(3, 300, 129, device=dev)
    _hold(tcov.gram(x), tref.gram(x), 300)


@pytest.mark.parametrize("m,d,r", [(3, 205, 5), (1, 130, 3), (8, 1000, 128), (2, 96, 1)])
def test_procrustes_kernels(dev, m, d, r):
    vs = _stack(dev, m, d, r)
    ref = vs[0].contiguous()
    kernels.reset_launch_counts()
    _hold(tpa.batched_gram(vs, ref), tref.batched_gram(vs, ref), d)
    z = tpa.batched_gram_polar(vs, ref)
    assert (z - tref.batched_gram_polar(vs, ref)).abs().max().item() <= 1e-4
    out = tpa.align_average(vs, z)
    _hold(out, tref.align_average(vs, z), m * r)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        "gram": 0, "batched_gram": 1, "batched_gram_polar": 1, "align_average": 1,
    }


def test_gram_stage_and_apply_beyond_one_tile(dev):
    """r = 200 spans several 64-wide output tiles (no Newton-Schulz:
    above its shared-memory limit)."""
    vs = _stack(dev, 2, 300, 200)
    ref = vs[0].contiguous()
    _hold(tpa.batched_gram(vs, ref), tref.batched_gram(vs, ref), 300)
    zs = tref.batched_gram_polar(vs, ref)
    _hold(tpa.align_average(vs, zs), tref.align_average(vs, zs), 2 * 200)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    vs = _stack(dev, 2, 64, 4)
    with pytest.raises(TypeError):
        tcov.gram(torch.randn(8, 4, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        tcov.gram(torch.randn(4, 8, device=dev).T)  # not contiguous
    with pytest.raises(TypeError):
        tpa.batched_gram(vs.double(), vs[0].double())
    with pytest.raises(ValueError):
        tpa.batched_gram(vs, vs[0].T.contiguous())  # wrong shape
    with pytest.raises(ValueError):
        tpa.align_average(vs, torch.zeros(2, 4, 4, device=dev).mT)
    big = torch.zeros(1, 16, 140, device=dev)
    with pytest.raises(ValueError):
        tpa.batched_gram_polar(big, big[0])  # r above the shared-memory limit
