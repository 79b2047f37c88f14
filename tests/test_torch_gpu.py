"""The CUDA attention kernel against its plain torch twin, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and
skips where there is none (decided at run time, never at collection, so
every pytest worker collects the same tests). Run on a CUDA machine with
``python -m pytest tests/test_torch_gpu.py -q --noconftest`` (the
repository's conftest imports JAX, which the port does not need).
"""

import pytest
import torch

from vln_hamt_torch.ops import attention as tops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain twin in full fp32
    return torch.device("cuda")


# fp32 at rate 0: a few ulps of O(1) outputs from another summation
# order. bf16 inputs are widened to fp32 identically on both sides, so
# the same bound holds; with dropout the kept values are scaled by
# 1 / (1 - rate), which scales the error with them.
TOL = {(torch.float32, 0.0): 1e-5, (torch.bfloat16, 0.0): 1e-5,
       (torch.float32, 0.1): 2e-5, (torch.bfloat16, 0.1): 2e-5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("lq,lk", [(60, 60), (36, 36), (60, 64), (64, 60), (250, 250)])
def test_kernel_matches_plain(cuda, dtype, rate, lq, lk):
    g = torch.Generator(device=cuda).manual_seed(lq * 1000 + lk)
    b, h, dh = 4, 12, 64
    q = torch.randn(b, lq, h, dh, device=cuda, generator=g).to(dtype).transpose(1, 2)
    k = torch.randn(b, lk, h, dh, device=cuda, generator=g).to(dtype).transpose(1, 2)
    v = torch.randn(b, lk, h, dh, device=cuda, generator=g).to(dtype).transpose(1, 2)
    m = torch.where(torch.rand(b, lk, device=cuda, generator=g) < 0.8, 0.0, -10000.0)
    seed = 2**31 + 11
    n0 = tops.launch_counts["attention_fwd"]
    got = tops.fused_attention(q, k, v, m, dropout_rate=rate, dropout_seed=seed)
    torch.cuda.synchronize()
    assert tops.launch_counts["attention_fwd"] == n0 + 1
    want = tops.attention_reference(q, k, v, m, seed, rate)
    assert got.shape == want.shape == (b, h, lq, dh)
    err = (got - want).abs().max().item()
    assert err <= TOL[(dtype, rate)], err
