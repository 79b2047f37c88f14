"""The port's attention (plain torch twin) against the JAX package's
Pallas kernel (interpret mode) and its XLA reference, and the dropout
keep mask bit for bit. The CUDA kernel itself is held against the same
twin on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_hamt_tpu.ops.attention import (
    _attention_reference,
    _dropout_keep_mask,
    fused_attention as jax_fused_attention,
)
from vln_hamt_torch.ops import attention as tops

# fp32 on both sides; the sums run in different orders (XLA einsum vs
# torch einsum), a few ulps on O(1) outputs
ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, b=2, h=3, lq=6, lk=9, dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, dh)).astype(np.float32)
    k = rng.standard_normal((b, h, lk, dh)).astype(np.float32)
    v = rng.standard_normal((b, h, lk, dh)).astype(np.float32)
    m = np.where(rng.random((b, lk)) < 0.7, 0.0, -10000.0).astype(np.float32)
    return q, k, v, m


def _jax_seed(seed):
    # negative seeds travel as int32, the others as uint32: both must
    # hash like the port's wrapped 32-bit value
    return jnp.asarray([seed], jnp.int32 if seed < 0 else jnp.uint32)


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.3, 1234), (0.3, 2**31 + 7),
                                       (0.3, -5), (0.3, 2**32 - 1)])
def test_plain_attention_matches_pallas(rate, seed):
    q, k, v, m = _inputs(seed % 97)
    jargs = [jnp.asarray(x) for x in (q, k, v, m)]
    want_kernel = np.asarray(jax_fused_attention(
        *jargs, interpret=True, dropout_rate=rate,
        dropout_seed=_jax_seed(seed) if rate > 0 else None))
    want_ref = np.asarray(_attention_reference(*jargs, _jax_seed(seed), rate))
    before = dict(tops.launch_counts)
    got = tops.fused_attention(*(torch.from_numpy(x) for x in (q, k, v, m)),
                               dropout_rate=rate,
                               dropout_seed=seed if rate > 0 else None).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)
    assert tops.launch_counts == before  # CPU calls never count as launches


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**31, 2**32 - 1, -1, -2**31])
def test_keep_mask_bit_identical(seed):
    b, h, lq, lk, rate = 3, 4, 11, 13, 0.3
    want = np.asarray(_dropout_keep_mask(_jax_seed(seed), b, h, lq, lk, rate))
    got = tops.dropout_keep_mask(seed, b, h, lq, lk, rate).numpy()
    np.testing.assert_array_equal(got, want)


def test_strided_views_and_checks():
    """The layer hands over (B, L, H, Dh) projections as (B, H, L, Dh)
    views; results must not depend on the layout, and bad shapes raise."""
    q, k, v, m = _inputs(3)
    tq, tk, tv, tm = (torch.from_numpy(x) for x in (q, k, v, m))
    want = tops.fused_attention(tq, tk, tv, tm)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (tq, tk, tv)]
    got = tops.fused_attention(*views, tm)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError):
        tops.fused_attention(tq, tk, tv, tm[:, :-1])
    with pytest.raises(ValueError):
        tops.fused_attention(tq, tk, tv, tm, dropout_rate=0.1)  # no seed
