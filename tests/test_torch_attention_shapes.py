"""The shapes past the whole-row CUDA kernels -- more than 256 keys, head
widths outside 16, 32, 64 and 128 -- which the key-blocked kernels take
on the card: the port's attention (its plain twins, on the CPU) against
the JAX package's Pallas kernels in interpret mode, forward and
gradients in q, k, v and the mask, and the port's ViT against the JAX
package's at the image pretraining store's 248 x 330 (301 tokens). The
key-blocked kernels themselves are held against the same twins on the
card (tests/test_torch_gpu.py, chip_smoke.py phase 21)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vision import jax_vit, port_vit
from vln_hamt_tpu.ops.attention import fused_attention as jax_fused_attention
from vln_hamt_torch.ops import attention as tops

# the repository's forward bar (ROADMAP "Tolerances") and the gradients'
# of tests/test_ops_vision.py:92-98
FWD_ATOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
SEED = 2**31 + 7


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(b, h, lq, lk, dh, seed=0):
    """q, k, v, a 0 / -10000 mask whose last key is dropped, and an output
    cotangent, from numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, dh)).astype(np.float32) for n in (lq, lk, lk))
    m = np.where(rng.random((b, lk)) < 0.8, 0.0, -10000.0).astype(np.float32)
    m[:, -1] = -10000.0
    g = rng.standard_normal((b, h, lq, dh)).astype(np.float32)
    return q, k, v, m, g


# (B, H, Lq, Lk, Dh): the --tiny ViT's Dh 12 at the ViT's 301 keys, Dh 48
# at the 384 x 384 ViT's 577, Dh 80 at the long text's 300
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(1, 2, 17, 301, 12), (1, 2, 9, 577, 48),
                                   (2, 2, 33, 300, 80)], ids=lambda s: "x".join(map(str, s)))
def test_attention_past_the_whole_row_kernels_matches_pallas(shape, rate):
    """Forward and the gradients in q, k, v and the mask against the
    Pallas kernels' custom VJP (interpret mode) at shapes that route to
    the key-blocked kernels on the card; dropout with one seed."""
    b, h, lq, lk, dh = shape
    assert tops.fwd_kernel(lk, dh) == "attention_fwd_blocked"
    assert tops.bwd_kernel(lk, dh) == "attention_bwd_blocked"
    q, k, v, m, g = _inputs(*shape, seed=lk + dh)
    seed = SEED if rate > 0 else None

    def jax_fn(*a):
        return jax_fused_attention(*a, interpret=True, dropout_rate=rate,
                                   dropout_seed=None if seed is None else
                                   jnp.asarray([seed], jnp.uint32))

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (q, k, v, m)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, m)]
    got = tops.fused_attention(*leaves, dropout_rate=rate, dropout_seed=seed)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    for name, x, w in zip("qkvm", grads, want_grads):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_vit_at_the_store_size_matches_jax():
    """The image pretraining CLI's ViT under --transform none sees the
    store's 248 x 330 records: 15 x 20 patches and the class token, 301
    keys, at hidden 48 over 4 heads (Dh 12, as --tiny's), one layer,
    through the ViT converter, on 2 images."""
    kw = dict(img_size=(248, 330), patch_size=16, hidden_size=48, num_layers=1, num_heads=4,
              num_classes=10)
    model, params = jax_vit(kw)
    vit = port_vit(kw, params)
    assert vit.config.num_patches + 1 == 301
    assert tops.fwd_kernel(301, 12) == "attention_fwd_blocked"
    x = np.random.default_rng(3).normal(size=(2, 248, 330, 3)).astype(np.float32)
    jf, jl = model.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        f, logits = vit(torch.from_numpy(x))
    assert f.shape == (2, 48) and logits.shape == (2, 10)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0, atol=FWD_ATOL)
