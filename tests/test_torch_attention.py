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


def _inputs(seed, b=2, h=3, lq=6, lk=9, dh=16, masked_rows=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, lq, dh)).astype(np.float32)
    k = rng.standard_normal((b, h, lk, dh)).astype(np.float32)
    v = rng.standard_normal((b, h, lk, dh)).astype(np.float32)
    m = np.where(rng.random((b, lk)) < 0.7, 0.0, -10000.0).astype(np.float32)
    if masked_rows:
        # every key of batch element 0 at -10000; q and k on a grid of
        # 1/4, so the scores and their rounding next to -10000 (an fp32
        # step of about 1e-3) are exact in any summation order
        m[0] = -10000.0
        q, k = (np.round(x * 4) / 4 for x in (q, k))
    return q, k, v, m


def _jax_seed(seed):
    # negative seeds travel as int32, the others as uint32: both must
    # hash like the port's wrapped 32-bit value
    return jnp.asarray([seed], jnp.int32 if seed < 0 else jnp.uint32)


# (rate, seed, shape and mask of _inputs): seeds across the int32 and
# uint32 wraps, then the cases the card kernel's query blocks could get
# wrong -- one key, a ragged last query block, batch elements whose keys
# all read -10000 -- with dropout off and with a seed above 2**31
_PLAIN_CASES = [pytest.param(rate, seed, {}, id=f"{rate}-{seed}") for rate, seed in
                [(0.0, 0), (0.3, 1234), (0.3, 2**31 + 7), (0.3, -5), (0.3, 2**32 - 1)]] + [
    pytest.param(rate, seed, shape, id=f"{name}-{rate}")
    for name, shape in [("lk1", dict(lq=1, lk=1)), ("ragged", dict(lq=33, lk=65)),
                        ("masked_rows", dict(lq=65, lk=65, masked_rows=True))]
    for rate, seed in [(0.0, 0), (0.3, 2**31 + 7)]]


@pytest.mark.parametrize("rate,seed,shape", _PLAIN_CASES)
def test_plain_attention_matches_pallas(rate, seed, shape):
    q, k, v, m = _inputs(seed % 97, **shape)
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


def _layer_view(dtype=torch.float32, b=2, l=5, h=3, dh=16, offset=0):
    """The (B, H, L, Dh) view of a (B, L, H * Dh) projection, as the layer
    hands it to the kernel, starting ``offset`` elements into its buffer."""
    buf = torch.zeros(offset + b * l * h * dh, dtype=dtype)
    return buf[offset:].view(b, l, h, dh).transpose(1, 2)


#: head widths past the whole-row kernels' (the --tiny ViT's 12, and 48
#: and 80), which the key-blocked kernels take
BLOCKED_HEAD_DIMS = (12, 48, 80)
#: key rows past the whole-row kernels' 256: the ViT at 248 x 330 (301)
#: and at 384 x 384 (577)
LONG_KEYS = (257, 577)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", tops.FWD_HEAD_DIMS + BLOCKED_HEAD_DIMS)
def test_kernel_layout_checks_accept_layer_views(dtype, dh):
    """The forward kernels' argument checks, run on CPU tensors (no card
    needed): the layer's strided views at every head width the JAX CLIs
    run pass, as do Lk = 256, 257 and 577 and a size-1 batch whose stride
    is unused; the whole-row kernel takes Lk = 256 at its head widths up
    to Dh 64, the key-blocked one the rest. At Dh 12 in bf16 the layer's
    heads lie 24 bytes apart, which only the key-blocked kernel reads."""
    x = _layer_view(dtype, dh=dh)
    tops.check_fwd_layout(x, x, x)
    for lk in (tops.FWD_MAX_LK,) + LONG_KEYS:
        long_k = _layer_view(dtype, l=lk, dh=dh)
        tops.check_fwd_layout(x, long_k, long_k)
        tiered = dh in tops.FWD_HEAD_DIMS and lk <= tops.FWD_MAX_LK and dh < 128
        assert tops.fwd_kernel(lk, dh) == "attention_fwd" + ("" if tiered else "_blocked")
    one = torch.zeros(15 * dh, dtype=dtype).as_strided((1, 3, 5, dh), (7, 5 * dh, dh, 1))
    tops.check_fwd_layout(one, one, one)


@pytest.mark.parametrize("case,match", [
    ("fp32_offset", "16-byte boundary"),  # 4 bytes into a 16-byte word
    ("bf16_offset", "16-byte boundary"),  # 8 bytes into a 16-byte word
    ("row_stride", "along dim 2"),  # rows 17 floats apart
    ("head_stride", "along dim 1"),  # heads 2 bf16 values apart
    ("head_dim", "head widths"),  # Dh 144 is past both kernels' 128
])
def test_kernel_layout_checks_raise(case, match):
    """Views the whole-row forward kernel's 16-byte loads cannot take, and
    a head width past 128, raise a ValueError that names the problem,
    before anything is launched."""
    q = k = _layer_view()
    if case == "fp32_offset":
        q = _layer_view(offset=1)
    elif case == "bf16_offset":
        q = k = _layer_view(torch.bfloat16, offset=4)
    elif case == "row_stride":
        k = torch.zeros(1000).as_strided((2, 3, 5, 16), (400, 100, 17, 1))
    elif case == "head_stride":
        q = k = torch.zeros(960, dtype=torch.bfloat16).as_strided((2, 3, 5, 16), (480, 2, 48, 1))
    else:
        q = k = _layer_view(dh=144)
    with pytest.raises(ValueError, match=match):
        tops.check_fwd_layout(q, k, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", tops.FWD_HEAD_DIMS + BLOCKED_HEAD_DIMS)
def test_bwd_layout_checks_accept_layer_views(dtype, dh):
    """The backward kernels' argument checks, on CPU tensors: the layer's
    views of q, k, v at every head width the JAX CLIs run, with the output
    cotangent as autograd hands it over (the (B, H, Lq, Dh) view of the
    fp32 (B, Lq, H, Dh) gradient) or contiguous, Lk = 256, 257 and 577,
    and a size-1 batch whose stride is unused; the whole-row backward
    takes Dh 128 up to 160 keys, the key-blocked one the rest."""
    x = _layer_view(dtype, dh=dh)
    g = _layer_view(dh=dh)
    tops.check_bwd_layout(x, x, x, g)
    tops.check_bwd_layout(x, x, x, g.contiguous())
    for lk in (tops.FWD_MAX_LK,) + LONG_KEYS:
        long_k = _layer_view(dtype, l=lk, dh=dh)
        tops.check_bwd_layout(x, long_k, long_k, g)
        tiered = dh in tops.FWD_HEAD_DIMS and lk <= tops.FWD_MAX_LK and dh < 128
        assert tops.bwd_kernel(lk, dh) == "attention_bwd" + ("" if tiered else "_blocked")
    assert tops.bwd_kernel(160, 128) == "attention_bwd"
    assert tops.bwd_kernel(161, 128) == "attention_bwd_blocked"
    one = torch.zeros(15 * dh, dtype=dtype).as_strided((1, 3, 5, dh), (7, 5 * dh, dh, 1))
    tops.check_bwd_layout(one, one, one, g[:1])


@pytest.mark.parametrize("case,match", [
    ("q_offset", "16-byte boundary"),  # q 4 bytes into a 16-byte word
    ("g_offset", "16-byte boundary"),  # the cotangent 4 bytes in
    ("row_stride", "along dim 2"),  # k rows 17 floats apart
    ("head_dim", "head widths"),  # Dh 144 is past both kernels' 128
])
def test_bwd_layout_checks_raise(case, match):
    """Inputs the whole-row backward kernel's 16-byte loads cannot take,
    and a head width past 128, raise a ValueError that names the problem,
    before anything is launched."""
    q = k = _layer_view()
    g = _layer_view()
    if case == "q_offset":
        q = _layer_view(offset=1)
    elif case == "g_offset":
        g = _layer_view(offset=1)
    elif case == "row_stride":
        k = torch.zeros(1000).as_strided((2, 3, 5, 16), (400, 100, 17, 1))
    else:
        q = k = _layer_view(dh=144)
        g = _layer_view(dh=144)
    with pytest.raises(ValueError, match=match):
        tops.check_bwd_layout(q, k, k, g)


@pytest.mark.parametrize("case", ["layer_view", "contiguous", "misaligned", "bf16", "dh_stride"])
def test_bwd_cotangent_copied_only_when_unreadable(case):
    """The wrapper reads the layer's fp32 cotangent in place and copies
    any other (a misaligned base, another float type, a Dh stride other
    than 1) into a layout the kernel takes, with the same values."""
    g = _layer_view()
    g.copy_(torch.from_numpy(np.random.default_rng(4).standard_normal(g.shape)
                             .astype(np.float32)))
    if case == "contiguous":
        g = g.contiguous()
    elif case == "misaligned":
        g = _layer_view(offset=1).copy_(g)
    elif case == "bf16":
        g = g.to(torch.bfloat16)
    elif case == "dh_stride":
        g = g.transpose(2, 3).contiguous().transpose(2, 3)
    got = tops._kernel_cotangent(g)
    tops.check_bwd_layout(got, got, got, got)
    assert got.dtype == torch.float32 and torch.equal(got, g.float())
    in_place = case in ("layer_view", "contiguous")
    assert (got.data_ptr() == g.data_ptr()) == in_place


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


# ------------------------------------------------------------ backward
# as tests/test_ops_vision.py:92-98: fp32 gradients of O(1) inputs
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _jax_grads(fn, q, k, v, m, g):
    """(dq, dk, dv, dm) of fn(q, k, v, m) for the cotangent g."""
    import jax

    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v, m)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.3, 1234), (0.3, 2**31 + 7),
                                       (0.3, -5), (0.3, 2**32 - 1)])
def test_backward_matches_jax(rate, seed):
    """The backward twin and the autograd Function (CPU) against jax.grad
    of the XLA reference and against the Pallas custom VJP in interpret
    mode, which runs _attn_bwd_kernel; dm included."""
    q, k, v, m = _inputs(seed % 89 + 1)
    g = np.random.default_rng(seed % 7).standard_normal(q.shape).astype(np.float32)
    js = _jax_seed(seed)
    want_ref = _jax_grads(lambda *a: _attention_reference(*a, js, rate), q, k, v, m, g)
    want_kernel = _jax_grads(lambda *a: jax_fused_attention(
        *a, interpret=True, dropout_rate=rate, dropout_seed=js if rate > 0 else None),
        q, k, v, m, g)

    tq, tk, tv, tm, tg = (torch.from_numpy(x) for x in (q, k, v, m, g))
    twin = tops.attention_bwd_reference(tq, tk, tv, tm, tg, seed, rate)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv, tm)]
    before = dict(tops.launch_counts)
    out = tops.fused_attention(*leaves, dropout_rate=rate,
                               dropout_seed=seed if rate > 0 else None)
    fn_grads = torch.autograd.grad(out, leaves, tg)
    assert tops.launch_counts == before
    for name, a, b_, w1, w2 in zip("qkvm", twin, fn_grads, want_ref, want_kernel):
        for got in (a, b_):
            np.testing.assert_allclose(got.numpy(), w1, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=name)
            np.testing.assert_allclose(got.numpy(), w2, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=name)


def test_backward_through_strided_views():
    """The layer's (B, L, H, Dh) projections seen as (B, H, L, Dh) views:
    gradients land in the projections' layout and equal those of
    contiguous inputs."""
    q, k, v, m = _inputs(5)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(q.shape).astype(np.float32))
    grads = []
    for strided in (False, True):
        leaves = [torch.from_numpy(x.transpose(0, 2, 1, 3).copy() if strided else x)
                  .requires_grad_() for x in (q, k, v)]
        args = [x.transpose(1, 2) if strided else x for x in leaves]
        out = tops.fused_attention(*args, torch.from_numpy(m), dropout_rate=0.3,
                                   dropout_seed=77)
        (out * g).sum().backward()
        grads.append([x.grad.transpose(1, 2) if strided else x.grad for x in leaves])
    for a, b_ in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-6, atol=1e-7)


def test_dropout_seed_must_be_a_host_int():
    q, k, v, m = (torch.from_numpy(x) for x in _inputs(2))
    with pytest.raises(TypeError, match="host int"):
        tops.fused_attention(q, k, v, m, dropout_rate=0.1, dropout_seed=torch.tensor(3))
