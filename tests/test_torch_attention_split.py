"""The bf16 arithmetic of the key-blocked CUDA forward (csrc/attention_blocked.cu),
emulated in numpy on the CPU and held against the JAX package's Pallas kernel
in interpret mode; and the choice between its two staging paths.

The kernel cannot run here, so its arithmetic is written out step by step
as the tensor cores and the CUDA cores carry it: bf16 q . k products
(exact in fp32) summed per 16-wide k-step and added into an fp32
accumulator; score * scale + mask rounded twice; the online softmax over
64-key blocks with the undropped running sum; each e split into
hi = bf16(e) and lo = bf16(e - hi); and hi v + lo v summed per 16-key
step into fp32. The kernel itself is held against the plain version on
the card (tests/test_torch_gpu.py, chip_smoke.py phase 21).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_hamt_tpu.ops.attention import fused_attention as jax_fused_attention
from vln_hamt_torch.ops import attention as tops

# chip_smoke.py:TOL, the forward kernel's bar against its plain version in
# bf16: 1e-5 at dropout 0, 2e-5 at 0.1 (kept values scaled by 1 / (1 - rate))
TOL = {0.0: 1e-5, 0.1: 2e-5}
SEED = 2**31 + 7
KEY_BLOCK, K_STEP = 64, 16
# chip_smoke.py:LAYOUT_LKS, the key rows phase 21 checks every head width at
LAYOUT_LKS = (1, 40, 41, 72, 73, 160, 161, 192, 193, 256, 257, 301, 514, 577, 1024)


def bf16_values(x):
    """float32 array -> the nearest bf16 values (ties to even), as float32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def _steps(a, b, width):
    """sum over the last axis of a[..., None, :] * b, in steps of ``width``:
    each step's products summed exactly (float64, exact for bf16 x bf16 and
    for the few fp32 terms here) and rounded to fp32, then added into an
    fp32 accumulator, as one m16n8k16 mma after another."""
    acc = np.zeros(a.shape[:-1] + b.shape[:-1], np.float32)
    for s in range(0, a.shape[-1], width):
        part = np.einsum("...d,nd->...n", a[..., s:s + width].astype(np.float64),
                         b[:, s:s + width].astype(np.float64))
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def emulate_bf16_forward(q, k, v, m, keep, rate, split=True):
    """The bf16 kernel's output for one (batch, head): q (Lq, Dh), k, v
    (Lk, Dh) holding bf16 values, m (Lk,), keep (Lq, Lk) or None. With
    ``split`` off, P is rounded once to bf16 instead (not the kernel)."""
    lq, dh = q.shape
    dp = -(-dh // K_STEP) * K_STEP  # Dh padded to a multiple of 16 with zeros
    q, k = (np.pad(x, ((0, 0), (0, dp - dh))) for x in (q, k))
    scale = np.float32(1.0 / dh ** 0.5)
    mrow = np.full(lq, -np.inf, np.float32)
    lrow = np.zeros(lq, np.float32)
    o = np.zeros((lq, dh), np.float32)
    for k0 in range(0, k.shape[0], KEY_BLOCK):
        kb, vb = k[k0:k0 + KEY_BLOCK], v[k0:k0 + KEY_BLOCK]
        s = _steps(q, kb, K_STEP)
        s = (s * scale).astype(np.float32) + m[k0:k0 + len(kb)]  # two roundings
        mn = np.maximum(mrow, s.max(axis=1))
        a = np.exp(mrow - mn).astype(np.float32)
        e = np.exp(s - mn[:, None]).astype(np.float32)
        lrow = (lrow * a + e.sum(axis=1, dtype=np.float32)).astype(np.float32)
        mrow = mn
        if keep is not None:
            e = np.where(keep[:, k0:k0 + len(kb)], e, np.float32(0))
        hi = bf16_values(e)
        parts = (hi, bf16_values(e - hi)) if split else (hi,)
        o = (o * a[:, None]).astype(np.float32)
        for j in range(0, len(kb), K_STEP):  # per 16-key step: hi v, then lo v
            for part in parts:
                o = (o + _steps(part[:, None, j:j + K_STEP], vb[j:j + K_STEP].T, K_STEP)[:, 0]
                     ).astype(np.float32)
    inv_keep = np.float32(1.0 / (1.0 - rate))
    return o * (inv_keep / lrow)[:, None]


def _inputs(b, h, lq, lk, dh, seed):
    """bf16 values from numpy. Lane 0 has every key at -10000, where the
    fp32 step is 2^-10: the Pallas kernel on the CPU rounds score * scale
    + mask once (XLA fuses it), the port twice, as torch's plain version
    does, and one step there moves an output by about 2e-4. So
    lane 0's scores are powers of two -- q rows one-hot, k entries 0 or
    +-2^n -- whose product with the scale is exact in fp32, and both
    orders of rounding agree; its softmax and P still vary over the keys.
    Lane 1 is random, with a random mask whose last key is dropped."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, dh)).astype(np.float32) for n in (lq, lk, lk))
    q[0] = 0.0
    rows = np.arange(lq)
    q[0][:, rows, rows % dh] = rng.choice([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], (h, lq))
    k[0] = rng.choice([-1.0, 1.0], k[0].shape) * 2.0 ** rng.integers(-2, 2, k[0].shape)
    k[0][rng.random(k[0].shape) < 0.2] = 0.0
    m = np.where(rng.random((b, lk)) < 0.8, 0.0, -10000.0).astype(np.float32)
    m[0] = -10000.0
    m[:, -1] = -10000.0
    return (*(bf16_values(x) for x in (q, k, v)), m)


# (H, Lq, Lk, Dh) of tests/test_torch_attention_shapes.py's key-blocked
# shapes: the --tiny ViT's Dh 12 at 301 keys, Dh 48 at the 384 x 384
# ViT's 577, Dh 80 at the long text's 300; two lanes each
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(2, 17, 301, 12), (2, 9, 577, 48), (2, 33, 300, 80)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_split_arithmetic_matches_pallas(shape, rate, capsys):
    """The emulated bf16 kernel against the Pallas kernel (fp32 on the same
    bf16 values) at chip_smoke.py's bars; the same emulation with P rounded
    once to bf16 is printed beside it, not asserted (PERF.md records it as
    the reason for the split)."""
    h, lq, lk, dh = shape
    b = 2
    assert tops.fwd_kernel(lk, dh) == "attention_fwd_blocked"
    q, k, v, m = _inputs(b, h, lq, lk, dh, seed=lk + dh)
    want = np.asarray(jax_fused_attention(
        *(jnp.asarray(x) for x in (q, k, v, m)), interpret=True, dropout_rate=rate,
        dropout_seed=jnp.asarray([SEED], jnp.uint32) if rate > 0 else None))
    keep = (tops.dropout_keep_mask(SEED, b, h, lq, lk, rate).numpy() if rate > 0
            else np.ones((b, h, lq, lk), bool))
    errs = {}
    for split in (True, False):
        got = np.stack([np.stack([
            emulate_bf16_forward(q[i, j], k[i, j], v[i, j], m[i], keep[i, j] if rate > 0
                                 else None, rate, split) for j in range(h)]) for i in range(b)])
        assert np.isfinite(got).all()
        errs[split] = float(np.abs(got - want).max())
    with capsys.disabled():
        print(f"\nbf16 forward {shape} rate {rate}: max abs err against Pallas, P split "
              f"{errs[True]:.3e}, P rounded once {errs[False]:.3e} (bar {TOL[rate]})")
    assert errs[True] <= TOL[rate], errs


def _layer_view(l, dh, dtype):
    """(B, L, 3 * Dh) as (B, 3, L, Dh): heads Dh elements apart, rows 3 Dh
    apart, as chip_smoke.py phase 21 builds the layer's views."""
    return torch.empty(2, l, 3 * dh, dtype=dtype).view(2, l, 3, dh).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staging_choice_follows_the_16_byte_rule(dtype):
    """Every head width 1..128 at LAYOUT_LKS: q, k and v go by 16-byte
    copies exactly where all three pass _misalignment -- for these views,
    where a head (Dh elements) is a multiple of 16 bytes -- and by element
    loads where any of them does not, such as a view one element past a
    16-byte boundary."""
    elt = torch.empty((), dtype=dtype).element_size()
    for dh in range(1, tops.MAX_HEAD_DIM + 1):
        for lk in LAYOUT_LKS:
            q, k, v = _layer_view(9, dh, dtype), _layer_view(lk, dh, dtype), _layer_view(
                lk, dh, dtype)
            rule = all(tops._misalignment(n, t) is None for n, t in (("q", q), ("k", k),
                                                                    ("v", v)))
            assert tops.blocked_staging(q, k, v) == int(rule), (dh, lk)
            assert rule == ((dh * elt) % 16 == 0), (dh, lk)
    flat = torch.empty(1 + 2 * 301 * 4 * 64, dtype=dtype)
    shifted = flat[1:].view(2, 301, 4, 64).transpose(1, 2)
    aligned = torch.empty(2, 301, 4, 64, dtype=dtype).transpose(1, 2)
    assert tops.blocked_staging(aligned, aligned, aligned) == 1
    for i in range(3):
        views = [aligned] * 3
        views[i] = shifted
        assert tops.blocked_staging(*views) == 0, i
