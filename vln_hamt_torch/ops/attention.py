"""Fused masked attention: the hand-written CUDA kernel and its plain twin.

``fused_attention`` is the port of ``vln_hamt_tpu/ops/attention.py:
fused_attention`` (forward only). On a CUDA tensor it launches the
kernel in ``csrc/attention.cu``, built with ``nvcc`` for ``sm_90a`` at
first use into ``vln_hamt_torch/build/`` (keyed by a hash of the source)
and bound through its plain C interface with ``ctypes``. On a CPU tensor
it runs :func:`attention_reference`, the same math in torch, which is
also the kernel's check. It never falls back from one to the other.

Both compute ``dropout(softmax(q k^T / sqrt(Dh) + m)) v`` in fp32 with
the TPU kernel's counter-hash dropout, so the keep mask is bit-identical
to ``vln_hamt_tpu/ops/attention.py:_dropout_keep_mask``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "attention.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-block shared-memory limit of an H100 (227 KB)
MAX_SMEM_BYTES = 232448

#: kernel launches per wrapper (plain-version calls are not counted);
#: a run resets and reads these to show which path it took
launch_counts: Dict[str, int] = {"attention_fwd": 0}

_MASK32 = 0xFFFFFFFF


# ------------------------------------------------------------ plain twin
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 on int64 tensors holding uint32 values.

    The constant is split into 16-bit halves so that no product exceeds
    2**48: torch's uint32 support is thin and int64 overflow is not
    guaranteed to wrap.
    """
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _splitmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def dropout_keep_mask(seed: int, b: int, h: int, lq: int, lk: int,
                      rate: float, device=None) -> torch.Tensor:
    """(B, H, Lq, Lk) bool keep mask of the kernel's counter hash."""
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    i = ar(b)[:, None, None, None]
    j = ar(h)[None, :, None, None]
    row = ar(lq)[None, None, :, None]
    col = ar(lk)[None, None, None, :]
    idx = (row * lk + col) & _MASK32
    key = (int(seed) & _MASK32) + _mul32(i, 0x9E3779B1) + _mul32(j, 0x85EBCA77)
    bits = _splitmix32((key & _MASK32) ^ _splitmix32(idx))
    return bits >= _threshold(rate)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        m: torch.Tensor, seed: int = 0,
                        rate: float = 0.0) -> torch.Tensor:
    """Plain torch twin of the kernel: (B, H, Lq, Dh) float32."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / dh ** 0.5) + m.float()[:, None, None, :]
    p = torch.softmax(scores, dim=-1)
    if rate > 0.0:
        keep = dropout_keep_mask(seed, b, h, lq, lk, rate, device=q.device)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())


# ----------------------------------------------------------- the kernel
def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA attention kernel cannot be built")
    return nvcc


def build_library() -> Dict[str, object]:
    """Compile ``csrc/attention.cu`` unless a build of this source exists.

    Returns ``{"path", "seconds", "ptxas"}``: the shared library, the
    nvcc wall time of this call (0.0 when the build was already there)
    and the ``-Xptxas -v`` register / shared-memory report.
    """
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"attention_{digest}.so"
    report = BUILD_DIR / f"attention_{digest}.ptxas.txt"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "ptxas": report.read_text()}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    report.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders agree on one file
    return {"path": str(lib), "seconds": seconds, "ptxas": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library()["path"])
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hamt_attention_fwd.argtypes = (
        [p, p, p, p, p, i, i, i, i, i, i] + [ll] * 14
        + [ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
           i, p])
    lib.hamt_attention_fwd.restype = i
    lib.hamt_attention_smem_bytes.argtypes = [i, i]
    lib.hamt_attention_smem_bytes.restype = ll
    return lib


def _check_inputs(q, k, v, m):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or m.dim() != 2:
        raise ValueError("expected q, k, v of rank 4 (B, H, L, Dh) and m (B, Lk)")
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, dh) or v.shape != (b, h, lk, dh):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if m.shape != (b, lk):
        raise ValueError(f"mask shape {tuple(m.shape)} != {(b, lk)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    return b, h, lq, lk, dh


def _launch(q, k, v, m, seed: int, rate: float) -> torch.Tensor:
    b, h, lq, lk, dh = _check_inputs(q, k, v, m)
    dtypes = {torch.float32: 0, torch.bfloat16: 1}
    if q.dtype not in dtypes:
        raise TypeError(f"CUDA attention takes float32 or bfloat16, got {q.dtype}")
    devices = {t.device for t in (q, k, v, m)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along Dh, strides {t.stride()}")
    m = m.to(torch.float32)
    # output stored (B, Lq, H, Dh) so the layer's merge of heads is free;
    # returned as the (B, H, Lq, Dh) view of the public layout
    out = torch.empty((b, lq, h, dh), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or lk == 0:
        return out.zero_().permute(0, 2, 1, 3)
    lib = _library()
    smem = lib.hamt_attention_smem_bytes(lk, dh)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"attention over Lk={lk}, Dh={dh} needs {smem} B of "
                         f"shared memory per block (limit {MAX_SMEM_BYTES})")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.hamt_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), out.data_ptr(),
        dtypes[q.dtype], b, h, lq, lk, dh,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        m.stride(0), m.stride(1),
        out.stride(0), out.stride(2), out.stride(1),
        1.0 / dh ** 0.5, int(seed) & _MASK32, _threshold(rate),
        1.0 / (1.0 - rate), int(rate > 0.0), stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    launch_counts["attention_fwd"] += 1
    return out.permute(0, 2, 1, 3)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    additive_mask: torch.Tensor, dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None) -> torch.Tensor:
    """(B, H, Lq, Dh) float32 attention output.

    ``q`` (B, H, Lq, Dh), ``k``/``v`` (B, H, Lk, Dh) may be strided views
    (Dh contiguous); ``additive_mask`` (B, Lk) holds 0 / -10000. With
    ``dropout_rate > 0`` the probabilities are dropped by the counter
    hash of ``dropout_seed`` (a 32-bit value; negative int32 seeds wrap
    as in the TPU kernel). CPU tensors take :func:`attention_reference`;
    CUDA tensors launch the kernel or raise.
    """
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    seed = 0 if dropout_seed is None else int(dropout_seed)
    if q.device.type == "cpu":
        _check_inputs(q, k, v, additive_mask)
        return attention_reference(q, k, v, additive_mask, seed, dropout_rate)
    if q.device.type == "cuda":
        return _launch(q, k, v, additive_mask, seed, dropout_rate)
    raise ValueError(f"no attention kernel for device {q.device}")
