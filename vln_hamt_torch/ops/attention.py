"""Fused masked attention: the hand-written CUDA kernels and their plain twins.

``fused_attention`` is the port of ``vln_hamt_tpu/ops/attention.py:
fused_attention``: one ``torch.autograd.Function`` whose forward and
backward replace the two Pallas kernels and the custom VJP that joins
them. On CUDA tensors it launches, for the forward, the whole-row kernel
of ``csrc/attention.cu`` or the key-blocked one of
``csrc/attention_blocked.cu``, and for the backward ``csrc/attention_bwd.cu``
or ``csrc/attention_blocked_bwd.cu``, each built with ``nvcc`` for
``sm_90a`` at first use into ``vln_hamt_torch/build/`` (keyed by a hash
of its sources) and bound through its plain C interface with ``ctypes``.
The whole-row kernels take the shapes of every preset (Dh 16, 32, 64 or
128, Lk <= 256, their tiles within a block's shared memory); the
key-blocked ones every other shape up to Dh 128 (:func:`fwd_kernel`,
:func:`bwd_kernel`), so the card takes every shape the Pallas kernels
take up to that width. On CPU tensors it runs the plain twins
:func:`attention_reference` and :func:`attention_bwd_reference`, the same
math in torch, which are also the kernels' checks. It never falls back
from one to the other.

Forward: ``dropout(softmax(q k^T / sqrt(Dh) + m)) v`` in fp32 with the
TPU kernel's counter-hash dropout, so the keep mask is bit-identical to
``vln_hamt_tpu/ops/attention.py:_dropout_keep_mask``. Backward: dq, dk,
dv and the mask cotangent dm, recomputing p with the same keep mask.
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
from typing import Dict, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
#: one shared library per kernel source; the headers are part of each hash
SOURCES = {"attention_fwd": CSRC / "attention.cu", "attention_bwd": CSRC / "attention_bwd.cu",
           "attention_fwd_blocked": CSRC / "attention_blocked.cu",
           "attention_bwd_blocked": CSRC / "attention_blocked_bwd.cu"}
HEADERS = (CSRC / "attention_common.cuh", CSRC / "attention_blocked.cuh")
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-block shared-memory limit of an H100 (227 KB)
MAX_SMEM_BYTES = 232448

#: kernel launches per kernel (plain-version calls are not counted), one
#: per wrapper call that launches it; a run resets and reads these to
#: show which path it took
launch_counts: Dict[str, int] = {"attention_fwd": 0, "attention_bwd": 0,
                                 "attention_fwd_blocked": 0, "attention_bwd_blocked": 0}
#: the key-blocked kernels, which no preset's shapes reach
BLOCKED = ("attention_fwd_blocked", "attention_bwd_blocked")

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


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            m: torch.Tensor, g: torch.Tensor, seed: int = 0,
                            rate: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """Plain torch twin of the backward kernel, the recompute formula
    written out: (dq, dk, dv) in the input dtype, dm (B, Lk) float32.

    ``g`` is the cotangent of :func:`attention_reference`'s output.
    """
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    scale = 1.0 / dh ** 0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale + m.float()[:, None, None, :]
    p = torch.softmax(scores, dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)  # cotangent of the dropped p
    if rate > 0.0:
        keep = dropout_keep_mask(seed, b, h, lq, lk, rate, device=q.device)
        inv = 1.0 / (1.0 - rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    else:
        pd = p
    dv = torch.einsum("bhqk,bhqd->bhkd", pd, gf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))  # softmax VJP
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dm = ds.sum(dim=(1, 2))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dm


# ---------------------------------------------------------- the kernels
def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA attention kernels cannot be built")
    return nvcc


def build_library(name: str) -> Dict[str, object]:
    """Compile the source of kernel ``name`` (a key of :data:`SOURCES`)
    unless a build of these sources exists.

    Returns ``{"path", "seconds", "ptxas"}``: the shared library, the
    nvcc wall time of this call (0.0 when the build was already there)
    and the ``-Xptxas -v`` register / shared-memory report. Builds of
    different kernels may run at the same time (one nvcc each).
    """
    source = SOURCES[name]
    text = source.read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}_{digest}.so"
    report = BUILD_DIR / f"{source.stem}_{digest}.ptxas.txt"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "ptxas": report.read_text()}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
    report.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders agree on one file
    return {"path": str(lib), "seconds": seconds, "ptxas": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library(name)["path"])
    p, i, ll, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_uint32, ctypes.c_float)
    if name == "attention_fwd":
        lib.hamt_attention_fwd.argtypes = (
            [p, p, p, p, p, i, i, i, i, i, i] + [ll] * 14 + [f32, u32, u32, f32, i, p])
        lib.hamt_attention_fwd.restype = i
        lib.hamt_attention_smem_bytes.argtypes = [i, i]
        lib.hamt_attention_smem_bytes.restype = ll
    elif name == "attention_bwd":
        lib.hamt_attention_bwd.argtypes = (
            [p] * 12 + [i] * 6 + [ctypes.POINTER(ll), f32, u32, u32, f32, i, p])
        lib.hamt_attention_bwd.restype = i
        lib.hamt_attention_bwd_smem_bytes.argtypes = [i, i]
        lib.hamt_attention_bwd_smem_bytes.restype = ll
        for fn in (lib.hamt_attention_bwd_query_blocks, lib.hamt_attention_bwd_needs_scratch):
            fn.argtypes = [i]
            fn.restype = i
    elif name == "attention_fwd_blocked":
        lib.hamt_attention_fwd_blocked.argtypes = (
            [p] * 5 + [i] * 6 + [ctypes.POINTER(ll), f32, u32, u32, f32, i, i, p])
        lib.hamt_attention_fwd_blocked.restype = i
        lib.hamt_attention_fwd_blocked_occupancy.argtypes = [i, i, ctypes.POINTER(ll)]
        lib.hamt_attention_fwd_blocked_occupancy.restype = i
    else:
        lib.hamt_attention_bwd_blocked.argtypes = (
            [p] * 13 + [i] * 6 + [ctypes.POINTER(ll), f32, u32, u32, f32, i, i, p])
        lib.hamt_attention_bwd_blocked.restype = i
        lib.hamt_attention_blocked_width.argtypes = [i]
        lib.hamt_attention_blocked_width.restype = i
        lib.hamt_attention_bwd_blocked_key_blocks.argtypes = [i, i]
        lib.hamt_attention_bwd_blocked_key_blocks.restype = i
        lib.hamt_attention_bwd_blocked_occupancy.argtypes = [i, i, i, ctypes.POINTER(ll)]
        lib.hamt_attention_bwd_blocked_occupancy.restype = i
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


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head widths the whole-row kernels are instantiated for, and their
#: longest key row (the scores stay in registers: 8 lanes x 32 columns)
FWD_HEAD_DIMS = (16, 32, 64, 128)
FWD_MAX_LK = 256
#: the longest key row each whole-row kernel takes, by head width, where
#: its tiles would pass MAX_SMEM_BYTES before FWD_MAX_LK (K and V at pitch
#: Dh + 4 in shared memory; ``chip_smoke.py`` holds both limits against the
#: libraries' ``hamt_attention_smem_bytes`` and
#: ``hamt_attention_bwd_smem_bytes``)
FWD_SMEM_MAX_LK = {128: 192}
BWD_SMEM_MAX_LK = {128: 160}
#: the widest head the kernels take (in shared memory the key-blocked
#: backward and the fp32 forward pad Dh to the next of FWD_HEAD_DIMS, the
#: bf16 forward to the next multiple of 16); no JAX CLI configuration
#: reaches past it
MAX_HEAD_DIM = 128


def _check_head_dim(kernel: str, dh: int) -> None:
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"the {kernel} takes head widths up to {MAX_HEAD_DIM}, got Dh={dh}")


def _whole_row(lk: int, dh: int, smem_max_lk: Dict[int, int]) -> bool:
    return dh in FWD_HEAD_DIMS and lk <= smem_max_lk.get(dh, FWD_MAX_LK)


def fwd_kernel(lk: int, dh: int) -> str:
    """The forward kernel (a key of :data:`launch_counts`) a call with Lk
    keys at head width Dh launches: the whole-row kernel where it takes
    the shape (Dh one of :data:`FWD_HEAD_DIMS`, Lk <= :data:`FWD_MAX_LK`,
    and <= 192 at Dh 128, :data:`FWD_SMEM_MAX_LK`), the key-blocked one up
    to :data:`MAX_HEAD_DIM` otherwise; raises past it."""
    _check_head_dim("attention kernel", dh)
    return "attention_fwd" if _whole_row(lk, dh, FWD_SMEM_MAX_LK) else "attention_fwd_blocked"


def bwd_kernel(lk: int, dh: int) -> str:
    """The backward kernel a call with Lk keys at head width Dh launches,
    by :func:`fwd_kernel`'s rule with the backward's limits
    (:data:`BWD_SMEM_MAX_LK`): at Dh 128 the whole-row backward takes up
    to 160 keys."""
    _check_head_dim("attention backward kernel", dh)
    return "attention_bwd" if _whole_row(lk, dh, BWD_SMEM_MAX_LK) else "attention_bwd_blocked"


def _misalignment(name: str, t: torch.Tensor) -> Optional[str]:
    """Why the whole-row kernels' 16-byte loads cannot read ``t`` as it
    lies, or None: its base address and every batch, head and row stride
    must be multiples of 16 bytes (strides of size-1 dimensions are never
    used)."""
    if t.data_ptr() % 16:
        return f"{name} starts {t.data_ptr() % 16} bytes past a 16-byte boundary"
    for dim in range(3):
        nbytes = t.stride(dim) * t.element_size()
        if t.shape[dim] > 1 and nbytes % 16:
            return (f"{name}'s stride along dim {dim} is {nbytes} bytes, "
                    f"not a multiple of 16 (strides {t.stride()})")
    return None


def blocked_staging(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """How the key-blocked kernels stage q, k and v: 1, all three by
    16-byte ``cp.async``, where all three pass the 16-byte rule of
    :func:`_misalignment`; 0, all three by element loads, which take any
    layout with a unit stride on Dh (the bf16 Dh 12 heads 24 bytes apart
    of a (B, L, H * 12) projection). Reads only addresses and strides."""
    return int(all(_misalignment(name, t) is None for name, t in (("q", q), ("k", k), ("v", v))))


def _check_alignment(tensors: Dict[str, torch.Tensor]) -> None:
    for name, t in tensors.items():
        problem = _misalignment(name, t)
        if problem:
            raise ValueError(problem)


def check_fwd_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless a forward kernel can take q, k, v as they lie: a head
    width up to :data:`MAX_HEAD_DIM`, and, where the whole-row kernel
    takes the shape (:func:`fwd_kernel`), what its 16-byte loads need,
    every base address and every batch, head and row stride a multiple of
    16 bytes (strides of size-1 dimensions are never used). The
    key-blocked kernel takes any layout with a unit stride on Dh, such as
    the bf16 Dh 12 heads 24 bytes apart of a (B, L, H * 12) projection: by
    16-byte copies where the same rule holds, by element loads elsewhere
    (:func:`blocked_staging`). Reads only
    shapes, strides and addresses, so it runs on CPU tensors too."""
    if fwd_kernel(k.shape[2], q.shape[3]) == "attention_fwd":
        _check_alignment({"q": q, "k": k, "v": v})


def check_bwd_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     g: torch.Tensor) -> None:
    """Raise unless a backward kernel can take q, k, v and the output
    cotangent g as they lie: the forward's rules (:func:`check_fwd_layout`)
    for all four, by :func:`bwd_kernel`'s route. Runs on CPU tensors too.
    The wrapper copies a cotangent that fails them
    (:func:`_kernel_cotangent`), so on the autograd path only q, k, v can
    raise here, and the forward has checked them."""
    if bwd_kernel(k.shape[2], q.shape[3]) == "attention_bwd":
        _check_alignment({"q": q, "k": k, "v": v, "g": g})


def _kernel_cotangent(g: torch.Tensor) -> torch.Tensor:
    """The output cotangent as the backward kernels read it: fp32, Dh
    contiguous, its base and every batch, head and row stride a multiple
    of 16 bytes, so both backward kernels stage it by 16-byte copies. The
    layer's gradient arrives as the (B, H, Lq, Dh) view of a (B, Lq, H, Dh)
    fp32 tensor and is read in place where Dh is a multiple of 4; any
    other float type or layout costs one copy, into rows padded to a
    multiple of 4 floats (the padding is never read)."""
    g = g.to(torch.float32)
    if g.stride(3) != 1 or _misalignment("g", g):
        *lead, dh = g.shape
        padded = torch.empty((*lead, -(-dh // 4) * 4), dtype=torch.float32, device=g.device)
        g = padded[..., :dh].copy_(g)
    return g


def _check_cuda(tensors, dtype):
    if dtype not in _DTYPES:
        raise TypeError(f"CUDA attention takes float32 or bfloat16, got {dtype}")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    for name, t in tensors.items():
        if name != "m" and t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous along Dh, strides {t.stride()}")


def _dropout_args(seed: int, rate: float):
    return (int(seed) & _MASK32, _threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0))


def _launch(q, k, v, m, seed: int, rate: float, kernel: Optional[str] = None) -> torch.Tensor:
    """The forward kernel that :func:`fwd_kernel` picks for the shape, or
    ``kernel`` (``chip_smoke.py`` times the key-blocked kernel at shapes
    the whole-row one takes)."""
    b, h, lq, lk, dh = _check_inputs(q, k, v, m)
    _check_cuda({"q": q, "k": k, "v": v, "m": m}, q.dtype)
    m = m.to(torch.float32)
    # output stored (B, Lq, H, Dh) so the layer's merge of heads is free;
    # returned as the (B, H, Lq, Dh) view of the public layout
    out = torch.empty((b, lq, h, dh), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or lk == 0:
        return out.zero_().permute(0, 2, 1, 3)
    check_fwd_layout(q, k, v)
    kernel = kernel or fwd_kernel(lk, dh)
    lib = _library(kernel)
    strides = ([s for t in (q, k, v) for s in t.stride()[:3]]
               + [out.stride(0), out.stride(2), out.stride(1)])
    # the stream, the kernel's cudaFuncSetAttribute and the launch all act
    # on the current device: make it the tensors' card (a process may see
    # several)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kernel == "attention_fwd":
            err = lib.hamt_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, h, lq, lk, dh, *strides[:9], *m.stride(), *strides[9:],
                1.0 / dh ** 0.5, *_dropout_args(seed, rate), stream)
        else:
            err = lib.hamt_attention_fwd_blocked(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, h, lq, lk, dh,
                (ctypes.c_longlong * 14)(*strides, *m.stride()),
                1.0 / dh ** 0.5, *_dropout_args(seed, rate), blocked_staging(q, k, v), stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    launch_counts[kernel] += 1
    return out.permute(0, 2, 1, 3)


def _launch_bwd(q, k, v, m, g, seed: int, rate: float, need_dm: bool = True,
                kernel: Optional[str] = None) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward kernel that :func:`bwd_kernel` picks for the shape (or
    ``kernel``, as in :func:`_launch`);
    without ``need_dm`` it skips the mask's cotangent (its column sums,
    scratch and head-sum pass) and returns None for it. A call of the
    whole-row kernel issues the main kernel (a pair's query blocks sum dk
    and dv inside their thread-block cluster), then, for Lq > 256 only,
    the pass that sums their dk / dv partials, then the dm pass when it is
    wanted. A call of the key-blocked one issues its row-statistics pass,
    its key-block kernel, the pass that sums dq's partials over the key
    blocks, then the dm pass when it is wanted."""
    b, h, lq, lk, dh = _check_inputs(q, k, v, m)
    if g.shape != (b, h, lq, dh):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != {(b, h, lq, dh)}")
    g = _kernel_cotangent(g)
    _check_cuda({"q": q, "k": k, "v": v, "m": m, "g": g}, q.dtype)
    m = m.to(torch.float32)
    # dq, dk, dv stored (B, L, H, Dh): the backward of the layer's
    # view(b, l, h, dh).transpose(1, 2) is then free
    dq = torch.empty((b, lq, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, lk, h, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, lk, h, dh), dtype=q.dtype, device=q.device)
    dm = torch.empty((b, lk), dtype=torch.float32, device=q.device) if need_dm else None
    views = tuple(t.permute(0, 2, 1, 3) for t in (dq, dk, dv))
    if b * h == 0 or lq == 0 or lk == 0 or dh == 0:
        for t in (dq, dk, dv, dm):
            if t is not None:
                t.zero_()
        return (*views, dm)
    check_bwd_layout(q, k, v, g)
    kernel = kernel or bwd_kernel(lk, dh)
    lib = _library(kernel)
    f32 = dict(dtype=torch.float32, device=q.device)
    if kernel == "attention_bwd":
        nqb = lib.hamt_attention_bwd_query_blocks(lq)
        # fp32 partials of dk and dv per query block where a thread-block
        # cluster cannot hold the pair's blocks (Lq > 256)
        dk_part, dv_part = (torch.empty((2, nqb, b * h, lk, dh), **f32)
                            if lib.hamt_attention_bwd_needs_scratch(lq) else (None, None))
        dm_part = torch.empty((nqb, b, h, lk), **f32) if need_dm else None
        scratch = (dk_part, dv_part, dm_part)
        launch, extra = lib.hamt_attention_bwd, ()
    else:
        # fp32 partials of dq per key block, each row's max, 1 / sum and D
        # from the statistics pass, and in bf16 the cotangent split into
        # bf16 hi, mid and lo parts by the statistics pass
        nkb = lib.hamt_attention_bwd_blocked_key_blocks(lk, dh)
        width = lib.hamt_attention_blocked_width(dh)
        dq_part = torch.empty((nkb, b * h, lq, width), **f32)
        stats = torch.empty((3, b * h, lq), **f32)
        gsplit = (torch.empty((3, b * h, lq, width), dtype=torch.bfloat16, device=q.device)
                  if q.dtype == torch.bfloat16 else None)
        dm_part = torch.empty((b * h, lk), **f32) if need_dm else None
        scratch = (dq_part, stats, gsplit, dm_part)
        launch = lib.hamt_attention_bwd_blocked
        extra = (blocked_staging(q, k, v),)
    ptr = lambda t: None if t is None else t.data_ptr()
    strides = [s for t in (q, k, v, g, *views) for s in t.stride()[:3]] + list(m.stride())
    with torch.cuda.device(q.device):  # as in _launch
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *map(ptr, scratch), ptr(dm),
            _DTYPES[q.dtype], b, h, lq, lk, dh, (ctypes.c_longlong * 23)(*strides),
            1.0 / dh ** 0.5, *_dropout_args(seed, rate), *extra, stream)
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: cudaError {err}")
    launch_counts[kernel] += 1
    return (*views, dm)


def attention_bwd(q, k, v, m, g, seed: int = 0, rate: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dm) of the attention at ``q, k, v, m`` for the output
    cotangent ``g``: the backward kernel on CUDA tensors,
    :func:`attention_bwd_reference` on CPU tensors."""
    if q.device.type == "cpu":
        _check_inputs(q, k, v, m)
        return attention_bwd_reference(q, k, v, m, g, seed, rate)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, m, g, seed, rate)
    raise ValueError(f"no attention kernel for device {q.device}")


class _FusedAttention(torch.autograd.Function):
    """Forward and backward kernels as one differentiable op (the custom
    VJP of ``_fused_attention_core``). Saves q, k, v, m and the seed;
    the backward recomputes p."""

    @staticmethod
    def forward(ctx, q, k, v, m, seed: int, rate: float):
        ctx.save_for_backward(q, k, v, m)
        ctx.seed, ctx.rate = seed, rate
        if q.device.type == "cpu":
            return attention_reference(q, k, v, m, seed, rate)
        return _launch(q, k, v, m, seed, rate)

    @staticmethod
    def backward(ctx, g):
        q, k, v, m = ctx.saved_tensors
        need_dm = ctx.needs_input_grad[3]  # the main path's masks take none
        if q.device.type == "cpu":
            dq, dk, dv, dm = attention_bwd_reference(q, k, v, m, g, ctx.seed, ctx.rate)
        else:
            dq, dk, dv, dm = _launch_bwd(q, k, v, m, g, ctx.seed, ctx.rate, need_dm)
        return dq, dk, dv, dm.to(m.dtype) if need_dm else None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    additive_mask: torch.Tensor, dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None) -> torch.Tensor:
    """(B, H, Lq, Dh) float32 attention output, differentiable in q, k, v
    and the mask.

    ``q`` (B, H, Lq, Dh), ``k``/``v`` (B, H, Lk, Dh) may be strided views
    (Dh contiguous); ``additive_mask`` (B, Lk) holds 0 / -10000. With
    ``dropout_rate > 0`` the probabilities are dropped by the counter
    hash of ``dropout_seed``, a host integer (negative int32 seeds wrap
    as in the TPU kernel; a tensor is refused, since reading one from the
    card would stall the host on every call). CPU tensors take the plain
    twins; CUDA tensors launch the kernels or raise.
    """
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if isinstance(dropout_seed, torch.Tensor):
        raise TypeError("dropout_seed must be a host int, not a tensor")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")
    _check_inputs(q, k, v, additive_mask)
    seed = 0 if dropout_seed is None else int(dropout_seed)
    return _FusedAttention.apply(q, k, v, additive_mask, seed, float(dropout_rate))
