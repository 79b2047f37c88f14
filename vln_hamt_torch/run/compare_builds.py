"""Builds of an attention kernel against each other, timed in turns in one process.

    python -m vln_hamt_torch.run.compare_builds [--kernel bwd|fwd_blocked|bwd_blocked]
        NAME=SOURCE[@NVCC_FLAGS] ...

Each SOURCE is a version of the kernel's source that exports its C
interface, for example the parent commit's (``git show
REV:vln_hamt_torch/csrc/attention_bwd.cu``, saved to a file first)
beside the working tree's; ``@`` adds nvcc flags (``-DNAME=1``) for
builds instrumented with compile-time switches. All sources are built at
once (one nvcc each, ``-I csrc`` for the headers; a quoted include finds
the headers beside its source first, so an old version saved with its
own headers builds against them), then every build is
checked against the plain version and timed in the order A B ... B A, on
the same card in the same process. Prints the card's name and power
limit and one JSON line per build (registers, spills), per shape and per
summary. Every build is called through the working tree's C interface; a
version with another one is built from a small source beside it that
includes it with its entry renamed (``#define`` before the
``#include``) and exports the working tree's entry, which calls it.

``--kernel bwd`` (the default), ``csrc/attention_bwd.cu``
(``hamt_attention_bwd`` with the arguments ``ops/attention.py:_launch_bwd``
passes): for each training shape of the R2R main path (12 heads, Dh 64,
fp32) at batches 8 and 32, checked against ``attention_bwd_reference``
(dropout 0.1, dm included) and timed with and without dm; per batch the
means over the shapes, which the IL update launches equally often, and
the device time per call by kernel name from ``torch.profiler`` at batch
8, 65 x 65. Every call is handed fp32 dk / dv scratch when Lq spans
several query blocks, as older versions need it; builds that sum the
blocks otherwise ignore it.

``--kernel fwd_blocked``, ``csrc/attention_blocked.cu``
(``hamt_attention_fwd_blocked``): at each key-blocked forward shape of
``chip_smoke.py`` phase 21's configuration runs (:data:`FWD_BLOCKED_SHAPES`,
with their launches), fp32 and bf16, the layer's views as the model hands
them over, checked against ``attention_reference`` at dropout 0 and 0.1
and timed (dropout off) beside the plain version,
``scaled_dot_product_attention`` and the bound; per type the times
weighted by the launches, with the staging flag
(``ops/attention.py:blocked_staging``).

``--kernel bwd_blocked``, ``csrc/attention_blocked_bwd.cu``
(``hamt_attention_bwd_blocked``): the same at each key-blocked backward
shape of those runs (:data:`BWD_BLOCKED_SHAPES`), checked against
``attention_bwd_reference`` at dropout 0 and 0.1 (dm included, at
``chip_smoke.py``'s bars) and timed with dm (as ``chip_smoke.py`` phase
21 times it) and without, with the staging flag and the split-G
scratch. Each build sizes its own dq scratch through its
``hamt_attention_bwd_blocked_key_blocks``; each row also has each
build's device time per call by kernel name (``torch.profiler``, dm
on).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..agents.agent import resolve_device
from ..ops import attention as attn
from .profile_attention import (attention_bound_ms, attention_bwd_bound_ms, cuda_time_ms,
                                kernel_inputs, nvidia_smi, ptxas_report, rel_err, sdpa_backward,
                                staging_name)

SHAPES = ((60, 60), (60, 65), (65, 60), (65, 65))  # an IL update's, 60 launches each
#: the key-blocked forward's shapes in chip_smoke.py phase 21's configuration
#: runs, (lanes, heads, Lq, Lk, Dh): launches per run (image_pretrain
#: --transform none, precompute_features --image_size 384 384,
#: image_pretrain --tiny, pretrain --max_txt_len 300)
FWD_BLOCKED_SHAPES = {(900, 12, 301, 301, 64): 12, (36, 12, 301, 301, 64): 12,
                      (36, 12, 577, 577, 64): 12, (900, 4, 5, 5, 12): 2, (36, 4, 5, 5, 12): 2,
                      (16, 12, 300, 300, 64): 13, (16, 12, 26, 300, 64): 4}
FWD_TOL = {0.0: 1e-5, 0.1: 2e-5}  # chip_smoke.py:TOL, both types
#: the key-blocked backward's shapes in those runs: the e2e observation
#: ViT's 12 layers at 36 lanes (--transform none) and its 2 at Dh 12
#: (--tiny), the long text's 13 text-key attentions and 3 visual-to-text
#: ones (--max_txt_len 300, MLM)
BWD_BLOCKED_SHAPES = {(36, 12, 301, 301, 64): 12, (36, 4, 5, 5, 12): 2,
                      (16, 12, 300, 300, 64): 13, (16, 12, 26, 300, 64): 3}
#: chip_smoke.py:BWD_RTOL and BWD_DM_RTOL, relative to the largest value
BWD_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -8}
BWD_DM_RTOL = 2e-5


def build(name: str, spec: str, out_dir: str):
    """(name, library path or None, build report or nvcc's errors)."""
    source, _, flags = spec.partition("@")
    out = os.path.join(out_dir, f"{name}.so")
    proc = subprocess.run([attn._find_nvcc(), *attn.NVCC_FLAGS, "-I", str(attn.CSRC),
                           *flags.split(), "-o", out, source], capture_output=True, text=True)
    if proc.returncode:
        return name, None, proc.stderr[-3000:]
    report = ptxas_report(proc.stdout + proc.stderr)
    spilling = {e["entry"]: [e.get("registers"), e["spill_stores"] + e["spill_loads"]]
                for e in report["entries"] if e.get("spill_stores", 0) + e.get("spill_loads", 0)}
    return name, out, {"max_registers": report["max_registers"],
                       "spill_bytes": report["spill_bytes"], "spilling": spilling}


def load(path: str, kernel: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    p, i, ll, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_uint32, ctypes.c_float)
    if kernel == "bwd":
        lib.hamt_attention_bwd.argtypes = (
            [p] * 12 + [i] * 6 + [ctypes.POINTER(ll), f32, u32, u32, f32, i, p])
        lib.hamt_attention_bwd.restype = i
    elif kernel == "bwd_blocked":
        lib.hamt_attention_bwd_blocked.argtypes = (
            [p] * 13 + [i] * 6 + [ctypes.POINTER(ll), f32, u32, u32, f32, i, i, p])
        lib.hamt_attention_bwd_blocked.restype = i
        lib.hamt_attention_blocked_width.argtypes = [i]
        lib.hamt_attention_blocked_width.restype = i
        lib.hamt_attention_bwd_blocked_key_blocks.argtypes = [i, i]
        lib.hamt_attention_bwd_blocked_key_blocks.restype = i
    else:
        lib.hamt_attention_fwd_blocked.argtypes = (
            [p] * 5 + [i] * 6 + [ctypes.POINTER(ll), f32, u32, u32, f32, i, i, p])
        lib.hamt_attention_fwd_blocked.restype = i
    return lib


def make_call(lib, q, k, v, m, g, need_dm: bool, seed: int = 0, rate: float = 0.0):
    """A function that launches ``lib``'s backward on these inputs into
    outputs allocated once, and those outputs (dq, dk, dv, dm)."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    nqb = -(-lq // 32)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((b, n, h, dh), dtype=q.dtype, device=q.device)
                  for n in (lq, lk, lk))
    part = torch.empty((2, nqb, b * h, lk, dh), **f32) if nqb > 1 else None
    dm_part = torch.empty((nqb, b, h, lk), **f32) if need_dm else None
    dm = torch.empty((b, lk), **f32) if need_dm else None
    views = tuple(t.permute(0, 2, 1, 3) for t in (dq, dk, dv))
    strides = [s for t in (q, k, v, g, *views) for s in t.stride()[:3]] + list(m.stride())
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *((ptr(part[0]), ptr(part[1])) if part is not None else (None, None)),
            ptr(dm_part), ptr(dm), attn._DTYPES[q.dtype], b, h, lq, lk, dh,
            (ctypes.c_longlong * 23)(*strides), 1.0 / dh ** 0.5,
            *attn._dropout_args(seed, rate), torch.cuda.current_stream().cuda_stream)

    def call():
        err = lib.hamt_attention_bwd(*args)
        if err:
            raise RuntimeError(f"attention backward launch failed: cudaError {err}")
    return call, (*views, dm)


def make_fwd_call(lib, q, k, v, m, seed: int = 0, rate: float = 0.0):
    """A function that launches ``lib``'s key-blocked forward on these
    inputs into an output allocated once (as ``ops/attention.py:_launch``
    lays it out), and that output's (B, H, Lq, Dh) view."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    out = torch.empty((b, lq, h, dh), dtype=torch.float32, device=q.device)
    strides = ([s for t in (q, k, v) for s in t.stride()[:3]]
               + [out.stride(0), out.stride(2), out.stride(1)] + list(m.stride()))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), out.data_ptr(),
            attn._DTYPES[q.dtype], b, h, lq, lk, dh, (ctypes.c_longlong * 14)(*strides),
            1.0 / dh ** 0.5, *attn._dropout_args(seed, rate), attn.blocked_staging(q, k, v),
            torch.cuda.current_stream().cuda_stream)

    def call():
        err = lib.hamt_attention_fwd_blocked(*args)
        if err:
            raise RuntimeError(f"key-blocked forward launch failed: cudaError {err}")
    return call, out.permute(0, 2, 1, 3)


def make_bwd_blocked_call(lib, q, k, v, m, g, need_dm: bool, seed: int = 0,
                          rate: float = 0.0):
    """A function that launches ``lib``'s key-blocked backward on these
    inputs into outputs and scratch allocated once (as
    ``ops/attention.py:_launch_bwd`` lays them out), and those outputs
    (dq, dk, dv, dm)."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    g = attn._kernel_cotangent(g)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((b, n, h, dh), dtype=q.dtype, device=q.device)
                  for n in (lq, lk, lk))
    nkb = lib.hamt_attention_bwd_blocked_key_blocks(lk, dh)
    dq_part = torch.empty((nkb, b * h, lq, lib.hamt_attention_blocked_width(dh)), **f32)
    stats = torch.empty((3, b * h, lq), **f32)
    gsplit = (torch.empty((3, b * h, lq, dq_part.shape[-1]), dtype=torch.bfloat16,
                          device=q.device) if q.dtype == torch.bfloat16 else None)
    dm_part = torch.empty((b * h, lk), **f32) if need_dm else None
    dm = torch.empty((b, lk), **f32) if need_dm else None
    views = tuple(t.permute(0, 2, 1, 3) for t in (dq, dk, dv))
    strides = [s for t in (q, k, v, g, *views) for s in t.stride()[:3]] + list(m.stride())
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *map(ptr, (dq_part, stats, gsplit)),
            ptr(dm_part), ptr(dm), attn._DTYPES[q.dtype], b, h, lq, lk, dh,
            (ctypes.c_longlong * 23)(*strides), 1.0 / dh ** 0.5,
            *attn._dropout_args(seed, rate), attn.blocked_staging(q, k, v),
            torch.cuda.current_stream().cuda_stream)

    def call():
        err = lib.hamt_attention_bwd_blocked(*args)
        if err:
            raise RuntimeError(f"key-blocked backward launch failed: cudaError {err}")
    return call, (*views, dm)


def by_kernel_ms(call, iters: int = 20) -> dict:
    """Device ms per call of ``call`` by kernel name (``torch.profiler``)."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            found = re.search(r"(\w+_kernel)", e.name)
            key = found.group(1) if found else e.name[:60]
            out[key] = out.get(key, 0.0) + e.device_time / 1e3 / iters
    return out


def compare_bwd(libs, dev) -> None:
    names = list(libs)
    order = names + names[::-1]
    gen = torch.Generator(device=dev).manual_seed(0)
    for b in (8, 32):
        means = {n: {"ms": 0.0, "ms_dm": 0.0} for n in names}
        for lq, lk in SHAPES:
            q, k, v, m, g = kernel_inputs(b, 12, lq, lk, 64, torch.float32, gen, dev)
            want = attn.attention_bwd_reference(q, k, v, m, g, 5, 0.1)
            row = {"batch": b, "lq": lq, "lk": lk}
            for n in names:
                call, outs = make_call(libs[n], q, k, v, m, g, True, 5, 0.1)
                call()
                row[f"{n}_max_rel_err"] = max(rel_err(x, y) for x, y in zip(outs, want))
            times = {n: [] for n in names}
            times_dm = {n: [] for n in names}
            for n in order:
                times[n].append(cuda_time_ms(make_call(libs[n], q, k, v, m, g, False)[0]))
                times_dm[n].append(cuda_time_ms(make_call(libs[n], q, k, v, m, g, True)[0]))
            for n in names:
                row[f"{n}_ms"] = sum(times[n]) / len(times[n])
                row[f"{n}_ms_dm"] = sum(times_dm[n]) / len(times_dm[n])
                means[n]["ms"] += row[f"{n}_ms"] / len(SHAPES)
                means[n]["ms_dm"] += row[f"{n}_ms_dm"] / len(SHAPES)
            print(json.dumps(row), flush=True)
        print(json.dumps({"batch": b, "mean_over_shapes": means}), flush=True)

    q, k, v, m, g = kernel_inputs(8, 12, 65, 65, 64, torch.float32, gen, dev)
    for n in names:
        by_kernel = by_kernel_ms(make_call(libs[n], q, k, v, m, g, False)[0])
        print(json.dumps({"build": n, "ms_per_call_by_kernel_b8_65x65": by_kernel}), flush=True)


def compare_fwd_blocked(libs, dev) -> None:
    names = list(libs)
    order = names + names[::-1]
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        rows = []
        for (lanes, heads, lq, lk, dh), launches in FWD_BLOCKED_SHAPES.items():
            q, k, v, m, _ = kernel_inputs(lanes, heads, lq, lk, dh, dtype, gen, dev)
            row = {"lanes": lanes, "heads": heads, "lq": lq, "lk": lk, "head_dim": dh,
                   "dtype": str(dtype).split(".")[1], "launches": launches,
                   "staging": staging_name(q, k, v)}
            for rate in (0.0, 0.1):
                want = attn.attention_reference(q, k, v, m, 2**31 + 7, rate)
                for n in names:
                    call, out = make_fwd_call(libs[n], q, k, v, m, 2**31 + 7, rate)
                    call()
                    torch.cuda.synchronize()
                    err = (out - want).abs().max().item()
                    if not err <= FWD_TOL[rate]:
                        raise AssertionError(f"{n} at {row}, rate {rate}: {err}")
                    row[f"{n}_max_abs_err_{rate}"] = err
                del want, out
                torch.cuda.empty_cache()  # the plain version's scores at 900 lanes
            times = {n: [] for n in names}
            for n in order:
                times[n].append(cuda_time_ms(make_fwd_call(libs[n], q, k, v, m)[0]))
            for n in names:
                row[f"{n}_ms"] = min(times[n])
                row[f"{n}_ms_each"] = times[n]
            row["plain_ms"] = cuda_time_ms(lambda: attn.attention_reference(q, k, v, m))
            row["library_ms"] = cuda_time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=m[:, None, None, :].to(dtype)))
            row["bound_ms"] = max(attention_bound_ms(lanes, heads, lq, lk, dh,
                                                     q.element_size()))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del q, k, v, m
            torch.cuda.empty_cache()
        weighted_line(rows, names, dtype)


def weighted_line(rows, names, dtype, extra=()) -> None:
    total = sum(r["launches"] for r in rows)
    keys = [f"{n}_ms" for n in names] + list(extra) + ["plain_ms", "library_ms", "bound_ms"]
    print(json.dumps({"dtype": str(dtype).split(".")[1], "launches": total, "weighted": {
        key: sum(r["launches"] * r[key] for r in rows) / total for key in keys}}), flush=True)


def compare_bwd_blocked(libs, dev) -> None:
    names = list(libs)
    order = names + names[::-1]
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        rows = []
        for (lanes, heads, lq, lk, dh), launches in BWD_BLOCKED_SHAPES.items():
            q, k, v, m, g = kernel_inputs(lanes, heads, lq, lk, dh, dtype, gen, dev)
            row = {"lanes": lanes, "heads": heads, "lq": lq, "lk": lk, "head_dim": dh,
                   "dtype": str(dtype).split(".")[1], "launches": launches,
                   "staging": staging_name(q, k, v)}
            for rate in (0.0, 0.1):
                want = attn.attention_bwd_reference(q, k, v, m, g, 2**31 + 7, rate)
                for n in names:
                    call, outs = make_bwd_blocked_call(libs[n], q, k, v, m, g, True, 2**31 + 7,
                                                       rate)
                    call()
                    torch.cuda.synchronize()
                    errs = {t: rel_err(x, y) for t, x, y in zip(("dq", "dk", "dv", "dm"), outs,
                                                                 want)}
                    bad = {t: e for t, e in errs.items()
                           if not e <= (BWD_DM_RTOL if t == "dm" else BWD_RTOL[dtype])}
                    if bad:
                        raise AssertionError(f"{n} at {row}, rate {rate}: {bad}")
                    row[f"{n}_rel_err_{rate}"] = errs
                del want, outs
                torch.cuda.empty_cache()
            times = {n: [] for n in names}
            times_no_dm = {n: [] for n in names}
            for n in order:
                times[n].append(cuda_time_ms(make_bwd_blocked_call(libs[n], q, k, v, m, g,
                                                                   True)[0]))
                times_no_dm[n].append(cuda_time_ms(make_bwd_blocked_call(libs[n], q, k, v, m, g,
                                                                         False)[0]))
            for n in names:
                row[f"{n}_ms"] = min(times[n])
                row[f"{n}_ms_each"] = times[n]
                row[f"{n}_ms_no_dm"] = min(times_no_dm[n])
                row[f"{n}_ms_by_kernel"] = by_kernel_ms(
                    make_bwd_blocked_call(libs[n], q, k, v, m, g, True)[0])
            row["plain_ms"] = cuda_time_ms(lambda: attn.attention_bwd_reference(q, k, v, m, g))
            row["library_ms"] = cuda_time_ms(sdpa_backward(q, k, v, m, g))
            row["bound_ms"] = max(attention_bwd_bound_ms(lanes, heads, lq, lk, dh,
                                                         q.element_size()))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del q, k, v, m, g
            torch.cuda.empty_cache()
        weighted_line(rows, names, dtype, [f"{n}_ms_no_dm" for n in names])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=tuple(COMPARERS), default="bwd")
    parser.add_argument("builds", nargs="+", metavar="NAME=SOURCE[@NVCC_FLAGS]")
    args = parser.parse_args(argv)
    specs = dict(a.split("=", 1) for a in args.builds)
    dev = resolve_device()  # the card; raises without one
    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi(), flush=True)
    out_dir = os.path.join(attn.BUILD_DIR, "compare")
    os.makedirs(out_dir, exist_ok=True)
    with ThreadPoolExecutor(min(len(specs), os.cpu_count() or 1)) as pool:
        built = list(pool.map(lambda kv: build(*kv, out_dir), specs.items()))
    libs = {}
    for name, path, report in built:
        print(json.dumps({"build": name, "ok": path is not None, "report": report}), flush=True)
        if path:
            libs[name] = load(path, args.kernel)
    COMPARERS[args.kernel](libs, dev)


COMPARERS = {"bwd": compare_bwd, "fwd_blocked": compare_fwd_blocked,
             "bwd_blocked": compare_bwd_blocked}


if __name__ == "__main__":
    main()
