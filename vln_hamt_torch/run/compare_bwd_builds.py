"""Builds of the attention backward kernel against each other, timed in turns in one process.

    python -m vln_hamt_torch.run.compare_bwd_builds NAME=SOURCE[@NVCC_FLAGS] ...

Each SOURCE is a version of ``csrc/attention_bwd.cu`` that exports its
C interface (``hamt_attention_bwd`` with the arguments
``ops/attention.py:_launch_bwd`` passes), for example the parent
commit's (``git show REV:vln_hamt_torch/csrc/attention_bwd.cu``) beside
the working tree's; ``@`` adds nvcc flags (``-DNAME=1``) for builds
instrumented with compile-time switches. All sources are built at once
(one nvcc each), then for each training shape of the R2R main path
(12 heads, Dh 64, fp32) at batches 8 and 32 every build is checked
against ``attention_bwd_reference`` (dropout 0.1, dm included) and
timed with and without dm, in the order A B ... B A, on the same card
in the same process. Every call is handed fp32 dk / dv scratch when Lq
spans several query blocks, as older versions need it; builds that sum
the blocks otherwise ignore it. Prints the card's name and power
limit, one JSON line per build (registers, spills), per shape, per
batch (means over the shapes, which the IL update launches equally
often) and the device time per call by kernel name from
``torch.profiler`` at batch 8, 65 x 65.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..agents.agent import resolve_device
from ..ops import attention as attn
from .profile_attention import cuda_time_ms, kernel_inputs, nvidia_smi, ptxas_report, rel_err

SHAPES = ((60, 60), (60, 65), (65, 60), (65, 65))  # an IL update's, 60 launches each


def build(name: str, spec: str, out_dir: str):
    """(name, library path or None, build report or nvcc's errors)."""
    source, _, flags = spec.partition("@")
    out = os.path.join(out_dir, f"{name}.so")
    proc = subprocess.run([attn._find_nvcc(), *attn.NVCC_FLAGS, "-I", str(attn.CSRC),
                           *flags.split(), "-o", out, source], capture_output=True, text=True)
    if proc.returncode:
        return name, None, proc.stderr[-3000:]
    report = ptxas_report(proc.stdout + proc.stderr)
    return name, out, {k: report[k] for k in ("max_registers", "spill_bytes")}


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    p, i, ll, u32, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_uint32, ctypes.c_float)
    lib.hamt_attention_bwd.argtypes = (
        [p] * 12 + [i] * 6 + [ctypes.POINTER(ll), f32, u32, u32, f32, i, p])
    lib.hamt_attention_bwd.restype = i
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


def main(argv=None):
    specs = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
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
            libs[name] = load(path)
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
        call = make_call(libs[n], q, k, v, m, g, False)[0]
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                found = re.search(r"(\w+_kernel)", e.name)
                key = found.group(1) if found else e.name[:60]
                by_kernel[key] = by_kernel.get(key, 0.0) + e.device_time / 1e3 / 20
        print(json.dumps({"build": n, "ms_per_call_by_kernel_b8_65x65": by_kernel}), flush=True)


if __name__ == "__main__":
    main()
