"""The attention kernels' name table: every CUDA kernel of the port's
attention sources, as the profiler names it, is attributed to its pass,
and the other kernels of a traced update are not."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark import trace

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "vln_hamt_torch" / "csrc"


def _kernels():
    """(file, kernel name, templated) of every ``__global__`` function
    under the port's CUDA sources."""
    out = []
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        text = re.sub(r"__launch_bounds__\([^)]*\)", "", path.read_text())
        for m in re.finditer(r"__global__\s+void\s+(\w+)\s*\(", text):
            before = text[:m.start()].rstrip().splitlines()
            templated = bool(before) and before[-1].lstrip().startswith("template")
            out.append((path.name, m.group(1), templated))
    return out


KERNELS = _kernels()
TABLE = json.loads(trace.KERNEL_TABLE.read_text())


def test_the_sources_hold_the_attention_kernels():
    names = {k for _, k, _ in KERNELS}
    assert {"attention_fwd_kernel", "attention_bwd_kernel", "fwd_fp32_kernel",
            "key_bf16_kernel", "dq_sum_kernel", "dm_sum_kernel"} <= names
    assert len(KERNELS) >= 12


@pytest.mark.parametrize("source,kernel,templated", KERNELS,
                         ids=[f"{f}:{k}" for f, k, _ in KERNELS])
def test_every_port_kernel_is_attributed_to_its_pass(source, kernel, templated):
    # the profiler's demangled name of a kernel in an anonymous namespace
    args = "((anonymous namespace)::Params)" if templated else "(float const*, float*, int, int, int)"
    name = f"void (anonymous namespace)::{kernel}{'<64>' if templated else ''}{args}"
    assert trace.attention_kind(name, TABLE) == ("bwd" if "bwd" in source else "fwd")


@pytest.mark.parametrize("name", [
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_warpsize1x4x1_ffma_aligna4"
    "_alignc4_execute_kernel__5x_cublas",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, false>"
    "(int, float, float const*, float const*, float const*, float*, float*, float*)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
    "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, float, float, "
    "at::native::(anonymous namespace)::SoftMaxForwardEpilogue>(float*, float const*, int)",
])
def test_other_kernels_are_not_attention(name):
    assert trace.attention_kind(name, TABLE) == ""
