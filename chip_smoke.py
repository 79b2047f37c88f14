"""GPU smoke test of the PyTorch/CUDA port (vln_hamt_torch) on one card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   -- card name, count, torch / CUDA versions, nvidia-smi name
               and power limit.
2. build    -- nvcc build of every kernel of the main path from this
               checkout's sources, with the -Xptxas -v report.
3. kernels  -- each kernel against its plain torch twin on the card at
               the main path's shapes (batch 32, full width), fp32 and
               bf16, dropout off and on; kernel, plain and library-call
               times and the card's bound for the same work.
4. slice    -- the main path: full-width R2R greedy evaluation
               (HAMTAgent.eval_split_device, `r2r` preset, fp32, seeded
               random weights) over a synthetic world at batch 32;
               episodes/s, SR/SPL/nDTW, and the kernel launch counts of
               that run (279 attention launches per batch).
5. parity   -- the same full-width model and weights at batch 4, once on
               the card and once on the CPU (plain attention): per-step
               logits within tolerance and identical trajectories.

The second-to-last line is the kernel summary {"kernels": [...]}; the
last is {"ok": true, "device": {...}}. Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero before
printing either.
"""

from __future__ import annotations

import collections
import json
import math
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 CUDA-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

B, H, DH = 32, 12, 64
TOL = {  # kernel vs plain twin, max abs error
    (torch.float32, 0.0): 1e-5,  # fp32, another summation order
    (torch.bfloat16, 0.0): 1e-5,  # bf16 inputs widened to fp32 alike on both sides
    (torch.float32, 0.1): 2e-5,  # kept values scaled by 1 / (1 - rate)
    (torch.bfloat16, 0.1): 2e-5,
}
PARITY_LOGIT_ATOL = 1e-3  # card vs CPU after 13 fp32 layers per step


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def attention_bound_ms(lq: int, lk: int, elt_bytes: int):
    """Least time for one launch: q, k, v read once, the (B, Lk) fp32
    mask read once, the fp32 output written once, over HBM; and
    4*B*H*Lq*Lk*Dh fp32 FLOPs over the CUDA cores' peak."""
    nbytes = B * H * (lq + 2 * lk) * DH * elt_bytes + B * lk * 4 + B * H * lq * DH * 4
    flops = 4 * B * H * lq * lk * DH
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vln_hamt_torch.agents.agent import HAMTAgent
    from vln_hamt_torch.ops import attention as attn
    from vln_hamt_torch.run.profile_eval import slice_config, slice_env

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ------------------------------------------------------------ device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi)

    # ------------------------------------------------------------- build
    built = attn.build_library()
    ptxas = [ln.strip() for ln in built["ptxas"].splitlines()
             if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=built["seconds"], library=built["path"], ptxas=ptxas)

    # ------------------------------------------------- the slice's world
    cfg, world = slice_config(B, seed=0)
    mcfg, t_max = cfg.model, cfg.env.max_action_len
    n_ob = cfg.env.max_candidates + 1 + 36
    l_txt, l_pano, l_visn = cfg.env.max_instr_len, 36, t_max + 1 + n_ob
    # attention launches per greedy batch, by (Lq, Lk): the text stack
    # once, then per step the panorama encoder and, in each cross-modal
    # layer, cross-attention both ways and the two self-attentions
    mix = collections.Counter()
    mix[(l_txt, l_txt)] += mcfg.num_l_layers + t_max * mcfg.num_x_layers
    mix[(l_pano, l_pano)] += t_max * mcfg.num_h_pano_layers
    mix[(l_txt, l_visn)] += t_max * mcfg.num_x_layers
    mix[(l_visn, l_txt)] += t_max * mcfg.num_x_layers
    mix[(l_visn, l_visn)] += t_max * mcfg.num_x_layers
    per_batch = sum(mix.values())

    # ----------------------------------------------------------- kernels
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, max_err = [], 0.0
    for (lq, lk) in mix:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, lq, H, DH, device=dev, generator=gen).to(dtype).transpose(1, 2)
            k = torch.randn(B, lk, H, DH, device=dev, generator=gen).to(dtype).transpose(1, 2)
            v = torch.randn(B, lk, H, DH, device=dev, generator=gen).to(dtype).transpose(1, 2)
            m = torch.where(torch.rand(B, lk, device=dev, generator=gen) < 0.8, 0.0, -10000.0)
            for rate in (0.0, 0.1):
                seed = 2**31 + 7  # above int32: exercises the 32-bit wrap
                got = attn.fused_attention(q, k, v, m, dropout_rate=rate, dropout_seed=seed)
                want = attn.attention_reference(q, k, v, m, seed, rate)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tol = TOL[(dtype, rate)]
                if not err <= tol:
                    raise AssertionError(f"attention ({lq},{lk}) {dtype} rate {rate}: "
                                         f"max abs err {err} > {tol}")
                max_err = max(max_err, err)
                row = {"lq": lq, "lk": lk, "dtype": str(dtype).split(".")[1], "rate": rate,
                       "max_abs_err": err, "tol": tol}
                if rate == 0.0:
                    bytes_ms, flops_ms = attention_bound_ms(lq, lk, q.element_size())
                    mask4 = m[:, None, None, :].to(dtype)
                    row.update(
                        ms=cuda_time_ms(lambda: attn.fused_attention(q, k, v, m)),
                        plain_ms=cuda_time_ms(lambda: attn.attention_reference(q, k, v, m)),
                        library_ms=cuda_time_ms(
                            lambda: torch.nn.functional.scaled_dot_product_attention(
                                q, k, v, attn_mask=mask4)),
                        bytes_ms=bytes_ms, flops_ms=flops_ms)
                rows.append(row)
    emit("kernels", kernel="attention_fwd", batch=B, heads=H, head_dim=DH, results=rows)

    # main-path mix at fp32, dropout off: per-launch means weighted by
    # the launches of one greedy batch
    fp32 = {(r["lq"], r["lk"]): r for r in rows if r["dtype"] == "float32" and "ms" in r}

    def mean(key_fn):
        return sum(n * key_fn(fp32[s]) for s, n in mix.items()) / per_batch

    bytes_mean = mean(lambda r: r["bytes_ms"])
    flops_mean = mean(lambda r: r["flops_ms"])

    # ------------------------------------------------------------- slice
    env = slice_env(cfg, world, seed=0)
    agent = HAMTAgent(cfg, env, seed=0)  # the card, by default
    agent.enable_feature_table()
    agent.eval_split_device()  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    for name in attn.launch_counts:
        attn.launch_counts[name] = 0
    t0 = time.perf_counter()
    preds = agent.eval_split_device()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(attn.launch_counts)
    batches = len(world.instr_data) // B + 1  # iterate until an instr_id repeats
    if per_batch != 279 or launches["attention_fwd"] != per_batch * batches:
        raise AssertionError(f"attention launches {launches} != 279 x {batches} batches "
                             f"(per batch by shape: {mix})")
    metrics, _ = env.eval_metrics(preds)
    if len(preds) != len(world.instr_data):
        raise AssertionError(f"{len(preds)} predictions for {len(world.instr_data)} items")
    starts = {it["instr_id"]: it["path"][0] for it in world.instr_data}
    if any(p["trajectory"][0][0] != starts[p["instr_id"]] for p in preds):
        raise AssertionError("a trajectory does not begin at its start viewpoint")
    if not all(math.isfinite(v) for v in metrics.values()) or not 0 <= metrics["sr"] <= 100:
        raise AssertionError(f"bad metrics {metrics}")
    emit("slice", preset="r2r", hidden=mcfg.hidden_size, layers=[mcfg.num_l_layers,
         mcfg.num_x_layers, mcfg.num_h_pano_layers], batch=B, t_max=t_max,
         episodes=len(preds), rollouts=batches * B, seconds=seconds,
         episodes_per_s=len(preds) / seconds, rollouts_per_s=batches * B / seconds,
         sr=metrics["sr"], spl=metrics["spl"], ndtw=metrics["nDTW"],
         launches=launches, launches_per_batch=per_batch, shape_mix=
         {f"{lq}x{lk}": n for (lq, lk), n in mix.items()},
         attention_ms_per_batch=mean(lambda r: r["ms"]) * per_batch)

    # ------------------------------------------------------------ parity
    small = cfg.replace(train={"batch_size": 4})
    outs = {}
    for device in ("cuda", "cpu"):
        pagent = HAMTAgent(small, slice_env(small, world, seed=0), seed=0, device=device)
        pagent.enable_feature_table()
        ins = pagent._device_rollout_args()
        ep, extras = pagent._ensure_device_rollout_fn()(
            ins["txt_ids"], ins["txt_mask"], pagent._feat_table, pagent._nav_tables,
            ins["start_node"], ins["start_view"])
        outs[device] = ({k: v.cpu() for k, v in ep.items()},
                        {k: v.cpu() for k, v in extras.items()})
    (ep_g, ex_g), (ep_c, ex_c) = outs["cuda"], outs["cpu"]
    for key in ("node_idx", "view_index", "actions", "step_mask", "final_node_idx"):
        if not torch.equal(ep_g[key], ep_c[key]):
            raise AssertionError(f"card and CPU trajectories differ in {key}")
    lg, lc = ex_g["rollout_logits"], ex_c["rollout_logits"]
    fin = torch.isfinite(lc)
    if not torch.equal(torch.isfinite(lg), fin):
        raise AssertionError("card and CPU logits are -inf at different places")
    logit_err = (lg[fin] - lc[fin]).abs().max().item()
    if not logit_err <= PARITY_LOGIT_ATOL:
        raise AssertionError(f"card vs CPU logits differ by {logit_err}")
    emit("parity", batch=4, t_max=t_max, max_abs_logit_err=logit_err,
         tol=PARITY_LOGIT_ATOL, trajectories_identical=True)

    summary = {"kernels": [{
        "name": "attention_fwd", "route": "cuda",
        "source": "vln_hamt_torch/csrc/attention.cu",
        "replaces": "vln_hamt_tpu/ops/attention.py:53",  # _attn_kernel
        "launches": launches["attention_fwd"], "max_abs_err": max_err,
        "ms": mean(lambda r: r["ms"]), "plain_ms": mean(lambda r: r["plain_ms"]),
        "bound_ms": mean(lambda r: max(r["bytes_ms"], r["flops_ms"])),
        "bound_by": "bytes" if bytes_mean >= flops_mean else "operations",
        "library_ms": mean(lambda r: r["library_ms"]),
    }]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
