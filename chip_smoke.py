"""GPU smoke test of the PyTorch/CUDA port (vln_hamt_torch) on one card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   -- card name, count, torch / CUDA versions, nvidia-smi name
               and power limit.
2. build    -- nvcc builds of every kernel of the main paths from this
               checkout's sources, one nvcc per source, all started
               together, with each instantiation's registers and spill
               bytes from the -Xptxas -v reports.
3. kernels  -- each kernel against its plain torch twin on the card at
               the main paths' shapes (batch 32, full width), fp32 and
               bf16, dropout off and on: the attention forward, and the
               attention backward (dq, dk, dv and the mask cotangent dm);
               kernel, plain and library-call times and the card's bound
               for the same work; both kernels checked and timed at the
               training batch of 8 too, each at its training path's
               shapes; edge cases of the query-blocked tiling at batches
               32 and 8 (Lq = Lk = 1, a ragged 33 x 65 query block,
               65 x 65 with batch elements whose keys all read -10000,
               Dh 16 and 128), for the backward also 100 x 100, 250 x 65,
               65 x 250 and 250 x 250 (R4R / CVDN and RxR text lengths)
               and 300 x 65 (more query blocks than a cluster holds);
               and both kernels checked and timed at batch 16, the
               merged sample update's lanes, at the training shapes.
               Timing, bounds and build reports come from
               vln_hamt_torch/run/profile_attention.py.
4. slice    -- the serving path: full-width R2R greedy evaluation
               (HAMTAgent.eval_split_device, `r2r` preset, fp32, seeded
               random weights) over a synthetic world at batch 32;
               episodes/s, SR/SPL/nDTW, and the kernel launches of that
               run (279 forward launches per batch, no backward).
5. parity   -- the same full-width model and weights at batch 4, once on
               the card and once on the CPU (plain attention): per-step
               logits within tolerance and identical trajectories.
6. train    -- the training path: full-width R2R imitation learning
               (HAMTAgent.train_iteration("teacher"), `r2r` preset, fp32,
               production dropout, adamw lr 1e-5, clip 40, batch 8,
               T = 15) over the same world; 3 warm-up and 20 timed
               updates: IL episodes/s, the losses, and 279 forward and
               240 backward launches per update. Then 15 updates on one
               repeated batch (lr 1e-4, dropout off): the loss must fall.
7. train_parity -- one IL update's loss and every parameter's gradient,
               card against CPU, batch 4, dropout off, same weights and
               batch; with the preset's fix_lang / fix_hist flags (240
               backward launches), and with both off (277: the text and
               panorama backward shapes too).
8. sample   -- the sample training path: full-width R2R IL + A2C
               (HAMTAgent.train_iteration("sample"), the same optimizer,
               production dropout, batch 8, T = 15), merged (8 sampling
               lanes and 8 teacher-forced lanes in one rollout); 3
               warm-up and 20 timed updates: sample episodes/s, the
               losses, peak memory, and 295 forward (279 at 16 lanes, the
               bootstrap's 16 at 8) and 240 backward launches per update.
               Then 3 fused updates (the teacher episode forward, then
               the rollout): 574 forward and 480 backward launches each.
9. sample_parity -- card against CPU, batch 4, dropout off, the same
               weights and batches: the argmax rollout with rewards and
               the bootstrap value (identical trajectories, masks and
               bootstrap mask; rewards, logits, values and last_value
               within tolerance), and the fused IL + A2C loss with the
               argmax policy and every model and critic gradient.

The second-to-last line is the kernel summary {"kernels": [...]}, each
kernel at the batch of its main path: the forward's launches from the
serving slice and its times at batch 32, the backward's from the
training slice and its times at batch 8; each also with its launches
per merged and per fused sample update and its times at batch 16. The
last is {"ok": true, "device": {...}}. Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero before
printing either.
"""

from __future__ import annotations

import json
import math
import sys
import time

import torch

from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.ops import attention as attn
from vln_hamt_torch.run.profile_attention import (
    build_all, kernel_inputs, launch_mix, nvidia_smi, rel_err, time_backward, time_forward,
    weighted)
from vln_hamt_torch.run.profile_eval import slice_config, slice_env

B, H, DH = 32, 12, 64
TRAIN_B = 8  # the r2r preset's training batch
MERGED_B = 2 * TRAIN_B  # lanes of the merged sample update's rollout
TOL = {  # forward kernel vs plain twin, max abs error
    (torch.float32, 0.0): 1e-5,  # fp32, another summation order
    (torch.bfloat16, 0.0): 1e-5,  # bf16 inputs widened to fp32 alike on both sides
    (torch.float32, 0.1): 2e-5,  # kept values scaled by 1 / (1 - rate)
    (torch.bfloat16, 0.1): 2e-5,
}
# shapes the query-blocked tilings can get wrong, checked at both
# batches: (Lq, Lk, Dh, every third batch element's keys all at -10000)
EDGE_CASES = ((1, 1, DH, False), (33, 65, DH, False), (65, 65, DH, True),
              (65, 65, 16, False), (65, 65, 128, False))
# and for the backward the lengths past its old limit of 114 tokens (R4R
# and CVDN text, RxR text and its cross-attention with the visual
# tokens), and 300 query rows: more query blocks than a thread-block
# cluster holds, summed through global scratch
BWD_EDGE_CASES = EDGE_CASES + ((100, 100, DH, False), (250, 65, DH, False),
                               (65, 250, DH, False), (250, 250, DH, False),
                               (300, 65, DH, False))
# backward kernel vs plain twin, max abs error over the tensor's max abs
# value. fp32: sums of at most 250 (dq, dk, dv) or 12 x 250 (dm) products
# in another order than cuBLAS's. bf16 dq, dk, dv: both sides round an
# fp32 value to bf16, and a last-bit fp32 difference may flip that
# rounding by one bf16 step, 2^-8 of the value. dm is fp32 always.
BWD_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -8}
BWD_DM_RTOL = 2e-5
PARITY_LOGIT_ATOL = 1e-3  # card vs CPU after 13 fp32 layers per step
# card vs CPU rewards of one rollout: fp32 distances and nDTW, as the
# JAX package holds its device rollout against its host rollout
REWARD_RTOL, REWARD_ATOL = 1e-4, 1e-5
# card vs CPU, one IL update: the loss relative, each gradient tensor
# within 1e-3 of its own largest entry, plus 1e-6 of the model's largest
# gradient for tensors that are zero in exact arithmetic and rounding
# noise on both sides (the attention key biases, the action head's
# LayerNorm and output biases: a softmax ignores a shift of its inputs)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR = 1e-3, 1e-6


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def reset_counts() -> None:
    for name in attn.launch_counts:
        attn.launch_counts[name] = 0


def check_bwd(q, k, v, m, g, seed, rate, where):
    """The backward kernel against its plain twin on the same inputs:
    each output's relative error, raising above its tolerance; and the
    largest absolute error."""
    got = attn.attention_bwd(q, k, v, m, g, seed, rate)
    want = attn.attention_bwd_reference(q, k, v, m, g, seed, rate)
    torch.cuda.synchronize()
    errs, abs_err = {}, 0.0
    for name, x, y in zip(("dq", "dk", "dv", "dm"), got, want):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"backward {name}: {x.shape} {x.dtype} vs "
                                 f"{y.shape} {y.dtype}")
        errs[name] = rel_err(x, y)
        tol = BWD_DM_RTOL if name == "dm" else BWD_RTOL[q.dtype]
        if not errs[name] <= tol:
            raise AssertionError(f"attention backward {where} {q.dtype} rate {rate}: "
                                 f"{name} rel err {errs[name]} > {tol}")
        abs_err = max(abs_err, (x.float() - y.float()).abs().max().item())
    return errs, abs_err


def check_fwd(q, k, v, m, seed, rate, where) -> float:
    """The forward kernel against its plain twin on the same inputs: the
    largest absolute error, raising above its tolerance or on a wrong
    shape or a non-finite value."""
    got = attn.fused_attention(q, k, v, m, dropout_rate=rate, dropout_seed=seed)
    want = attn.attention_reference(q, k, v, m, seed, rate)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"attention {where}: output {tuple(got.shape)} against "
                             f"{tuple(want.shape)}, or not finite")
    err = (got - want).abs().max().item()
    tol = TOL[(q.dtype, rate)]
    if not err <= tol:
        raise AssertionError(f"attention {where} {q.dtype} rate {rate}: "
                             f"max abs err {err} > {tol}")
    return err


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def phase_kernels(dev, fwd_mix, bwd_mix):
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd_rows, bwd_rows, fwd_err, bwd_err = [], [], 0.0, 0.0
    seed = 2**31 + 7  # above int32: exercises the 32-bit wrap
    for (lq, lk) in fwd_mix:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, m, g = kernel_inputs(B, H, lq, lk, DH, dtype, gen, dev)
            for rate in (0.0, 0.1):
                err = check_fwd(q, k, v, m, seed, rate, f"B {B} ({lq},{lk})")
                fwd_err = max(fwd_err, err)
                row = {"lq": lq, "lk": lk, "dtype": dtype_name(dtype), "rate": rate,
                       "max_abs_err": err, "tol": TOL[(dtype, rate)]}
                if rate == 0.0:
                    row.update(time_forward(q, k, v, m))
                fwd_rows.append(row)

                # the backward at the same inputs, dropout bits included
                errs, err = check_bwd(q, k, v, m, g, seed, rate, f"B {B} ({lq},{lk})")
                bwd_err = max(bwd_err, err)
                brow = {"lq": lq, "lk": lk, "dtype": dtype_name(dtype), "rate": rate,
                        "rel_err": errs, "rtol": BWD_RTOL[dtype], "dm_rtol": BWD_DM_RTOL}
                if rate == 0.0:
                    brow.update(time_backward(q, k, v, m, g), main_path=(lq, lk) in bwd_mix)
                bwd_rows.append(brow)
    emit("kernels", kernel="attention_fwd", batch=B, heads=H, head_dim=DH, results=fwd_rows)
    emit("kernels", kernel="attention_bwd", batch=B, heads=H, head_dim=DH, results=bwd_rows)

    # the forward at the training batch, which each IL update launches 279
    # times: checked at both rates, timed with dropout off
    fwd8 = []
    for (lq, lk) in fwd_mix:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, m, _ = kernel_inputs(TRAIN_B, H, lq, lk, DH, dtype, gen, dev)
            for rate in (0.0, 0.1):
                err = check_fwd(q, k, v, m, seed, rate, f"B {TRAIN_B} ({lq},{lk})")
                fwd_err = max(fwd_err, err)
                row = {"lq": lq, "lk": lk, "dtype": dtype_name(dtype), "rate": rate,
                       "max_abs_err": err}
                if rate == 0.0:
                    row.update(time_forward(q, k, v, m))
                fwd8.append(row)
    emit("kernels", kernel="attention_fwd", batch=TRAIN_B, heads=H, head_dim=DH, results=fwd8,
         weighted={key: weighted(fwd8, fwd_mix, lambda r: r[key])
                   for key in ("ms", "plain_ms", "library_ms", "bytes_ms", "flops_ms")})

    # the edge cases of the query-blocked tilings, at both batches
    edge, bwd_edge = [], []
    for batch in (B, TRAIN_B):
        for (lq, lk, dh, masked) in BWD_EDGE_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, m, g = kernel_inputs(batch, H, lq, lk, dh, dtype, gen, dev, masked)
                for rate in (0.0, 0.1):
                    where = f"B {batch} ({lq},{lk}) Dh {dh}{' masked rows' if masked else ''}"
                    case = {"batch": batch, "lq": lq, "lk": lk, "head_dim": dh,
                            "masked_rows": masked, "dtype": dtype_name(dtype), "rate": rate}
                    if (lq, lk, dh, masked) in EDGE_CASES:
                        err = check_fwd(q, k, v, m, seed, rate, where)
                        fwd_err = max(fwd_err, err)
                        edge.append({**case, "max_abs_err": err})
                    errs, err = check_bwd(q, k, v, m, g, seed, rate, where)
                    bwd_err = max(bwd_err, err)
                    bwd_edge.append({**case, "rel_err": errs})
    emit("kernels", kernel="attention_fwd", edge_cases=edge)
    emit("kernels", kernel="attention_bwd", edge_cases=bwd_edge)

    # the backward at the training batch and the main path's own shapes:
    # checked at both rates, timed with dropout off
    b8 = []
    for (lq, lk) in bwd_mix:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, m, g = kernel_inputs(TRAIN_B, H, lq, lk, DH, dtype, gen, dev)
            for rate in (0.0, 0.1):
                errs, err = check_bwd(q, k, v, m, g, seed, rate,
                                      f"B {TRAIN_B} ({lq},{lk})")
                bwd_err = max(bwd_err, err)
                row = {"lq": lq, "lk": lk, "dtype": dtype_name(dtype), "rate": rate,
                       "rel_err": errs}
                if rate == 0.0:
                    row.update(time_backward(q, k, v, m, g))
                b8.append(row)
    emit("kernels", kernel="attention_bwd", batch=TRAIN_B, heads=H, head_dim=DH, results=b8)

    # both kernels at the merged sample update's 16 lanes, fp32, at the
    # shapes it launches them with: checked at both rates, timed with
    # dropout off
    f16, b16 = [], []
    for (lq, lk) in fwd_mix:
        q, k, v, m, g = kernel_inputs(MERGED_B, H, lq, lk, DH, torch.float32, gen, dev)
        for rate in (0.0, 0.1):
            where = f"B {MERGED_B} ({lq},{lk})"
            row = {"lq": lq, "lk": lk, "dtype": "float32", "rate": rate,
                   "max_abs_err": check_fwd(q, k, v, m, seed, rate, where)}
            fwd_err = max(fwd_err, row["max_abs_err"])
            if rate == 0.0:
                row.update(time_forward(q, k, v, m))
            f16.append(row)
            if (lq, lk) not in bwd_mix:
                continue
            errs, err = check_bwd(q, k, v, m, g, seed, rate, where)
            bwd_err = max(bwd_err, err)
            brow = {"lq": lq, "lk": lk, "dtype": "float32", "rate": rate, "rel_err": errs,
                    "max_abs_err": err}
            if rate == 0.0:
                brow.update(time_backward(q, k, v, m, g))
            b16.append(brow)
    emit("kernels", kernel="attention_fwd", batch=MERGED_B, heads=H, head_dim=DH, results=f16)
    emit("kernels", kernel="attention_bwd", batch=MERGED_B, heads=H, head_dim=DH, results=b16)
    return fwd_rows, b8, (f16, b16), fwd_err, bwd_err


def kernel_times(rows, mix):
    """Times and bound from ``rows`` (one batch), weighted over ``mix``'s
    launches by shape."""
    bytes_mean = weighted(rows, mix, lambda r: r["bytes_ms"])
    flops_mean = weighted(rows, mix, lambda r: r["flops_ms"])
    return {
        "ms": weighted(rows, mix, lambda r: r["ms"]),
        "plain_ms": weighted(rows, mix, lambda r: r["plain_ms"]),
        "bound_ms": weighted(rows, mix, lambda r: max(r["bytes_ms"], r["flops_ms"])),
        "bound_by": "bytes" if bytes_mean >= flops_mean else "operations",
        "library_ms": weighted(rows, mix, lambda r: r["library_ms"]),
    }


def summary_row(name, source, replaces, launches, max_err, rows, mix, batch, sample):
    """The kernel's line of the summary: ``launches`` from the run of its
    main path, times and bound from ``rows`` timed at that path's batch
    and shapes, weighted by its launches per shape; ``sample``: its
    launches per merged and fused sample update and its times at the
    merged update's batch."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "batch": batch, "max_abs_err": max_err,
            **kernel_times(rows, mix), "sample": sample}


def il_gradients(agent, ep):
    """Loss and named gradients of one IL update's loss, no step."""
    agent.model.train()
    agent.critic.train()
    loss = agent._il_loss(ep, agent.cfg.train.teacher_weight)
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in agent.model.named_parameters()
             if p.grad is not None}
    return loss.item(), grads


def sample_gradients(agent, il_ep, ins):
    """Loss and named model and critic gradients of the fused sample
    update's loss with the argmax policy (no draws), no step."""
    agent.model.train()
    agent.critic.train()
    loss, _ = agent._fused_sample_loss(il_ep, ins, policy="argmax")
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in agent.model.named_parameters()
             if p.grad is not None}
    grads.update({"critic." + k: p.grad.detach().cpu()
                  for k, p in agent.critic.named_parameters()})
    return loss.item(), grads


def check_grads(grads_g, grads_c, what):
    """Card gradients against CPU ones, each tensor within TRAIN_GRAD_REL
    of its own largest entry plus TRAIN_GRAD_FLOOR of the largest
    gradient; returns the worst error over its tolerance."""
    if grads_g.keys() != grads_c.keys():
        raise AssertionError(f"{what}: gradients on different parameters: "
                             f"{sorted(grads_g.keys() ^ grads_c.keys())}")
    top = max(g.abs().max().item() for g in grads_c.values())
    worst = 0.0
    for name, gc in grads_c.items():
        scale = gc.abs().max().item()
        err = (grads_g[name] - gc).abs().max().item()
        tol = TRAIN_GRAD_REL * scale + TRAIN_GRAD_FLOOR * top
        if not err <= tol:
            raise AssertionError(f"{what}: card vs CPU gradient of {name}: {err} "
                                 f"(max {scale})")
        worst = max(worst, err / tol)
    return worst


def timed_sample_updates(agent, iters):
    """``iters`` sample updates, unsynchronized, from zeroed launch
    counts: their losses (host tensors), wall seconds and launches."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = [agent.train_iteration("sample", sync=False) for _ in range(iters)]
    keys = ("loss", "IL_loss", "RL_loss", "entropy")
    vals = torch.stack([torch.stack([o[k] for k in keys]) for o in outs]).cpu()
    seconds = time.perf_counter() - t0
    launches = dict(attn.launch_counts)
    if not torch.isfinite(vals).all():
        raise AssertionError(f"non-finite sample losses {vals.tolist()}")
    return dict(zip(keys, vals.T)), seconds, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ------------------------------------------------------------ device
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi)

    # ------------------------------------------------------------- build
    t0 = time.perf_counter()
    for name, built in build_all().items():  # registers and spills per instantiation
        emit("build", kernel=name, **built)
    emit("build", wall_seconds=time.perf_counter() - t0)

    # ------------------------------------------------- the slice's world
    cfg, world = slice_config(B, seed=0)
    mcfg, t_max = cfg.model, cfg.env.max_action_len
    # attention launches by (Lq, Lk): the forward's per greedy batch or IL
    # update, the backward's per IL update
    mix, bwd_mix = launch_mix(cfg)
    per_batch, per_update_bwd = sum(mix.values()), sum(bwd_mix.values())
    if per_batch != 279 or per_update_bwd != 240:
        raise AssertionError(f"launch mix {mix} / {bwd_mix}: expected 279 and 240")

    # ----------------------------------------------------------- kernels
    # timed at each main path's batch: the forward at the serving slice's
    # 32, the backward at the training slice's 8
    fwd_rows, bwd_rows, (f16_rows, b16_rows), fwd_err, bwd_err = phase_kernels(
        dev, mix, bwd_mix)

    # ------------------------------------------------------------- slice
    env = slice_env(cfg, world, seed=0)
    agent = HAMTAgent(cfg, env, seed=0)  # the card, by default
    agent.enable_feature_table()
    agent.eval_split_device()  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    preds = agent.eval_split_device()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    slice_launches = dict(attn.launch_counts)
    batches = len(world.instr_data) // B + 1  # iterate until an instr_id repeats
    if slice_launches != {"attention_fwd": per_batch * batches, "attention_bwd": 0}:
        raise AssertionError(f"attention launches {slice_launches} != 279 x {batches} batches "
                             f"and no backward (per batch by shape: {mix})")
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
         launches=slice_launches, launches_per_batch=per_batch, shape_mix=
         {f"{lq}x{lk}": n for (lq, lk), n in mix.items()},
         attention_ms_per_batch=weighted(fwd_rows, mix, lambda r: r["ms"]) * per_batch)
    del agent

    # ------------------------------------------------------------ parity
    small = cfg.replace(train={"batch_size": 4})
    outs = {}
    for device in ("cuda", "cpu"):
        pagent = HAMTAgent(small, slice_env(small, world, seed=0), seed=0, device=device)
        pagent.enable_feature_table()
        ins = pagent._device_rollout_args(include_rewards=False)
        with torch.no_grad():  # as eval_split_device calls it
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
    del pagent, outs

    # ------------------------------------------------------------- train
    tcfg = cfg.replace(train={"batch_size": TRAIN_B, "feedback": "teacher"})
    tr = tcfg.train
    if (tr.optim, tr.lr, tr.grad_clip, tr.weight_decay) != ("adamw", 1e-5, 40.0, 0.0):
        raise AssertionError(f"the r2r preset's optimizer changed: {tr}")
    agent = HAMTAgent(tcfg, slice_env(tcfg, world, seed=0), seed=0)
    agent.enable_feature_table()
    for _ in range(3):  # warm-up: allocator, cuBLAS workspaces
        agent.train_iteration("teacher", sync=False)
    torch.cuda.synchronize()
    iters = 20
    reset_counts()
    t0 = time.perf_counter()
    losses = [agent.train_iteration("teacher", sync=False)["loss"] for _ in range(iters)]
    losses = torch.stack(losses).cpu()  # waits for the last update
    seconds = time.perf_counter() - t0
    train_launches = dict(attn.launch_counts)
    want = {"attention_fwd": per_batch * iters, "attention_bwd": per_update_bwd * iters}
    if train_launches != want:
        raise AssertionError(f"IL launches {train_launches} != {want} "
                             f"(279 forward, 240 backward per update)")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite IL losses {losses.tolist()}")
    emit("train", preset="r2r", hidden=mcfg.hidden_size, batch=TRAIN_B, t_max=t_max,
         optim=tr.optim, lr=tr.lr, grad_clip=tr.grad_clip,
         dropout=[mcfg.hidden_dropout_prob, mcfg.attention_probs_dropout_prob,
                  mcfg.feat_dropout], updates=iters, seconds=seconds,
         il_episodes_per_s=iters * TRAIN_B / seconds, ms_per_update=seconds / iters * 1e3,
         loss_mean=losses.mean().item(), loss_first=losses[0].item(),
         loss_last=losses[-1].item(), launches=train_launches,
         launches_per_update={k: v / iters for k, v in train_launches.items()},
         bwd_shape_mix={f"{lq}x{lk}": n for (lq, lk), n in bwd_mix.items()},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    del agent

    # one repeated batch, dropout off, lr 1e-4: the loss must fall
    no_drop = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
               "feat_dropout": 0.0, "pred_head_dropout_prob": 0.0, "critic_dropout": 0.0}
    ocfg = tcfg.replace(model=no_drop, train={"lr": 1e-4})
    agent = HAMTAgent(ocfg, slice_env(ocfg, world, seed=0), seed=0)
    agent.enable_feature_table()
    ep = agent._ep_to_device(agent.env.teacher_episode())
    fit = torch.stack([agent._il_update(ep, 1.0) for _ in range(15)]).cpu()
    if not torch.isfinite(fit).all() or not fit[-1] < fit[0]:
        raise AssertionError(f"15 updates on one batch did not lower the loss: {fit.tolist()}")
    emit("train", overfit_losses=fit.tolist())
    del agent

    # ------------------------------------------------------ train_parity
    pcfg = cfg.replace(model=no_drop, train={"batch_size": 4, "feedback": "teacher"})
    for fix in (True, False):
        fcfg = pcfg.replace(model={"fix_lang_embedding": fix, "fix_hist_embedding": fix})
        res = {}
        reset_counts()
        for device in ("cuda", "cpu"):
            pagent = HAMTAgent(fcfg, slice_env(fcfg, world, seed=0), seed=0, device=device)
            pagent.enable_feature_table()
            res[device] = il_gradients(pagent, pagent._ep_to_device(pagent.env.teacher_episode()))
            del pagent
        counts = dict(attn.launch_counts)
        (loss_g, grads_g), (loss_c, grads_c) = res["cuda"], res["cpu"]
        loss_err = abs(loss_g - loss_c) / abs(loss_c)
        if not loss_err <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"card vs CPU IL loss {loss_g} vs {loss_c}")
        worst = check_grads(grads_g, grads_c, "IL update")
        # with the flags off the text stack and the panorama encoder run
        # backward too, except at the last step: its history token is
        # never read, so autograd skips that encoder (the JAX package's
        # scan runs it on a zero cotangent)
        want_bwd = per_update_bwd + (0 if fix else mcfg.num_l_layers
                                     + (t_max - 1) * mcfg.num_h_pano_layers)
        if counts != {"attention_fwd": per_batch, "attention_bwd": want_bwd}:
            raise AssertionError(f"train_parity launches {counts}, expected "
                                 f"{per_batch} / {want_bwd}")
        emit("train_parity", fix_lang_and_hist=fix, batch=4, loss_cuda=loss_g, loss_cpu=loss_c,
             loss_rel_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL, tensors=len(grads_c),
             max_grad_err_over_tol=worst, grad_rel_tol=TRAIN_GRAD_REL,
             grad_floor=TRAIN_GRAD_FLOOR, launches=counts)

    # ------------------------------------------------------------ sample
    # IL + A2C on the same optimizer and dropout as `train`; merged first
    # (the CLI's default), then fused
    scfg = cfg.replace(train={"batch_size": TRAIN_B, "feedback": "sample"})
    agent = HAMTAgent(scfg, slice_env(scfg, world, seed=0), seed=0)
    agent.merged_sample_update = True
    agent.enable_feature_table()
    for _ in range(3):  # warm-up
        agent.train_iteration("sample", sync=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 20
    losses, seconds, merged_launches = timed_sample_updates(agent, iters)
    # the rollout at 16 lanes (279) and the bootstrap at the 8 RL lanes
    # (4 cross-modal layers x 4 attentions); the backward of the
    # cross-modal layers at 16 lanes
    boot = 4 * mcfg.num_x_layers
    merged_per = {"attention_fwd": per_batch + boot, "attention_bwd": per_update_bwd}
    if merged_launches != {k: n * iters for k, n in merged_per.items()}:
        raise AssertionError(f"merged sample launches {merged_launches} over {iters} "
                             f"updates, expected {merged_per} per update")
    emit("sample", update="merged", preset="r2r", hidden=mcfg.hidden_size, batch=TRAIN_B,
         lanes=MERGED_B, t_max=t_max, optim=tr.optim, lr=tr.lr, grad_clip=tr.grad_clip,
         ml_weight=scfg.train.ml_weight, updates=iters, seconds=seconds,
         sample_episodes_per_s=iters * TRAIN_B / seconds,
         ms_per_update=seconds / iters * 1e3,
         **{f"{k}_mean": v.mean().item() for k, v in losses.items()},
         launches=merged_launches, launches_per_update=merged_per,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)

    agent.merged_sample_update = False  # the fused update, the class default
    agent.train_iteration("sample", sync=False)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    fused_iters = 3
    losses, seconds, fused_launches = timed_sample_updates(agent, fused_iters)
    fused_per = {"attention_fwd": 2 * per_batch + boot, "attention_bwd": 2 * per_update_bwd}
    if fused_launches != {k: n * fused_iters for k, n in fused_per.items()}:
        raise AssertionError(f"fused sample launches {fused_launches} over {fused_iters} "
                             f"updates, expected {fused_per} per update")
    emit("sample", update="fused", batch=TRAIN_B, updates=fused_iters, seconds=seconds,
         sample_episodes_per_s=fused_iters * TRAIN_B / seconds,
         ms_per_update=seconds / fused_iters * 1e3,
         **{f"{k}_mean": v.mean().item() for k, v in losses.items()},
         launches=fused_launches, launches_per_update=fused_per,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    del agent

    # ----------------------------------------------------- sample_parity
    # one rewarded argmax rollout, then the fused loss on the next batch
    # (the update's host order: teacher episode, then the rollout's reset)
    spcfg = cfg.replace(model=no_drop, train={"batch_size": 4, "feedback": "sample"})
    res = {}
    reset_counts()
    for device in ("cuda", "cpu"):
        pagent = HAMTAgent(spcfg, slice_env(spcfg, world, seed=0), seed=0, device=device)
        pagent.enable_feature_table()
        ins = pagent._device_rollout_args()
        with torch.no_grad():
            ep, ex = pagent._rollout(ins, ins["txt_ids"], ins["txt_mask"], "argmax")
        il_ep = pagent._ep_to_device(pagent.env.teacher_episode())
        loss, grads = sample_gradients(pagent, il_ep, pagent._device_rollout_args())
        res[device] = ({k: v.cpu() for k, v in ep.items()},
                       {k: v.cpu() for k, v in ex.items()}, loss, grads)
        del pagent
    counts = dict(attn.launch_counts)
    (ep_g, ex_g, loss_g, grads_g), (ep_c, ex_c, loss_c, grads_c) = res["cuda"], res["cpu"]
    for key in ("node_idx", "view_index", "actions", "step_mask", "final_node_idx"):
        if not torch.equal(ep_g[key], ep_c[key]):
            raise AssertionError(f"sample_parity: card and CPU trajectories differ in {key}")
    for key in ("masks", "bootstrap_mask"):
        if not torch.equal(ex_g[key], ex_c[key]):
            raise AssertionError(f"sample_parity: card and CPU {key} differ")
    if not torch.allclose(ex_g["rewards"], ex_c["rewards"], rtol=REWARD_RTOL,
                          atol=REWARD_ATOL):
        raise AssertionError(f"sample_parity: rewards {ex_g['rewards'].tolist()} vs "
                             f"{ex_c['rewards'].tolist()}")
    lg, lc = ex_g["rollout_logits"], ex_c["rollout_logits"]
    fin = torch.isfinite(lc)
    if not torch.equal(torch.isfinite(lg), fin):
        raise AssertionError("sample_parity: logits are -inf at different places")
    errs = {"rollout_logits": (lg[fin] - lc[fin]).abs().max().item()}
    errs.update({k: (ex_g[k] - ex_c[k]).abs().max().item() for k in ("values", "last_value")})
    if not max(errs.values()) <= PARITY_LOGIT_ATOL:
        raise AssertionError(f"sample_parity: card vs CPU {errs}")
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"card vs CPU fused sample loss {loss_g} vs {loss_c}")
    worst = check_grads(grads_g, grads_c, "fused sample update")
    # the rewarded rollout and its bootstrap, then the fused update's IL
    # episode, rollout and bootstrap, and their backward
    want = {"attention_fwd": 3 * per_batch + 2 * boot, "attention_bwd": 2 * per_update_bwd}
    if counts != want:
        raise AssertionError(f"sample_parity launches {counts}, expected {want}")
    emit("sample_parity", batch=4, t_max=t_max, trajectories_identical=True,
         steps=int(ex_c["masks"].sum().item()),
         reward_max_abs_err=(ex_g["rewards"] - ex_c["rewards"]).abs().max().item(),
         max_abs_err=errs, tol=PARITY_LOGIT_ATOL, loss_cuda=loss_g, loss_cpu=loss_c,
         loss_rel_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL, tensors=len(grads_c),
         max_grad_err_over_tol=worst, launches=counts)

    sample = {
        name: {"launches_per_update": {"merged": merged_per[name], "fused": fused_per[name]},
               "batch": MERGED_B, **kernel_times(rows, m)}
        for name, rows, m in (("attention_fwd", f16_rows, mix),
                              ("attention_bwd", b16_rows, bwd_mix))}
    summary = {"kernels": [
        summary_row("attention_fwd", "vln_hamt_torch/csrc/attention.cu",
                    "vln_hamt_tpu/ops/attention.py:53",  # _attn_kernel
                    slice_launches["attention_fwd"], fwd_err, fwd_rows, mix, B,
                    sample["attention_fwd"]),
        summary_row("attention_bwd", "vln_hamt_torch/csrc/attention_bwd.cu",
                    "vln_hamt_tpu/ops/attention.py:85",  # _attn_bwd_kernel
                    train_launches["attention_bwd"], bwd_err, bwd_rows, bwd_mix, TRAIN_B,
                    sample["attention_bwd"]),
    ]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
