"""Greedy evaluation: ``HAMTAgent.eval_split_fast``, the CLI's
``--valid_only`` path, over shards of a validation split.

Shard ``k`` holds items ``n k`` to ``n k + n - 1`` of the split, taken
round it, ``n`` the cell's ``shard_items``, so that every call does the
same work (a shard of the whole split's 2,349 items is the split itself,
in one order); the window runs whole calls, one after the other, and the
rate counts every item of them. One env, built in set-up over the split
as a user's evaluation builds it, is pointed at each shard in turn.
``eval_split_device`` runs batches until an item repeats, so a shard
that the batch divides pays one more rollout that finds its first items
again; one that it does not divide pays none.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from .. import harness, trace
from ..reference.evaluate import judge
from ..reference.navigation import Tables
from ..work import attention as attn_work
from ..work import flops as flop_work

#: shard calls in the traced window
TRACED = 2
#: the keys this entry reads from its cell file, besides the common ones
CELL_KEYS = ("shard_items", "warmup_calls", "check_episodes")


def _shard(state, k: int) -> List[dict]:
    items, n = state.world.items, int(state.ctx.cell["shard_items"])
    return [items[(k * n + j) % len(items)] for j in range(n)]


def _call(state) -> None:
    items = _shard(state, state.calls)
    state.env.data = list(items)  # eval_split_device starts at the first item
    preds = state.agent.eval_split_fast(state.env)
    state.outputs.append((items, preds))
    state.calls += 1


def setup(ctx) -> SimpleNamespace:
    world = harness.world_of(ctx)
    env = harness.program_env(ctx, world, world.items, int(ctx.cell["batch"]), "val_unseen")
    agent = harness.program_agent(ctx, world, env)
    state = SimpleNamespace(ctx=ctx, world=world, agent=agent, env=env, outputs=[], calls=0,
                            attempted=0, failed=0)
    for _ in range(int(ctx.cell["warmup_calls"])):
        _call(state)
    return state


def window(state, seconds: float) -> Dict[str, float]:
    start = state.calls
    t0 = time.perf_counter()
    while True:
        _call(state)  # each call reads its predictions back: the clock sees the device
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    state.attempted = (state.calls - start) * int(state.ctx.cell["shard_items"])
    return {"eval_episodes_per_s": state.attempted / elapsed}


def traced(state) -> dict:
    summary = trace.profile(lambda: _call(state), TRACED, "eval_split_fast", state.ctx.device)
    c, b = state.ctx.config, int(state.ctx.cell["batch"])
    state.attempted = TRACED * int(state.ctx.cell["shard_items"])
    t_max = c["env"]["max_action_len"]
    useful = 0.0
    # trace.profile runs TRACED calls untraced, then the window the numbers
    # come from, then one that names the gaps
    for _, preds in state.outputs[-2 * TRACED:-TRACED]:
        # predictions come in the device rollout's batch order; a batch runs
        # to its last stop (a trajectory of m moves took m + 1 decisions)
        lens = [min(len(p["trajectory"]), t_max) for p in preds]
        useful += sum(flop_work.rollout(c["model"], c["env"], b, max(lens[i:i + b]))
                      for i in range(0, len(lens), b))
    # the kernels run every rollout of a call at every step: the full
    # batches, then one that ends the shard or only finds its first items
    batches = TRACED * (int(state.ctx.cell["shard_items"]) // b + 1)
    bound = attn_work.eval_bound_s(c["model"], c["env"], b)
    summary.update(kind="eval", units=state.attempted, flops=useful,
                   peak_flops=flop_work.peak(c["model"]["dtype"]),
                   attn_fwd_bound_s=batches * bound["fwd"], attn_bwd_bound_s=0.0)
    return summary


def _pool(state):
    """Every call's (item, trajectory) pairs and the count of items with
    no prediction or with more than one."""
    missing, pool = 0, []
    for items, preds in state.outputs:
        got = {p["instr_id"]: p for p in preds}
        missing += sum(1 for it in items if it["instr_id"] not in got)
        missing += len(preds) - len(got)
        pool += [(it, got[it["instr_id"]]["trajectory"]) for it in items
                 if it["instr_id"] in got]
    return pool, missing


def check(state) -> list:
    """Every item of every call predicted once; a sample of the window's
    trajectories, drawn from the seed with the longest among them, judged
    by the reference; frees the program first."""
    ctx = state.ctx
    pool, missing = _pool(state)
    harness.free(state.__dict__.pop("agent"), state.__dict__.pop("env"))
    nums = judge_sample(ctx, state.world, pool)[0]
    nums["mismatch"] += missing
    limits = ctx.cell["limits"]
    return [(k, nums[k], float(limits[k])) for k in limits]


def calibrate(state, calls: int = 3) -> tuple:
    """(program's numbers, control's numbers): a short window of
    ``calls`` shard calls at the cell's load, then the sample judged by
    the reference, and the TF32 reference's own choices along the same
    trajectories judged by it too."""
    for _ in range(calls):
        _call(state)
    pool, missing = _pool(state)
    harness.free(state.__dict__.pop("agent"), state.__dict__.pop("env"))
    prog, ctl = judge_sample(state.ctx, state.world, pool, control=True)
    prog["mismatch"] += missing
    return prog, ctl


def sample(ctx, pool):
    n = min(int(ctx.cell["check_episodes"]), len(pool))
    longest = max(range(len(pool)), key=lambda i: len(pool[i][1]))
    rng = np.random.default_rng(ctx.seed + harness.SAMPLE_SEED)
    rest = [i for i in rng.permutation(len(pool)).tolist() if i != longest][:n - 1]
    return [pool[i] for i in [longest] + rest]


def judge_sample(ctx, world, pool, control: bool = False) -> tuple:
    """The reference's judgement of the sample, and with ``control`` the
    TF32 reference's own choices along the same trajectories, judged by
    the float32 reference (else None)."""
    picked = sample(ctx, pool)
    c, dev = ctx.config, ctx.device
    tables = Tables(world, c["env"]["max_candidates"], c["model"]["angle_feat_size"], dev)
    feats = harness.features(ctx, world)
    w, cw = harness.weights(ctx)
    items, trajs = [p[0] for p in picked], [p[1] for p in picked]
    ref = judge(c, tables, feats, w, cw, items, trajs)
    prog = {"logit_gap": ref["gap"], "mismatch": float(ref["mismatch"])}
    if not control:
        return prog, None
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low = judge(c, tables, feats, w, cw, items, trajs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    lg = ref["logits"]
    chosen = torch.gather(lg, -1, low["logits"].argmax(-1)[..., None])[..., 0]
    gap = (lg.max(-1).values - chosen)[ref["live"]]
    return prog, {"logit_gap": float(gap.max()), "mismatch": 0.0}
