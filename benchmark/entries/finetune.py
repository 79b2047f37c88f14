"""Fine-tuning: ``HAMTAgent.train_iteration`` with ``--feedback sample``,
the merged IL + A2C update, updates issued back to back as
``run/finetune.py`` issues them (``sync=False``).

Set-up builds the agent over the cell's world, drives its first three
updates through the window's own call and feed while noting what the
check compares (each update's loss, the first gradient from the
optimizer's moments after one update, every parameter's change after one
update and after three), and hands the same agent to the window. Every
update, in set-up and in the window, leaves its record: the lanes'
instructions, starts, actions, poses, live masks and teacher targets.
The reference replays the first three updates in full and walks every
later record through the world. An update trains a batch of ``batch``
sampled episodes and ``batch`` teacher-forced ones, and the rate counts
both.
"""

from __future__ import annotations

import statistics
import time
from types import SimpleNamespace
from typing import Dict, List

import torch

from .. import harness, trace
from ..reference.finetune import ADAM_B1, Replay
from ..reference.navigation import Tables, record_mismatch
from ..work import attention as attn_work
from ..work import flops as flop_work

#: updates the reference follows
CHECKED = 3
#: updates in the traced window
TRACED = 3
#: a leaf's change is compared where its first gradient reaches this
#: share of the median leaf's (a key's bias under softmax moves by
#: round-off alone)
MOVED = 1e-3
_RECORD = ("actions", "node_idx", "view_index", "step_mask")
#: the keys this entry reads from its cell file, besides the common ones
CELL_KEYS = ()


def _named(agent):
    return ([(n, p, agent.optimizer) for n, p in agent.model.named_parameters()]
            + [("critic." + n, p, agent.critic_optimizer)
               for n, p in agent.critic.named_parameters()])


def setup(ctx) -> SimpleNamespace:
    world = harness.world_of(ctx)
    env = harness.program_env(ctx, world, world.items, int(ctx.cell["batch"]), "train")
    agent = harness.program_agent(ctx, world, env)
    agent.merged_sample_update = True  # the CLI's default (run/finetune.py)
    records: List[dict] = []
    teachers: List[torch.Tensor] = []
    rollout, teacher = agent._rollout, agent._teacher_episode

    def note_rollout(ins, txt_ids, txt_mask, policy, il=None):
        ep, extras = rollout(ins, txt_ids, txt_mask, policy, il)
        b = ins["start_node"].shape[0]
        rec = {k: ep[k].detach().clone() for k in _RECORD}
        rec.update(txt_ids=txt_ids[:b].clone(), txt_mask=txt_mask[:b].clone(),
                   start_node=ins["start_node"].clone(), il_txt_ids=txt_ids[b:].clone(),
                   il_txt_mask=txt_mask[b:].clone())
        rec.update({"il_" + k: il[k].clone() for k in _RECORD})
        records.append(rec)
        return ep, extras

    def note_teacher():
        ep = teacher()
        teachers.append(ep["teacher"].clone())
        return ep

    # the notes stay on for the agent's life: every update leaves a record
    agent._rollout, agent._teacher_episode = note_rollout, note_teacher
    losses, grads = [], None
    for k in range(CHECKED):
        losses.append(agent.train_iteration(sync=False)["loss"])
        if k == 0:  # the first gradient as the optimizer took it, the first step
            grads = {n: opt.state[p]["mu"].norm() / (1.0 - ADAM_B1)
                     for n, p, opt in _named(agent) if "mu" in opt.state[p]}
            change1 = _change(ctx, agent)
    change = _change(ctx, agent)
    noted = {"losses": [float(x) for x in losses],
             "grads": {n: float(v) for n, v in grads.items()},
             "change1": {n: float(v) for n, v in change1.items()},
             "change": {n: float(v) for n, v in change.items()}}
    return SimpleNamespace(ctx=ctx, world=world, env=env, agent=agent, noted=noted,
                           records=records, teachers=teachers, updates=CHECKED,
                           attempted=0, failed=0)


def _change(ctx, agent) -> Dict[str, torch.Tensor]:
    """Each parameter's distance from the seeded weights it started at."""
    w0, cw0 = harness.weights(ctx)
    start = {**w0, **{"critic." + k: v for k, v in cw0.items()}}
    return {n: (p.detach() - start[n]).norm() for n, p, _ in _named(agent)}


def _lanes(state) -> int:
    return 2 * int(state.ctx.cell["batch"])


def window(state, seconds: float) -> Dict[str, float]:
    agent = state.agent
    dev = state.ctx.device
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    while True:
        agent.train_iteration(sync=False)
        n += 1
        state.updates += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    state.attempted = n * _lanes(state)
    return {"train_episodes_per_s": state.attempted / elapsed}


def traced(state) -> dict:
    agent = state.agent
    start = len(state.records)

    def update():
        agent.train_iteration(sync=False)
        state.updates += 1

    summary = trace.profile(update, TRACED, "train_iteration", state.ctx.device)
    state.attempted = TRACED * _lanes(state)
    c = state.ctx.config
    b = int(state.ctx.cell["batch"])
    # trace.profile runs TRACED updates untraced, then the window the
    # numbers come from, then one that names the gaps; each update counts
    # its steps up to its lanes' last stop, as upstream's loop ends
    recs = state.records[start + TRACED:start + 2 * TRACED]
    steps = [int(torch.cat([r["step_mask"], r["il_step_mask"]]).any(0).sum()) for r in recs]
    useful = sum(flop_work.update(c["model"], c["env"], b, b, s)["useful"] for s in steps)
    bound = attn_work.update_bound_s(c["model"], c["env"], b, b)
    summary.update(kind="train", units=state.attempted, flops=useful,
                   peak_flops=flop_work.peak(c["model"]["dtype"]),
                   attn_fwd_bound_s=TRACED * bound["fwd"], attn_bwd_bound_s=TRACED * bound["bwd"])
    return summary


def _records(state) -> List[dict]:
    """Every update's record with its teacher targets; frees the program."""
    harness.free(state.__dict__.pop("agent"), state.__dict__.pop("env"))
    for rec, teach in zip(state.records, state.teachers):
        rec["il_teacher"] = teach
    return state.records


def _walk(state, records) -> int:
    """How far the records of the updates after the first three stray
    from the world, with one for each update that left no record."""
    c, dev = state.ctx.config, state.ctx.device
    tables = Tables(state.world, c["env"]["max_candidates"], c["model"]["angle_feat_size"], dev)
    by_text = {tuple(it["instr_encoding"]): it for it in state.world.items}
    bad = abs(state.updates - len(records)) + abs(len(records) - len(state.teachers))
    for rec in records[CHECKED:]:
        bad += record_mismatch(tables, by_text, rec, c["env"]["max_action_len"])
    return bad


def check(state) -> list:
    """Follow the first three updates with the plain reference, walk the
    later records through the world, and compare; frees the program
    first."""
    ctx, noted = state.ctx, state.noted
    records = _records(state)
    walked = _walk(state, records)
    ref = replay(ctx, state.world, records[:CHECKED], tf32=False)
    nums = compare(noted, records, ref, program=True)
    nums["mismatch"] += walked
    limits = ctx.cell["limits"]
    return [(k, nums[k], float(limits[k])) for k in limits]


def calibrate(state) -> tuple:
    """(program's numbers, control's numbers) against the reference: the
    control is the reference itself with TF32 products, in the program's
    place."""
    ctx, noted = state.ctx, state.noted
    records = _records(state)
    walked = _walk(state, records)
    ref = replay(ctx, state.world, records[:CHECKED], tf32=False)
    harness.free()
    low = replay(ctx, state.world, records[:CHECKED], tf32=True)
    prog = compare(noted, records, ref, program=True)
    prog["mismatch"] += walked
    return prog, compare(low, records, ref, program=False)


def replay(ctx, world, records, tf32: bool) -> dict:
    """The reference over the records, in float32 with TF32 off, or with
    TF32 on (the control)."""
    dev = ctx.device
    c = ctx.config
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        tables = Tables(world, c["env"]["max_candidates"], c["model"]["angle_feat_size"], dev)
        feats = harness.features(ctx, world)
        by_text = {tuple(it["instr_encoding"]): it for it in world.items}
        w, cw = harness.weights(ctx)
        rp = Replay(c, tables, feats, by_text, w, cw, ctx.seed, dev)
        losses, perturbed, live, mismatch, grads = [], [], [], 0, None
        for k, rec in enumerate(records):
            out = rp.update(rec)
            losses.append(out["loss"])
            perturbed.append(out["perturbed"])
            live.append(out["live"])
            mismatch += out["mismatch"]
            if k == 0:
                grads = {n: float(g.norm()) for n, g in out["grads"].items()}
                change1 = _ref_change(ctx, rp)
            del out
        return {"losses": losses, "grads": grads, "change1": change1,
                "change": _ref_change(ctx, rp), "perturbed": perturbed, "live": live,
                "mismatch": mismatch}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _ref_change(ctx, rp) -> Dict[str, float]:
    w0, cw0 = harness.weights(ctx)
    start = {**w0, **{"critic." + k: v for k, v in cw0.items()}}
    return {n: float((p.detach() - start[n]).norm()) for n, p in rp.params().items()}


def compare(side: dict, records: List[dict], ref: dict, program: bool) -> Dict[str, float]:
    """The numbers of ``side`` (the program's notes, or the control's
    replay) against the reference's replay: the first update's loss,
    gradient, step and sampled actions, the later two updates' losses
    and sampled actions, the change after three updates by the worst leaf
    and by the median leaf, and the records of the three that disagree
    with the world."""
    losses = [abs(a - b) / abs(b) for a, b in zip(side["losses"], ref["losses"])]
    med = sorted(ref["grads"].values())[len(ref["grads"]) // 2]
    moved = {n for n, g in ref["grads"].items() if g >= MOVED * med}
    # leaves the reference never moves (no gradient) must not move
    frozen = [n for n in ref["change"] if n not in ref["grads"]]
    frozen_moved = sum(1 for n in frozen if side["change"].get(n, 0.0) != 0.0)
    gaps = []
    for k, pert in enumerate(ref["perturbed"]):
        if program:
            acts = records[k]["actions"].long().T  # (T, B)
        else:
            acts = side["perturbed"][k].argmax(-1)
        chosen = torch.gather(pert, -1, acts[..., None])[..., 0]
        gap = pert.max(-1).values - chosen
        gaps.append(gap[ref["live"][k]].max())
    return {"loss_gap": losses[0],
            "grad_gap": harness.leaf_gap(side["grads"], ref["grads"], moved),
            "change_gap": harness.leaf_gap(side["change1"], ref["change1"], moved),
            "action_gap": float(gaps[0]),
            "mismatch": float(ref["mismatch"] if program else 0) + frozen_moved,
            "later_loss_gap": max(losses[1:]),
            "later_action_gap": float(torch.stack(gaps[1:]).max()),
            "change3_gap": harness.leaf_gap(side["change"], ref["change"], moved),
            "change3_median_gap": harness.leaf_gap(side["change"], ref["change"], moved,
                                                   reduce=statistics.median)}
