"""Device-resident episode computation (torch), the port of
``vln_hamt_tpu/agents/rollout.py``: the device rollout
(:func:`build_device_rollout`), greedy for evaluation or sampled with
the task's in-loop reward (R2R, R2R-Back, CVDN, REVERIE) for the
``sample`` update, optionally with teacher-forced IL lanes in the same
loop; the teacher-forced episode
of IL training and of the A2C replay (:func:`build_episode_forward`);
its packed twin, several episodes back to back per slot
(:func:`build_packed_il_forward`, ``agents/packing.py``); and the step
functions of the host-loop rollouts and evaluators
(:func:`build_policy_step`, :func:`build_slot_reset`,
:func:`build_text_row_update`), which the agent calls once per policy
step and reads the action back from.

The reference interleaves per-step GPU forwards with Python list
appends and simulator calls (``agent_cmt.py:248-529``). Here a whole
episode runs on the device: the feature table and the nav tables
(``data/nav_graph.py:build_nav_tables``) live in device memory, so the
graph transition is a gather, the nDTW reward a DP row extension and
the goal distance a cost-slab read, and the Python loop over ``t_max``
only enqueues work — nothing inside it reads a value back to the host.
The sampling rollout keeps its autograd graph, so the ``sample`` update
differentiates through it: no replay, and no key-derivation invariant
to keep (the JAX package's fold_in scheme, rollout.py:39-51).

History cache invariant (as in the JAX package): the cache has a fixed
``T + 1`` slots, the token of step ``t`` is written at slot ``t + 1``,
and per-sample history length is ``1 + (# live steps so far)`` — masked
attention reproduces the reference's per-sample ``hist_lens``
bookkeeping (agent_cmt.py:305-306,399-401) without ragged shapes.

Activation recomputation (``ModelConfig.remat``, :func:`remat_step`):
the three differentiated loops (the device rollout, the episode forward
and the packed forward) run each step's model call as a checkpointed
function of the step's carry (history cache and length) and inputs; its
activations are dropped after the forward and recomputed in backward.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..configs import ModelConfig
from ..data.angle import all_point_angle_feature
from ..models.hamt import HAMT, Critic

#: products without batch dimensions: what ``remat_policy="dots"`` saves
#: (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``)
_SAVED_PRODUCTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def rng_streams(*modules: torch.nn.Module,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Generator, ...]:
    """The random streams a step of ``modules`` draws from: each distinct
    ``DropoutRNG``'s mask and seed generators (``models/layers.py``), and
    ``generator`` (the sampling rollout's actions) when given."""
    rngs = {}
    for module in modules:
        for m in module.modules():
            rng = getattr(m, "rng", None)
            if rng is not None:
                rngs[id(rng)] = rng
    out = [g for rng in rngs.values() for g in (rng.masks, rng.seeds)]
    return tuple(out + ([generator] if generator is not None else []))


def remat_step(step_fn: Callable, cfg: ModelConfig,
               streams: Sequence[torch.Generator] = ()) -> Callable:
    """The configured activation recomputation of one loop step, the
    port of ``vln_hamt_tpu/agents/rollout.py:remat_scan_body``.

    Off (``cfg.remat`` false) it returns ``step_fn`` unchanged. Else,
    under autograd, each call runs ``step_fn`` through
    ``torch.utils.checkpoint.checkpoint`` (non-reentrant): ``"full"``
    keeps none of the step's activations and recomputes the whole step
    in backward; ``"dots"`` keeps the outputs of the products without
    batch dimensions (``aten.mm`` / ``aten.addmm``: the dense layers) and
    recomputes the rest (elementwise work, LayerNorm, both attention
    kernels). Without gradient the step runs as it is.

    The step draws from private generators (``streams``: dropout masks,
    attention seeds, sampled actions), which torch's own RNG stashing
    does not cover. So each call notes their states at its start; the
    recompute starts from them, drawing the forward's masks, seeds and
    actions again, and puts the streams back where it found them. The
    losses, gradients and the streams' next draws equal those without
    recomputation (``tests/test_torch_remat.py``); only the forward
    attention launches grow (``run/profile_attention.py:launch_mix``).
    """
    if not cfg.remat:
        return step_fn
    if cfg.remat_policy == "dots":  # the listed ops saved, every other recomputed
        kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                              _SAVED_PRODUCTS)}
    elif cfg.remat_policy == "full":
        kw = {}
    else:
        raise ValueError(f"unknown remat_policy: {cfg.remat_policy!r}")

    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return step_fn(*args, **kwargs)
        start = [g.get_state() for g in streams]
        calls = 0

        def body(*a, **k):
            nonlocal calls
            calls += 1
            if calls == 1:  # the forward
                return step_fn(*a, **k)
            resume = [g.get_state() for g in streams]
            for g, s in zip(streams, start):
                g.set_state(s)
            try:
                return step_fn(*a, **k)
            finally:  # also when the recompute stops early
                for g, s in zip(streams, resume):
                    g.set_state(s)

        # every random draw is in ``streams``: torch's global RNG needs no stash
        return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False,
                          **kw, **kwargs)

    return run


def hist_mask(hist_len: torch.Tensor, h: int) -> torch.Tensor:
    return torch.arange(h, device=hist_len.device)[None, :] < hist_len[:, None]


def angle_table(angle_feat_size: int, device=None) -> torch.Tensor:
    """(36, 36, A): the angle feature of view j seen from view i."""
    return torch.as_tensor(all_point_angle_feature(angle_feat_size), device=device)


def make_expand_obs(views: int, angle_feat_size: int, ob_type: str = "pano",
                    device=None) -> Callable[..., Dict[str, torch.Tensor]]:
    """Device-side expansion of compact observations.

    The (B, V, D) panorama feature matrix + candidate index/angle tables
    (see env/observation.py) are gathered on the device into the fixed
    layout [candidates | STOP | panorama]. Must match
    ``env/observation.py:expand_obs_np`` exactly (tested).
    """
    table = angle_table(angle_feat_size, device)
    view_ids = torch.arange(views, device=device)

    def expand_obs(pano_feat, view_index, cand_point, cand_ang):
        lead = tuple(pano_feat.shape[:-2])
        d = pano_feat.shape[-1]
        a = cand_ang.shape[-1]
        c = cand_point.shape[-1]
        dtype = pano_feat.dtype

        valid = cand_point >= 0
        idx = torch.where(valid, cand_point, 0).long()
        cand_feats = torch.gather(pano_feat, -2, idx[..., None].expand(*lead, c, d))
        cand_feats = torch.where(valid[..., None], cand_feats, 0.0)
        stop_img = pano_feat.new_zeros(lead + (1, d))
        ob_img = torch.cat([cand_feats, stop_img, pano_feat], dim=-2)

        pano_ang = table[view_index.long()].to(dtype)  # (..., V, A)
        stop_ang = pano_feat.new_zeros(lead + (1, a))
        ob_ang = torch.cat(
            [torch.where(valid[..., None], cand_ang.to(dtype), 0.0), stop_ang, pano_ang],
            dim=-2)

        ob_nav = torch.cat(
            [valid.to(torch.int32),
             torch.full(lead + (1,), 2, dtype=torch.int32, device=valid.device),
             torch.zeros(lead + (views,), dtype=torch.int32, device=valid.device)],
            dim=-1)

        onehot = (idx[..., None] == view_ids) & valid[..., None]
        claimed = onehot.any(dim=-2)
        if ob_type == "cand":
            pano_region = torch.zeros_like(claimed)
        else:
            pano_region = ~claimed
        ob_mask = torch.cat(
            [valid, torch.ones(lead + (1,), dtype=torch.bool, device=valid.device),
             pano_region], dim=-1)

        hist_img = torch.gather(
            pano_feat, -2, view_index.long()[..., None, None].expand(*lead, 1, d)
        ).squeeze(-2)

        return dict(ob_img=ob_img, ob_ang=ob_ang, ob_nav=ob_nav,
                    ob_mask=ob_mask, hist_img=hist_img,
                    pano_img=pano_feat, pano_ang=pano_ang)

    return expand_obs


def gumbel_max(logits: torch.Tensor, generator: torch.Generator,
               rows: Optional[Tuple[int, torch.Tensor]] = None) -> torch.Tensor:
    """One categorical draw per row of ``logits`` (B, N) by the
    Gumbel-max trick, the method of ``jax.random.categorical``:
    ``argmax(logits + g)`` with ``g = -log(-log(u))``. ``u`` is clamped
    into (0, 1), so every ``g`` is finite and a -inf (masked) slot is
    never drawn. Draws from ``generator`` only, and reads nothing back
    to the host (``torch.multinomial`` may). With ``rows`` = (n, index)
    the lanes are rows ``index`` of a global batch of ``n``: the noise is
    drawn at (n, N) and the lanes take theirs, so data-parallel ranks
    sharing the generator draw what one rank over the whole batch would."""
    shape = logits.shape if rows is None else (rows[0], logits.shape[1])
    u = torch.rand(shape, generator=generator, device=logits.device, dtype=logits.dtype)
    if rows is not None:
        u = u[rows[1]]
    fi = torch.finfo(u.dtype)
    u = u.clamp(fi.tiny, 1.0 - fi.eps / 2)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def full_logits(act_logits: torch.Tensor, obj_logits: torch.Tensor,
                stop_slot: int) -> torch.Tensor:
    """REVERIE's action space (reverie/agent.py:251-254): the observation
    slots with the layout's own STOP masked to -inf (the JAX package's
    documented deviation: the reference leaves it selectable, though its
    candidate lookup would fail on it), then the largest object logit
    as the one stop action; 0 where the viewpoint has no object, so
    stopping stays possible."""
    act = act_logits.clone()
    act[:, stop_slot] = -math.inf
    max_obj = obj_logits.max(dim=-1, keepdim=True).values
    max_obj = torch.where(torch.isfinite(max_obj), max_obj, 0.0)
    return torch.cat([act, max_obj], dim=1)


def object_rows(obj_tables: Dict[str, torch.Tensor], node_idx: torch.Tensor,
                view_index: torch.Tensor, ang_tab: torch.Tensor):
    """The objects of the viewpoints ``node_idx`` (any leading shape) from
    the node-aligned object tables (``data/feature_db.py:
    build_object_table``): (fts, angs, pos, mask), the angles relative to
    the agent's ``view_index`` from the (36, 36, A) table, as the JAX
    package gathers them (reverie.py:61-70)."""
    node_idx = node_idx.long()
    mask = obj_tables["mask"][node_idx]
    angs = ang_tab[view_index.long()[..., None], obj_tables["view"][node_idx].long()]
    angs = torch.where(mask[..., None], angs, 0.0)
    return obj_tables["fts"][node_idx], angs, obj_tables["pos"][node_idx], mask


def make_policy_core(model: HAMT, critic: Critic, expand_obs, objects: bool = False):
    """One interactive policy step (``_make_policy_core`` of the JAX
    package; with ``objects``, ``_make_ref_policy_core``).

    core(txt_embeds, txt_mask, hist_cache, hist_len, t, pano_feat,
         view_index, cand_point, cand_ang, live, forbid, given_action, mode,
         generator=None, objs=None, draw_rows=None)
      -> action (B,), logits (B, N), state (B, D), value (B,), hist_cache,
         hist_len, obj_logits (B, K) or None

    Modes: ``argmax`` and ``sample`` (Gumbel-max from ``generator``) over
    the logits with ``forbid`` (B, N) masked; ``teacher`` takes
    ``given_action``; ``mixed`` takes ``given_action`` where it is >= 0
    (teacher-forced lanes) and samples elsewhere; ``draw_rows``: the
    lanes' rows of the global batch (:func:`gumbel_max`).

    With ``objects`` the step plans with ``HAMT.plan_ref`` over ``objs``
    = (obj_fts, obj_angs, obj_pos, obj_mask) and the logits are
    :func:`full_logits`' N + 1; the appended stop slot, like the
    layout's STOP, has a zero angle for the history token.

    ``t`` is a step id on the device: 0-d (lock-step rollout) or (B,)
    (per-sample positions); the new history token goes to slot ``t+1``
    of each sample. The cache is written out of place, as the JAX
    package's ``dynamic_update_slice``: under autograd an op that saved
    the old cache for its backward (a linear layer of ``h_layers``, say)
    would otherwise see it change.
    """

    def core(txt_embeds, txt_mask, hist_cache, hist_len, t,
             pano_feat, view_index, cand_point, cand_ang,
             live, forbid, given_action, mode: str,
             generator: Optional[torch.Generator] = None, objs=None, draw_rows=None):
        h_max = hist_cache.shape[1]
        ob = expand_obs(pano_feat, view_index, cand_point, cand_ang)
        n_ob = ob["ob_ang"].shape[1]
        stop_slot = n_ob - 1 - 36  # [C cands | STOP | 36 views]
        obj_logits = None
        if objects:
            act_logits, obj_logits, state = model.plan_ref(
                txt_embeds, txt_mask, hist_cache, hist_mask(hist_len, h_max),
                ob["ob_img"], ob["ob_ang"], ob["ob_nav"], ob["ob_mask"], *objs)
            logits = full_logits(act_logits, obj_logits, stop_slot)
        else:
            logits, state = model.plan(
                txt_embeds, txt_mask, hist_cache, hist_mask(hist_len, h_max),
                ob["ob_img"], ob["ob_ang"], ob["ob_nav"], ob["ob_mask"])
        if mode == "teacher":
            action = given_action
        elif mode in ("argmax", "sample", "mixed"):
            masked = logits.detach().masked_fill(forbid, -math.inf)
            if mode == "argmax":
                action = torch.argmax(masked, dim=-1)
            else:
                if generator is None:
                    raise ValueError(f"policy mode {mode!r} needs a torch.Generator")
                action = gumbel_max(masked, generator, draw_rows)
                if mode == "mixed":
                    action = torch.where(given_action >= 0, given_action, action)
        else:
            raise ValueError(f"policy mode {mode!r}")
        action = action.long()

        value = critic(state)

        gather_a = torch.where(action >= n_ob, stop_slot, action) if objects else action
        act_ang = torch.gather(
            ob["ob_ang"], 1, gather_a[:, None, None].expand(-1, 1, ob["ob_ang"].shape[-1])
        ).squeeze(1)
        new_tok = model.encode_history(ob["hist_img"], act_ang, t,
                                       ob["pano_img"], ob["pano_ang"])
        b = hist_cache.shape[0]
        index = (torch.arange(b, device=hist_cache.device), t.expand(b) + 1)
        hist_cache = hist_cache.index_put(index, new_tok.to(hist_cache.dtype))
        hist_len = hist_len + live.to(hist_len.dtype)
        return action, logits, state, value, hist_cache, hist_len, obj_logits

    return core


def device_angle_feats(heading: torch.Tensor, elevation: torch.Tensor,
                       a_size: int) -> torch.Tensor:
    """torch mirror of data.angle.angle_features (fp32 trig)."""
    heading = heading.float()
    elevation = elevation.float()
    base = torch.stack([torch.sin(heading), torch.cos(heading),
                        torch.sin(elevation), torch.cos(elevation)], dim=-1)
    reps = a_size // 4
    if reps > 1:
        base = base.repeat((1,) * (base.dim() - 1) + (reps,))
    return base


def _dp_extend(dp: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """One DTW row extension, vectorized over the batch.

    dp (B, R+1): previous DP row; cost (B, R): dist(new_node, ref_j).
    Mirrors eval.metrics.IncrementalNDTW._extend:
      cur[j] = cost[j-1] + min(prev[j], prev[j-1], cur[j-1]), cur[0]=inf,
    one reference column after another as the JAX package's scan (R is a
    handful of columns for R2R). Padded columns (inf cost) stay inf.
    """
    cur = torch.full_like(dp[:, 0], math.inf)
    cols = [cur]
    for j in range(cost.shape[1]):
        cur = cost[:, j] + torch.minimum(torch.minimum(dp[:, j + 1], dp[:, j]), cur)
        cols.append(cur)
    return torch.stack(cols, dim=1)


TASKS = ("r2r", "r2r_back", "cvdn", "reverie")


def build_device_rollout(model: HAMT, critic: Critic, t_max: int,
                         ob_type: str = "pano", error_margin: float = 3.0,
                         task: str = "r2r"):
    """The JAX ``build_device_rollout``: a whole rollout of a batch on the
    device, greedy (evaluation) or sampled (the ``sample`` update), with
    the task's in-loop reward and termination, the host hooks' rules
    (tested against them):

    - ``r2r`` (the R2R family; ``_step_rewards``, agent_cmt.py:407-445):
      nDTW by one DP row extension per step (:func:`_dp_extend`) and the
      goal distance by a cost-slab read; ``task_inputs`` ``ref_cost``
      (B, N_scan_max, R), the distance of each node of the item's scan to
      each reference node (inf-padded), and ``ref_len`` (B,);
    - ``r2r_back`` (agent_r2rback.py:233-277): the distance to the
      midstop until the first STOP, to the final goal after it (read
      with the phase before this step's update); the second STOP ends
      the episode; under rewards a failed (mid)stop ends it at once,
      greedy evaluation has no forced end; inputs ``ref_cost`` /
      ``ref_len`` plus ``mid_cost`` and ``goal_cost`` (B, N_scan_max);
    - ``cvdn`` (cvdn/agent.py:173-203): no nDTW, +2 for a stop on an end
      pano, a unit move reward by the distance's sign (0 when level), no
      miss penalty; input ``goal_cost`` (B, N_scan_max), the distance to
      the nearest end pano;
    - ``reverie`` (reverie/agent.py:251-304): the policy plans with
      ``plan_ref`` over each viewpoint's objects, gathered per step from
      ``obj_tables``; the action space appends the object-stop slot;
      nDTW grows on candidate moves only; R2R's shaping over
      ``goal_cost``, the distance to the nearest viewpoint that sees the
      target object, with ``ref_cost`` / ``ref_len``.

    Returns rollout(txt_ids, txt_mask, feat_table, nav, start_node,
    start_view, offs=None, task_inputs=None, *, policy="argmax",
    compute_rewards=False, compute_bootstrap=False, il=None,
    generator=None, obj_tables=None, draw_rows=None) -> (ep, extras) with the JAX
    package's keys:

    - ``ep``: batch-major (B, T) records of nodes, views, candidate
      tables, actions and live masks plus the final pose;
    - ``extras``: time-major ``rollout_logits`` (T, B, N), ``values``,
      ``masks``, ``rewards`` (detached; zero without
      ``compute_rewards``) and ``bootstrap_mask``; ``last_value`` (B,)
      with ``compute_bootstrap``, the critic on the final observation
      (RL lanes only, no gradient); ``il_logits`` (T, B_il, N) with
      ``il`` (REVERIE: also ``il_obj_logits``); REVERIE's greedy rollout
      also ``obj_pred`` (T, B), each step's best object slot.

    ``policy`` is ``argmax`` or ``sample`` (from ``generator``; with
    ``draw_rows`` = (n, index) the [RL | IL] lanes are rows ``index`` of
    a global batch of ``n`` lanes, :func:`gumbel_max`).
    ``compute_rewards`` needs ``offs`` (B,), each item's scan offset in
    the feature table, and the task's ``task_inputs``.

    ``il``: teacher-forced lanes run in the same loop (the merged
    ``sample`` update): batch-major (B_il, T) ``node_idx``,
    ``view_index``, ``actions`` and ``step_mask`` of a recorded teacher
    episode, with ``txt_ids`` / ``txt_mask`` the concatenation
    [RL lanes | IL lanes]. IL lanes take their pose from the record,
    force the recorded action and get no reward; the RL lanes sample.

    Gradients flow as the caller's grad mode says: the ``sample`` update
    differentiates through the loop (integer transitions and rewards
    carry none), evaluation calls it under ``torch.no_grad()``. The loop
    over ``t_max`` only enqueues work: nothing is read back to the host.
    """
    if task not in TASKS:
        raise ValueError(f"device rollout task {task!r}; one of {TASKS}")
    cfg = model.config
    if t_max > cfg.max_action_steps:
        raise ValueError(f"t_max {t_max} exceeds the history position table "
                         f"({cfg.max_action_steps})")
    device = next(model.parameters()).device
    expand_obs = make_expand_obs(36, cfg.angle_feat_size, ob_type, device=device)
    reverie, back, cvdn = task == "reverie", task == "r2r_back", task == "cvdn"
    core = make_policy_core(model, critic, expand_obs, objects=reverie)
    ang_tab = angle_table(cfg.angle_feat_size, device) if reverie else None
    use_ndtw = not cvdn
    steps = torch.arange(t_max, device=device)

    def rollout(txt_ids, txt_mask, feat_table, nav, start_node, start_view,
                offs=None, task_inputs=None, *, policy: str = "argmax",
                compute_rewards: bool = False, compute_bootstrap: bool = False,
                il: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                obj_tables: Optional[Dict[str, torch.Tensor]] = None,
                draw_rows: Optional[Tuple[int, torch.Tensor]] = None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        if policy not in ("argmax", "sample"):
            raise ValueError(f"rollout policy {policy!r}")
        if il is not None and policy != "sample":
            raise ValueError("teacher-forced il lanes ride a sampling rollout "
                             "(policy='sample')")
        if reverie and obj_tables is None:
            raise ValueError("the reverie rollout reads the object tables (obj_tables)")
        b = start_node.shape[0]
        b_il = 0 if il is None else il["actions"].shape[0]
        bt = b + b_il
        if txt_ids.shape[0] != bt:
            raise ValueError(f"{txt_ids.shape[0]} text rows for {b} RL + {b_il} IL lanes")
        stop = nav["nbr_global"].shape[1]  # slot layout: [C cands | STOP | pano]
        n_ob = stop + 1 + 36
        # REVERIE appends the object-stop slot to the action space
        stop_action = n_ob if reverie else stop

        txt_embeds = model.encode_text(txt_ids, txt_mask)
        hist0 = model.init_history(bt)
        hist_cache = torch.cat([hist0[:, None],
                                hist0.new_zeros((bt, t_max, cfg.hidden_size))], dim=1)
        hist_len = torch.ones(bt, dtype=torch.int32, device=device)

        def cand_tables(node, view):
            cg = nav["nbr_global"][node].long()  # (B, C)
            valid = cg >= 0
            cp = torch.where(valid, nav["nbr_point"][node], -1)
            base_h = (view % 12).float() * (math.pi / 6.0)
            ang = device_angle_feats(nav["nbr_head"][node] - base_h[:, None],
                                     nav["nbr_elev"][node], cfg.angle_feat_size)
            ang = torch.where(valid[:, :, None], ang, 0.0)
            return cg, valid, cp, ang

        node, view = start_node.long(), start_view.long()
        # R2R-Back's phase, kept in greedy evaluation too
        first_ended = torch.zeros(b, dtype=torch.bool, device=device)
        if compute_rewards:
            bi = torch.arange(b, device=device)
            offs = offs.long()

            def slab_at(name, node):  # (B,) a per-node slab's value at node
                return task_inputs[name][bi, node - offs]

            if use_ndtw:
                ref_cost = task_inputs["ref_cost"]
                rl = task_inputs["ref_len"].long()

                def ref_cost_at(node):  # (B, R) dist(node, ref_j)
                    return ref_cost[bi, node - offs]

                def ndtw_val(dp):
                    return torch.exp(-dp[bi, rl] / (error_margin * rl.float()))

                # the nDTW DP row: closed column 0, then the start node
                dp = torch.full((b, ref_cost.shape[2] + 1), math.inf, device=device)
                dp[:, 0] = 0.0
                dp = _dp_extend(dp, ref_cost_at(node))
                last_ndtw = ndtw_val(dp)

            def goal_dist(node):
                if task == "r2r":  # dist to the last reference node
                    return ref_cost_at(node)[bi, rl - 1]
                return slab_at("goal_cost", node)

            # R2R-Back's first goal is the midstop (agent_r2rback.py:234-237)
            last_dist = slab_at("mid_cost", node) if back else goal_dist(node)
            force_ended = torch.zeros(b, dtype=torch.bool, device=device)

        if il is not None:
            il_node, il_view = il["node_idx"].long(), il["view_index"].long()
            il_act, il_live = il["actions"].long(), il["step_mask"]
            rl_given = torch.full((b,), -1, dtype=torch.long, device=device)
        mode = policy if il is None else "mixed"
        ended = torch.zeros(b, dtype=torch.bool, device=device)
        forbid = torch.zeros((bt, n_ob + int(reverie)), dtype=torch.bool, device=device)
        given = torch.zeros(b, dtype=torch.long, device=device)
        ys, il_logits, il_obj_logits, obj_pred = [], [], [], []
        step = remat_step(core, cfg, rng_streams(model, critic, generator=generator))
        for t in range(t_max):
            live = ~ended
            node_all, view_all, live_all = node, view, live
            if il is not None:
                node_all = torch.cat([node, il_node[:, t]])
                view_all = torch.cat([view, il_view[:, t]])
                live_all = torch.cat([live, il_live[:, t]])
                given = torch.cat([rl_given, il_act[:, t]])
            cg, valid, cand_point, cand_ang = cand_tables(node_all, view_all)
            pano = feat_table[node_all]
            objs = object_rows(obj_tables, node_all, view_all, ang_tab) if reverie else None
            action, logits, _, value, hist_cache, hist_len, obj_logits = step(
                txt_embeds, txt_mask, hist_cache, hist_len, steps[t], pano,
                view_all, cand_point, cand_ang, live_all, forbid, given, mode, generator,
                objs=objs, draw_rows=draw_rows)
            if il is not None:
                il_logits.append(logits[b:])
                if reverie:
                    il_obj_logits.append(obj_logits[b:])
                action, logits, value = action[:b], logits[:b], value[:b]
                cg, valid = cg[:b], valid[:b]
                cand_point, cand_ang = cand_point[:b], cand_ang[:b]
            elif reverie and policy == "argmax":
                # greedy evaluation records each step's grounded object;
                # the host reads it at each lane's stop step
                obj_pred.append(torch.argmax(obj_logits, dim=-1))

            rec_action = torch.where(live, action, stop_action)
            slot = action.clamp(0, stop - 1)[:, None]
            tgt = torch.gather(cg, 1, slot)[:, 0]
            tgt_ok = torch.gather(valid, 1, slot)[:, 0]
            moved = live & (action < stop) & tgt_ok
            new_node = torch.where(moved, tgt, node)
            new_view = torch.where(moved, torch.gather(cand_point, 1, slot)[:, 0].long(),
                                   view)
            stopped = action == stop_action
            if compute_rewards:
                if use_ndtw:
                    # the prediction path grows on every live move (the
                    # env's moves: candidate slots only under REVERIE)
                    extend = live & (action < stop) if reverie else live & ~stopped
                    dp = torch.where(extend[:, None], _dp_extend(dp, ref_cost_at(new_node)),
                                     dp)
                    cur_ndtw = ndtw_val(dp)
                    nr = cur_ndtw - last_ndtw
                    last_ndtw = cur_ndtw
                if back:  # the phase before this step's update
                    dist = torch.where(first_ended, goal_dist(new_node),
                                       slab_at("mid_cost", new_node))
                else:
                    dist = goal_dist(new_node)
                delta = -(dist - last_dist)
                if cvdn:
                    stop_r = torch.where(dist == 0.0, 2.0, -2.0)
                    move_r = torch.where(delta > 0.0, 1.0, torch.where(delta < 0.0, -1.0, 0.0))
                else:
                    stop_r = torch.where(dist < error_margin, 2.0 + cur_ndtw * 2.0, -2.0)
                    move_r = torch.where(delta > 0.0, 1.0 + nr, -1.0 + nr)
                    miss = (last_dist <= 1.0) & (dist - last_dist > 0.0)
                    move_r = move_r - torch.where(miss, (1.0 - last_dist) * 2.0, 0.0)
                reward = torch.where(live, torch.where(stopped, stop_r, move_r), 0.0)
                if back:
                    # a failed (mid)stop ends the episode (agent_r2rback.py:
                    # 254-256); after the midstop the tracked distance is
                    # the final goal's (:270-273)
                    force_ended = force_ended | (live & stopped & (dist >= error_margin))
                    last_dist = torch.where(live & stopped & ~first_ended,
                                            goal_dist(new_node), dist)
                else:
                    last_dist = dist
            else:
                reward = torch.zeros(b, device=device)
            ys.append((rec_action, logits, value, reward, live, node, view, cand_point,
                       cand_ang))
            if back:  # the second STOP ends the episode
                ended = ended | (first_ended & stopped)
                if compute_rewards:
                    ended = ended | force_ended
                first_ended = first_ended | stopped
            else:
                ended = ended | stopped
            node, view = new_node, new_view

        actions, logits, values, rewards, lives, nodes, views, cpoints, cangs = (
            torch.stack(x) for x in zip(*ys))
        _, _, final_cp, final_ca = cand_tables(node, view)
        i32 = torch.int32
        ep = {
            "txt_ids": txt_ids, "txt_mask": txt_mask,
            "node_idx": nodes.T.to(i32),
            "view_index": views.T.to(i32),
            "cand_point": cpoints.transpose(0, 1).to(i32),
            "cand_ang": cangs.transpose(0, 1),
            "actions": actions.T.to(i32),
            "step_mask": lives.T,
            "final_node_idx": node.to(i32),
            "final_view_index": view.to(i32),
            "final_cand_point": final_cp.to(i32),
            "final_cand_ang": final_ca,
        }
        extras = {
            "rewards": rewards.detach(),  # (T, B)
            "masks": lives.float(),       # (T, B)
            "bootstrap_mask": ~ended,     # (B,)
            "rollout_logits": logits,     # (T, B, N)
            "values": values,             # (T, B)
        }
        if il is not None:
            extras["il_logits"] = torch.stack(il_logits)  # (T, B_il, N)
            if reverie:
                extras["il_obj_logits"] = torch.stack(il_obj_logits)  # (T, B_il, K)
        if obj_pred:
            extras["obj_pred"] = torch.stack(obj_pred)  # (T, B)
        if compute_bootstrap:
            # the critic on the final observation (agent_cmt.py:481-484),
            # RL lanes only; under no_lang_ca the text states are
            # (X+1, B, L, D), batch on axis 1
            with torch.no_grad():
                fob = expand_obs(feat_table[node], view, final_cp, final_ca)
                txt_f = txt_embeds[:, :b] if txt_embeds.dim() == 4 else txt_embeds[:b]
                plan_in = (txt_f, txt_mask[:b], hist_cache[:b],
                           hist_mask(hist_len[:b], hist_cache.shape[1]),
                           fob["ob_img"], fob["ob_ang"], fob["ob_nav"], fob["ob_mask"])
                if reverie:
                    last_state = model.plan_ref(
                        *plan_in, *object_rows(obj_tables, node, view, ang_tab))[2]
                else:
                    last_state = model.plan(*plan_in)[1]
                extras["last_value"] = critic(last_state)
        return ep, extras

    return rollout


@dataclasses.dataclass
class EpisodeOutputs:
    logits: torch.Tensor  # (T, B, N) float32
    states: torch.Tensor  # (T, B, D)
    values: torch.Tensor  # (T, B)
    last_value: torch.Tensor  # (B,) bootstrap value of the final obs
    hist_cache: torch.Tensor  # (B, T+1, D) final history cache
    obj_logits: Optional[torch.Tensor] = None  # (T, B, K) REVERIE's object logits


#: the per-step object arrays of an episode without the object tables
OBJ_KEYS = ("obj_fts", "obj_angs", "obj_pos", "obj_mask")


def _episode_objects(ep, obj_tables, ang_tab, final: bool = False):
    """An episode's object arrays: gathered from the tables at its node
    rows, or the arrays the host shipped; ``final``: the final pose's."""
    pre = "final_" if final else ""
    if pre + "node_idx" in ep:
        return object_rows(obj_tables, ep[pre + "node_idx"], ep[pre + "view_index"], ang_tab)
    return tuple(ep[pre + k] for k in OBJ_KEYS)


def build_episode_forward(model: HAMT, critic: Critic, ob_type: str = "pano",
                          objects: bool = False) -> Callable[..., EpisodeOutputs]:
    """The teacher-forced episode of ``vln_hamt_tpu/agents/rollout.py:
    build_episode_forward`` (:147-262; with ``objects`` REVERIE's
    ``build_ref_episode_forward``, reverie.py:79-192): the whole recorded
    episode through the model, differentiable end to end.

    Returns episode_forward(ep, feat_table=None, obj_tables=None) ->
    EpisodeOutputs, where ``ep`` holds device tensors in the compact
    observation schema: txt_ids (B, L), txt_mask (B, L), view_index
    (B, T), cand_point (B, T, C), cand_ang (B, T, C, A), actions (B, T)
    (the slots taken; STOP once ended), step_mask (B, T), and either
    pano_feat (B, T, V, D) or node_idx (B, T) rows of ``feat_table``
    (N, V, D). With ``objects`` the objects come from ``obj_tables`` at
    the node rows, or from the episode's obj_fts / obj_angs / obj_pos /
    obj_mask (B, T, K, ...), and ``obj_logits`` is set. Optional
    final_{pano_feat | node_idx} (and final_obj_*), final_view_index,
    final_cand_point and final_cand_ang give the observation after the
    last action, for the bootstrap value (no gradient); without them
    ``last_value`` is zero. Dropout follows the modules' train/eval
    mode. The loop over T only enqueues work: nothing is read back.
    """
    cfg = model.config
    device = next(model.parameters()).device
    expand_obs = make_expand_obs(36, cfg.angle_feat_size, ob_type, device=device)
    core = make_policy_core(model, critic, expand_obs, objects=objects)
    ang_tab = angle_table(cfg.angle_feat_size, device) if objects else None

    def episode_forward(ep: Dict[str, torch.Tensor], feat_table: Optional[torch.Tensor] = None,
                        obj_tables: Optional[Dict[str, torch.Tensor]] = None
                        ) -> EpisodeOutputs:
        if "node_idx" in ep:
            pano_feat = feat_table[ep["node_idx"].long()]  # one gather, (B, T, V, D)
            final_pano = (feat_table[ep["final_node_idx"].long()]
                          if "final_node_idx" in ep else None)
        else:
            pano_feat, final_pano = ep["pano_feat"], ep.get("final_pano_feat")
        objs = _episode_objects(ep, obj_tables, ang_tab) if objects else None
        txt_mask = ep["txt_mask"]
        b, t_steps = ep["actions"].shape
        if t_steps > cfg.max_action_steps:
            raise ValueError(f"episode of {t_steps} steps exceeds the history position "
                             f"table ({cfg.max_action_steps})")
        h_max = t_steps + 1

        txt_embeds = model.encode_text(ep["txt_ids"], txt_mask)
        hist0 = model.init_history(b)
        hist_cache = torch.cat([hist0[:, None], hist0.new_zeros((b, t_steps, cfg.hidden_size))],
                               dim=1)
        hist_len = torch.ones(b, dtype=torch.int32, device=device)
        steps = torch.arange(t_steps, device=device)
        logits, states, values, obj_logits = [], [], [], []
        step = remat_step(core, cfg, rng_streams(model, critic))
        for t in range(t_steps):
            _, lg, state, value, hist_cache, hist_len, olg = step(
                txt_embeds, txt_mask, hist_cache, hist_len, steps[t], pano_feat[:, t],
                ep["view_index"][:, t], ep["cand_point"][:, t], ep["cand_ang"][:, t],
                ep["step_mask"][:, t], None, ep["actions"][:, t], "teacher",
                objs=None if objs is None else tuple(x[:, t] for x in objs))
            logits.append(lg)
            states.append(state)
            values.append(value)
            obj_logits.append(olg)

        if final_pano is not None:
            with torch.no_grad():
                ob = expand_obs(final_pano, ep["final_view_index"], ep["final_cand_point"],
                                ep["final_cand_ang"])
                plan_in = (txt_embeds, txt_mask, hist_cache, hist_mask(hist_len, h_max),
                           ob["ob_img"], ob["ob_ang"], ob["ob_nav"], ob["ob_mask"])
                if objects:
                    last_state = model.plan_ref(
                        *plan_in, *_episode_objects(ep, obj_tables, ang_tab, final=True))[2]
                else:
                    last_state = model.plan(*plan_in)[1]
                last_value = critic(last_state)
        else:
            last_value = torch.zeros(b, device=device)
        return EpisodeOutputs(logits=torch.stack(logits), states=torch.stack(states),
                              values=torch.stack(values), last_value=last_value,
                              hist_cache=hist_cache,
                              obj_logits=torch.stack(obj_logits) if objects else None)

    return episode_forward


def build_packed_il_forward(model: HAMT, ob_type: str = "pano", objects: bool = False
                            ) -> Callable[..., torch.Tensor]:
    """The teacher-forced forward over a packed episode grid
    (``vln_hamt_tpu/agents/rollout.py:build_packed_il_forward``,
    :266-359; with ``objects`` REVERIE's ``build_packed_ref_il_forward``,
    reverie.py:195-298): the per-step model of
    :func:`build_episode_forward`, but each slot carries several episodes
    back to back (``agents/packing.py``). One text encoding covers every
    packed instruction; each cell's ``ep_id`` picks its episode's text
    (under ``no_lang_ca`` from the (X+1, E, L, D) stack of per-layer
    states); ``is_start`` cells reset the slot's history cache to
    ``[hist0]`` and its length to 1; the new history token goes to the
    episode-local slot ``local_t + 1`` of live cells only. Every episode
    sees at each of its steps the text, history and observation the
    unpacked forward shows it, so its logits are the unpacked ones
    (tested).

    Returns packed_forward(pack, feat_table=None, obj_tables=None) ->
    logits (T, S, N) float32, or with ``objects`` (logits (T, S, N + 1),
    obj_logits (T, S, K)), the objects gathered from ``obj_tables`` at
    the cells' node rows; ``pack`` holds device tensors of the pack
    schema (``node_idx`` rows of ``feat_table``, or ``pano_feat``). IL
    only: no critic, no bootstrap. The loop over T only enqueues work:
    nothing is read back to the host.
    """
    cfg = model.config
    device = next(model.parameters()).device
    expand_obs = make_expand_obs(36, cfg.angle_feat_size, ob_type, device=device)
    ang_tab = angle_table(cfg.angle_feat_size, device) if objects else None

    def packed_forward(pack: Dict[str, torch.Tensor], feat_table: Optional[torch.Tensor] = None,
                       obj_tables: Optional[Dict[str, torch.Tensor]] = None):
        pano_feat = (feat_table[pack["node_idx"].long()] if "node_idx" in pack
                     else pack["pano_feat"])  # (S, T, V, D)
        objs = (object_rows(obj_tables, pack["node_idx"], pack["view_index"], ang_tab)
                if objects else None)
        s, t_steps = pack["actions"].shape
        if t_steps > cfg.max_action_steps:
            raise ValueError(f"pack of {t_steps} steps exceeds the history position "
                             f"table ({cfg.max_action_steps})")
        h_max = t_steps + 1

        txt_all = model.encode_text(pack["txt_ids"], pack["txt_mask"])  # all E texts
        hist0 = model.init_history(s)
        reset_cache = torch.cat([hist0[:, None],
                                 hist0.new_zeros((s, t_steps, cfg.hidden_size))], dim=1)
        hist_cache = reset_cache
        hist_len = torch.ones(s, dtype=torch.int32, device=device)
        positions = torch.arange(h_max, device=device)

        def step(hist_cache, hist_len, txt_e, txt_m, pano, view_index, cand_point, cand_ang,
                 action, local_t, live, objs_t):
            ob = expand_obs(pano, view_index, cand_point, cand_ang)
            plan_in = (txt_e, txt_m, hist_cache, hist_mask(hist_len, h_max),
                       ob["ob_img"], ob["ob_ang"], ob["ob_nav"], ob["ob_mask"])
            obj_lg = None
            if objects:
                act_lg, obj_lg, _ = model.plan_ref(*plan_in, *objs_t)
                stop_slot = ob["ob_ang"].shape[1] - 1 - 36
                lg = full_logits(act_lg, obj_lg, stop_slot)
                action = torch.where(action >= ob["ob_ang"].shape[1], stop_slot, action)
            else:
                lg, _ = model.plan(*plan_in)
            act_ang = torch.gather(
                ob["ob_ang"], 1, action[:, None, None].expand(-1, 1, ob["ob_ang"].shape[-1])
            ).squeeze(1)
            new_tok = model.encode_history(ob["hist_img"], act_ang, local_t,
                                           ob["pano_img"], ob["pano_ang"])
            write = (positions[None, :] == local_t[:, None] + 1) & live[:, None]
            hist_cache = torch.where(write[:, :, None], new_tok[:, None].to(hist_cache.dtype),
                                     hist_cache)
            return lg, obj_lg, hist_cache, hist_len + live.to(hist_len.dtype)

        step = remat_step(step, cfg, rng_streams(model))
        logits, obj_logits = [], []
        for t in range(t_steps):
            start = pack["is_start"][:, t]
            hist_cache = torch.where(start[:, None, None], reset_cache, hist_cache)
            hist_len = hist_len.masked_fill(start, 1)
            ep_id = pack["ep_id"][:, t].long()
            txt_e = txt_all[:, ep_id] if txt_all.dim() == 4 else txt_all[ep_id]
            lg, obj_lg, hist_cache, hist_len = step(
                hist_cache, hist_len, txt_e, pack["txt_mask"][ep_id], pano_feat[:, t],
                pack["view_index"][:, t], pack["cand_point"][:, t], pack["cand_ang"][:, t],
                pack["actions"][:, t].long(), pack["local_t"][:, t], pack["live"][:, t],
                tuple(x[:, t] for x in objs) if objects else None)
            logits.append(lg)
            obj_logits.append(obj_lg)
        if objects:
            return torch.stack(logits), torch.stack(obj_logits)
        return torch.stack(logits)

    return packed_forward


# ----------------------------------------------------------------------
def build_policy_step(model: HAMT, critic: Critic, ob_type: str = "pano",
                      objects: bool = False):
    """One interactive step of the host loop (JAX ``build_policy_step``,
    rollout.py:363-400; with ``objects`` REVERIE's
    ``build_ref_policy_step``, reverie.py:45-76): :func:`make_policy_core`
    on one step's compact observation.

    policy_step(txt_embeds, txt_mask, hist_cache, hist_len, t, view_index,
                cand_point, cand_ang, live, forbid, given_action, mode, *,
                pano_feat=None, node_idx=None, feat_table=None,
                obj_tables=None, objs=None, generator=None)
      -> action (B,), logits (B, N), value (B,), hist_cache, hist_len,
         obj_logits (B, K) or None

    The panoramas are ``pano_feat`` (B, V, D), shipped per step, or with
    ``node_idx`` (B,) rows gathered from the resident ``feat_table``;
    with ``objects`` the objects likewise ``objs`` (obj_fts, obj_angs,
    obj_pos, obj_mask), or rows of ``obj_tables`` at ``node_idx``.
    ``t`` is a 0-d step (the lock-step rollout) or a (B,) per-slot step
    (the packed evaluator); ``forbid`` (B, N) masks candidates for
    ``no_cand_backtrack``. Nothing is read back to the host.
    """
    cfg = model.config
    device = next(model.parameters()).device
    expand_obs = make_expand_obs(36, cfg.angle_feat_size, ob_type, device=device)
    core = make_policy_core(model, critic, expand_obs, objects=objects)
    ang_tab = angle_table(cfg.angle_feat_size, device) if objects else None

    def policy_step(txt_embeds, txt_mask, hist_cache, hist_len, t, view_index, cand_point,
                    cand_ang, live, forbid, given_action, mode: str, *, pano_feat=None,
                    node_idx=None, feat_table=None, obj_tables=None, objs=None,
                    generator: Optional[torch.Generator] = None):
        if node_idx is not None:
            pano_feat = feat_table[node_idx]
            if objects:
                objs = object_rows(obj_tables, node_idx, view_index, ang_tab)
        action, logits, _, value, hist_cache, hist_len, obj_logits = core(
            txt_embeds, txt_mask, hist_cache, hist_len, t, pano_feat, view_index,
            cand_point, cand_ang, live, forbid, given_action, mode, generator, objs=objs)
        return action, logits, value, hist_cache, hist_len, obj_logits

    return policy_step


def build_slot_reset(model: HAMT):
    """Reset chosen history-cache rows to a fresh episode, ``[hist0]`` and
    length 1 (JAX ``build_slot_reset``, rollout.py:547-562): the packed
    evaluator's slot that takes its next item.

    slot_reset(hist_cache, hist_len, reset_mask) -> hist_cache, hist_len
    """

    def slot_reset(hist_cache, hist_len, reset_mask):
        b, h, d = hist_cache.shape
        hist0 = model.init_history(b).to(hist_cache.dtype)
        fresh = torch.cat([hist0[:, None], hist0.new_zeros((b, h - 1, d))], dim=1)
        return (torch.where(reset_mask[:, None, None], fresh, hist_cache),
                hist_len.masked_fill(reset_mask, 1))

    return slot_reset


def build_text_row_update(model: HAMT):
    """Re-encode K text rows and write them into the cached text states
    (JAX ``_ensure_text_row_update``, agent.py:1280-1298): the packed
    evaluator's slot resets touch a few rows at a time. Under
    ``no_lang_ca`` the states are (X+1, B, L, D), batch on axis 1.

    update(txt_embeds, ids_k, mask_k, rows) -> txt_embeds; ``rows`` (K,)
    may repeat a row with the same ids (a padded chunk).
    """

    def update(txt_embeds, ids_k, mask_k, rows):
        emb = model.encode_text(ids_k, mask_k).to(txt_embeds.dtype)
        return txt_embeds.index_copy(txt_embeds.dim() - 3, rows, emb)

    return update
