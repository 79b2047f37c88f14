"""What every entry shares: the inputs made from the seed, the program
built over them, and the comparisons that decide ``correct``.

Seeds: the world from ``seed``, the weights from ``seed + 1``, the
panorama features from ``seed + 2``, the sample the checks draw from
``seed + 3``; the agent and the env take ``seed`` itself.
"""

from __future__ import annotations

import gc
import statistics
from typing import Dict, Optional, Set

import numpy as np
import torch

from .reference.hamt import make_weights, param_shapes
from .world.generator import World, make_world

WEIGHT_SEED, FEATURE_SEED, SAMPLE_SEED = 1, 2, 3


def world_of(ctx) -> World:
    world = make_world(ctx.config["world"], ctx.cell["world"], ctx.seed)
    texts = {tuple(it["instr_encoding"]) for it in world.items}
    if len(texts) != len(world.items):  # lanes are matched to items by their text
        raise ValueError("two items of the world share an instruction")
    return world


def features(ctx, world: World) -> torch.Tensor:
    """(panoramas, 36, D) float32 on the device, rows in the global node
    order (scans sorted, each scan's nodes in order), in one draw."""
    d = ctx.config["model"]["image_feat_size"]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed + FEATURE_SEED)
    return torch.randn((world.num_nodes, 36, d), generator=gen, device=ctx.device)


def weights(ctx):
    """(model, critic) weights by the reference's names, on the device."""
    shapes, cshapes = param_shapes(ctx.config["model"])
    flat = make_weights({**shapes, **{"critic." + k: v for k, v in cshapes.items()}},
                        ctx.seed + WEIGHT_SEED, ctx.device)
    return ({k: flat[k] for k in shapes}, {k: flat["critic." + k] for k in cshapes})


class FeatureRows:
    """The program's feature database over a host copy of the benchmark's
    feature table: ``get(scan, viewpoint)`` is that panorama's (36, D) rows."""

    def __init__(self, world: World, table: np.ndarray):
        self.table, self.row, at = table, {}, 0
        for scan in world.scans:
            for vp in world.graphs[scan].node_ids:
                self.row[(scan, vp)] = at
                at += 1

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        return self.table[self.row[(scan, viewpoint)]]


def program_config(ctx):
    """The program's ``HAMTConfig``: the preset with the configuration
    file's sizes and the cell's batch."""
    from vln_hamt_torch.configs import get_preset

    c, cell = ctx.config, ctx.cell
    env = dict(c["env"], image_feat_size=c["model"]["image_feat_size"],
               angle_feat_size=c["model"]["angle_feat_size"])
    train = dict(c["train"], batch_size=int(cell["batch"]), seed=ctx.seed, feedback="sample")
    return get_preset(c["preset"]).replace(model=c["model"], env=env, train=train)


def program_env(ctx, world: World, items, batch: int, name: str):
    """The program's env over ``items``; the agent's feature table serves it
    (:func:`program_agent`), so it holds no feature database."""
    from vln_hamt_torch.data.nav_graph import NavGraph
    from vln_hamt_torch.env import ObsSpec, R2RNavEnv

    c = ctx.config
    if not hasattr(ctx, "graphs"):
        ctx.graphs = {s: NavGraph(s, g.node_ids, g.positions, g.adj)
                      for s, g in world.graphs.items()}
    spec = ObsSpec(max_candidates=c["env"]["max_candidates"],
                   image_feat_size=c["model"]["image_feat_size"],
                   angle_feat_size=c["model"]["angle_feat_size"])
    return R2RNavEnv(ctx.graphs, None, items, spec, batch_size=batch,
                     max_instr_len=c["env"]["max_instr_len"],
                     max_action_len=c["env"]["max_action_len"], seed=ctx.seed, name=name,
                     error_margin=c["env"]["error_margin"],
                     reuse_episode_buffers=name == "train")


def program_agent(ctx, world: World, env):
    """The agent over ``env`` with the benchmark's weights and the
    benchmark's feature table resident on the device."""
    from vln_hamt_torch.agents.agent import HAMTAgent

    agent = HAMTAgent(program_config(ctx), env, seed=ctx.seed, device=ctx.device)
    w, cw = weights(ctx)
    agent.model.load_state_dict(w, strict=True)
    agent.critic.load_state_dict(cw, strict=True)
    del w, cw
    feats = features(ctx, world)
    env.feat_db = FeatureRows(world, feats.cpu().numpy())
    del feats
    agent.enable_feature_table(env)
    env.feat_db.table = None  # the table lives on the device now
    return agent


def free(*objs) -> None:
    """Drop the program's state before the reference runs."""
    del objs
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---------------------------------------------------------- comparisons
def leaf_gap(side: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Set[str]] = None, reduce=max) -> float:
    """The worst leaf's gap between two norms (``reduce=statistics.median``:
    the median leaf's), over the larger of the reference's norm of that
    leaf and of the median leaf; ``keep`` limits the leaves."""
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return 0.0
    med = statistics.median(ref[n] for n in names)
    return reduce(abs(side.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30) for n in names)
