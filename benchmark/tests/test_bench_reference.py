"""The plain reference held to ``vln_hamt_torch`` at a tiny size on the
CPU, through the benchmark's own check: the merged IL + A2C update with
frozen stacks and with ``no_lang_ca`` and every stack trained (losses,
first gradients, three AdamW steps, dropout and sampling draws, env and
teacher), and greedy evaluation (logits along the program's paths)."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.reference.hamt import HAMT
from benchmark.reference.navigation import Tables

from .helpers import run_tiny, tiny_state


@pytest.mark.parametrize("cell", ["tiny.finetune", "tiny_nolang.finetune", "tiny.eval"])
def test_reference_agrees_with_the_program(cell):
    res, nums = run_tiny(cell)
    assert res["correct"], nums
    assert res["attempted"] > 0 and res["failed"] == 0
    assert nums["mismatch"][0] == 0
    for name, (value, _) in nums.items():
        assert value < 2e-5 if name != "change_gap" else value < 2e-4, (name, value)


@pytest.mark.parametrize("cell", ["tiny.finetune", "tiny_nolang.finetune"])
def test_plan_logits_match_the_program_forward(cell):
    """One planning step of the reference against ``HAMT.plan`` of the
    program, both in evaluation mode on the same weights and inputs."""
    entry, state = tiny_state(cell)
    ctx, agent = state.ctx, state.agent
    c = ctx.config
    tables = Tables(state.world, c["env"]["max_candidates"], c["model"]["angle_feat_size"],
                    ctx.device)
    feats = harness.features(ctx, state.world)
    w, cw = harness.weights(ctx)
    items = state.world.items[:4]
    node = torch.tensor([tables.node(it["scan"], it["path"][0]) for it in items])
    view = torch.tensor([12, 13, 20, 5])
    ob = tables.obs(feats, node, view)
    l = c["env"]["max_instr_len"]
    ids = torch.zeros((4, l), dtype=torch.long)
    mask = torch.zeros((4, l), dtype=torch.bool)
    for i, it in enumerate(items):
        ids[i, :len(it["instr_encoding"])] = torch.tensor(it["instr_encoding"])
        mask[i, :len(it["instr_encoding"])] = True
    t_max = c["env"]["max_action_len"]
    ref = HAMT(c["model"], w, cw)
    agent.model.load_state_dict(w)  # set-up trained it for three updates
    agent.model.eval()
    with torch.no_grad():
        txt_r, txt_p = ref.encode_text(ids, mask), agent.model.encode_text(ids, mask)
        torch.testing.assert_close(txt_r, txt_p, rtol=1e-5, atol=1e-5)
        h0 = ref.init_history(4, ctx.device)
        hist = torch.cat([h0[:, None], h0.new_zeros(4, t_max, h0.shape[-1])], 1)
        hmask = torch.arange(t_max + 1)[None] < 1
        hmask = hmask.expand(4, -1)
        args = (hist, hmask, ob["ob_img"], ob["ob_ang"], ob["ob_nav"], ob["ob_mask"])
        lr, sr = ref.plan(txt_r, mask, *args)
        lp, sp = agent.model.plan(txt_p, mask, *args)
    torch.testing.assert_close(lr, lp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sr, sp, rtol=1e-5, atol=1e-5)
