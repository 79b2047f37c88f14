"""The benchmark's work counts: the FLOP count held to
``torch.utils.flop_counter.FlopCounterMode`` around the program's own
update and greedy rollout at a tiny size on the CPU (where the attention
runs as plain products that the counter sees), and the attention bounds
held to hand-counted values."""

from __future__ import annotations

import pytest
from torch.utils.flop_counter import FlopCounterMode

from benchmark.work import attention, flops

from .helpers import tiny_state


class _Global:
    """Counts every operation under "Global" alone. FlopCounterMode's
    per-module attribution hooks every module's inputs, and fails on a
    view taken under ``no_grad`` of a tensor that carries a gradient (the
    no_lang_ca bootstrap's text states); the counting is unchanged."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return None


def _counted(fn) -> int:
    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _Global()
    with counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("cell", ["tiny.finetune", "tiny_nolang.finetune"])
def test_update_count_matches_the_counter(cell):
    _, state = tiny_state(cell)
    c, b = state.ctx.config, int(state.ctx.cell["batch"])
    got = _counted(lambda: state.agent.train_iteration(sync=True))
    want = flops.update(c["model"], c["env"], b, b, c["env"]["max_action_len"])
    # the counter sees the backward's recomputed scores too
    assert got == want["useful"] + want["recompute"]


def test_rollout_count_matches_the_counter():
    _, state = tiny_state("tiny.eval")
    ctx, c = state.ctx, state.ctx.config
    b = int(ctx.cell["batch"])
    state.env.data = list(state.world.items[:b])
    got = _counted(lambda: state.agent.eval_split_fast(state.env))
    # one batch of the b items, then the batch that finds them again
    assert got == 2 * flops.rollout(c["model"], c["env"], b, c["env"]["max_action_len"])


def test_frozen_stacks_and_no_lang_ca_are_counted_as_they_run():
    m = {"hidden_size": 8, "num_attention_heads": 2, "intermediate_size": 16,
         "image_feat_size": 8, "angle_feat_size": 4, "num_l_layers": 1, "num_x_layers": 1,
         "num_h_pano_layers": 1, "no_lang_ca": False, "fix_lang_embedding": True,
         "fix_hist_embedding": True, "update_lang_bert": True}
    env = {"max_candidates": 2, "views": 36, "max_action_len": 3, "max_instr_len": 5}
    frozen = flops.update(m, env, 1, 1, 3)["useful"]
    trained = flops.update({**m, "fix_lang_embedding": False, "fix_hist_embedding": False},
                           env, 1, 1, 3)["useful"]
    assert trained > frozen
    # under no_lang_ca the language half leaves the steps for the text
    c1, c2 = flops.Count(), flops.Count()
    flops.step(c1, {**m, "no_lang_ca": True}, env, 1, False, False)
    flops.step(c2, m, env, 1, False, False)
    assert c1.fwd < c2.fwd


def test_attention_bounds_by_hand():
    # B 2, H 3, Lq 5, Lk 7, Dh 4 in fp32: q 2*3*5*4*4 = 480 bytes, k and v
    # 672 each, the mask 2*7*4 = 56, the fp32 output 480: 2360 bytes;
    # 4 * 2*3*5*7*4 = 3360 FLOPs
    fwd = attention.fwd_bound_s(2, 3, 5, 7, 4, "float32")
    assert fwd == pytest.approx(max(2360 / 3.35e12, 3360 / 67e12), rel=1e-12)
    # backward: q, k, v read and dq, dk, dv written (2 * 1824), g 480,
    # the mask read and dm written (2 * 56): 4240 bytes; 8 * 840 FLOPs
    bwd = attention.bwd_bound_s(2, 3, 5, 7, 4, "float32")
    assert bwd == pytest.approx(max(4240 / 3.35e12, 6720 / 67e12), rel=1e-12)
    # r2r's visual stream over the text at 32 lanes is bound by its bytes
    big = attention.fwd_bound_s(32, 12, 65, 60, 64, "float32")
    nbytes = 32 * 12 * (65 + 120) * 64 * 4 + 32 * 60 * 4 + 32 * 12 * 65 * 64 * 4
    assert big == pytest.approx(nbytes / 3.35e12, rel=1e-12)


def test_update_launch_mix_is_the_programs():
    """295 forward and 240 backward attentions for r2r's merged update,
    221 and 211 for rxr's, as the port's own launch counts have it."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "configs"
    for name, want in (("r2r", (295, 240)), ("rxr", (221, 211))):
        c = json.loads((root / f"{name}.json").read_text())
        b = attention.update_bound_s(c["model"], c["env"], 8, 8)
        assert (b["launches_fwd"], b["launches_bwd"]) == want
