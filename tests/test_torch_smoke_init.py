"""chip_smoke.py:memo_init_hamt, which the card smoke puts in place of the
agents' init_hamt, against models/hamt.py:init_hamt: the same weights
on every call, whether it draws them or loads a copy from its cache, for
two presets and for a config that differs from a drawn one only in the
fields that choose how the model runs."""

from __future__ import annotations

import dataclasses

import pytest
import torch

import chip_smoke
from vln_hamt_torch.configs import get_preset
from vln_hamt_torch.models.hamt import init_hamt

# the model of the CLIs' --tiny
TINY_MODEL = {"hidden_size": 64, "num_attention_heads": 4, "intermediate_size": 128,
              "num_l_layers": 2, "num_x_layers": 1, "num_h_pano_layers": 1,
              "image_feat_size": 32, "max_position_embeddings": 128, "max_action_steps": 32}
# a value of every RUN_ONLY field other than chip_smoke.RUN_ONLY's
RUN_ONLY_OTHER = {"hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.2,
                  "pred_head_dropout_prob": 0.3, "feat_dropout": 0.4, "critic_dropout": 0.5,
                  "dtype": "bfloat16", "use_pallas_attention": True, "remat": True,
                  "remat_policy": "dots", "fix_lang_embedding": True,
                  "fix_hist_embedding": True, "fix_obs_embedding": True}


def assert_same_weights(got, want):
    for g, w in zip(got, want):
        gs, ws = g.state_dict(), w.state_dict()
        assert list(gs) == list(ws)
        for k in ws:
            assert gs[k].dtype == ws[k].dtype and torch.equal(gs[k], ws[k]), k


@pytest.fixture
def empty_cache(monkeypatch):
    monkeypatch.setattr(chip_smoke, "_INITS", {})


def test_run_only_names_config_fields():
    fields = {f.name for f in dataclasses.fields(get_preset("r2r").model)}
    assert set(chip_smoke.RUN_ONLY) <= fields
    assert set(RUN_ONLY_OTHER) == set(chip_smoke.RUN_ONLY)


@pytest.mark.parametrize("task", ["r2r", "reverie"])
def test_memo_init_hamt_equals_init_hamt(empty_cache, task):
    """A draw, a second call (a copy from the cache, unchanged by what the
    first caller did to its model), a config that differs only in the
    RUN_ONLY fields (a cache hit) and another seed (a draw), each equal to
    init_hamt of the same config and seed."""
    mcfg = get_preset(task).replace(model=TINY_MODEL).model
    first = chip_smoke.memo_init_hamt(mcfg, 3)
    assert_same_weights(first, init_hamt(mcfg, 3))
    with torch.no_grad():
        for p in first[0].parameters():
            p.add_(1.0)
    assert_same_weights(chip_smoke.memo_init_hamt(mcfg, 3), init_hamt(mcfg, 3))
    other = dataclasses.replace(mcfg, **RUN_ONLY_OTHER)
    assert_same_weights(chip_smoke.memo_init_hamt(other, 3), init_hamt(other, 3))
    assert len(chip_smoke._INITS) == 1
    assert_same_weights(chip_smoke.memo_init_hamt(mcfg, 4), init_hamt(mcfg, 4))
    assert len(chip_smoke._INITS) == 2


def test_memo_init_hamt_draws_other_architectures(empty_cache):
    """Configs that differ outside RUN_ONLY draw anew, also where every
    tensor has the same shape (initializer_range)."""
    mcfg = get_preset("r2r").replace(model=TINY_MODEL).model
    for cfg in (mcfg, dataclasses.replace(mcfg, num_l_layers=1),
                dataclasses.replace(mcfg, initializer_range=0.05)):
        assert_same_weights(chip_smoke.memo_init_hamt(cfg, 0), init_hamt(cfg, 0))
    assert len(chip_smoke._INITS) == 3
