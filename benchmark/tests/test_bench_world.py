"""The world generator: one seed gives one world, two seeds two, and the
sizes are the ones the configuration and cell files state."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.world.generator import make_world, max_degree

BENCH = Path(__file__).resolve().parents[1]


def _files(cell: str):
    c = json.loads((BENCH / "cells" / f"{cell}.json").read_text())
    return json.loads((BENCH / "configs" / f"{c['config']}.json").read_text()), c


def _small(split: dict) -> dict:
    """The cell's split scaled down 20 times, scans and all, so the test
    stays short; the generator sizes each scan the same way."""
    return {k: max(2, int(v) // 20) for k, v in split.items()}


@pytest.mark.parametrize("cell", ["r2r.finetune_sample", "rxr.finetune_sample",
                                  "r2r.eval_greedy"])
def test_same_seed_same_world_and_sizes(cell):
    config, c = _files(cell)
    split = _small(c["world"])
    a, b = make_world(config["world"], split, 2147483648), make_world(config["world"], split,
                                                                       2147483648)
    assert a.items == b.items
    for s in a.graphs:
        assert (a.graphs[s].adj == b.graphs[s].adj).all()
        assert np.array_equal(a.graphs[s].positions, b.graphs[s].positions)
    assert len(a.graphs) == split["scans"]
    assert a.num_nodes == split["panoramas"]
    assert len(a.items) == split["items"]
    w = config["world"]
    lo, hi = w["path_hops"]
    hops = [len(it["path"]) - 1 for it in a.items]
    assert min(hops) >= 1 and max(hops) <= hi
    assert np.mean([lo <= h <= hi for h in hops]) > 0.95
    t_lo, t_hi = w["instr_tokens"]
    lens = [len(it["instr_encoding"]) for it in a.items]
    assert t_lo <= min(lens) and max(lens) <= t_hi <= config["env"]["max_instr_len"]
    ids = np.concatenate([it["instr_encoding"][1:-1] for it in a.items])
    assert ids.min() >= w["token_ids"][0] and ids.max() < w["token_ids"][1]
    assert ids.max() < config["model"]["vocab_size"]
    assert max_degree(a) <= config["env"]["max_candidates"]


def test_two_seeds_two_worlds():
    config, c = _files("r2r.eval_greedy")
    split = _small(c["world"])
    a, b = make_world(config["world"], split, 1), make_world(config["world"], split, 2)
    assert [it["path"] for it in a.items] != [it["path"] for it in b.items]
    assert any(not np.array_equal(a.graphs[s].positions, b.graphs[s].positions)
               for s in a.graphs)


def test_full_split_sizes():
    """The split of the evaluation cell at its stated size: 11 scans,
    1,292 panoramas, 2,349 items, every scan connected."""
    config, c = _files("r2r.eval_greedy")
    w = make_world(config["world"], c["world"], 7)
    assert (len(w.graphs), w.num_nodes, len(w.items)) == (11, 1292, 2349)
    assert {g.num_nodes for g in w.graphs.values()} <= {117, 118}
