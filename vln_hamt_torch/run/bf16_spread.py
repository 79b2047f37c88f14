"""How far bf16 gradients lie from fp32 on the card and on the CPU.

    python -m vln_hamt_torch.run.bf16_spread [--task mrc] [--seeds 0 1 2]
        [--updates 0 20] [--tensor NAME]

For each seed and each count of prior updates: the ``r2r`` pretraining
model of ``run/pretrain.py --synthetic --bf16`` at full width, with the
seed's weights and world, after ``updates`` bf16 updates of the task mix
at the CLI's batch of 16 (``chip_smoke.py`` phase 12 runs 30 before its
check); then one batch of ``--task`` at batch 2, dropout off, through
three models on the same weights: bf16 on the card, bf16 on the CPU and
fp32 on the card with the fp32 feature table (the answer). Per gradient
tensor: its largest fp32 entry, the card's and the CPU's max-abs distance
from the answer, their ratio, and ``chip_smoke.py:bf16_close``'s bound
(3 times the CPU's distance plus 1e-3 of the largest entry below 1).

Prints one JSON line per (seed, updates) with ``--tensor``'s figures (by
default the gradient that sat at 1.03 times its bound in a phase 12 run),
the ratios' quantiles over all tensors and the tensors past the bound,
and a last line with the ratio's range over the runs. Needs the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict

import numpy as np
import torch

from ..agents.agent import resolve_device
from ..data.feature_db import build_feature_table
from ..pretrain import init_pretrain
from ..pretrain.model import batch_to_device
from .profile_pretrain import slice_trainer

TENSOR = "bert.encoder.x_layers.2.lang_self_att.output.LayerNorm.weight"
# chip_smoke.py's bf16 bar
FACTOR, ATOL = 3.0, 1e-3
PARITY_B = 2
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
              "feat_dropout": 0.0, "pred_head_dropout_prob": 0.0}


def gradients(model, batch, task: str, table) -> Dict[str, torch.Tensor]:
    """Named gradients of one task's loss on a host batch, dropout off."""
    model.eval()
    model.zero_grad(set_to_none=True)
    loss, _ = model(batch_to_device(batch, table.device), task, table)
    loss.backward()
    out = {k: p.grad.detach().float().cpu() for k, p in model.named_parameters()
           if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return out


def spread(card: Dict[str, torch.Tensor], cpu: Dict[str, torch.Tensor],
           fp32: Dict[str, torch.Tensor]) -> Dict[str, dict]:
    """Per tensor: largest fp32 entry, card and CPU distance, their ratio
    and the bar's bound."""
    out = {}
    for k, f in fp32.items():
        mag = f.abs().max().item()
        dist, cpu_dist = ((x - f).abs().max().item() for x in (card[k], cpu[k]))
        out[k] = {"max_abs": mag, "card": dist, "cpu": cpu_dist,
                  "ratio": dist / cpu_dist if cpu_dist else float("inf"),
                  "bound": FACTOR * cpu_dist + ATOL * min(1.0, mag)}
    return out


def run(seed: int, updates: int, task: str, device) -> Dict[str, dict]:
    trainer, _ = slice_trainer("r2r", batch_size=16, seed=seed, device=device,
                               extra=("--bf16",))
    for _ in range(updates):
        trainer.train_step()
    trainer.close()
    cfg = dataclasses.replace(trainer.cfg, **NO_DROPOUT)
    sd = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    models = {}
    for name, dtype, dev in (("card", "bfloat16", device), ("cpu", "bfloat16", "cpu"),
                             ("fp32", "float32", device)):
        m = init_pretrain(dataclasses.replace(cfg, dtype=dtype), seed=0)
        m.load_state_dict(sd)
        models[name] = m.to(dev)
    ds = trainer.batcher.ds
    table32 = torch.as_tensor(build_feature_table(ds.graphs, ds.feat_db)[0]).to(device)
    tables = {"card": trainer._feat_table, "cpu": trainer._feat_table.cpu(), "fp32": table32}
    batch = trainer.batcher.batch(task, PARITY_B)
    del trainer
    grads = {name: gradients(models[name], batch, task, tables[name]) for name in models}
    return spread(grads["card"], grads["cpu"], grads["fp32"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", default="mrc")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--updates", type=int, nargs="+", default=[0, 20])
    p.add_argument("--tensor", default=TENSOR)
    args = p.parse_args(argv)
    device = resolve_device()  # the card; raises without one
    ratios = []
    for seed in args.seeds:
        for updates in args.updates:
            per = run(seed, updates, args.task, device)
            r = np.array([v["ratio"] for v in per.values() if np.isfinite(v["ratio"])])
            over = {k: round(v["card"] / v["bound"], 3) for k, v in per.items()
                    if v["card"] > v["bound"]}
            ratios.append(per[args.tensor]["ratio"])
            print(json.dumps({"seed": seed, "updates": updates, "task": args.task,
                              "tensor": args.tensor, **per[args.tensor],
                              "over_bound": per[args.tensor]["card"] / per[args.tensor]["bound"],
                              "ratio_quantiles": dict(zip(
                                  ("min", "median", "p90", "max"),
                                  np.quantile(r, [0, 0.5, 0.9, 1]).tolist())),
                              "tensors": len(per), "past_bound": over}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"tensor": args.tensor, "ratio_min": min(ratios),
                      "ratio_max": max(ratios), "runs": len(ratios)}))


if __name__ == "__main__":
    main()
