"""Multi-task pretraining loop (torch), the port of
``vln_hamt_tpu/pretrain/trainer.py``.

Parity target: ``pretrain_src/main_r2r.py:231-316`` (training with
mix-ratio task sampling, gradient accumulation, warmup-linear LR,
periodic per-task validation) and ``pretrain_src/data/loader.py``
(MetaLoader). As in the JAX package the task schedule is a pure function
of (seed, step) and gradient accumulation is ``optax.MultiSteps``'s
(``agents/optim.py``).

Each update builds its batch on the host (numpy only, in a one-worker
thread that prepares batch k+1 while the device trains on batch k),
ships it (index mode: table rows and small arrays), gathers the features
on the device from the resident table, runs the task's forward and
backward through the attention kernels and steps the optimizer. No CUDA
call is made from the worker thread.

Across ranks (:meth:`PretrainTrainer.enable_mesh`) each rank's batcher
builds the same global batch and the rank trains on its data index's
rows (ITM takes the whole batch and scores its rows: its in-batch
negatives index the whole batch); or, with the sharded feed, each rank's
batcher (seeded per data index by the caller) builds the rank's rows
alone, ITM's negatives drawn within them. The losses divide by the
global batch's counts and the optimizer sums the gradients over the data
group; validation splits its batches over the data ranks and averages
through ``reduce_dict_mean``.
"""

from __future__ import annotations

import zlib
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..agents.agent import resolve_device
from ..configs import ModelConfig
from ..models.convert import pretrain_params_from_flax
from ..models.layers import DropoutRNG, compute_dtype, drop_weight_cache, set_dropout_rng
from ..parallel.mesh import (Mesh, barrier, gather_state_dict, is_default_process,
                             process_feed_rows, reduce_dict_mean, shard_model, shard_state_dict)
from .model import HAMTPretrain, batch_to_device, init_pretrain
from .optim import build_pretrain_optimizer, warmup_linear_schedule
from .tasks import TASK_NAMES, PretrainBatcher


# the reference's pretraining defaults, as the JAX trainer's
GRAD_NORM = 5.0  # global-norm clip
WEIGHT_DECAY = 0.01
VAL_SEED = 1234  # validation's masking and negative-sampling streams
AUG_RATIO = 0.5  # the chance a step draws from the aug stream, when there is one


class TaskScheduler:
    """Deterministic mix-ratio task sampling (loader.py:18-59): the task
    of step k is a pure function of (seed, k), the JAX package's draw."""

    def __init__(self, tasks: Sequence[str], mix_ratio: Sequence[float], seed: int = 0):
        if len(tasks) != len(mix_ratio):
            raise ValueError(f"{len(tasks)} tasks but {len(mix_ratio)} mix ratios")
        self.tasks = list(tasks)
        p = np.asarray(mix_ratio, np.float64)
        self.p = p / p.sum()
        self.seed = seed

    def sample(self, step: int) -> str:
        rng = np.random.default_rng((self.seed << 20) + step)
        return self.tasks[int(rng.choice(len(self.tasks), p=self.p))]


class PretrainTrainer:
    """Pretraining of a :class:`HAMTPretrain` on ``device`` (the card
    unless told otherwise): ``model``, a ready one (end-to-end image
    pretraining's ``HAMTImagePretrain``), or one initialized from
    ``seed``; ``aug_batcher``, a second stream drawn with probability
    :data:`AUG_RATIO` per step (the JAX trainer's default). ``optim``
    names the zoo's optimizer (``pretrain/optim.py``); ``feat_table``
    (N, 36, D + P), when given,
    lives on the device in the compute dtype (bf16 under bfloat16
    compute: half the memory, and MRC's prob-tail labels bf16-approximate,
    as the JAX CLI's table) and the batchers' datasets must be in index mode
    (``TrajectoryDataset.set_feat_offsets``)."""

    def __init__(
        self,
        cfg: ModelConfig,
        batcher: PretrainBatcher,
        tasks: Sequence[str] = TASK_NAMES,
        mix_ratio: Sequence[float] = (5, 1, 1, 1, 2, 2),  # pretrain_r2r.json
        batch_size: int = 16,
        lr: float = 5e-5,
        warmup_steps: int = 10_000,
        total_steps: int = 200_000,
        grad_accum: int = 1,
        seed: int = 0,
        optim: str = "adamw",
        feat_table: Optional[np.ndarray] = None,
        device=None,
        model: Optional[HAMTPretrain] = None,
        aug_batcher: Optional[PretrainBatcher] = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batcher = batcher
        self.batch_size = batch_size
        self.scheduler = TaskScheduler(tasks, mix_ratio, seed)
        self._feat_table = (None if feat_table is None else torch.as_tensor(feat_table).to(
            self.device, compute_dtype(cfg)))
        self.aug_batcher = aug_batcher
        self.model: HAMTPretrain = (init_pretrain(cfg, seed) if model is None
                                    else model).to(self.device)
        # dropout masks on the device, the attention kernels' seeds on the host
        self.seed = seed
        self.dropout_rng = DropoutRNG(self.device, seed + 99)
        set_dropout_rng(self.model, self.dropout_rng)
        self.mesh: Optional[Mesh] = None
        self._rows: Optional[Tuple[int, int]] = None  # the rank's rows of a global batch
        self._local_bs = batch_size  # the rows a batcher builds per step
        self._opt_args = dict(name=optim, lr=warmup_linear_schedule(lr, warmup_steps,
                                                                     total_steps),
                              weight_decay=WEIGHT_DECAY, grad_norm=GRAD_NORM,
                              grad_accum=grad_accum)
        self.optimizer = build_pretrain_optimizer(model=self.model, **self._opt_args)
        self.step = 0
        # one-worker prefetch: batch k+1 is built on a host thread while
        # the device trains on batch k (the reference's PrefetchLoader,
        # pretrain_src/data/loader.py:90-124); numpy only there
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._next_batch = None

    # ------------------------------------------------------------------
    def enable_mesh(self, mesh: Mesh, sharded_feed: bool = False) -> None:
        """Train as this rank of ``mesh`` (the JAX trainer's ``mesh`` and
        ``host_sharded``): the model's blocks split over the model group,
        dropout drawn per rank, the losses over the global batch; the
        rank's rows of each global batch, or with ``sharded_feed`` a
        batch of ``batch_size / data_shards`` rows from its own batcher.
        Call before training: the optimizer starts afresh."""
        if self.batch_size % mesh.data_shards:
            raise ValueError(f"batch {self.batch_size} is not divisible by "
                             f"{mesh.data_shards} data shards")
        self.mesh = mesh
        shard_model(self.model, mesh)
        self.model.data_group = mesh.data_group
        split = mesh.data_shards > 1
        self._rows = process_feed_rows(mesh, self.batch_size) if split and not sharded_feed else None
        self._local_bs = self.batch_size // mesh.data_shards if sharded_feed else self.batch_size
        self.dropout_rng = DropoutRNG(self.device, self.seed + 99, mesh.dropout_streams)
        set_dropout_rng(self.model, self.dropout_rng)
        drop_weight_cache(self.model)
        self.optimizer = build_pretrain_optimizer(model=self.model, mesh=mesh, **self._opt_args)

    def set_params(self, state_dict: Mapping[str, Any]) -> None:
        """Install weights (a full state dict of the model, tensors or
        numpy arrays) before training, as the JAX trainer's
        ``set_params``: the optimizer starts fresh (lookahead's slow
        weights are copies of these), the step count stays."""
        self.model.load_state_dict(shard_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()}, self.mesh), strict=True)
        drop_weight_cache(self.model)
        self.optimizer = build_pretrain_optimizer(model=self.model, mesh=self.mesh,
                                                  **self._opt_args)

    def load_flax_params(self, params: Mapping) -> None:
        """Install the JAX package's flax ``HAMTPretrain`` params (nested
        dicts of numpy arrays)."""
        self.set_params(pretrain_params_from_flax(params, self.cfg))

    def save(self, path: str) -> None:
        """The model's state dict (a reference pretrain ``ModelSaver``
        file: ``bert.*``, ``mlm_head.*``, the heads) plus ``step``; under
        lookahead the fast weights. Loads with ``weights_only=True``. In
        the one-rank layout: every rank gathers, rank 0 writes."""
        sd = gather_state_dict(self.model.state_dict(), self.mesh)
        if is_default_process():
            torch.save({**sd, "step": self.step}, path)
        barrier(self.mesh)

    def resume(self, path: str) -> int:
        """Weights and step from a :meth:`save` file (the reference's
        --checkpoint, main_r2r.py:145-148); a fresh optimizer."""
        blob = torch.load(path, map_location=self.device, weights_only=True)
        step = int(blob.pop("step"))
        self.set_params(blob)
        self.step = step
        return step

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    # ------------------------------------------------------------------
    def _pick_batcher(self, step: int) -> PretrainBatcher:
        """The GT batcher, or the aug stream's with probability
        :data:`AUG_RATIO` when there is one: a pure function of (seed,
        step), the JAX trainer's draw."""
        if self.aug_batcher is None:
            return self.batcher
        rng = np.random.default_rng((self.scheduler.seed << 21) + step)
        return self.aug_batcher if rng.random() < AUG_RATIO else self.batcher

    def _build_batch(self, step: int) -> Tuple[str, Dict[str, np.ndarray]]:
        task = self.scheduler.sample(step)
        if task == "itm" and self.batch_size < 2:
            # in-batch ITM negatives need >= 2 items; the reference skips
            # these batches (main_r2r_image.py:239-246), this resamples
            task = next(t for t in self.scheduler.tasks if t != "itm")
        return task, self._pick_batcher(step).batch(task, self._local_bs)

    def next_batch(self) -> Tuple[str, Dict[str, np.ndarray]]:
        """The host batch of the current step (prefetched), and the next
        step's put in preparation."""
        if self._next_batch is None:
            self._next_batch = self._pool.submit(self._build_batch, self.step)
        task, batch = self._next_batch.result()
        self._next_batch = self._pool.submit(self._build_batch, self.step + 1)
        return task, batch

    def update(self, task: str, batch: Dict[str, np.ndarray]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One optimizer step (or micro-batch under ``grad_accum``) on a
        host batch of ``task``, in training mode. Returns the loss and the
        metrics, detached device tensors; the host does not wait. Across
        data ranks the batch is the global one (the rank takes its rows)
        or, under the sharded feed, the rank's, and the results are the
        global batch's."""
        rows = None
        if self._rows is not None:
            if task == "itm":
                rows = self._rows
            else:
                batch = _batch_rows(batch, self._rows, self.batch_size)
        return self.update_device(task, batch_to_device(batch, self.device), rows)

    def update_device(self, task: str, batch: Dict[str, torch.Tensor],
                      rows: Optional[Tuple[int, int]] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """:meth:`update` on a batch already on the device (``rows``:
        ITM's rows of a global batch)."""
        self.model.train()
        loss, aux = self.model(batch, task, self._feat_table, rows=rows)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        drop_weight_cache(self.model)
        self.step += 1
        loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
        group = None if self.mesh is None else self.mesh.data_group
        if group is not None:  # the ranks' parts of the global values
            vals = torch.stack([loss, *(v.to(loss.device) for v in aux.values())]).float()
            dist.all_reduce(vals, group=group)
            loss, aux = vals[0], dict(zip(aux, vals[1:]))
        return loss, aux

    def train_step(self) -> Tuple[str, torch.Tensor, Dict[str, torch.Tensor]]:
        """One scheduled update: its task, loss and metrics. The loss and
        metrics are device tensors and the host runs ahead; convert them
        at logging points only."""
        task, batch = self.next_batch()
        return (task, *self.update(task, batch))

    @torch.no_grad()
    def evaluate(self, task: str, batch: Dict[str, np.ndarray]
                 ) -> Tuple[float, Dict[str, float]]:
        """The task's loss and metrics on a host batch, dropout off."""
        self.model.eval()
        loss, aux = self.model(batch_to_device(batch, self.device), task, self._feat_table)
        return float(loss), {k: float(v) for k, v in aux.items()}

    def validate(self, val_batcher: PretrainBatcher) -> Dict[str, Dict[str, float]]:
        """Per-task validation (main_r2r.py:319-511 validators).

        Every task walks its whole split in a fixed order, the last
        partial batch wrap-padded with its duplicated rows weighted 0
        (``ex_valid``), so each example counts once; batch metrics are
        averaged weighted by their example counts, and the masking and
        negative-sampling stream is re-seeded per task (from
        ``VAL_SEED``), so the numbers do not depend on earlier draws.
        Across ranks each data rank evaluates every ``data_shards``-th
        batch (all build every batch, keeping the stream in step), and
        the sums meet in ``reduce_dict_mean``.
        """
        n_data, d_idx = ((1, 0) if self.mesh is None
                         else (self.mesh.data_shards, self.mesh.data_index))
        out = {}
        for task in self.scheduler.tasks:
            if task == "itm" and self.batch_size < 2:
                continue
            saved_rng = val_batcher.rng
            # crc32, not hash(): str hashing is salted per process
            val_batcher.rng = np.random.default_rng(
                (VAL_SEED << 8) + zlib.crc32(task.encode()) % 251)
            try:
                n_ex = val_batcher.n_examples(task)
                sums: Dict[str, float] = defaultdict(float)
                wsum = 0.0
                for bi in range(max(1, -(-n_ex // self.batch_size))):
                    refs = val_batcher.ordered_refs(task, bi * self.batch_size, self.batch_size)
                    batch = val_batcher.batch(task, self.batch_size, refs=refs)
                    if bi % n_data != d_idx:
                        continue
                    n_valid = min(self.batch_size, n_ex - bi * self.batch_size)
                    batch["ex_valid"] = np.arange(self.batch_size) < n_valid
                    loss, aux = self.evaluate(task, batch)
                    w = aux.get("n", float(self.batch_size)) or 1.0
                    sums["loss"] += loss * w
                    for k, v in aux.items():
                        sums[k] += v * w
                    wsum += w
                if self.mesh is not None:
                    sums = reduce_dict_mean({**sums, "_w": wsum}, self.mesh)
                    wsum = sums.pop("_w") * n_data
                    sums = {k: v * n_data for k, v in sums.items()}
                vals = {k: v / wsum for k, v in sums.items()}
                if "n" in vals:
                    vals["n"] = wsum  # total examples, not a mean of n
                out[task] = vals
            finally:
                val_batcher.rng = saved_rng
        return out


def _batch_rows(batch: Mapping[str, np.ndarray], rows: Tuple[int, int], batch_size: int
                ) -> Dict[str, np.ndarray]:
    """Rows [start, stop) of a host batch of ``batch_size``: every array
    whose leading axis is the batch's."""
    sl = slice(*rows)
    return {k: (v[sl] if np.ndim(v) and np.shape(v)[0] == batch_size else v)
            for k, v in batch.items()}
