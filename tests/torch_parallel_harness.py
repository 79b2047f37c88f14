"""Multi-rank runs of the port (data and tensor parallelism) that a
one-rank run checks: the updates' losses, the gathered gradients and
parameters, the greedy trajectories, the kernels' launches per rank.
The tests/test_torch_parallel*.py files and ``chip_smoke.py`` drive it.

    python tests/torch_parallel_harness.py --cpu --tiny --steps il,merged --out one.json
    torchrun --standalone --nproc_per_node 2 tests/torch_parallel_harness.py \\
        --cpu --tiny --steps il,merged [--model_shards 2] --out two.json

Without a process group (no WORLD_SIZE) it runs undistributed: the
reference of the ranks. :func:`launch` starts the ranks of this script
or of a CLI module through ``torch.distributed.run``, bounded by a
timeout. The backend is gloo (which lets ranks share one card) unless
``--backend nccl``. Rank 0 writes the result JSON (``--out``) and, when
asked, the gradients of the updates that ``--grads_steps`` lists
(``--grads_out``, keys ``{update}/{name}``, the critic's as
``{update}/critic.{name}``) and the parameters after the last update
(``--params_out``), as ``.npz`` in the one-rank layout.

Fine-tuning (the default): ``--task`` r2r or reverie, the ``--tiny``
model on the CPU or the preset at full width (``run/profile_eval.py:
slice_config``), ``--batch`` the global batch, dropout off unless
``--dropout``. ``--sharded_feed N``: each of N data ranks' train env
holds its shard of the items (``sel_data_idxs``) at ``batch / N``
(``enable_host_sharded_feed``), and the undistributed run feeds the N
shards' minibatches joined. ``--steps`` lists the updates: ``il``,
``packed`` (packed IL), ``fused``, ``merged`` (sampling from the shared
action generator), ``argmax`` (the fused update on a greedy rollout),
``merged_argmax`` (the merged update with the argmax for its sampler:
nothing drawn), ``replay`` (rollout then replay on the device). ``--eval device|packed`` evaluates
``--val_items`` items sharded over the data ranks and gathers the
trajectories. Pretraining (``--pretrain``): one update per task at
``--batch``, then with ``--validate`` the validation of every task.
``finetune ARGV`` runs the fine-tuning CLI over ARGV with dropout off
and SGD (:func:`finetune_for_parity`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

import vln_hamt_torch.agents.rollout as rollout_module
from vln_hamt_torch.agents.agent import HAMTAgent, resolve_device
from vln_hamt_torch.agents.reverie import ReverieAgent
from vln_hamt_torch.configs import HAMTConfig
from vln_hamt_torch.data.fixtures import add_synthetic_objects, make_synthetic_world
from vln_hamt_torch.env import ObsSpec, R2RNavEnv, ReverieNavEnv
from vln_hamt_torch.ops.attention import launch_counts
from vln_hamt_torch.parallel.mesh import (Mesh, all_reduce_grads, gather_state_dict,
                                          host_allgather, init_distributed, is_default_process,
                                          local_device, make_mesh, param_partition_spec,
                                          process_feed_rows, reduce_dict_mean)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_WORLD = dict(num_scans=1, nodes_per_scan=12, num_items=12, feat_dim=32, seed=1)
TINY_MODEL = {"hidden_size": 64, "num_attention_heads": 4, "intermediate_size": 128,
              "num_l_layers": 2, "num_x_layers": 2, "num_h_pano_layers": 1,
              "image_feat_size": 32, "max_action_steps": 20, "max_position_embeddings": 64}
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
              "feat_dropout": 0.0, "pred_head_dropout_prob": 0.0, "critic_dropout": 0.0}
OBJ_FEAT, MAX_OBJECTS = 24, 3
#: the updates that draw two minibatches: their teacher episode's and their rollout's
SAMPLE_STEPS = ("fused", "merged", "argmax", "merged_argmax", "replay")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--model_shards", type=int, default=1)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--remat", default=None, choices=("full", "dots"),
                   help="activation recomputation of the rollout steps, by this policy")
    p.add_argument("--pretrain", action="store_true")
    p.add_argument("--collectives", action="store_true",
                   help="only the host collectives: host_allgather, reduce_dict_mean, "
                        "is_default_process and each rank's feed rows")
    p.add_argument("--task", default="r2r", choices=("r2r", "reverie"))
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--sharded_feed", type=int, default=0,
                   help="data ranks whose train envs hold their own shard (0: every rank "
                        "builds the global batch)")
    p.add_argument("--steps", default="il")
    p.add_argument("--optim", default="sgd")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--grad_clip", type=float, default=40.0)
    p.add_argument("--dropout", action="store_true")
    p.add_argument("--eval", default="none", choices=("none", "device", "packed"))
    p.add_argument("--val_items", type=int, default=8)
    p.add_argument("--eval_batch", type=int, default=None,
                   help="the evaluation's global batch (default --batch)")
    p.add_argument("--logits_out", default=None,
                   help="after the updates, the eval-mode logits of the next teacher "
                        "episode, gathered (.npy)")
    p.add_argument("--validate", action="store_true",
                   help="pretraining: validate every task over the val split after the updates")
    p.add_argument("--flax_params", default=None,
                   help="an .npz of the JAX package's params (and cparams) to start from, "
                        "keys 'params/...' and 'cparams/...'")
    p.add_argument("--time_allreduce", type=int, default=0,
                   help="time the all-reduce of the model's gradient buffer this many times")
    p.add_argument("--ckpt_dir", default=None,
                   help="save the agent there as a .pt file and a directory (asynchronously), "
                        "then load both back")
    p.add_argument("--out", default=None)
    p.add_argument("--grads_out", default=None)
    p.add_argument("--grads_steps", default="0",
                   help="the updates (indexes into --steps) whose gradients --grads_out holds")
    p.add_argument("--params_out", default=None)
    return p.parse_args(argv)


# ---------------------------------------------------------------- launch
_RANK_LINE = re.compile(r"^\[[^\]]*?(\d+)\]:(.*)$")


def launch(target: List[str], ranks: int, timeout: float) -> List[str]:
    """Run ``ranks`` rank processes of ``target`` (a script and its
    arguments, or ``["-m", module, ...]``) through ``torch.distributed.run
    --standalone`` (its store on a port it binds itself) and return each
    rank's output. Raises if a rank fails (the launcher then stops the
    others) or if the ranks outlive ``timeout`` seconds (every process is
    then killed)."""
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, base.get("PYTHONPATH")]))
    if target[0] == "-m":
        target = ["--module", *target[1:]]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(ranks), "--tee", "3", *target]
    proc = subprocess.Popen(cmd, env=base, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    failed = None
    try:
        out, _ = proc.communicate(timeout=timeout)
        if proc.returncode != 0:
            failed = f"the ranks exited with {proc.returncode}"
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        failed = f"the ranks ran past {timeout} s"
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    outs = [""] * ranks
    for line in out.splitlines():
        m = _RANK_LINE.match(line)
        if m and int(m.group(1)) < ranks:
            outs[int(m.group(1))] += m.group(2) + "\n"
    if failed:
        raise RuntimeError(failed + "\n" + out[-12000:])
    return outs


def spawn(argv: List[str], ranks: int, timeout: float) -> List[str]:
    """:func:`launch` of this script's ranks over ``argv``."""
    return launch([os.path.abspath(__file__), *argv], ranks, timeout)


# ------------------------------------------------------------ fine-tuning
def finetune_config(args) -> tuple:
    """(config, world) of the run: the tiny model or the preset at full
    width over the profile scripts' synthetic world."""
    if args.tiny:
        world = make_synthetic_world(**TINY_WORLD)
        model = dict(TINY_MODEL, **({} if args.dropout else NO_DROPOUT))
        env = {"max_action_len": 6, "max_instr_len": 24, "image_feat_size": 32,
               "max_candidates": max(g.max_degree for g in world.graphs.values())}
        if args.task == "reverie":
            model.update(obj_feat_size=OBJ_FEAT)
            env.update(max_objects=MAX_OBJECTS)
            world.objects = add_synthetic_objects(world, obj_feat_size=OBJ_FEAT, seed=1)
        cfg = HAMTConfig().replace(model=model, env=env)
        if args.task == "reverie":
            cfg = cfg.replace(env={"dataset": "reverie"})
    else:
        from vln_hamt_torch.run.profile_eval import slice_config

        cfg, world = slice_config(args.batch, 0, args.task)
        if not args.dropout:
            cfg = cfg.replace(model=NO_DROPOUT)
    if args.bf16:
        cfg = cfg.replace(model={"dtype": "bfloat16"})
    if args.remat:
        cfg = cfg.replace(model={"remat": True, "remat_policy": args.remat})
    cfg = cfg.replace(train={"batch_size": args.batch, "optim": args.optim, "lr": args.lr,
                             "grad_clip": args.grad_clip, "ml_weight": 1.0})
    return cfg, world


def make_env(cfg: HAMTConfig, world, items, batch: int, shard=None) -> R2RNavEnv:
    """The task's env over ``items`` at ``batch`` (``shard``: the env's
    ``sel_data_idxs``)."""
    spec = ObsSpec(max_candidates=cfg.env.max_candidates,
                   image_feat_size=cfg.env.image_feat_size)
    kw = dict(batch_size=batch, max_instr_len=cfg.env.max_instr_len,
              max_action_len=cfg.env.max_action_len, seed=0, sel_data_idxs=shard)
    if cfg.env.dataset == "reverie":
        obj_db, obj2vp = world.objects
        return ReverieNavEnv(world.graphs, world.feat_db, items, spec, obj_db=obj_db,
                             obj2viewpoint=obj2vp, max_objects=cfg.env.max_objects,
                             obj_feat_size=cfg.model.obj_feat_size, multi_endpoints=False, **kw)
    return R2RNavEnv(world.graphs, world.feat_db, items, spec, **kw)


def train_env(cfg: HAMTConfig, world, args, mesh: Optional[Mesh]) -> R2RNavEnv:
    """The train env: the global batch's, the data rank's shard under
    ``--sharded_feed``, or for the undistributed run under it an env whose
    minibatches are the shards' joined."""
    n, b, items = args.sharded_feed, args.batch, world.instr_data
    if not n:
        return make_env(cfg, world, items, b)
    if mesh is not None:
        if mesh.data_shards != n:
            raise ValueError(f"--sharded_feed {n} on {mesh.data_shards} data ranks")
        return make_env(cfg, world, items, b // n, (mesh.data_index, n))
    shards = [make_env(cfg, world, items, b // n, (r, n)) for r in range(n)]
    seq = []
    for _ in range(sum(2 if s in SAMPLE_STEPS else 1 for s in args.steps.split(","))):
        for env in shards:
            env._next_minibatch()
            seq.extend(env.batch)
    env = make_env(cfg, world, items, b)
    env.data, env.ix = seq, 0
    return env


def load_flax(path: str) -> Dict[str, dict]:
    """The nested params / cparams trees of a ``--flax_params`` file."""
    blob = np.load(path)
    trees: Dict[str, dict] = {"params": {}, "cparams": {}}
    for key in blob.files:
        root, *parts = key.split("/")
        node = trees[root]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = blob[key]
    return trees


def _reset_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _stats(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in d.items()}


@contextlib.contextmanager
def greedy_draws(on: bool = True):
    """The rollouts' sampler (``rollout.gumbel_max``) replaced by the
    argmax while on: a sampling update draws nothing, so that it compares
    with the JAX package's under the same replacement."""
    draw = rollout_module.gumbel_max
    if on:
        rollout_module.gumbel_max = lambda logits, generator, rows=None: logits.argmax(-1)
    try:
        yield
    finally:
        rollout_module.gumbel_max = draw


class AllReduceCount:
    """Counts ``torch.distributed.all_reduce`` calls by group (``model``:
    the tensor-parallel layers' and the norms', ``data``: the gradients'
    and the global counts', else ``other``) while it is installed."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh, self.counts = mesh, {}
        self._orig = dist.all_reduce

    def __enter__(self):
        def counted(tensor, *a, group=None, **kw):
            m = self.mesh
            name = ("model" if m and group is m.model_group and m.model_shards > 1 else
                    "data" if m and group in (m.data_group, m.data_host_group) else "other")
            self.counts[name] = self.counts.get(name, 0) + 1
            return self._orig(tensor, *a, group=group, **kw)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self._orig


def _grads(agent: HAMTAgent, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The model's and the critic's gradients (zeros where none), gathered."""
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
             for k, p in agent.model.named_parameters()}
    grads = gather_state_dict(grads, mesh)
    grads.update({"critic." + k: (p.grad if p.grad is not None else torch.zeros_like(p))
                  .detach() for k, p in agent.critic.named_parameters()})
    return grads


def run_finetune(args, mesh: Optional[Mesh], device) -> dict:
    cfg, world = finetune_config(args)
    b = args.batch
    env = train_env(cfg, world, args, mesh)
    agent_cls = ReverieAgent if cfg.env.dataset == "reverie" else HAMTAgent
    agent = agent_cls(cfg, env, seed=0, device=device)
    steps = args.steps.split(",")
    if mesh is not None:
        agent.enable_mesh(mesh)
        if args.sharded_feed:
            agent.enable_host_sharded_feed()
    if args.flax_params:
        trees = load_flax(args.flax_params)
        agent.load_flax_params(trees["params"], trees["cparams"])
    agent.enable_feature_table()
    if "packed" in steps:
        agent.enable_packed_il()

    out = {"losses": [], "launches": [], "seconds": [], "episodes": [], "allreduces": []}
    grads, grad_steps = {}, {int(i) for i in args.grads_steps.split(",")}
    for i, step in enumerate(steps):
        _reset_counts()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with AllReduceCount(mesh) as counted:
            if step in ("il", "packed"):
                res = agent.train_iteration("teacher")
                episodes = res.get("episodes", b)
            elif step == "argmax":
                il_ep = agent._teacher_episode()
                ins = agent._device_rollout_args()
                loss, aux = agent._update(lambda: agent._fused_sample_loss(il_ep, ins, "argmax"))
                res = {"loss": float(loss), **_stats(aux)}
                episodes = b
            else:
                agent.merged_sample_update = step in ("merged", "merged_argmax")
                agent.fused_sample_update = step == "fused"
                with greedy_draws(step == "merged_argmax"):
                    res = agent.train_iteration("sample")
                episodes = b  # the CLI's count: the batch per update
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        out["seconds"].append(time.perf_counter() - t0)
        out["episodes"].append(episodes)
        out["losses"].append([step, res])
        out["launches"].append(dict(launch_counts))
        out["allreduces"].append(counted.counts)
        if args.grads_out and i in grad_steps:
            grads.update({f"{i}/{k}": v.float().cpu().numpy()
                          for k, v in _grads(agent, mesh).items()})
    if args.grads_out and _rank0():
        np.savez(args.grads_out, **grads)
    out["launches_per_rank"] = host_allgather(out["launches"], mesh)
    if args.time_allreduce:
        out["allreduce"] = time_allreduce(agent, mesh, args.time_allreduce)
    if args.logits_out:
        agent.model.eval()
        with torch.no_grad():
            logits = agent.episode_forward(agent._teacher_episode(), agent._feat_table,
                                           agent._obj_tables).logits.float().cpu().numpy()
        parts = host_allgather((0 if mesh is None else mesh.model_index, logits), mesh)
        if _rank0():  # (T, B, N): the data ranks' rows, once per model group
            np.save(args.logits_out, np.concatenate([x for m, x in parts if m == 0], axis=1))
    if args.params_out:
        sd = gather_state_dict(agent.model.state_dict(), mesh)
        csd = agent.critic.state_dict()
        if _rank0():
            np.savez(args.params_out, **{k: v.float().cpu().numpy() for k, v in sd.items()},
                     **{"critic." + k: v.float().cpu().numpy() for k, v in csd.items()})
    if args.ckpt_dir:
        out["ckpt"] = checkpoint_roundtrip(agent, args.ckpt_dir)
    if args.dropout:
        out["dropout"] = probe_dropout(agent, mesh)
    if args.eval != "none":
        out.update(evaluate(agent, cfg, world, args, mesh))
    return out


def _digest(sd: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().abs().sum()) for k, v in sd.items()}


def checkpoint_roundtrip(agent: HAMTAgent, ckpt_dir: str) -> dict:
    """``save`` (``ckpt_dir/agent.pt``) and an asynchronous ``save_dir``
    (``ckpt_dir/agent``), each loaded back with the optimizers: whether
    the rank's parameters and moments came back the same."""
    before = {**_digest(agent.model.state_dict()), **_digest(
        {f"{i}/{k}": v for i, st in agent.optimizer.state_dict()["state"].items()
         for k, v in st.items() if torch.is_tensor(v)})}
    step = agent.step
    agent.save(os.path.join(ckpt_dir, "agent.pt"))
    agent.save_dir(os.path.join(ckpt_dir, "agent"), async_=True)
    agent.wait_for_checkpoints()
    same = {}
    for name in ("agent.pt", "agent"):
        agent.step = -1
        got_step = agent.load(os.path.join(ckpt_dir, name), resume_optimizer=True)
        after = {**_digest(agent.model.state_dict()), **_digest(
            {f"{i}/{k}": v for i, st in agent.optimizer.state_dict()["state"].items()
             for k, v in st.items() if torch.is_tensor(v)})}
        same[name] = got_step == step and after == before
    return same


def probe_dropout(agent: HAMTAgent, mesh: Optional[Mesh]) -> list:
    """Per rank: the next hidden-dropout mask bits and attention seed of
    the agent's streams, a train-mode teacher episode forward's logits
    (dropout on) and the replicated parameters' digest."""
    probe = _next_draws(agent)
    agent.model.train()
    with torch.no_grad():
        logits = agent.episode_forward(agent._teacher_episode(), agent._feat_table,
                                       agent._obj_tables).logits
    replicated = {k: v for k, v in agent.model.state_dict().items()
                  if param_partition_spec(k) is None}
    fin = torch.isfinite(logits)
    mine = {"mask": probe[0], "seed": probe[1],
            "logits": float(torch.where(fin, logits, 0.0).double().sum()),
            "replicated": sum(_digest(replicated).values()),
            "data_index": 0 if mesh is None else mesh.data_index,
            "model_index": 0 if mesh is None else mesh.model_index}
    return host_allgather(mine, mesh)


def _next_draws(agent: HAMTAgent):
    """The agent's next mask bits and attention seed, from copies of its
    streams (the agent's own draws are left as they are)."""
    state = agent.dropout_rng.get_state()
    mask = agent.dropout_rng.keep(torch.ones(32, device=agent.device), 0.5)
    seed = agent.dropout_rng.attention_seed()
    agent.dropout_rng.set_state(state)
    return [int(x) for x in mask.cpu().tolist()], seed


def evaluate(agent: HAMTAgent, cfg, world, args, mesh: Optional[Mesh]) -> dict:
    """Greedy evaluation of the first ``val_items`` items, sharded over the
    data ranks (the env's ``sel_data_idxs``) at the local batch, the
    trajectories gathered from every rank; the forward launches of the
    rank's evaluation."""
    n_data = 1 if mesh is None else mesh.data_shards
    shard = None if n_data == 1 else (mesh.data_index, n_data)
    env = make_env(cfg, world, world.instr_data[:args.val_items],
                   (args.eval_batch or args.batch) // n_data, shard)
    env.feat_offsets = agent.env.feat_offsets
    _reset_counts()
    with torch.no_grad():
        preds = (agent.eval_split_device(env) if args.eval == "device"
                 else agent.eval_split_packed(env))
    launches = dict(launch_counts)
    merged = {}
    for shard_preds in host_allgather(preds, mesh):
        for p in shard_preds:
            merged.setdefault(p["instr_id"], p)
    return {"traj": {k: [x[0] for x in p["trajectory"]] for k, p in sorted(merged.items())},
            "obj_preds": {k: p.get("predObjId") for k, p in sorted(merged.items())},
            "eval_launches": launches, "eval_items": len(preds)}


def time_allreduce(agent: HAMTAgent, mesh: Optional[Mesh], reps: int) -> dict:
    """ms per all-reduce of the model's and the critic's gradients over
    the data group (the optimizers' bucketed sum), and its bytes."""
    grads = [p.grad for m in (agent.model, agent.critic) for p in m.parameters()
             if p.grad is not None]
    nbytes = sum(g.numel() * g.element_size() for g in grads)
    if mesh is None or mesh.data_group is None or not grads:
        return {"ms": None, "bytes": nbytes}
    work = [g.clone() for g in grads]
    all_reduce_grads(work, mesh.data_group)  # warm-up
    if work[0].is_cuda:
        torch.cuda.synchronize(work[0].device)
    t0 = time.perf_counter()
    for _ in range(reps):
        all_reduce_grads(work, mesh.data_group)
    if work[0].is_cuda:
        torch.cuda.synchronize(work[0].device)
    return {"ms": (time.perf_counter() - t0) * 1e3 / reps, "bytes": nbytes}


# ------------------------------------------------------------ pretraining
def run_pretrain(args, mesh: Optional[Mesh], device) -> dict:
    """One update per task on the synthetic pretraining slice at
    ``args.batch``, the CLI's build (``run/pretrain.py``), then
    validation; losses and metrics per task."""
    from vln_hamt_torch.run import pretrain as pretrain_cli

    argv = ["--synthetic", "--batch_size", str(args.batch), "--optim", "adamw",
            "--lr", str(args.lr), "--warmup_steps", "0"]
    if args.tiny:
        argv.append("--tiny")
    if args.bf16:
        argv.append("--bf16")
    if args.sharded_feed:
        argv.append("--sharded_feed")
    pargs = pretrain_cli.parse_args(argv)
    trainer, val_batchers = pretrain_cli.build(pargs, device, mesh)
    if args.flax_params:
        trainer.load_flax_params(load_flax(args.flax_params)["params"])
    if not args.dropout:
        for m in trainer.model.modules():
            if hasattr(m, "p") and isinstance(m.p, float):
                m.p = 0.0
            if hasattr(m, "dropout_prob"):
                m.dropout_prob = 0.0
    out = {"losses": [], "launches": [], "batches": []}
    grads = {}
    for task in pargs.tasks:
        batch = trainer.batcher.batch(task, trainer._local_bs)
        out["batches"].append(int(np.asarray(batch["txt_ids"], np.int64).sum()))
        _reset_counts()
        loss, aux = trainer.update(task, batch)
        out["losses"].append([task, {"loss": float(loss), **_stats(aux)}])
        out["launches"].append(dict(launch_counts))
        if args.grads_out:  # the update's gradients (summed over the data ranks)
            g = {k: p.grad.detach() for k, p in trainer.model.named_parameters()
                 if p.grad is not None}
            grads.update({f"{task}/{k}": v.float().cpu().numpy()
                          for k, v in gather_state_dict(g, mesh).items()})
    if args.grads_out and _rank0():
        np.savez(args.grads_out, **grads)
    out["launches_per_rank"] = host_allgather(out["launches"], mesh)
    if args.params_out:
        sd = gather_state_dict(trainer.model.state_dict(), mesh)
        if _rank0():
            np.savez(args.params_out, **{k: v.float().cpu().numpy() for k, v in sd.items()})
    if args.validate:
        out["val"] = trainer.validate(next(iter(val_batchers.values())))
    out["batches"] = host_allgather(out["batches"], mesh)  # per rank
    trainer.close()
    return out


def run_collectives(args, mesh: Optional[Mesh]) -> dict:
    rank = int(os.environ.get("RANK", "0"))
    return {"gathered": host_allgather({"rank": rank}, mesh),
            "reduced": reduce_dict_mean({"x": float(rank), "y": 2.0}, mesh),
            "default": host_allgather(is_default_process(), mesh),
            "coords": host_allgather([mesh.data_index, mesh.model_index] if mesh else [0, 0],
                                     mesh),
            "rows": host_allgather(list(process_feed_rows(mesh, args.batch)) if mesh
                                   else [0, args.batch], mesh)}


def _rank0() -> bool:
    return int(os.environ.get("RANK", "0")) == 0


def main(argv=None):
    args = parse_args(argv)
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    dist_up = init_distributed(backend=args.backend, cpu=args.cpu)
    mesh = None
    if dist_up:
        world = dist.get_world_size()
        mesh = make_mesh(world // args.model_shards, args.model_shards)
    device = resolve_device(local_device(args.cpu) if dist_up else
                            ("cpu" if args.cpu else None))
    if args.collectives:
        result = run_collectives(args, mesh)
    else:
        result = (run_pretrain if args.pretrain else run_finetune)(args, mesh, device)
    result["world"] = 1 if mesh is None else mesh.data_shards * mesh.model_shards
    result["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    if _rank0() and args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    if dist_up:
        dist.barrier()
        dist.destroy_process_group()
    return result


def finetune_for_parity(argv: List[str]) -> dict:
    """``run/finetune.py``'s ``main`` over ``argv`` with the presets'
    dropout off and SGD for their optimizer, so that runs compare weight
    for weight (``python torch_parallel_harness.py finetune ARGV``)."""
    from vln_hamt_torch.run import finetune

    preset = finetune.get_preset
    finetune.get_preset = lambda task: preset(task).replace(model=NO_DROPOUT,
                                                            train={"optim": "sgd"})
    try:
        return finetune.main(argv)
    finally:
        finetune.get_preset = preset


if __name__ == "__main__":
    if sys.argv[1:2] == ["finetune"]:
        finetune_for_parity(sys.argv[2:])
    else:
        main()
