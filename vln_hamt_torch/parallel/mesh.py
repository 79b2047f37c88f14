"""Data and tensor parallelism over ``torch.distributed`` process
groups, the port of ``vln_hamt_tpu/parallel/mesh.py``.

The JAX package lays one ``Mesh`` with axes ``('data', 'model')`` over
every device and lets GSPMD insert the collectives. Here each rank is
one process with one device, and the mesh is the rank's coordinates with
two process groups:

- rank = data index x model_shards + model index (the JAX grid's
  ``reshape(num_data, num_model)``, model-minor);
- the *data group* holds the ranks with this rank's model index: the
  gradients are summed over it once per optimizer step
  (:func:`all_reduce_grads`, called by ``agents/optim.py``), and the
  losses divide by global counts summed over it (:func:`global_sum`);
- the *model group* holds the ranks with this rank's data index: the
  tensor-parallel layers of ``models/layers.py`` reduce over it, with
  the weights that :data:`_TP_RULES` select split across it
  (:func:`shard_model`).

Deviations from the JAX package, each a consequence of the layout:

- one process per GPU (``torchrun`` or the RANK / WORLD_SIZE /
  MASTER_ADDR / MASTER_PORT variables), where a JAX process may hold
  several devices of the mesh;
- gradients by an explicit bucketed all-reduce, not
  ``DistributedDataParallel``: the agent calls the model's methods
  (``encode_text``, ``plan``, ...) directly, past DDP's ``forward``;
- a column-parallel layer's bias is split with its output features
  (JAX keeps every 1-D bias replicated and lets GSPMD slice it);
- dropout masks are per rank (seeded by the data index; the ranks of a
  model group draw the same hidden-dropout masks so that their
  replicated activations stay equal, and attention-probability seeds
  from both indices), so a multi-rank run with dropout on is not
  bit-equal to one rank;
- validation is sharded over the data axis in both feed layouts;
- directory checkpoints are ``torch.distributed.checkpoint``'s, which
  cannot read the JAX package's orbax directories.
"""

from __future__ import annotations

import datetime
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: bucket size of the gradient all-reduce
BUCKET_BYTES = 25 << 20


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data_shards, model_shards) grid of ranks.
    The groups are None when the process runs without a process group
    (one rank, no collectives); under one they exist even at size 1, so a
    world of one runs every collective."""

    data_shards: int = 1
    model_shards: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None
    host_group: Any = None  # gloo: host objects and directory checkpoints
    data_host_group: Any = None  # gloo over the data group: host-side flags

    @property
    def dropout_streams(self) -> Tuple[int, int]:
        """(mask stream, attention-seed stream) of ``DropoutRNG``: masks
        by the data index (a model group's replicas draw alike), seeds by
        both indices (each rank's own heads)."""
        return self.data_index, self.data_index * self.model_shards + self.model_index


def init_distributed(backend: Optional[str] = None, cpu: bool = False) -> bool:
    """Join the process group that ``torchrun`` (or RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT) describes; a no-op without WORLD_SIZE
    or when already joined, like the JAX package's. The backend is NCCL
    on CUDA and gloo under ``cpu``, unless ``backend`` says otherwise
    (gloo lets several ranks share one card). Returns whether a process
    group is up."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    if backend is None:
        backend = "gloo" if cpu else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_device(cpu=False))
    dist.init_process_group(backend=backend, timeout=datetime.timedelta(minutes=10))
    return True


def local_device(cpu: bool = False) -> torch.device:
    """The rank's device: ``cuda:{LOCAL_RANK % device_count}``, or the CPU."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())


def make_mesh(num_data: Optional[int] = None, num_model: int = 1) -> Mesh:
    """The rank's mesh: its data and model indexes and groups. Without a
    process group, the one-rank mesh with no groups. Every rank must call
    it (the groups are made collectively)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    num_data = world // num_model if num_data is None else num_data
    if num_data * num_model != world:
        raise ValueError(
            f"--data_shards {num_data} x --model_shards {num_model} must equal the world "
            f"size {world}: launch {num_data * num_model} ranks "
            f"(torchrun --nproc_per_node {num_data * num_model})")
    if not dist.is_initialized():
        return Mesh()
    rank = dist.get_rank()
    d_idx, m_idx = divmod(rank, num_model)
    data_group = model_group = None
    for m in range(num_model):  # every rank creates every group, in order
        g = dist.new_group([d * num_model + m for d in range(num_data)])
        if m == m_idx:
            data_group = g
    for d in range(num_data):
        g = dist.new_group([d * num_model + m for m in range(num_model)])
        if d == d_idx:
            model_group = g
    if dist.get_backend() == "gloo":
        host_group, data_host_group = dist.group.WORLD, data_group
    else:
        host_group = dist.new_group(backend="gloo")
        for m in range(num_model):
            g = dist.new_group([d * num_model + m for d in range(num_data)], backend="gloo")
            if m == m_idx:
                data_host_group = g
    return Mesh(num_data, num_model, d_idx, m_idx, data_group, model_group, host_group,
                data_host_group)


def is_default_process() -> bool:
    """Rank-0 gating (the reference's ``is_default_gpu``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(mesh: Optional[Mesh] = None) -> None:
    """Wait for every rank (a no-op on one)."""
    if dist.is_initialized():
        dist.barrier(group=None if mesh is None else mesh.host_group)


def host_allgather(obj: Any, mesh: Optional[Mesh] = None) -> list:
    """Every rank's picklable ``obj``, in rank order (``[obj]`` on one):
    evaluation predictions and other rich host objects."""
    if not dist.is_initialized():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj, group=None if mesh is None else mesh.host_group)
    return out


def reduce_dict_mean(scalars: Dict[str, float], mesh: Optional[Mesh] = None
                     ) -> Dict[str, float]:
    """A dict of host scalars averaged over the ranks (the reference's
    ``reduce_dict``); identity on one rank."""
    if not dist.is_initialized():
        return dict(scalars)
    gathered = host_allgather(scalars, mesh)
    return {k: float(np.mean([g[k] for g in gathered])) for k in gathered[0]}


def process_feed_rows(mesh: Mesh, global_batch: int) -> Tuple[int, int]:
    """The [start, stop) rows of a ``global_batch`` that this rank owns:
    its data index's block (the JAX function's rows for a process that
    holds this rank's device)."""
    if global_batch % mesh.data_shards:
        raise ValueError(f"batch {global_batch} is not divisible by "
                         f"{mesh.data_shards} data shards")
    per = global_batch // mesh.data_shards
    return mesh.data_index * per, (mesh.data_index + 1) * per


# ------------------------------------------------------------ collectives
def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A detached copy of ``x`` summed over ``group`` (``x`` itself when
    there is none): the global count behind a local loss's normaliser."""
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_grads(grads: Sequence[torch.Tensor], group,
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum ``grads`` over ``group`` in place, flattened into buckets of
    at most ``bucket_bytes`` per dtype and device (one all-reduce each)."""
    buckets: Dict[Tuple, List[List[torch.Tensor]]] = {}
    for g in grads:
        lst = buckets.setdefault((g.dtype, g.device), [[]])
        if lst[-1] and sum(t.numel() for t in lst[-1]) * g.element_size() >= bucket_bytes:
            lst.append([])
        lst[-1].append(g)
    for lst in buckets.values():
        for bucket in lst:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


# ---------------------------------------------------- tensor parallelism
# The JAX package's _TP_RULES (mesh.py:51-58) over the port's names:
# query / key / value and the feed-forward's first dense column-parallel
# (weight rows and bias split), the attention output's and the
# feed-forward's second dense row-parallel (weight columns split, the
# bias added once after the reduce). Torch weights are (out, in), the
# transpose of flax kernels. The ViT's qkv / proj / fc1 / fc2 match none.
_TP_RULES: Tuple[Tuple[str, int], ...] = (
    (r".*\.(query|key|value)\.(weight|bias)$", 0),
    (r".*\.(intermediate|lang_inter|visn_inter)\.dense\.(weight|bias)$", 0),
    (r".*\.(output|lang_output|visn_output)\.dense\.weight$", 1),
)


def param_partition_spec(name: str) -> Optional[int]:
    """The dimension along which tensor parallelism splits the port
    parameter ``name`` (0: rows, 1: columns), or None (replicated)."""
    for pattern, dim in _TP_RULES:
        if re.match(pattern, name):
            return dim
    return None


def shard_tensor(full: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``full`` along ``dim`` (``full`` when
    replicated or without tensor parallelism)."""
    if dim is None or mesh.model_shards == 1:
        return full
    if full.shape[dim] % mesh.model_shards:
        raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split "
                         f"{mesh.model_shards} ways")
    return full.chunk(mesh.model_shards, dim)[mesh.model_index].clone()


def gather_tensor(local: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """The whole tensor from the model group's blocks along ``dim``."""
    if dim is None or mesh.model_shards == 1:
        return local
    parts = [torch.empty_like(local) for _ in range(mesh.model_shards)]
    dist.all_gather(parts, local.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim)


def shard_state_dict(sd: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                     ) -> Dict[str, torch.Tensor]:
    """A whole (one-rank) state dict as this rank's tensor-parallel
    blocks; a tensor that does not split evenly stays whole (it fits no
    split parameter, and a load by name and shape skips it)."""
    if mesh is None or mesh.model_shards == 1:
        return dict(sd)
    out = {}
    for k, v in sd.items():
        v, dim = torch.as_tensor(v), param_partition_spec(k)
        fits = dim is not None and v.dim() > dim and v.shape[dim] % mesh.model_shards == 0
        out[k] = shard_tensor(v, dim, mesh) if fits else v
    return out


def gather_state_dict(sd: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                      ) -> Dict[str, torch.Tensor]:
    """This rank's state dict made whole (every rank of the model group
    takes part)."""
    if mesh is None or mesh.model_shards == 1:
        return dict(sd)
    return {k: gather_tensor(v, param_partition_spec(k), mesh) for k, v in sd.items()}


def _optimizer_dims(module: torch.nn.Module) -> List[Optional[int]]:
    # an optimizer over module.parameters() numbers them in this order
    return [param_partition_spec(n) for n, _ in module.named_parameters()]


def _map_optimizer_state(osd: Dict[str, Any], dims: List[Optional[int]], fn) -> Dict[str, Any]:
    state = {i: {k: (fn(v, dims[i]) if torch.is_tensor(v) and v.dim() > 0 else v)
                 for k, v in st.items()} for i, st in osd["state"].items()}
    return {**osd, "state": state}


def gather_optimizer_state(osd: Dict[str, Any], module: torch.nn.Module,
                           mesh: Optional[Mesh]) -> Dict[str, Any]:
    """An optimizer's ``state_dict()`` over ``module``'s parameters with
    the moments of split parameters made whole."""
    if mesh is None or mesh.model_shards == 1:
        return osd
    return _map_optimizer_state(osd, _optimizer_dims(module),
                                lambda v, d: gather_tensor(v, d, mesh))


def shard_optimizer_state(osd: Dict[str, Any], module: torch.nn.Module,
                          mesh: Optional[Mesh]) -> Dict[str, Any]:
    """A whole optimizer state as this rank's blocks."""
    if mesh is None or mesh.model_shards == 1:
        return osd
    return _map_optimizer_state(osd, _optimizer_dims(module),
                                lambda v, d: shard_tensor(v, d, mesh))


def shard_model(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Parameter]:
    """Split ``module``'s transformer blocks over the model group in
    place: every parameter that :func:`param_partition_spec` selects
    becomes this rank's block, the attentions run ``heads / model_shards``
    heads, and the layers of ``models/layers.py`` take the group
    (Megatron's pair of collectives around each split block). Returns the
    split parameters (their norms span the model group)."""
    from ..models.layers import enable_tensor_parallel

    if mesh.model_shards == 1:
        return []
    split = []
    for name, p in list(module.named_parameters()):
        dim = param_partition_spec(name)
        if dim is None:
            continue
        owner = module.get_submodule(name.rsplit(".", 1)[0])
        leaf = name.rsplit(".", 1)[1]
        new = torch.nn.Parameter(shard_tensor(p.data, dim, mesh), requires_grad=p.requires_grad)
        setattr(owner, leaf, new)
        split.append(new)
    enable_tensor_parallel(module, mesh.model_group, mesh.model_shards)
    return split
