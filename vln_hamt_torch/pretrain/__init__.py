"""Proxy-task pretraining (torch), the port of ``vln_hamt_tpu/pretrain``:
the trajectory data and task batchers (numpy copies), the pretraining
model, the optimizer zoo and the trainer; end-to-end image pretraining
with the ViT in the loop (``image_model``, ``image_data``)."""

from .model import HAMTPretrain, expand_index_batch, init_pretrain
from .tasks import TASK_NAMES, PretrainBatcher
from .trainer import PretrainTrainer, TaskScheduler
from .trajectory_data import TrajectoryDataset, make_synthetic_trajectories

__all__ = [
    "HAMTPretrain",
    "expand_index_batch",
    "init_pretrain",
    "TrajectoryDataset",
    "make_synthetic_trajectories",
    "PretrainBatcher",
    "TASK_NAMES",
    "PretrainTrainer",
    "TaskScheduler",
]
