from .sim import GraphSimulator, SimState
from .observation import ObsBatch, EpisodeBatch, ObsSpec, make_obs_batch
from .r2r_env import R2RNavEnv

__all__ = [
    "GraphSimulator",
    "SimState",
    "ObsBatch",
    "EpisodeBatch",
    "ObsSpec",
    "make_obs_batch",
    "R2RNavEnv",
]
