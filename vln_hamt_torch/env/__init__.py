from .sim import GraphSimulator, SimState
from .observation import ObsBatch, EpisodeBatch, ObsSpec, make_obs_batch
from .r2r_env import R2RNavEnv
from .task_envs import CVDNNavEnv, R2RBackNavEnv, ReverieNavEnv

__all__ = [
    "GraphSimulator",
    "SimState",
    "ObsBatch",
    "EpisodeBatch",
    "ObsSpec",
    "make_obs_batch",
    "R2RNavEnv",
    "R2RBackNavEnv",
    "ReverieNavEnv",
    "CVDNNavEnv",
]
