"""Batched render-off navigation simulator.

Replacement for the external MatterSim C++ library in its
render-off configuration, which is what every training/eval path in the
reference uses (``setRenderingEnabled(False)``, ``finetune_src/r2r/
env.py:44``). In that mode MatterSim is a graph walker + discretized
36-view camera state machine; the reference additionally *emulates*
egocentric rotation with per-sample while-loops of ``makeAction`` calls
(``agent_cmt.py:213-246``) purely to reach the target pose — rendering
is off, so only the final pose is observable. We therefore implement the
direct transition: ``move(slot, candidate)`` jumps to the neighbor and
sets the view index to the candidate's representative view, which is
exactly the pose MatterSim ends in after the emulated rotation+forward
sequence.

Pose conventions (MatterSim):
- ``viewIndex = elevation_level * 12 + heading_index``; [0-11] looking
  down, [12-23] horizon, [24-35] up (env.py:60-62).
- With discretized viewing angles the initial heading snaps to the
  nearest 30-degree increment, elevation starts at the horizon.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.angle import DEG30, NUM_HEADINGS, view_elevation, view_heading
from ..data.nav_graph import NavGraph


@dataclasses.dataclass
class SimState:
    """Pose of one batch slot (mirrors the MatterSim state surface)."""

    scan: str
    node: int  # node index in the scan's NavGraph
    view_index: int  # 0..35

    @property
    def heading(self) -> float:
        return float(view_heading(self.view_index))

    @property
    def elevation(self) -> float:
        return float(view_elevation(self.view_index))


def snap_heading_to_view(heading: float, elevation: float = 0.0) -> int:
    """Initial discretized view from a continuous start heading."""
    h_idx = int(np.round(heading / DEG30)) % NUM_HEADINGS
    e_idx = int(np.clip(np.round(elevation / DEG30), -1, 1)) + 1
    return e_idx * NUM_HEADINGS + h_idx


class GraphSimulator:
    """A batch of graph-walker episodes over preloaded NavGraphs.

    One instance serves the whole batch (the reference builds one C++
    Simulator object per slot, ``env.py:38-49``; here state is just three
    small arrays).
    """

    def __init__(self, graphs: Dict[str, NavGraph], batch_size: int):
        self.graphs = graphs
        self.batch_size = batch_size
        self._scan: List[Optional[str]] = [None] * batch_size
        self.node = np.zeros(batch_size, dtype=np.int32)
        self.view_index = np.zeros(batch_size, dtype=np.int32)

    def graph(self, slot: int) -> NavGraph:
        scan = self._scan[slot]
        assert scan is not None, f"slot {slot} has no active episode"
        return self.graphs[scan]

    # ------------------------------------------------------------------
    def new_episodes(
        self,
        scans: Sequence[str],
        viewpoints: Sequence[str],
        headings: Sequence[float],
        elevations: Optional[Sequence[float]] = None,
    ) -> None:
        """Parity with EnvBatch.newEpisodes (env.py:54-56); elevation 0."""
        n = len(scans)
        assert n <= self.batch_size
        if elevations is None:
            elevations = [0.0] * n
        for i, (scan, vp, h, e) in enumerate(zip(scans, viewpoints, headings, elevations)):
            g = self.graphs[scan]
            self._scan[i] = scan
            self.node[i] = g.index(vp)
            self.view_index[i] = snap_heading_to_view(h, e)

    def new_episode_at(self, slot: int, scan: str, viewpoint: str,
                       heading: float, elevation: float = 0.0) -> None:
        """Replace a single slot's episode (continuation packing)."""
        g = self.graphs[scan]
        self._scan[slot] = scan
        self.node[slot] = g.index(viewpoint)
        self.view_index[slot] = snap_heading_to_view(heading, elevation)

    def move(self, slot: int, target_node: int, target_view: int) -> None:
        """Direct transition to a neighboring node + representative view.

        Equivalent final pose to the reference's make_equiv_action
        rotation emulation followed by makeAction(idx) (agent_cmt.py:
        213-246): after rotating to the candidate's pointId and stepping
        forward, heading/elevation (hence viewIndex) are unchanged by the
        move itself.
        """
        g = self.graph(slot)
        assert g.adj[self.node[slot], target_node], (
            f"slot {slot}: {target_node} is not adjacent to {self.node[slot]}"
        )
        self.node[slot] = target_node
        self.view_index[slot] = target_view

    def get_state(self, slot: int) -> SimState:
        return SimState(
            scan=self._scan[slot],
            node=int(self.node[slot]),
            view_index=int(self.view_index[slot]),
        )

    def get_states(self) -> List[SimState]:
        return [self.get_state(i) for i in range(self.batch_size)
                if self._scan[i] is not None]
