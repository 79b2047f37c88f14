"""Closed-form angle geometry for the discretized 36-view panorama.

The reference derives view angles by stepping a throwaway MatterSim
instance through all 36 views (``finetune_src/r2r/data_utils.py:139-167``).
Views form a 12x3 grid: ``viewIndex = elevation_level * 12 + heading_index``
with headings at 30 degree increments clockwise from north and elevation
levels {-30, 0, +30} degrees ([0-11] down, [12-23] horizon, [24-35] up;
``finetune_src/r2r/env.py:60-62``). All of that is pure trigonometry, so
we compute it directly and vectorized.

Conventions (Matterport3D / MatterSim):
- heading 0 points along +Y, increasing clockwise towards +X:
  ``heading = atan2(dx, dy)``.
- elevation measured from the horizontal plane: ``atan2(dz, hypot(dx, dy))``.
"""

from __future__ import annotations

import numpy as np

DEG30 = np.pi / 6.0
NUM_HEADINGS = 12
NUM_ELEVATIONS = 3
NUM_VIEWS = NUM_HEADINGS * NUM_ELEVATIONS


def view_heading(view_index):
    """Absolute heading of a view center (radians)."""
    return (np.asarray(view_index) % NUM_HEADINGS) * DEG30


def view_elevation(view_index):
    """Absolute elevation of a view center (radians)."""
    return (np.asarray(view_index) // NUM_HEADINGS - 1) * DEG30


def closest_view_index(heading, elevation):
    """Discretize a direction to the nearest of the 36 views.

    Equivalent to the reference's closest-view dedup rule
    (``finetune_src/r2r/env.py:207-228``): MatterSim reports a navigable
    location from every view that sees it, and the representation view is
    the one minimizing sqrt(rel_heading^2 + rel_elevation^2). On the
    12x3 grid that minimum factorizes into independently snapping heading
    to the nearest 30-degree multiple and elevation to the nearest level
    in {-1, 0, +1}.
    """
    heading = np.asarray(heading, dtype=np.float64)
    elevation = np.asarray(elevation, dtype=np.float64)
    h_idx = np.round(heading / DEG30).astype(np.int64) % NUM_HEADINGS
    e_idx = np.clip(np.round(elevation / DEG30), -1, 1).astype(np.int64) + 1
    return e_idx * NUM_HEADINGS + h_idx


def angle_features(heading, elevation, angle_feat_size: int = 4) -> np.ndarray:
    """Vectorized [sin h, cos h, sin e, cos e] features.

    Parity with ``finetune_src/r2r/data_utils.py:114-117``; broadcasting
    over any leading shape, output ``(*shape, angle_feat_size)``.
    """
    heading = np.asarray(heading, dtype=np.float32)
    elevation = np.asarray(elevation, dtype=np.float32)
    base = np.stack(
        [np.sin(heading), np.cos(heading), np.sin(elevation), np.cos(elevation)],
        axis=-1,
    )
    reps = angle_feat_size // 4
    if reps > 1:
        base = np.tile(base, (1,) * (base.ndim - 1) + (reps,))
    return base.astype(np.float32)


def angle_feature(heading: float, elevation: float, angle_feat_size: int = 4) -> np.ndarray:
    """Scalar convenience wrapper (reference signature)."""
    return angle_features(heading, elevation, angle_feat_size)


def all_point_angle_feature(
    angle_feat_size: int = 4, minus_elevation: bool = False
) -> np.ndarray:
    """(36, 36, angle_feat_size) table of per-view angle features.

    ``table[baseViewId, ix]`` is the angle feature of view ``ix`` relative
    to the heading of ``baseViewId`` (and its elevation when
    ``minus_elevation``), replacing the simulator-stepping construction in
    ``finetune_src/r2r/data_utils.py:139-167`` with closed form.
    """
    views = np.arange(NUM_VIEWS)
    abs_h = view_heading(views)  # (36,)
    abs_e = view_elevation(views)
    base_h = view_heading(views)[:, None]  # (36, 1)
    if minus_elevation:
        base_e = view_elevation(views)[:, None]
    else:
        base_e = 0.0
    rel_h = abs_h[None, :] - base_h  # (36, 36)
    rel_e = np.broadcast_to(abs_e[None, :] - base_e, rel_h.shape)
    return angle_features(rel_h, rel_e, angle_feat_size)
