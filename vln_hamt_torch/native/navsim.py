"""ctypes bindings for the port's copy of the native navsim library
(``navsim.cpp`` beside this file), the port of
``vln_hamt_tpu/native/navsim.py``.

The C++ core mirrors :class:`~vln_hamt_torch.data.nav_graph.NavGraph`
(the dense all-pairs tables, by Floyd–Warshall) and the render-off
simulator's per-slot episode state, and adds the equirectangular
panorama sampler that feature extraction and the image store use.

The library is built with ``g++`` at first use into
``vln_hamt_torch/build/`` under a name keyed by the machine type and a
hash of the source and flags, written to a temporary file and renamed
into place, so several processes may build at once and a build carried
to another host is never loaded there. The flags leave out
``-march=native``: the library runs on any CPU of its machine type. A
failed build raises; nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "navsim.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
NUM_VIEWS = 36


def build_library() -> str:
    """Compile ``navsim.cpp`` unless a build of this source, these flags
    and this machine type exists; returns the shared library's path.
    Raises RuntimeError when ``g++`` is missing or fails."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"navsim_{platform.machine()}_{digest}.so"
    if lib.exists():
        return str(lib)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native navsim library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {SOURCE.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builds agree on one file
    return str(lib)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library with every entry point's signature declared."""
    lib = ctypes.CDLL(build_library())
    c = ctypes
    lib.navsim_graph_create.restype = c.c_void_p
    lib.navsim_graph_create.argtypes = [c.c_int, c.c_void_p, c.c_void_p]
    lib.navsim_graph_destroy.restype = None
    lib.navsim_graph_destroy.argtypes = [c.c_void_p]
    lib.navsim_graph_max_degree.restype = c.c_int
    lib.navsim_graph_max_degree.argtypes = [c.c_void_p]
    for fn in (lib.navsim_graph_dist, lib.navsim_graph_next_hop):
        fn.restype = None
        fn.argtypes = [c.c_void_p, c.c_void_p]
    lib.navsim_graph_neighbors.restype = None
    lib.navsim_graph_neighbors.argtypes = [c.c_void_p] * 5
    lib.navsim_batch_create.restype = c.c_void_p
    lib.navsim_batch_create.argtypes = [c.c_int]
    lib.navsim_batch_destroy.restype = None
    lib.navsim_batch_destroy.argtypes = [c.c_void_p]
    lib.navsim_new_episode.restype = None
    lib.navsim_new_episode.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_int,
                                       c.c_double, c.c_double]
    lib.navsim_move.restype = c.c_int
    lib.navsim_move.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_int]
    lib.navsim_state.restype = None
    lib.navsim_state.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_void_p]
    lib.navsim_sample_view.restype = None
    lib.navsim_sample_view.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_double, c.c_double,
                                       c.c_double, c.c_int, c.c_int, c.c_void_p]
    lib.navsim_sample_panorama.restype = None
    lib.navsim_sample_panorama.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_double, c.c_int,
                                           c.c_int, c.c_void_p]
    return lib


def native_available() -> bool:
    """Whether the library builds and loads on this machine."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeNavGraph:
    """Native twin of NavGraph: the same dense tables, built in C++.

    ``dist`` (V, V) float32, ``next_hop`` (V, V) int32, ``max_degree``
    and the (V, max_degree) neighbor tables ``nbr_index``,
    ``nbr_heading``, ``nbr_elevation``, ``nbr_point_id`` (index and
    point id -1 past a node's degree)."""

    def __init__(self, positions: np.ndarray, adjacency: np.ndarray):
        lib = load_library()
        self._lib = lib
        self._pos = np.ascontiguousarray(positions, dtype=np.float64)
        self._adj = np.ascontiguousarray(adjacency, dtype=np.uint8)
        n = self._pos.shape[0]
        if self._pos.shape != (n, 3) or self._adj.shape != (n, n):
            raise ValueError(f"positions {self._pos.shape} and adjacency {self._adj.shape} "
                             "must be (V, 3) and (V, V)")
        self.num_nodes = n
        self._h = lib.navsim_graph_create(n, _ptr(self._pos), _ptr(self._adj))
        self.max_degree = lib.navsim_graph_max_degree(self._h)
        self.dist = np.empty((n, n), np.float32)
        lib.navsim_graph_dist(self._h, _ptr(self.dist))
        self.next_hop = np.empty((n, n), np.int32)
        lib.navsim_graph_next_hop(self._h, _ptr(self.next_hop))
        d = self.max_degree
        self.nbr_index = np.empty((n, d), np.int32)
        self.nbr_heading = np.empty((n, d), np.float32)
        self.nbr_elevation = np.empty((n, d), np.float32)
        self.nbr_point_id = np.empty((n, d), np.int32)
        if d > 0:
            lib.navsim_graph_neighbors(self._h, _ptr(self.nbr_index), _ptr(self.nbr_heading),
                                       _ptr(self.nbr_elevation), _ptr(self.nbr_point_id))

    @property
    def handle(self):
        return self._h

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.navsim_graph_destroy(self._h)
            self._h = None


class NativeSimBatch:
    """Native twin of the simulator's per-slot episode state: each slot
    holds a graph, a node and a view index. The graphs of its episodes
    are kept alive with it."""

    def __init__(self, batch_size: int):
        self._lib = load_library()
        self.batch_size = batch_size
        self._graphs = [None] * batch_size
        self._h = self._lib.navsim_batch_create(batch_size)

    def _slot(self, slot: int) -> NativeNavGraph:
        if not 0 <= slot < self.batch_size:
            raise IndexError(f"slot {slot} outside a batch of {self.batch_size}")
        return self._graphs[slot]

    def new_episode(self, slot: int, graph: NativeNavGraph, node: int,
                    heading: float, elevation: float = 0.0) -> None:
        self._slot(slot)
        if not 0 <= node < graph.num_nodes:
            raise IndexError(f"node {node} outside a graph of {graph.num_nodes}")
        self._graphs[slot] = graph
        self._lib.navsim_new_episode(self._h, slot, graph.handle, node, heading, elevation)

    def move(self, slot: int, target_node: int, target_view: int) -> None:
        """Step slot ``slot`` to an adjacent node facing ``target_view``;
        raises ValueError on a node that is not adjacent."""
        graph = self._slot(slot)
        if graph is None:
            raise RuntimeError(f"slot {slot} has no episode")
        if not 0 <= target_node < graph.num_nodes:
            raise IndexError(f"node {target_node} outside a graph of {graph.num_nodes}")
        if self._lib.navsim_move(self._h, slot, target_node, target_view) != 0:
            raise ValueError(f"slot {slot}: target {target_node} not adjacent")

    def state(self, slot: int):
        """(node, view index) of slot ``slot``."""
        self._slot(slot)
        node, view = ctypes.c_int32(), ctypes.c_int32()
        self._lib.navsim_state(self._h, slot, ctypes.byref(node), ctypes.byref(view))
        return int(node.value), int(view.value)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.navsim_batch_destroy(self._h)
            self._h = None


def sample_panorama(equirect: np.ndarray, vfov: float = np.pi / 3,
                    width: int = 640, height: int = 480) -> np.ndarray:
    """(eq_h, eq_w, 3) uint8 equirect -> (36, height, width, 3) uint8
    views (12 headings x 3 elevations, view index = elevation level * 12
    + heading index), bilinear with horizontal wrap."""
    lib = load_library()
    eq = np.ascontiguousarray(equirect, dtype=np.uint8)
    if eq.ndim != 3 or eq.shape[2] != 3:
        raise ValueError(f"equirect must be (H, W, 3), got {eq.shape}")
    out = np.empty((NUM_VIEWS, height, width, 3), np.uint8)
    lib.navsim_sample_panorama(_ptr(eq), eq.shape[1], eq.shape[0], float(vfov), width, height,
                               _ptr(out))
    return out
