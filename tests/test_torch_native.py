"""The port's native navsim library against the JAX package's: the same
C++ source, built by the port with g++ into ``vln_hamt_torch/build/``
(no ``-march=native``), gives bit-equal tables and byte-equal panorama
views; the tables equal the numpy ``NavGraph``'s up to ``next_hop``
ties; the per-slot simulator moves and refuses non-adjacent targets; and
the connectivity loaders build the native tables by default, as the JAX
package's do."""

import os

import numpy as np
import pytest

from vln_hamt_tpu.data.fixtures import make_synthetic_graph
from vln_hamt_tpu.data.fixtures import make_synthetic_world as jax_world
from vln_hamt_tpu.data.nav_graph import load_nav_graphs as jax_load_nav_graphs
from vln_hamt_tpu.native import NativeNavGraph as JaxNativeNavGraph
from vln_hamt_tpu.native import sample_panorama as jax_sample_panorama
from vln_hamt_torch.data.fixtures import export_nav_and_annotations, make_synthetic_world
from vln_hamt_torch.data.nav_graph import NavGraph, load_nav_graph, load_nav_graphs
from vln_hamt_torch.native import (NativeNavGraph, NativeSimBatch, build_library,
                                   native_available, sample_panorama)
from vln_hamt_torch.native import navsim

TABLES = ("dist", "next_hop", "nbr_index", "nbr_heading", "nbr_elevation", "nbr_point_id")


def test_library_builds_into_the_port_and_never_loads_the_jax_build():
    path = build_library()
    assert native_available()
    assert os.path.dirname(path) == str(navsim.BUILD_DIR)
    assert os.path.basename(path).startswith("navsim_")
    assert navsim.load_library()._name == path  # the loaded library is the port's build
    assert "-march=native" not in navsim.CXX_FLAGS
    assert build_library() == path  # keyed by source and flags: built once


@pytest.mark.parametrize("nodes", [12, 30, 57])
def test_native_tables_bit_equal_to_jax(nodes):
    g = make_synthetic_graph(f"native{nodes}", nodes)
    got, want = NativeNavGraph(g.positions, g.adj), JaxNativeNavGraph(g.positions, g.adj)
    assert got.max_degree == want.max_degree
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def test_native_tables_match_numpy_navgraph():
    """Distances and neighbour tables equal the numpy path's; next_hop
    may break ties between equal shortest paths otherwise, so each
    successor walk is checked to reach its goal over the numpy distance."""
    g = make_synthetic_world(num_scans=1, nodes_per_scan=30, seed=5).graphs
    g = next(iter(g.values()))
    ng = NativeNavGraph(g.positions, g.adj)
    np.testing.assert_allclose(ng.dist, g.dist, rtol=1e-6)
    for src in range(g.num_nodes):
        for dst in range(0, g.num_nodes, 3):
            cur, total = src, 0.0
            for _ in range(g.num_nodes):
                if cur == dst:
                    break
                nxt = int(ng.next_hop[cur, dst])
                assert g.adj[cur, nxt]
                total += float(g.dist[cur, nxt])
                cur = nxt
            assert cur == dst
            assert total == pytest.approx(float(g.dist[src, dst]), rel=1e-5)
    assert ng.max_degree == g.max_degree
    for name in ("nbr_index", "nbr_point_id"):
        np.testing.assert_array_equal(getattr(ng, name), getattr(g, name), err_msg=name)
    for name in ("nbr_heading", "nbr_elevation"):
        np.testing.assert_allclose(getattr(ng, name), getattr(g, name), atol=1e-6, err_msg=name)


def test_navgraph_use_native_takes_the_native_tables():
    g = make_synthetic_graph("native_ng", 20)
    ours = NavGraph("s", g.node_ids, g.positions, g.adj, use_native=True)
    ng = NativeNavGraph(g.positions, g.adj)
    for name in TABLES:
        np.testing.assert_array_equal(getattr(ours, name), getattr(ng, name), err_msg=name)
    np.testing.assert_array_equal(ours.nbr_mask, ng.nbr_index >= 0)


def test_native_sim_batch_moves_and_refuses_non_adjacent_targets():
    g = make_synthetic_graph("native_sim", 16)
    ng = NativeNavGraph(g.positions, g.adj)
    sim = NativeSimBatch(2)
    sim.new_episode(0, ng, 0, 0.0)
    sim.new_episode(1, ng, 3, np.pi / 2, np.pi / 6)
    assert sim.state(0) == (0, 12)  # heading 0, horizon
    assert sim.state(1) == (3, 27)  # heading 90 degrees, looking up
    nbr, pid = int(g.nbr_index[0, 0]), int(g.nbr_point_id[0, 0])
    sim.move(0, nbr, pid)
    assert sim.state(0) == (nbr, pid)
    far = next(i for i in range(g.num_nodes) if i != nbr and not g.adj[nbr, i])
    with pytest.raises(ValueError, match="not adjacent"):
        sim.move(0, far, 0)
    assert sim.state(0) == (nbr, pid)
    with pytest.raises(IndexError):
        sim.move(2, nbr, 0)
    with pytest.raises(IndexError):
        sim.move(0, g.num_nodes, 0)


@pytest.mark.parametrize("shape,size", [((64, 128), (32, 24)), ((96, 192), (64, 48)),
                                        ((240, 480), (640, 480))])
def test_sample_panorama_byte_equal_to_jax(shape, size):
    eq = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    got = sample_panorama(eq, np.pi / 3, *size)
    want = jax_sample_panorama(eq, np.pi / 3, *size)
    assert got.shape == (36, size[1], size[0], 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_sample_panorama_direction_bands():
    """North (heading 0) red lands in view 12, east green in view 15, the
    sky's blue in the upper views (tests/test_native.py's geometry)."""
    eq_h, eq_w = 64, 128
    eq = np.full((eq_h, eq_w, 3), 10, np.uint8)
    eq[: eq_h // 4, :, 2] = 255
    eq[eq_h // 3: 2 * eq_h // 3, eq_w // 2 - 4: eq_w // 2 + 4, 0] = 255
    eq[eq_h // 3: 2 * eq_h // 3, 3 * eq_w // 4 - 4: 3 * eq_w // 4 + 4, 1] = 255
    views = sample_panorama(eq, vfov=np.pi / 3, width=32, height=24)
    assert views[12, 10:14, 14:18, 0].mean() > 150
    assert views[15, 10:14, 14:18, 1].mean() > 150
    assert views[24:, :, :, 2].mean() > views[12:24, :, :, 2].mean()


def test_load_nav_graphs_native_by_default_equal_to_jax(tmp_path):
    """The connectivity loaders build the native tables by default (the JAX
    package's default): bit-equal to the JAX loader's, node ids too."""
    kw = dict(num_scans=2, nodes_per_scan=18, num_items=4, seed=7)
    files = export_nav_and_annotations(make_synthetic_world(**kw), str(tmp_path))
    scans = sorted(jax_world(**kw).graphs)
    got = load_nav_graphs(files["connectivity_dir"], scans)
    want = jax_load_nav_graphs(files["connectivity_dir"], scans)
    for scan in scans:
        assert got[scan].node_ids == want[scan].node_ids
        for name in TABLES + ("nbr_mask", "adj", "positions"):
            np.testing.assert_array_equal(getattr(got[scan], name), getattr(want[scan], name),
                                          err_msg=f"{scan} {name}")
    one = load_nav_graph(files["connectivity_dir"], scans[0])
    np.testing.assert_array_equal(one.next_hop, got[scans[0]].next_hop)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A build that fails raises; nothing falls back to numpy."""
    bad = tmp_path / "navsim.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(navsim, "SOURCE", bad)
    monkeypatch.setattr(navsim, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        navsim.build_library()
    assert not any((tmp_path / "build").glob("*.so"))
