"""The port's multi-rank layer (``vln_hamt_torch/parallel/mesh.py``)
against the JAX package's mesh: which parameters tensor parallelism
splits, which batch rows a rank owns, and the host collectives across
processes. Also the helpers of tests/test_torch_parallel_*.py, which run
tests/torch_parallel_harness.py as rank processes (gloo on the CPU,
under a timeout) against one undistributed process."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_parallel_harness as harness
from test_torch_train import _fast_init_hamt_params
from torch_parallel_harness import TINY_MODEL
from vln_hamt_tpu.configs import ModelConfig as JaxModelConfig
from vln_hamt_tpu.parallel import mesh as jax_mesh
from vln_hamt_torch.configs import ModelConfig
from vln_hamt_torch.models.convert import params_from_flax
from vln_hamt_torch.parallel.mesh import Mesh, make_mesh, param_partition_spec, process_feed_rows
from vln_hamt_torch.run import finetune

#: seconds a rank may take (each spawn of the tests below)
RANK_TIMEOUT = 120


def run_ranks(tmp_path, tag: str, ranks: int, *argv, timeout: float = RANK_TIMEOUT) -> dict:
    """The harness over the tiny model on the CPU: ``ranks`` rank
    processes (gloo), or with 0 this process undistributed; its result."""
    out = tmp_path / f"{tag}.json"
    args = ["--cpu", "--tiny", *argv, "--out", str(out)]
    if ranks:
        harness.spawn(args, ranks, timeout)
    else:
        threads = torch.get_num_threads()
        try:
            harness.main(args)
        finally:
            torch.set_num_threads(threads)
    return json.loads(out.read_text())


def assert_losses_close(got: dict, want: dict, rtol: float = 2e-5, atol: float = 1e-6):
    """Every update's loss and parts (the same steps) within tolerance."""
    assert [s for s, _ in got["losses"]] == [s for s, _ in want["losses"]]
    for (step, g), (_, w) in zip(got["losses"], want["losses"]):
        assert g.keys() == w.keys(), step
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=f"{step} {k}")


def assert_npz_close(got_path, want_path, rtol: float = 1e-5, atol: float = 1e-6):
    """Each tensor within ``rtol`` of its own largest entry plus ``atol``
    (gradients that are zero in exact arithmetic are rounding noise)."""
    got, want = np.load(got_path), np.load(want_path)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        scale = np.abs(want[k]).max()
        err = np.abs(got[k] - want[k]).max()
        assert err <= rtol * scale + atol, (k, err, scale)


# ------------------------------------------------- tensor-parallel rules
def _marked_flax(params):
    """The flax tree with each leaf set to 1 where the JAX rules split its
    output features (P(None, 'model')), 2 where they split its input
    features (P('model', None)), else 0."""
    mark = {P(None, "model"): 1.0, P("model", None): 2.0}

    def leaf(path, v):
        spec = jax_mesh.param_partition_spec(jax_mesh._flatten_path(path), v)
        return np.full(np.shape(v), mark.get(spec, 0.0), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.mark.parametrize("no_lang_ca", [False, True], ids=["r2r", "no_lang_ca"])
def test_partition_spec_selects_the_jax_rules(no_lang_ca):
    """param_partition_spec over the port's names splits exactly the
    weights that the JAX rules split in the flax tree (mapped through
    params_from_flax), along the same features (torch's (out, in) is the
    flax kernel's transpose); beyond them only the column-parallel
    layers' biases, which JAX keeps whole."""
    sizes = dict(TINY_MODEL, no_lang_ca=no_lang_ca)
    _, _, params, _ = _fast_init_hamt_params(JaxModelConfig(**sizes), jax.random.PRNGKey(0))
    marked = params_from_flax(_marked_flax(params), ModelConfig(**sizes))
    want = {k: {1.0: 0, 2.0: 1}.get(float(v.max())) for k, v in marked.items()}
    got = {k: param_partition_spec(k) for k in marked}
    weights = [k for k in marked if k.endswith(".weight")]
    assert {k: got[k] for k in weights} == {k: want[k] for k in weights}
    # per text or panorama layer q, k, v, output, ffn in and out; per
    # cross-modal layer three attentions' four and two ffns' two
    assert sum(v is not None for v in want.values()) == 6 * 2 + (3 * 4 + 2 * 2) * 2 + 6 * 1
    biases = {k for k in marked if k.endswith(".bias") and got[k] is not None}
    assert biases == {k[:-len("weight")] + "bias" for k in weights if got[k] == 0}
    assert all(got[k] == 0 for k in biases)


def test_vit_stays_replicated():
    """No ViT parameter of the image pretraining model is split (flax's
    attention kernels are 3-D and the MLP's names match no rule)."""
    from vln_hamt_torch.pretrain.image_model import init_image_pretrain
    from vln_hamt_torch.run import image_pretrain

    args = image_pretrain.parse_args(["--tiny", "--synthetic"])
    model = init_image_pretrain(*image_pretrain.model_configs(args), 0)
    names = list(model.state_dict())
    assert [k for k in names if k.startswith("vit.") and param_partition_spec(k)] == []
    assert any(param_partition_spec(k) is not None for k in names)


@pytest.mark.parametrize("num_data,num_model", [(2, 1), (1, 2), (2, 2)])
def test_feed_rows_match_jax(num_data, num_model):
    """Each rank's rows of a global batch of 8 are the JAX package's rows
    for the process holding that rank's device of the (data, model) mesh."""
    jmesh = jax_mesh.make_mesh(num_data, num_model, devices=jax.devices()[:num_data * num_model])
    index_map = NamedSharding(jmesh, P("data")).devices_indices_map((8,))
    for d in range(num_data):
        for m in range(num_model):
            start, stop, _ = index_map[jmesh.devices[d, m]][0].indices(8)
            mesh = Mesh(num_data, num_model, d, m)
            assert process_feed_rows(mesh, 8) == (start, stop)
    with pytest.raises(ValueError, match="not divisible"):
        process_feed_rows(Mesh(3, 1, 0, 0), 8)


# ------------------------------------------------------- host collectives
@pytest.mark.parametrize("ranks,model_shards", [(2, 1), (4, 2)], ids=["2x1", "2x2"])
def test_host_collectives_across_processes(tmp_path, ranks, model_shards):
    """host_allgather, reduce_dict_mean and is_default_process across rank
    processes, and each rank's mesh coordinates (model-minor, as the JAX
    grid) and feed rows."""
    res = run_ranks(tmp_path, "coll", ranks, "--collectives", "--model_shards",
                    str(model_shards), "--batch", "8")
    assert res["gathered"] == [{"rank": r} for r in range(ranks)]
    assert res["reduced"] == {"x": (ranks - 1) / 2, "y": 2.0}
    assert res["default"] == [True] + [False] * (ranks - 1)
    coords = [list(divmod(r, model_shards)) for r in range(ranks)]
    assert res["coords"] == coords
    per = 8 // (ranks // model_shards)
    assert res["rows"] == [[d * per, (d + 1) * per] for d, _ in coords]


def test_mesh_must_fill_the_world():
    """A mesh larger than the ranks raises, naming the launch."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        make_mesh(2, 1)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        finetune.main(["--synthetic", "--tiny", "--cpu", "--data_shards", "2",
                       "--model_shards", "2"])
    assert "WORLD_SIZE" not in os.environ
