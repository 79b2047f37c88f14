"""End-to-end image pretraining in the port against the JAX package's
``HAMTImagePretrain`` on the same weights (converted from seeded flax
params) and the same batches: every task's loss and metrics within 2e-4,
every gradient at ``tests/test_torch_pretrain.py``'s tolerances; no
gradient reaches the ViT through the history; MRC's masking after the
ViT, ``ob_v_exists`` and the STOP row; the image batcher's arrays equal
to the JAX batcher's over one store; the attention launches of each
task's update (``run/profile_attention.py:image_pretrain_launch_mix``,
counted through the plain twins); the synthetic store the same in two
processes; and the CLI at its tiny size on the CPU (``metrics.jsonl``,
``model_step_N.pt``, ``--resume``, ``--init_ckpt``). Tiny sizes, dropout
off for the comparisons, one thread."""

import collections
import functools
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_hamt_tpu.configs import ModelConfig as JaxModelConfig
from vln_hamt_tpu.pretrain.image_data import ImagePretrainBatcher as JaxImageBatcher
from vln_hamt_tpu.pretrain.image_model import HAMTImagePretrain as JaxHAMTImagePretrain
from vln_hamt_tpu.pretrain.image_model import init_image_pretrain_params
from vln_hamt_tpu.pretrain.trajectory_data import TrajectoryDataset as JaxTrajectoryDataset
from vln_hamt_tpu.vision.transforms import ImageTransform as JaxImageTransform
from vln_hamt_tpu.vision.vit import ViTConfig as JaxViTConfig
from vln_hamt_torch.configs import ModelConfig
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.models.convert import image_pretrain_params_from_flax
from vln_hamt_torch.ops import attention as tops
from vln_hamt_torch.pretrain import TASK_NAMES, TrajectoryDataset, make_synthetic_trajectories
from vln_hamt_torch.pretrain.image_data import ImagePretrainBatcher, SyntheticPanoImageStore
from vln_hamt_torch.pretrain.image_model import HAMTImagePretrain, init_image_pretrain
from vln_hamt_torch.pretrain.model import HAMTPretrain, batch_to_device
from vln_hamt_torch.run import image_pretrain
from vln_hamt_torch.run.profile_attention import image_pretrain_launch_mix
from vln_hamt_torch.vision.transforms import ImageTransform
from vln_hamt_torch.vision.vit import ViTConfig

WORLD = dict(num_scans=1, nodes_per_scan=10, num_items=8, feat_dim=48 + 16, seed=3)
HIST, TXT, BATCH = 3, 16, 2
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
              "feat_dropout": 0.0, "pred_head_dropout_prob": 0.0}
TINY = dict(hidden_size=64, num_attention_heads=4, intermediate_size=128, num_l_layers=2,
            num_x_layers=2, num_h_pano_layers=1, image_feat_size=48, image_prob_size=16,
            max_position_embeddings=64, max_action_steps=16)
VIT = dict(img_size=(32, 32), patch_size=16, hidden_size=48, num_layers=2, num_heads=4,
           num_classes=16)
LOSS_ATOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # tests/test_torch_pretrain.py's


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def jax_model():
    """The JAX HAMTImagePretrain and its params (init under jit)."""
    jcfg, jvit = JaxModelConfig(**TINY, **NO_DROPOUT), JaxViTConfig(**VIT)
    params = jax.jit(lambda r: init_image_pretrain_params(
        jcfg, jvit, r, max_hist_len=HIST, instr_len=TXT)[1])(jax.random.PRNGKey(0))
    return JaxHAMTImagePretrain(jcfg, jvit), jax.tree.map(np.asarray, params)


def port_model(params=None, dropout=False):
    cfg = ModelConfig(**TINY, **({} if dropout else NO_DROPOUT))
    model = init_image_pretrain(cfg, ViTConfig(**VIT), seed=0)
    if params is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               image_pretrain_params_from_flax(params, cfg).items()}, strict=True)
    return cfg, model


def _dataset(pkg_ds=TrajectoryDataset):
    w = make_synthetic_world(**WORLD)
    return pkg_ds(make_synthetic_trajectories(w), w.graphs, w.feat_db, image_feat_size=48,
                  image_prob_size=16, max_txt_len=TXT, max_hist_len=HIST)


@pytest.fixture(scope="module")
def batcher():
    return ImagePretrainBatcher(_dataset(), SyntheticPanoImageStore((32, 32)), seed=1,
                                vocab_mask_range=(1000, 2000))


def _grads(model):
    return {k: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
            for k, p in model.named_parameters()}


@pytest.mark.parametrize("task", TASK_NAMES)
def test_task_loss_and_gradients_match_jax(batcher, task):
    """Loss, metrics and every parameter's gradient against
    jax.value_and_grad of the JAX model on the same batch."""
    jmodel, params = jax_model()
    cfg, model = port_model(params)
    batch = batcher.batch(task, BATCH)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.apply({"params": p}, b, task, deterministic=True),
        has_aux=True))(params, {k: jnp.asarray(v) for k, v in batch.items()})
    model.train()
    loss, aux = model(batch_to_device(batch, "cpu"), task)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=LOSS_ATOL)
    assert aux.keys() == jaux.keys()
    for k in jaux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=0,
                                   atol=LOSS_ATOL,
                                   err_msg=k)
    want = image_pretrain_params_from_flax(jax.tree.map(np.asarray, jgrads), cfg)
    got = _grads(model)
    assert got.keys() == want.keys()
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
                                   err_msg=k)
    vit_grads = [p.grad for n, p in model.named_parameters() if n.startswith("vit.")]
    if task in ("sap", "sar", "sprel"):  # the observation trains the ViT
        assert all(g is not None for g in vit_grads)
        # unless the random visual kill zeroed every example's views
        assert (sum(float(g.abs().sum()) for g in vit_grads) > 0) == bool(
            batch["ob_v_exists"].any())
    else:  # the history alone: no graph through the ViT at all
        assert all(g is None for g in vit_grads)
        assert all(not np.asarray(x).any() for x in jax.tree.leaves(jgrads["vit"]))


def test_history_takes_no_gradient_and_mrc_masks_after_the_vit(batcher, monkeypatch):
    """What the trunk receives: MRC-masked steps' features zero (the
    per-step view and the whole panorama), the others the ViT's features
    of the faced view, with no graph behind them; the observation's 36
    views with their graph, zeroed by ob_v_exists, and a zero STOP row."""
    _, model = port_model()
    seen = {}

    def spy(self, batch, task, feat_table=None, rows=None):
        seen.update(batch)
        return torch.zeros(()), {}

    monkeypatch.setattr(HAMTPretrain, "forward", spy)
    b = batcher.batch("mrc", BATCH)
    model(batch_to_device(b, "cpu"), "mrc")
    m = torch.from_numpy(b["hist_mrc_masks"])
    assert m.any() and (~m).any()
    assert not seen["hist_img"].requires_grad and not seen["hist_pano_img"].requires_grad
    assert (seen["hist_img"][m] == 0).all() and (seen["hist_pano_img"][m] == 0).all()
    with torch.no_grad():
        feats = model._encode_views(torch.from_numpy(b["hist_pano_images"]), False)
    idx = torch.from_numpy(b["hist_viewindex"]).long()
    faced = feats.gather(2, idx[:, :, None, None].expand(-1, -1, 1, 48))[:, :, 0]
    torch.testing.assert_close(seen["hist_img"][~m], faced[~m], rtol=0, atol=0)
    torch.testing.assert_close(seen["hist_pano_img"][~m], feats[~m], rtol=0, atol=0)
    assert "hist_pano_images" not in seen and "ob_images" not in seen

    seen.clear()
    b = batcher.batch("sap", BATCH)
    b["ob_v_exists"] = np.array([1.0, 0.0], np.float32)
    model(batch_to_device(b, "cpu"), "sap")
    ob = seen["ob_img"]
    assert ob.shape == (BATCH, 37, 48) and ob.requires_grad
    assert (ob[:, 36] == 0).all() and (ob[1] == 0).all() and (ob[0, :36] != 0).any()


def test_image_batcher_arrays_equal_jax(batcher):
    """The JAX batcher over the same store (the port's, seeded by crc32)
    and the same dataset draws the same batches, array for array, for
    every task; with the train transform too (its pixels within PIL's
    rounding of a few upsampled pixels)."""
    store = SyntheticPanoImageStore((32, 32))
    for transform in (None, "train"):
        ours = ImagePretrainBatcher(_dataset(), store, seed=4, vocab_mask_range=(1000, 2000),
                                    transform=transform and ImageTransform(out_size=24,
                                                                           train=True, seed=9))
        theirs = JaxImageBatcher(_dataset(JaxTrajectoryDataset), store, seed=4,
                                 vocab_mask_range=(1000, 2000),
                                 transform=transform and JaxImageTransform(out_size=24,
                                                                           train=True, seed=9))
        for task in TASK_NAMES:
            got, want = ours.batch(task, BATCH), theirs.batch(task, BATCH)
            assert got.keys() == want.keys(), task
            assert "hist_img" not in got and "ob_img" not in got
            assert ("ob_images" in got) == (task in ("sap", "sar", "sprel"))
            for k in want:
                g, w = np.asarray(got[k]), np.asarray(want[k])
                assert g.dtype == w.dtype and g.shape == w.shape, (task, k)
                if k.endswith("_images") and transform:
                    d = np.abs(g.astype(int) - w)
                    assert d.max() <= 2 and d.mean() <= 0.05, (task, k)
                else:
                    np.testing.assert_array_equal(g, w, err_msg=f"{task} {k}")
        side = 24 if transform else 32
        assert got["hist_pano_images"].shape == (BATCH, HIST, 36, side, side, 3)


@pytest.fixture
def counted(monkeypatch):
    """Calls of the plain attention forward and backward by (lanes, Lq, Lk)."""
    calls = {"fwd": collections.Counter(), "bwd": collections.Counter()}

    def counting(kind, fn):
        def wrapper(q, k, *args):
            calls[kind][(q.shape[0], q.shape[2], k.shape[2])] += 1
            return fn(q, k, *args)
        return wrapper

    monkeypatch.setattr(tops, "attention_reference", counting("fwd", tops.attention_reference))
    monkeypatch.setattr(tops, "attention_bwd_reference",
                        counting("bwd", tops.attention_bwd_reference))
    return calls


def test_launch_mix_counts_every_image_pretraining_attention(batcher, counted):
    """Each task's update with production dropout runs exactly
    image_pretrain_launch_mix's attentions: the trunk's, the history ViT's
    forward over B x T x 36 lanes, and for SAP, SAR and SpRel the
    observation ViT's forward and backward over B x 36."""
    cfg, model = port_model(dropout=True)
    from vln_hamt_torch.models.layers import DropoutRNG, set_dropout_rng

    set_dropout_rng(model, DropoutRNG("cpu", 0))
    model.train()
    for task in TASK_NAMES:
        loss, _ = model(batch_to_device(batcher.batch(task, BATCH), "cpu"), task)
        loss.backward()
        fwd, bwd = image_pretrain_launch_mix(cfg, ViTConfig(**VIT), task, BATCH, TXT, HIST)
        got = {k: +v for k, v in counted.items()}
        assert got == {"fwd": fwd, "bwd": bwd}, task
        n = 5  # 2 x 2 patches + cls
        assert fwd[(BATCH * HIST * 36, n, n)] == 2
        assert bwd[(BATCH * 36, n, n)] == (2 if task in ("sap", "sar", "sprel") else 0)
        for v in counted.values():
            v.clear()


def test_synthetic_store_is_the_same_in_two_processes():
    """crc32 seeding: another interpreter, with another str-hash salt,
    draws the same panorama."""
    code = ("import hashlib, sys; from vln_hamt_torch.pretrain.image_data import "
            "SyntheticPanoImageStore as S; "
            "print(hashlib.sha256(S((8, 12)).get('scanA', 'vp7').tobytes()).hexdigest())")
    import hashlib

    want = hashlib.sha256(SyntheticPanoImageStore((8, 12)).get("scanA", "vp7").tobytes())
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = set()
    for salt in ("1", "2"):
        env = {**os.environ, "PYTHONHASHSEED": salt, "PYTHONPATH": root}
        outs.add(subprocess.run([sys.executable, "-c", code], env=env, check=True,
                                capture_output=True, text=True).stdout.strip())
    assert outs == {want.hexdigest()}


def test_cli_tiny_synthetic_on_cpu(tmp_path):
    """The CLI at its tiny size: metrics.jsonl rows, model_step_N.pt files
    (the pretraining state dict plus vit.* and step), --resume continuing
    from the step, --init_ckpt starting from the weights."""
    out = str(tmp_path / "run")
    argv = ["--tiny", "--synthetic", "--cpu", "--num_steps", "4", "--valid_steps", "2",
            "--output_dir", out]
    res = image_pretrain.main(argv)
    assert res["final_step"] == 4 and res["checkpoint"].endswith("model_step_4.pt")
    # the run's config record, and the metrics' TensorBoard mirror where
    # tensorboardX imports (utils/logging.py:MetricsLogger)
    tb = ["tb"] if importlib.util.find_spec("tensorboardX") else []
    assert sorted(os.listdir(out)) == sorted(["metrics.jsonl", "model_step_2.pt",
                                              "model_step_4.pt", "training_config.json", *tb])
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert any("ex_per_sec" in r for r in rows)
    assert any(any(k.startswith("val_unseen/") for k in r) for r in rows)
    blob = torch.load(res["checkpoint"], weights_only=True)
    assert blob["step"] == 4
    assert any(k.startswith("vit.blocks.0.attn.qkv") for k in blob)
    assert any(k.startswith("bert.") for k in blob) and "vit.head.weight" not in blob
    res2 = image_pretrain.main(["--tiny", "--synthetic", "--cpu", "--num_steps", "5",
                                "--valid_steps", "5", "--output_dir", out,
                                "--resume", res["checkpoint"]])
    assert res2["final_step"] == 5 and os.path.exists(os.path.join(out, "model_step_5.pt"))
    res3 = image_pretrain.main(["--tiny", "--synthetic", "--cpu", "--num_steps", "1",
                                "--valid_steps", "1", "--output_dir", str(tmp_path / "init"),
                                "--init_ckpt", res["checkpoint"]])
    assert res3["final_step"] == 1
    bench = image_pretrain.main(["--tiny", "--synthetic", "--cpu", "--device_bench", "1",
                                 "--tasks", "sap", "itm", "--mix_ratio", "1", "1",
                                 "--output_dir", str(tmp_path / "bench")])
    assert list(bench["ex_per_sec_compute_bound"]) == ["sap"]  # ITM needs batch 2


def test_model_rejects_a_vit_of_another_width():
    with pytest.raises(ValueError, match="image_feat_size"):
        HAMTImagePretrain(ModelConfig(**TINY), ViTConfig(**dict(VIT, hidden_size=32)))
