"""The port's vision pipeline against the JAX package's on the same
seeded inputs and converted params: the transforms' geometry (crop
offsets, RandomResizedCrop boxes, flips, erasures, drawn from the same
numpy stream), the torch bicubic resize against PIL, the normalization,
the position-embedding resize, the ViT forward (small, and once at
ViT-B/16 width), the flax <-> timm weight converters both ways, the
checkpoint loader, the featurizer's ``extract`` and the
``precompute_features`` CLI. fp32 forwards within 2e-4 (the repository's
parity bar); bf16 within 3x the JAX package's bf16-to-fp32 distance
(``tests/test_torch_bf16.py``'s yardstick)."""

import math

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vln_hamt_tpu.models.convert import convert_vit_state_dict
from vln_hamt_tpu.models.convert import load_vit_checkpoint as jax_load_vit_checkpoint
from vln_hamt_tpu.vision import PanoramaFeaturizer as JaxFeaturizer
from vln_hamt_tpu.vision import transforms as jt
from vln_hamt_tpu.vision.vit import ViT as JaxViT
from vln_hamt_tpu.vision.vit import ViTConfig as JaxViTConfig
from vln_hamt_tpu.vision.vit import init_vit_params
from vln_hamt_tpu.vision.vit import resize_pos_embed as jax_resize_pos_embed
from vln_hamt_torch.models.convert import load_vit_checkpoint, vit_params_from_flax
from vln_hamt_torch.run import precompute_features
from vln_hamt_torch.vision import PanoramaFeaturizer, init_vit
from vln_hamt_torch.vision import transforms as tt
from vln_hamt_torch.vision.vit import ViTConfig, resize_pos_embed

FWD_ATOL = 2e-4
BF16_FACTOR, BF16_ATOL = 3.0, 1e-3
SMALL = dict(img_size=(32, 48), patch_size=16, hidden_size=64, num_layers=2, num_heads=4,
             num_classes=10)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _images(n, h, w, seed=0, smooth=False):
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        a, b = rng.uniform(20, 60, 2)
        img = np.stack([127 + 120 * np.sin(xx / a + i) * np.cos(yy / b), xx * 255.0 / w,
                        yy * 255.0 / h], -1)
        out.append(np.clip(np.round(img), 0, 255).astype(np.uint8))
    return np.stack(out)


def jax_vit(kw, dtype="float32", seed=0):
    model = JaxViT(JaxViTConfig(**kw, dtype=dtype))
    params = jax.jit(lambda r: init_vit_params(model, r))(jax.random.PRNGKey(seed))
    return model, jax.tree.map(np.asarray, params)


def port_vit(kw, params, dtype="float32"):
    vit = init_vit(ViTConfig(**kw, dtype=dtype), seed=1)
    vit.load_state_dict({k: torch.from_numpy(v) for k, v in vit_params_from_flax(params).items()},
                        strict=True)
    return vit.eval()


# ------------------------------------------------------------ transforms
def test_geometry_draws_equal_the_jax_package():
    """Center-crop offsets, RandomResizedCrop boxes (including the
    fallback) and erase boxes from the same numpy stream, left in the
    same state."""
    for h, w, out in ((248, 330, 224), (480, 640, 224), (35, 47, 32), (224, 224, 224)):
        img = np.zeros((h, w, 3), np.uint8)
        assert tt._center_crop(img, out).shape == jt._center_crop(img, out).shape
        a, b = np.random.default_rng(h), np.random.default_rng(h)
        for scale, ratio in (((0.08, 1.0), (3 / 4, 4 / 3)), ((0.9, 1.0), (5.0, 6.0))):
            for _ in range(20):
                assert (tt._rrc_params(a, h, w, scale, ratio)
                        == jt._rrc_params(b, h, w, scale, ratio))
                assert tt._erase_params(a, out, out) == jt._erase_params(b, out, out)
        assert a.bit_generator.state == b.bit_generator.state
    assert tt.timm_scale_size(224) == jt.timm_scale_size(224) == 248


@pytest.mark.parametrize("re_mode", ["const", "rand"])
def test_train_transform_matches_jax(re_mode):
    """The same crops, flips and erasures as the JAX package's train
    transform, and the generator left in the same state. Its resize is
    PIL's: on these smooth renders the two round a few upsampled pixels 2
    levels apart (mean 0.05 at most), where a crop, flip or erasure of
    its own would move the mean by tens of levels."""
    imgs = _images(6, 248, 330, seed=3, smooth=True)
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    got = tt.train_transform(imgs, a, 224, hflip=0.5, re_prob=0.5, re_mode=re_mode)
    want = jt.train_transform(imgs, b, 224, hflip=0.5, re_prob=0.5, re_mode=re_mode)
    assert a.bit_generator.state == b.bit_generator.state
    assert got.shape == want.shape == (6, 224, 224, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want)
    assert d.max() <= 2 and d.mean() <= 0.05


def test_image_transform_dispatch_and_auto_augment():
    imgs = _images(2, 248, 330, seed=4, smooth=True)
    got, want = tt.ImageTransform(out_size=224)(imgs), jt.ImageTransform(out_size=224)(imgs)
    assert got.shape == (2, 224, 224, 3) and np.abs(got.astype(int) - want).max() <= 1
    tr_got = tt.ImageTransform(train=True, seed=5)(imgs)
    tr_want = jt.ImageTransform(train=True, seed=5)(imgs)
    d = np.abs(tr_got.astype(int) - tr_want)
    assert d.max() <= 2 and d.mean() <= 0.05
    with pytest.raises(ValueError, match="auto_augment"):
        tt.ImageTransform(auto_augment="rand-m9")


@pytest.mark.parametrize("size", [(248, 330), (224, 224), (35, 47)])
def test_bicubic_resize_against_pil(size):
    """The torch resize against PIL's bicubic: within one level on smooth
    renders; on uniform noise (the hardest case) mean <= 0.2 and max <= 8
    levels. Shorter-side resizes of 480 x 640 and RandomResizedCrop's
    upsampling of a crop."""
    smooth, noise = _images(2, 480, 640, seed=1, smooth=True), _images(2, 480, 640, seed=2)
    for img in (*smooth, *noise, noise[0][17:120, 33:190]):
        img = np.ascontiguousarray(img)
        got = tt.bicubic_resize(img, *size).astype(int)
        want = np.asarray(Image.fromarray(img).resize(size[::-1], Image.BICUBIC)).astype(int)
        d = np.abs(got - want)
        assert d.mean() <= 0.2 and d.max() <= 8
    for img in smooth:
        d = np.abs(tt.bicubic_resize(img, *size).astype(int)
                   - np.asarray(Image.fromarray(img).resize(size[::-1], Image.BICUBIC)))
        assert d.max() <= 1


def test_eval_transform_matches_jax():
    imgs = _images(3, 480, 640, seed=6, smooth=True)
    got, want = tt.eval_transform(imgs), jt.eval_transform(imgs)
    assert got.shape == want.shape == (3, 224, 224, 3)
    assert np.abs(got.astype(int) - want).max() <= 1
    small = _images(2, 48, 64, seed=7)
    assert tt.eval_transform(small, 32).shape == (2, 32, 32, 3)


def test_normalize_images_matches_jax():
    imgs = _images(2, 8, 8, seed=8)
    for mean, std in ((tt.VIT_MEAN, tt.VIT_STD), ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))):
        got = tt.normalize_images(torch.from_numpy(imgs), mean, std)
        want = np.asarray(jt.normalize_images(jnp.asarray(imgs), mean, std))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- the ViT
@pytest.mark.parametrize("new,old", [((16, 20), (14, 14)), ((7, 9), (14, 14)), ((2, 3), (2, 2))])
def test_resize_pos_embed_matches_jax(new, old):
    """Within 1e-6 on position embeddings of the initializer's scale
    (normal 0.02)."""
    pos = np.random.default_rng(0).normal(0, 0.02, (1, 1 + old[0] * old[1], 32)).astype(np.float32)
    got = resize_pos_embed(torch.from_numpy(pos), new, old).numpy()
    want = np.asarray(jax_resize_pos_embed(jnp.asarray(pos), new, old))
    assert got.shape == want.shape == (1, 1 + new[0] * new[1], 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_vit_forward_matches_jax():
    model, params = jax_vit(SMALL)
    vit = port_vit(SMALL, params)
    x = np.random.default_rng(0).normal(size=(3, 32, 48, 3)).astype(np.float32)
    jf, jl = model.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        f, logits = vit(torch.from_numpy(x))
        f2, none = vit(torch.from_numpy(x), return_logits=False)
    assert f.shape == (3, 64) and logits.shape == (3, 10) and none is None
    assert f.dtype == logits.dtype == torch.float32
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0, atol=FWD_ATOL)
    np.testing.assert_array_equal(f2.numpy(), f.numpy())


def test_vit_base_width_matches_jax():
    """ViT-B/16 at 224 (hidden 768, 12 layers, 12 heads, 1000 classes) on 2
    images."""
    kw = dict(img_size=(224, 224))
    model, params = jax_vit(kw)
    vit = port_vit(kw, params)
    x = np.random.default_rng(1).normal(size=(2, 224, 224, 3)).astype(np.float32)
    jf, jl = model.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        f, logits = vit(torch.from_numpy(x))
    assert f.shape == (2, 768) and logits.shape == (2, 1000)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0, atol=FWD_ATOL)


def test_vit_bf16_within_the_bf16_yardstick():
    model32, params = jax_vit(SMALL)
    model16 = JaxViT(JaxViTConfig(**SMALL, dtype="bfloat16"))
    vit16 = port_vit(SMALL, params, "bfloat16")
    x = np.random.default_rng(2).normal(size=(4, 32, 48, 3)).astype(np.float32)
    want32 = model32.apply({"params": params}, jnp.asarray(x))
    want16 = model16.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = vit16(torch.from_numpy(x))
    for g, w16, w32 in zip(got, want16, want32):
        g, w16, w32 = g.numpy(), np.asarray(w16, np.float32), np.asarray(w32, np.float32)
        ref, err = np.abs(w16 - w32).max(), np.abs(g - w32).max()
        assert err <= BF16_FACTOR * ref + BF16_ATOL * min(1.0, np.abs(w32).max()), (err, ref)


def test_vit_attention_runs_through_fused_attention(monkeypatch):
    """Every block's attention is one fused_attention call with an
    all-zero (B, 1 + N) mask."""
    from vln_hamt_torch.vision import vit as vit_mod

    calls = []
    real = vit_mod.fused_attention

    def spy(q, k, v, m, rate=0.0, seed=None):
        calls.append((tuple(q.shape), tuple(m.shape), float(m.abs().max()), rate))
        return real(q, k, v, m, rate, seed)

    monkeypatch.setattr(vit_mod, "fused_attention", spy)
    vit = init_vit(ViTConfig(**SMALL), seed=0).eval()
    with torch.no_grad():
        vit(torch.zeros(2, 32, 48, 3))
    assert calls == [((2, 4, 7, 16), (2, 7), 0.0, 0.0)] * 2


# ------------------------------------------------------------ converters
def test_vit_converters_round_trip():
    """vit_params_from_flax is the exact inverse of the JAX package's
    convert_vit_state_dict, both ways."""
    _, params = jax_vit(SMALL)
    sd = vit_params_from_flax(params)
    back = convert_vit_state_dict(sd, num_layers=2, num_heads=4)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    again = vit_params_from_flax(back)
    assert again.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(again[k], sd[k], err_msg=k)
    assert sd["patch_embed.proj.weight"].shape == (64, 3, 16, 16)
    assert sd["blocks.0.attn.qkv.weight"].shape == (192, 64)


@pytest.mark.parametrize("fmt", ["pt", "npz"])
def test_load_vit_checkpoint_matches_jax(tmp_path, fmt):
    """A timm-style file with a DDP prefix, a model wrapper (.pt),
    pre-conv patchify weights and another patch grid: the port's loader
    gives the state dict of the JAX loader's params, the position
    embeddings resized within 1e-6."""
    src = dict(SMALL, img_size=(64, 64))
    _, params = jax_vit(src)
    sd = {("module." + k): v for k, v in vit_params_from_flax(params).items()}
    sd["module.patch_embed.proj.weight"] = sd["module.patch_embed.proj.weight"].reshape(64, -1)
    path = str(tmp_path / f"vit.{fmt}")
    if fmt == "pt":
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    else:
        np.savez(path, **sd)
    cfg = ViTConfig(**SMALL)  # a 2 x 3 grid against the file's 4 x 4
    got = load_vit_checkpoint(path, cfg)
    want = vit_params_from_flax(jax_load_vit_checkpoint(path, JaxViT(JaxViTConfig(**SMALL))))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert got["pos_embed"].shape == (1, 7, 64)
    vit = init_vit(cfg)
    vit.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()}, strict=True)
    headless = load_vit_checkpoint(path, ViTConfig(**dict(SMALL, num_classes=0)))
    assert "head.weight" not in headless and len(headless) == len(got) - 2


# ------------------------------------------------------------ featurizer
def test_featurizer_extract_matches_jax():
    """Three viewpoints through both featurizers (two per call): the same
    keys, (36, D + C) float32 rows of [features | logits], within 2e-4; the
    writer sees every matrix once."""
    kw = dict(SMALL, img_size=(32, 32))
    model, params = jax_vit(kw)
    vps = [("scanA", f"vp{i}", _images(36, 32, 32, seed=20 + i)) for i in range(3)]
    want = JaxFeaturizer(model, params, panos_per_batch=2).extract(iter(vps))
    written = []
    feat = PanoramaFeaturizer(port_vit(kw, params), panos_per_batch=2, device="cpu")
    got = feat.extract(iter(vps), writer=lambda s, v, m: written.append((s, v, m.shape)))
    assert sorted(got) == sorted(want) == ["scanA_vp0", "scanA_vp1", "scanA_vp2"]
    assert sorted(written) == [("scanA", f"vp{i}", (36, 74)) for i in range(3)]
    for k in want:
        assert got[k].shape == (36, 64 + 10) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=FWD_ATOL, err_msg=k)
    feats, logits = feat.featurize_images(vps[1][2])
    np.testing.assert_allclose(torch.cat([feats, logits], 1).numpy(), got["scanA_vp1"],
                               rtol=0, atol=1e-6)


def test_featurizer_raises_the_source_error():
    def source():
        yield ("s", "v0", _images(36, 32, 32))
        raise OSError("unreadable panorama")

    feat = PanoramaFeaturizer(init_vit(ViTConfig(**dict(SMALL, img_size=(32, 32)))),
                              panos_per_batch=2, device="cpu")
    with pytest.raises(OSError, match="unreadable panorama"):
        feat.extract(source())


def test_precompute_features_cli_writes_hdf5(tmp_path):
    """--synthetic 3 at ViT-B/16 width on small renders through the timm
    eval transform (resize to 35, crop 32), fp32: three (36, 1768) gzip
    datasets keyed scan_vp with their attributes, equal to the featurizer
    on the same views."""
    out = str(tmp_path / "feats.hdf5")
    argv = ["--synthetic", "3", "--cpu", "--no-bf16", "--output_file", out,
            "--image_size", "32", "32", "--render_size", "48", "64", "--panos_per_batch", "2"]
    result = precompute_features.main(argv)
    assert result["viewpoints"] == 3 and math.isfinite(result["viewpoints_per_sec"])
    with h5py.File(out) as f:
        assert sorted(f) == [f"synthscan_vp{i:05d}" for i in range(3)]
        for key in f:
            assert f[key].shape == (36, 768 + 1000) and f[key].dtype == np.float32
            assert f[key].compression == "gzip"
            assert f[key].attrs["scanId"] == "synthscan"
            assert np.isfinite(f[key][...]).all()
        first = f["synthscan_vp00000"][...]
    views = next(precompute_features.synthetic_view_source(
        1, 64, 48, lambda v: tt.eval_transform(v, 32)))[2]
    from vln_hamt_torch.vision import vit_base_patch16

    feat = PanoramaFeaturizer(vit_base_patch16(img_size=(32, 32)), device="cpu")
    feats, logits = feat.featurize_images(views)
    np.testing.assert_allclose(torch.cat([feats, logits], 1).numpy(), first, rtol=0, atol=1e-5)


@pytest.fixture
def pano_files(tmp_path):
    """A fixture world's connectivity files and one seeded .npy equirect
    (64 x 128) per viewpoint."""
    from vln_hamt_torch.data.fixtures import export_nav_and_annotations, make_synthetic_world

    files = export_nav_and_annotations(
        make_synthetic_world(num_scans=2, nodes_per_scan=3, num_items=2, seed=9),
        str(tmp_path / "world"))
    vps = precompute_features.load_viewpoint_ids(files["connectivity_dir"])
    pano_dir = tmp_path / "panos"
    pano_dir.mkdir()
    rng = np.random.default_rng(0)
    for scan, vp in vps:
        np.save(pano_dir / f"{scan}_{vp}.npy", rng.integers(0, 256, (64, 128, 3), np.uint8))
    return files["connectivity_dir"], str(pano_dir), vps


def test_build_image_store_matches_jax(pano_files, tmp_path):
    """The .npy store: one (36, 248, 330, 3) uint8 record per included
    viewpoint, byte-equal to the JAX CLI's (the same sampler)."""
    from vln_hamt_tpu.run import build_image_store as jax_build_image_store
    from vln_hamt_torch.run import build_image_store

    conn, panos, vps = pano_files
    out = {}
    for name, cli in (("port", build_image_store), ("jax", jax_build_image_store)):
        cli.main(["--connectivity_dir", conn, "--pano_dir", panos,
                  "--output", str(tmp_path / name)])
        out[name] = {p.name: np.load(p) for p in sorted((tmp_path / name).glob("*.npy"))}
    assert sorted(out["port"]) == sorted(f"{s}_{v}.npy" for s, v in vps) == sorted(out["jax"])
    for key, views in out["port"].items():
        assert views.shape == (36, 248, 330, 3) and views.dtype == np.uint8
        np.testing.assert_array_equal(views, out["jax"][key], err_msg=key)


def test_precompute_features_from_panoramas(pano_files, tmp_path):
    """The file-backed source: every included viewpoint's equirect through
    the native sampler and the eval transform, featurized, keyed
    scan_vp; equal to the featurizer on the same views."""
    conn, panos, vps = pano_files
    out = str(tmp_path / "feats.hdf5")
    precompute_features.main(["--connectivity_dir", conn, "--pano_dir", panos, "--cpu",
                              "--no-bf16", "--output_file", out, "--image_size", "32", "32",
                              "--render_size", "48", "64"])
    with h5py.File(out) as f:
        assert sorted(f) == sorted(f"{s}_{v}" for s, v in vps)
        scan, vp = vps[0]
        got = f[f"{scan}_{vp}"][...]
    source = precompute_features.equirect_view_source(
        panos, vps[:1], 64, 48, np.deg2rad(60.0), transform=lambda v: tt.eval_transform(v, 32))
    views = next(iter(source))[2]
    from vln_hamt_torch.vision import vit_base_patch16

    feat = PanoramaFeaturizer(vit_base_patch16(img_size=(32, 32)), device="cpu")
    feats, logits = feat.featurize_images(views)
    np.testing.assert_allclose(torch.cat([feats, logits], 1).numpy(), got, rtol=0, atol=1e-5)
    with pytest.raises(FileNotFoundError, match="no panorama"):
        precompute_features.find_panorama(panos, "nowhere", "vp")
