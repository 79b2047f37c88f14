"""Weights carried across: the JAX package's flax params and the
reference's released torch checkpoints -> port state dicts.

The port's modules carry the reference NavCMT names, so this is the
exact inverse of ``vln_hamt_tpu/models/convert.py:
convert_navcmt_state_dict`` (and ``convert_critic_state_dict``):
flax ``kernel`` (in, out) becomes torch ``weight`` (out, in), LayerNorm
``scale`` becomes ``weight``, embeddings map 1:1, and the history
[CLS] token goes from (1, D) to (1, 1, D). The results load into
:class:`~vln_hamt_torch.models.hamt.HAMT` / ``Critic`` with
``strict=True``.

Inputs are nested dicts of numpy arrays (``jax.tree.map(np.asarray,
params)`` on the JAX side); outputs are flat dicts of float32 numpy
arrays keyed by torch names.

Released reference checkpoints need no mapping at all, only their
prefixes stripped (:func:`load_reference_checkpoint`, the port's form of
the JAX package's loader of the same name), and load by name and shape
(:func:`merge_matching_params`).

The ViT keeps timm's names: :func:`vit_params_from_flax` is the exact
inverse of the JAX package's ``convert_vit_state_dict``,
:func:`load_vit_checkpoint` reads timm files with the JAX loader's
filtering, and :func:`image_pretrain_params_from_flax` converts the
end-to-end model (the trunk's names plus the ViT's under ``vit.``).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..configs import ModelConfig

Tree = Mapping[str, Any]


def _arr(x) -> np.ndarray:
    return np.array(x, dtype=np.float32, order="C")  # an owned, writable copy


def _linear(sd: Dict, torch_name: str, node: Tree) -> None:
    sd[torch_name + ".weight"] = _arr(np.asarray(node["kernel"]).T)
    if "bias" in node:
        sd[torch_name + ".bias"] = _arr(node["bias"])


def _layernorm(sd: Dict, torch_name: str, node: Tree) -> None:
    sd[torch_name + ".weight"] = _arr(node["scale"])
    sd[torch_name + ".bias"] = _arr(node["bias"])


def _embed(sd: Dict, torch_name: str, node: Tree) -> None:
    sd[torch_name + ".weight"] = _arr(node["embedding"])


def _attention_block(sd: Dict, torch_prefix: str, node: Tree, inner: str) -> None:
    """flax Attention -> BertAttention (``.self.``) / BertXAttention (``.att.``)."""
    for qkv in ("query", "key", "value"):
        _linear(sd, f"{torch_prefix}.{inner}.{qkv}", node["att"][qkv])
    _linear(sd, f"{torch_prefix}.output.dense", node["output"]["dense"])
    _layernorm(sd, f"{torch_prefix}.output.LayerNorm", node["output"]["LayerNorm"])


def _bert_layer(sd: Dict, torch_prefix: str, node: Tree) -> None:
    """flax TransformerLayer -> BertLayer (vilmodel_cmt.py:188-201)."""
    _attention_block(sd, f"{torch_prefix}.attention", node["attention"], "self")
    _linear(sd, f"{torch_prefix}.intermediate.dense", node["ffn"]["intermediate"])
    _linear(sd, f"{torch_prefix}.output.dense", node["ffn"]["output"])
    _layernorm(sd, f"{torch_prefix}.output.LayerNorm", node["ffn"]["LayerNorm"])


def params_from_flax(params: Tree, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """flax HAMT params -> the port's ``HAMT`` state dict (NavCMT names)."""
    p = params
    sd: Dict[str, np.ndarray] = {}

    emb = p["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        _embed(sd, f"embeddings.{name}", emb[name])
    _layernorm(sd, "embeddings.LayerNorm", emb["LayerNorm"])

    for i in range(cfg.num_l_layers):
        _bert_layer(sd, f"encoder.layer.{i}", p["lang_layers"][f"layer_{i}"])
    for i in range(cfg.num_h_layers):
        _bert_layer(sd, f"encoder.h_layers.{i}", p["h_layers"][f"layer_{i}"])
    for i in range(cfg.num_r_layers):
        _bert_layer(sd, f"encoder.r_layers.{i}", p["r_layers"][f"layer_{i}"])

    for i in range(cfg.num_x_layers):
        x = p[f"x_layer_{i}"]
        base = f"encoder.x_layers.{i}"
        _attention_block(sd, f"{base}.visual_attention", x["visual_attention"], "att")
        _attention_block(sd, f"{base}.lang_self_att", x["lang_self_att"], "self")
        _attention_block(sd, f"{base}.visn_self_att", x["visn_self_att"], "self")
        for stream in ("lang", "visn"):
            ffn = x[f"{stream}_ffn"]
            _linear(sd, f"{base}.{stream}_inter.dense", ffn["intermediate"])
            _linear(sd, f"{base}.{stream}_output.dense", ffn["output"])
            _layernorm(sd, f"{base}.{stream}_output.LayerNorm", ffn["LayerNorm"])

    _linear(sd, "img_embeddings.img_linear", p["ob_img_linear"])
    _layernorm(sd, "img_embeddings.img_layer_norm", p["ob_img_ln"])
    _linear(sd, "img_embeddings.ang_linear", p["ob_ang_linear"])
    _layernorm(sd, "img_embeddings.ang_layer_norm", p["ob_ang_ln"])
    _embed(sd, "img_embeddings.nav_type_embedding", p["ob_nav_type_embedding"])
    _layernorm(sd, "img_embeddings.layer_norm", p["ob_ln"])

    sd["hist_embeddings.cls_token"] = _arr(p["hist_cls"]).reshape(1, 1, -1)
    _linear(sd, "hist_embeddings.img_linear", p["hist_img_linear"])
    _layernorm(sd, "hist_embeddings.img_layer_norm", p["hist_img_ln"])
    _linear(sd, "hist_embeddings.ang_linear", p["hist_ang_linear"])
    _layernorm(sd, "hist_embeddings.ang_layer_norm", p["hist_ang_ln"])
    _embed(sd, "hist_embeddings.position_embeddings", p["hist_pos_embedding"])
    _embed(sd, "hist_embeddings.type_embedding", p["hist_type_embedding"])
    _layernorm(sd, "hist_embeddings.layer_norm", p["hist_ln"])
    if cfg.hist_enc_pano:
        _linear(sd, "hist_embeddings.pano_img_linear", p["hist_pano_img_linear"])
        _layernorm(sd, "hist_embeddings.pano_img_layer_norm", p["hist_pano_img_ln"])
        _linear(sd, "hist_embeddings.pano_ang_linear", p["hist_pano_ang_linear"])
        _layernorm(sd, "hist_embeddings.pano_ang_layer_norm", p["hist_pano_ang_ln"])
        for i in range(cfg.num_h_pano_layers):
            _bert_layer(sd, f"hist_embeddings.pano_encoder.layer.{i}",
                        p["pano_encoder"][f"layer_{i}"])

    if "act_dense1" in p:  # a pretraining trunk has no action head
        _mlp_head(sd, "next_action", p["act_dense1"], p["act_ln"], p["act_dense2"], 4)
    if "obj_img_linear" in p:  # REVERIE's object embeddings and head (NavRefCMT)
        for part in ("img", "ang", "pos"):
            _linear(sd, f"obj_embeddings.{part}_linear", p[f"obj_{part}_linear"])
            _layernorm(sd, f"obj_embeddings.{part}_layer_norm", p[f"obj_{part}_ln"])
        _layernorm(sd, "obj_embeddings.layer_norm", p["obj_ln"])
        _mlp_head(sd, "ref_object", p["ref_dense1"], p["ref_ln"], p["ref_dense2"], 4)
    return sd


def _mlp_head(sd: Dict, torch_name: str, dense1: Tree, ln: Tree, dense2: Tree,
              last: int) -> None:
    """dense -> ReLU -> LN [-> dropout] -> dense as an ``nn.Sequential``
    named ``net``: net.0, net.2 and net.``last`` (4 with the dropout, 3
    without; pretrain_cmt.py:13-71)."""
    _linear(sd, f"{torch_name}.net.0", dense1)
    _layernorm(sd, f"{torch_name}.net.2", ln)
    _linear(sd, f"{torch_name}.net.{last}", dense2)


#: the pretraining heads of ``MultiStepNavCMTPreTraining`` built as
#: dense -> ReLU -> LN [-> dropout] -> dense, with the index of their last
#: dense (pretrain_cmt.py:73-99)
PRETRAIN_MLP_HEADS = (("next_action", 4), ("regress_action", 4), ("sprel_head", 4),
                      ("image_classifier", 3), ("itm_head", 3))


def pretrain_params_from_flax(params: Tree, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """flax ``HAMTPretrain`` params -> the port's ``HAMTPretrain`` state
    dict, the names of the reference's ``MultiStepNavCMTPreTraining``
    (so also a reference pretrain ``ModelSaver`` file): the trunk under
    ``bert.`` with NavCMT names, ``mlm_head.predictions.{transform.dense,
    transform.LayerNorm, bias}`` (the decoder is tied to the word
    embeddings and carries no weight of its own), and the MLP heads. The
    exact inverse of ``vln_hamt_tpu/models/convert.py:
    convert_reference_pretrain_state_dict``; heads absent from
    ``params`` are left out."""
    sd = {"bert." + k: v for k, v in params_from_flax(params["hamt"], cfg).items()}
    if "mlm_head" in params:
        mh = params["mlm_head"]
        _linear(sd, "mlm_head.predictions.transform.dense", mh["transform_dense"])
        _layernorm(sd, "mlm_head.predictions.transform.LayerNorm", mh["transform_ln"])
        sd["mlm_head.predictions.bias"] = _arr(mh["bias"])
    for name, last in PRETRAIN_MLP_HEADS:
        if name in params:
            h = params[name]
            _mlp_head(sd, name, h["dense1"], h["ln"], h["dense2"], last)
    return sd


def vit_params_from_flax(params: Tree) -> Dict[str, np.ndarray]:
    """flax ``vision/vit.py`` ViT params -> the port's ViT state dict, in
    timm's names; the exact inverse of ``vln_hamt_tpu/models/convert.py:
    convert_vit_state_dict``: the conv kernel (kh, kw, I, O) becomes
    (O, I, kh, kw), the per-head query / key / value kernels (D, H, Dh)
    the fused ``attn.qkv`` (3D, D), the output kernel (H, Dh, D)
    ``attn.proj`` (D, D). ``head`` when the params have one."""
    sd: Dict[str, np.ndarray] = {
        "patch_embed.proj.weight": _arr(np.asarray(params["patch_embed"]["kernel"])
                                        .transpose(3, 2, 0, 1)),
        "patch_embed.proj.bias": _arr(params["patch_embed"]["bias"]),
        "cls_token": _arr(params["cls_token"]),
        "pos_embed": _arr(params["pos_embed"]),
    }
    i = 0
    while f"block_{i}" in params:
        node, tp = params[f"block_{i}"], f"blocks.{i}"
        _layernorm(sd, f"{tp}.norm1", node["norm1"])
        _layernorm(sd, f"{tp}.norm2", node["norm2"])
        att = node["attn"]
        d = np.asarray(att["query"]["kernel"]).shape[0]
        sd[f"{tp}.attn.qkv.weight"] = _arr(np.concatenate(
            [np.asarray(att[n]["kernel"]).reshape(d, d).T for n in ("query", "key", "value")]))
        sd[f"{tp}.attn.qkv.bias"] = _arr(np.concatenate(
            [np.asarray(att[n]["bias"]).reshape(d) for n in ("query", "key", "value")]))
        sd[f"{tp}.attn.proj.weight"] = _arr(np.asarray(att["out"]["kernel"]).reshape(d, d).T)
        sd[f"{tp}.attn.proj.bias"] = _arr(att["out"]["bias"])
        _linear(sd, f"{tp}.mlp.fc1", node["mlp_fc1"])
        _linear(sd, f"{tp}.mlp.fc2", node["mlp_fc2"])
        i += 1
    _layernorm(sd, "norm", params["norm"])
    if "head" in params:
        _linear(sd, "head", params["head"])
    return sd


def image_pretrain_params_from_flax(params: Tree, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """flax ``HAMTImagePretrain`` params (``vit`` and ``trunk``) -> the
    port's ``HAMTImagePretrain`` state dict: the trunk's
    :func:`pretrain_params_from_flax` names and the ViT's under
    ``vit.``."""
    sd = pretrain_params_from_flax(params["trunk"], cfg)
    sd.update({"vit." + k: v for k, v in vit_params_from_flax(params["vit"]).items()})
    return sd


def _vit_names(num_layers: int, head: bool) -> List[str]:
    names = ["patch_embed.proj.weight", "patch_embed.proj.bias", "cls_token", "pos_embed",
             "norm.weight", "norm.bias"]
    for i in range(num_layers):
        names += [f"blocks.{i}.{m}.{w}" for m in ("norm1", "attn.qkv", "attn.proj", "norm2",
                                                   "mlp.fc1", "mlp.fc2")
                  for w in ("weight", "bias")]
    return names + (["head.weight", "head.bias"] if head else [])


def load_vit_checkpoint(path: str, cfg) -> Dict[str, np.ndarray]:
    """A torch/timm ViT checkpoint (``.pth`` / ``.pt``, read with
    ``weights_only=True``) or an ``.npz`` archive of its state dict, as
    the state dict of a ``vision.vit.ViT`` of config ``cfg`` (float32
    numpy arrays in timm's names, ``head`` when ``cfg`` has classes).
    The JAX loader's filtering (``vision_transformer.py:399-434``
    ``checkpoint_filter_fn``): ``model`` / ``state_dict`` wrappers
    unwrapped, ``module.`` prefixes stripped, pre-conv patchify weights
    reshaped to the conv's (D, 3, p, p), and the position embeddings
    resized bilinearly when the checkpoint's patch grid is not
    ``cfg.grid``. Raises KeyError on a missing weight."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd: Mapping[str, Any] = dict(z)
    else:
        import torch

        sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("model", "state_dict"):  # DeiT and trainer checkpoints
        if wrapper in sd and not hasattr(sd[wrapper], "shape"):
            sd = sd[wrapper]
    sd = {_strip(k, "module."): np.asarray(v, dtype=np.float32) for k, v in sd.items()}
    p, grid = cfg.patch_size, tuple(cfg.grid)
    w = sd["patch_embed.proj.weight"]
    if w.ndim < 4:  # pre-conv patchify checkpoints
        sd["patch_embed.proj.weight"] = w.reshape(w.shape[0], -1, p, p)
    pos = sd["pos_embed"]
    if pos.shape[1] != grid[0] * grid[1] + 1:
        import torch

        from ..vision.vit import resize_pos_embed

        old = int(round((pos.shape[1] - 1) ** 0.5))
        sd["pos_embed"] = resize_pos_embed(torch.from_numpy(pos), grid, (old, old)).numpy()
    return {k: _arr(sd[k]) for k in _vit_names(cfg.num_layers, cfg.num_classes > 0)}


def critic_params_from_flax(cparams: Tree) -> Dict[str, np.ndarray]:
    """flax Critic params -> the port's ``Critic`` state dict
    (model_HAMT.py:258-269: state2value.0 / .3)."""
    sd: Dict[str, np.ndarray] = {}
    _linear(sd, "state2value.0", cparams["Dense_0"])
    _linear(sd, "state2value.3", cparams["Dense_1"])
    return sd


def adam_state_from_flax(count, mu: Tree, nu: Tree,
                         convert: Callable[[Tree], Dict[str, np.ndarray]]) -> Dict[str, Any]:
    """optax's Adam state -> the port's optimizer state.

    ``count``, ``mu`` and ``nu`` are the fields of optax's
    ``ScaleByAdamState`` (``mu`` and ``nu`` as nested dicts of numpy
    arrays, the same flax tree as the params they belong to); ``convert``
    is the tree's params mapping, e.g. ``lambda t: params_from_flax(t,
    cfg)`` or :func:`critic_params_from_flax`. The moments are laid out
    as the weights are (kernels transposed), so the result feeds
    ``agents/optim.py:OptaxOptimizer.load_adam_state``, and a JAX run and
    a port run continue from the same step.
    """
    return {"count": int(np.asarray(count)), "mu": convert(mu), "nu": convert(nu)}


# ----------------------------------------------------------------------
# HuggingFace text encoders

def _hf_text_names(num_l_layers: int) -> List[str]:
    """The text embeddings and first ``num_l_layers`` BertLayers, the
    part of a HuggingFace BERT (or XLM-R) that initializes the trunk;
    HF and NavCMT use the same names for them."""
    names = [f"embeddings.{e}.weight" for e in
             ("word_embeddings", "position_embeddings", "token_type_embeddings")]
    names += ["embeddings.LayerNorm.weight", "embeddings.LayerNorm.bias"]
    for i in range(num_l_layers):
        pre = f"encoder.layer.{i}"
        for lin in ("attention.self.query", "attention.self.key", "attention.self.value",
                    "attention.output.dense", "intermediate.dense", "output.dense"):
            names += [f"{pre}.{lin}.weight", f"{pre}.{lin}.bias"]
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            names += [f"{pre}.{ln}.weight", f"{pre}.{ln}.bias"]
    return names


def convert_hf_bert_state_dict(sd: Mapping[str, Any], num_l_layers: int = 9
                               ) -> Dict[str, np.ndarray]:
    """A HuggingFace bert-base state dict -> the trunk's partial state
    dict (NavCMT names, float32 numpy): the text embeddings and the first
    ``num_l_layers`` layers, the reference's BERT init
    (``pretrain_src/main_r2r.py:131-144``), to merge over the trunk. The
    port's form of ``vln_hamt_tpu/models/convert.py:
    convert_hf_bert_state_dict``; a name it needs and ``sd`` lacks raises
    KeyError, as there."""
    sd = {k.replace("bert.", ""): v for k, v in sd.items()}
    return {k: _arr(sd[k]) for k in _hf_text_names(num_l_layers)}


def convert_hf_xlmr_state_dict(sd: Mapping[str, Any], num_l_layers: int = 9,
                               max_position_embeddings: Optional[int] = None
                               ) -> Dict[str, np.ndarray]:
    """A HuggingFace xlm-roberta-base state dict -> the trunk's partial
    state dict (RxR text), as :func:`convert_hf_bert_state_dict` plus the
    reference's XLM init (``main_r2r.py:131-143``): the single token-type
    row duplicated to 2 (the second is the image tokens' type), and
    XLM-R's position table (514 rows, a +2 padding offset) left out
    unless its row count is ``max_position_embeddings``: the reference's
    name-matched load skips it on the shape mismatch."""
    sd = {k.replace("roberta.", ""): v for k, v in sd.items()}
    out = convert_hf_bert_state_dict(sd, num_l_layers)
    tte = out["embeddings.token_type_embeddings.weight"]
    if tte.shape[0] == 1:
        out["embeddings.token_type_embeddings.weight"] = np.concatenate([tte, tte], axis=0)
    pos = out["embeddings.position_embeddings.weight"]
    if max_position_embeddings is not None and pos.shape[0] != max_position_embeddings:
        del out["embeddings.position_embeddings.weight"]
    return out


# ----------------------------------------------------------------------
# Released reference checkpoints


def merge_matching_params(base: Mapping[str, Any], override: Mapping[str, Any]
                          ) -> Tuple[Dict[str, Any], List[str]]:
    """``override``'s tensors over a copy of the state dict ``base`` with
    the reference's ``strict=False`` load semantics (HF
    ``from_pretrained(state_dict=...)`` name matching,
    ``vlnbert_init.py:64-67``): a tensor replaces its namesake only when
    the shapes agree; every other name of ``override`` is skipped and
    reported. Returns ``(merged, skipped_names)``."""
    merged, skipped = dict(base), []
    for k, v in override.items():
        if k in merged and tuple(merged[k].shape) == tuple(v.shape):
            merged[k] = v
        else:
            skipped.append(k)
    return merged, skipped


def _detect_navcmt_dims(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The NavCMT stack depths and object-head presence from a state
    dict's key names, so a checkpoint of any configured depth is
    recognised without hand-passed dims."""
    def depth(pat: str) -> int:
        rex = re.compile(pat)
        mx = -1
        for k in sd:
            m = rex.match(k)
            if m:
                mx = max(mx, int(m.group(1)))
        return mx + 1

    return dict(
        num_l_layers=depth(r"encoder\.layer\.(\d+)\."),
        num_h_layers=depth(r"encoder\.h_layers\.(\d+)\."),
        num_r_layers=depth(r"encoder\.r_layers\.(\d+)\."),
        num_x_layers=depth(r"encoder\.x_layers\.(\d+)\."),
        num_h_pano_layers=depth(r"hist_embeddings\.pano_encoder\.layer\.(\d+)\."),
        has_objects="obj_embeddings.img_linear.weight" in sd,
    )


def _strip(k: str, prefix: str) -> str:
    return k[len(prefix):] if k.startswith(prefix) else k


def load_reference_checkpoint(path: str
                              ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """A released reference torch checkpoint as ``(navcmt_state_dict,
    critic_state_dict or None)``, tensors keyed by the reference NavCMT
    and Critic names, which the port's modules carry.

    Handles both released formats:

    - agent checkpoints of ``Seq2SeqCMTAgent.save`` (agent_cmt.py:607-622:
      ``{'vln_bert': {'state_dict': ...}, 'critic': {'state_dict': ...}}``),
      REVERIE's ``NavRefCMTAgent`` among them (the ``NavRefModel``
      wrapper, its NavRefCMT under ``vln_bert.``, model_navref.py:79,
      with ``obj_embeddings.*`` and ``ref_object.*``): the wrapper's
      ``vln_bert.`` prefix and a DDP ``module.`` prefix are stripped;
    - pretrain ``ModelSaver`` state dicts (the ``--bert_ckpt_file``
      files): ``module.`` is stripped, ``bert.*`` re-rooted onto NavCMT,
      the top-level ``next_action.*`` kept and the other pretraining
      heads (MLM, ITM, ...) dropped (vlnbert_init.py:20-31); no critic.

    Both formats hold only tensors, dicts, lists and numbers, which
    ``torch.load(weights_only=True)`` reads without running any of the
    pickle's code. A file that pickles other objects (a numpy scalar in
    an optimizer state, say) would need a full unpickle, which runs code
    from the file: the port refuses it (ValueError), and such a file,
    from a trusted source, is re-saved with its tensors only. Raises
    ValueError too on a file with no NavCMT layer in it.
    """
    import pickle

    import torch

    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path}: holds objects other than tensors, dicts, lists and "
                         "numbers, which torch.load(weights_only=True) refuses; re-save "
                         f"its tensors from a trusted copy ({e})") from e
    critic = None
    if isinstance(blob, dict) and "vln_bert" in blob:
        sd = {_strip(_strip(k, "module."), "vln_bert."): v
              for k, v in blob["vln_bert"]["state_dict"].items()}
        if "critic" in blob:
            critic = {_strip(k, "module."): v
                      for k, v in blob["critic"]["state_dict"].items()}
    else:
        sd = {}
        for k, v in blob.items():
            k = _strip(k, "module.")
            if k.startswith("bert."):
                sd[k[len("bert."):]] = v
            elif k.startswith("next_action"):
                sd[k] = v
    dims = _detect_navcmt_dims(sd)
    if dims["num_l_layers"] == 0 and dims["num_x_layers"] == 0:
        raise ValueError(f"{path}: no NavCMT text or cross-modal layer in the checkpoint")
    return sd, critic
