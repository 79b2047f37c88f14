"""Weights carried across: the JAX package's flax params -> port state dicts.

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
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

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

    _linear(sd, "next_action.net.0", p["act_dense1"])
    _layernorm(sd, "next_action.net.2", p["act_ln"])
    _linear(sd, "next_action.net.4", p["act_dense2"])
    return sd


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
