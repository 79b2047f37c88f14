"""HAMT written out from its layer equations, in plain float32 torch.

The model of Chen et al. (NeurIPS 2021), as the published code builds it
(``finetune_src/models/vilmodel_cmt.py`` NavCMT, ``model_HAMT.py``
Critic): BERT post-LN blocks with the erf GELU and LayerNorm eps 1e-12,
additive masks of -10000 at padding, a text stack, a history embedding
with a two-layer panorama encoder, LXMERT cross-modal layers whose
cross-attention is shared by both directions (the language half skipped
and precomputed once under ``no_lang_ca``), the action head over the
observation tokens and the 768-512-1 critic.

Parameters live in one dict under the reference's state-dict names
(:func:`param_shapes`), so the benchmark hands the same seeded tensors to
the program and to this file. Nothing here imports the program.

Dropout: training runs draw their masks as the program's streams do, so
a replay of the same seeds drops the same units. A :class:`Streams`
holds the three generators by the rule that the agent seeds them (masks
on the device at ``seed + 17``, attention seeds on the host at
``seed + 18``, sampled actions on the device at ``seed + 19``); every
dropout site draws a keep mask of its input's shape from the mask
stream, in the order the forward reaches it, and every attention draws
a 32-bit seed for the counter-hash keep mask of :mod:`.dropout`.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .dropout import keep_mask

Params = Dict[str, torch.Tensor]


class Streams:
    """The random streams of one training replay (module docstring)."""

    def __init__(self, device, agent_seed: int):
        self.masks = torch.Generator(device=device).manual_seed(agent_seed + 17)
        self.seeds = torch.Generator().manual_seed(agent_seed + 18)
        self.actions = torch.Generator(device=device).manual_seed(agent_seed + 19)


# ------------------------------------------------------------ parameters
def _bert_layer(prefix: str, d: int, ff: int, att: str = "attention.self",
                out: str = "attention.output") -> Dict[str, Tuple[int, ...]]:
    s = {}
    for n in ("query", "key", "value"):
        s[f"{prefix}.{att}.{n}.weight"] = (d, d)
        s[f"{prefix}.{att}.{n}.bias"] = (d,)
    s[f"{prefix}.{out}.dense.weight"] = (d, d)
    s[f"{prefix}.{out}.dense.bias"] = (d,)
    s[f"{prefix}.{out}.LayerNorm.weight"] = (d,)
    s[f"{prefix}.{out}.LayerNorm.bias"] = (d,)
    return s


def _ffn(inter: str, out: str, d: int, ff: int) -> Dict[str, Tuple[int, ...]]:
    return {f"{inter}.dense.weight": (ff, d), f"{inter}.dense.bias": (ff,),
            f"{out}.dense.weight": (d, ff), f"{out}.dense.bias": (d,),
            f"{out}.LayerNorm.weight": (d,), f"{out}.LayerNorm.bias": (d,)}


def _linear(name: str, i: int, o: int) -> Dict[str, Tuple[int, ...]]:
    return {f"{name}.weight": (o, i), f"{name}.bias": (o,)}


def _ln(name: str, d: int) -> Dict[str, Tuple[int, ...]]:
    return {f"{name}.weight": (d,), f"{name}.bias": (d,)}


def _self_layer(prefix: str, d: int, ff: int) -> Dict[str, Tuple[int, ...]]:
    return {**_bert_layer(prefix, d, ff), **_ffn(f"{prefix}.intermediate", f"{prefix}.output",
                                                 d, ff)}


def param_shapes(m: dict) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """(model, critic) parameter shapes by the reference's names for the
    configuration's ``model`` group."""
    d, ff, img, ang = m["hidden_size"], m["intermediate_size"], m["image_feat_size"], \
        m["angle_feat_size"]
    s: Dict[str, tuple] = {
        "embeddings.word_embeddings.weight": (m["vocab_size"], d),
        "embeddings.position_embeddings.weight": (m["max_position_embeddings"], d),
        "embeddings.token_type_embeddings.weight": (m["type_vocab_size"], d),
        **_ln("embeddings.LayerNorm", d),
    }
    for i in range(m["num_l_layers"]):
        s.update(_self_layer(f"encoder.layer.{i}", d, ff))
    for i in range(m["num_x_layers"]):
        p = f"encoder.x_layers.{i}"
        s.update(_bert_layer(f"{p}.visual_attention", d, ff, "att", "output"))
        s.update(_bert_layer(f"{p}.lang_self_att", d, ff, "self", "output"))
        s.update(_bert_layer(f"{p}.visn_self_att", d, ff, "self", "output"))
        s.update(_ffn(f"{p}.lang_inter", f"{p}.lang_output", d, ff))
        s.update(_ffn(f"{p}.visn_inter", f"{p}.visn_output", d, ff))
    s.update({**_linear("img_embeddings.img_linear", img, d),
              **_ln("img_embeddings.img_layer_norm", d),
              **_linear("img_embeddings.ang_linear", ang, d),
              **_ln("img_embeddings.ang_layer_norm", d),
              "img_embeddings.nav_type_embedding.weight": (3, d),
              **_ln("img_embeddings.layer_norm", d)})
    h = "hist_embeddings"
    s.update({f"{h}.cls_token": (1, 1, d),
              **_linear(f"{h}.img_linear", img, d), **_ln(f"{h}.img_layer_norm", d),
              **_linear(f"{h}.ang_linear", ang, d), **_ln(f"{h}.ang_layer_norm", d),
              f"{h}.position_embeddings.weight": (m["max_action_steps"], d),
              f"{h}.type_embedding.weight": (1, d), **_ln(f"{h}.layer_norm", d),
              **_linear(f"{h}.pano_img_linear", img, d), **_ln(f"{h}.pano_img_layer_norm", d),
              **_linear(f"{h}.pano_ang_linear", ang, d), **_ln(f"{h}.pano_ang_layer_norm", d)})
    for i in range(m["num_h_pano_layers"]):
        s.update(_self_layer(f"{h}.pano_encoder.layer.{i}", d, ff))
    s.update({**_linear("next_action.net.0", d, d), **_ln("next_action.net.2", d),
              **_linear("next_action.net.4", d, 1)})
    critic = {**_linear("state2value.0", d, 512), **_linear("state2value.3", 512, 1)}
    return s, critic


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Params:
    """Seeded weights made on the device in one draw: every tensor's
    elements from one normal stream, scaled to std 1/sqrt(fan-in) for a
    dense weight and 1/sqrt(width) for embedding rows; LayerNorm weights
    1, biases and the history [CLS] token 0."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if name.endswith("bias") or name.endswith("cls_token"):
            t.zero_()
        elif "LayerNorm" in name or "layer_norm" in name or ".net.2." in name:
            t.fill_(1.0)
        else:  # dense (out, in) or embedding (rows, width): both by the last dim
            t.mul_(1.0 / math.sqrt(shape[-1]))
        out[name] = t
    return out


# ------------------------------------------------------------ the model
class HAMT:
    """The forward of one configuration over a parameter dict ``w``.

    ``training`` turns the dropouts on, drawing from ``streams``."""

    def __init__(self, m: dict, w: Params, cw: Params, training: bool = False,
                 streams: Optional[Streams] = None):
        self.m, self.w, self.cw = m, w, cw
        self.training, self.streams = training, streams
        self.heads = m["num_attention_heads"]

    # -- primitives
    def drop(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if not self.training or p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=self.streams.masks)
        return x * keep * (1.0 / (1.0 - p))

    def lin(self, x, name, w=None):
        w = self.w if w is None else w
        return F.linear(x, w[name + ".weight"], w[name + ".bias"])

    def ln(self, x, name):
        d = x.shape[-1]
        return F.layer_norm(x, (d,), self.w[name + ".weight"], self.w[name + ".bias"], 1e-12)

    def attention(self, prefix: str, hidden, context, mask) -> torch.Tensor:
        """softmax(q k^T / sqrt(Dh) + mask) v with attention dropout; mask
        (B, Lk) additive."""
        b, lq, d = hidden.shape
        lk, h = context.shape[1], self.heads
        dh = d // h
        q = self.lin(hidden, prefix + ".query").view(b, lq, h, dh).transpose(1, 2)
        k = self.lin(context, prefix + ".key").view(b, lk, h, dh).transpose(1, 2)
        v = self.lin(context, prefix + ".value").view(b, lk, h, dh).transpose(1, 2)
        scores = q @ k.transpose(-1, -2) * (1.0 / math.sqrt(dh)) + mask[:, None, None, :]
        p = torch.softmax(scores, dim=-1)
        rate = self.m["attention_probs_dropout_prob"] if self.training else 0.0
        if rate > 0.0:
            seed = int(torch.randint(0, 2 ** 32, (), generator=self.streams.seeds))
            keep = keep_mask(seed, b, h, lq, lk, rate, p.device)
            p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
        return (p @ v).transpose(1, 2).reshape(b, lq, d)

    def att_block(self, prefix, att, hidden, context, mask):
        a = self.attention(f"{prefix}.{att}", hidden, context, mask)
        a = self.drop(self.lin(a, f"{prefix}.output.dense"), self.m["hidden_dropout_prob"])
        return self.ln(a + hidden, f"{prefix}.output.LayerNorm")

    def ffn(self, inter, out, x):
        h = self.lin(x, f"{inter}.dense")
        h = h * 0.5 * (1.0 + torch.erf(h / math.sqrt(2.0)))
        h = self.drop(self.lin(h, f"{out}.dense"), self.m["hidden_dropout_prob"])
        return self.ln(h + x, f"{out}.LayerNorm")

    def self_layer(self, prefix, x, mask):
        x = self.att_block(f"{prefix}.attention", "self", x, x, mask)
        return self.ffn(f"{prefix}.intermediate", f"{prefix}.output", x)

    @staticmethod
    def ext(mask: torch.Tensor) -> torch.Tensor:
        return (1.0 - mask.float()) * -10000.0

    def frozen(self, flag: bool):
        return torch.no_grad() if flag else contextlib.nullcontext()

    # -- text
    def encode_text(self, ids, mask):
        """(B, L, D); under no_lang_ca the (X+1, B, L, D) stack of the
        language half's states, layer i of the cross-modal stack reading
        state i."""
        m, w = self.m, self.w
        ext = self.ext(mask)
        with self.frozen(m["fix_lang_embedding"] or not m["update_lang_bert"]):
            pos = torch.arange(ids.shape[1], device=ids.device)
            x = (w["embeddings.word_embeddings.weight"][ids]
                 + w["embeddings.position_embeddings.weight"][pos][None]
                 + w["embeddings.token_type_embeddings.weight"][0])
            x = self.drop(self.ln(x, "embeddings.LayerNorm"), m["hidden_dropout_prob"])
            for i in range(m["num_l_layers"]):
                x = self.self_layer(f"encoder.layer.{i}", x, ext)
        if not m["no_lang_ca"]:
            return x
        states = [x]
        for i in range(m["num_x_layers"]):
            p = f"encoder.x_layers.{i}"
            x = self.att_block(f"{p}.lang_self_att", "self", x, x, ext)
            x = self.ffn(f"{p}.lang_inter", f"{p}.lang_output", x)
            states.append(x)
        return torch.stack(states)

    # -- history
    def init_history(self, b: int, device) -> torch.Tensor:
        h = "hist_embeddings"
        with self.frozen(self.m["fix_hist_embedding"]):
            cls = (self.w[f"{h}.cls_token"].view(1, -1)
                   + self.w[f"{h}.type_embedding.weight"][0])
            cls = cls.expand(b, -1)
            return self.drop(self.ln(cls, f"{h}.layer_norm"), self.m["hidden_dropout_prob"])

    def encode_history(self, img, ang, step: int, pano_img, pano_ang):
        m, w, h = self.m, self.w, "hist_embeddings"
        pf, ph = m["feat_dropout"], m["hidden_dropout_prob"]
        with self.frozen(m["fix_hist_embedding"]):
            emb = (self.ln(self.lin(self.drop(img, pf), f"{h}.img_linear"), f"{h}.img_layer_norm")
                   + self.ln(self.lin(ang, f"{h}.ang_linear"), f"{h}.ang_layer_norm")
                   + w[f"{h}.position_embeddings.weight"][step]
                   + w[f"{h}.type_embedding.weight"][0])
            pano = (self.ln(self.lin(self.drop(pano_img, pf), f"{h}.pano_img_linear"),
                            f"{h}.pano_img_layer_norm")
                    + self.ln(self.lin(pano_ang, f"{h}.pano_ang_linear"),
                              f"{h}.pano_ang_layer_norm"))
            pano = self.drop(pano, ph)
            zero = pano.new_zeros(pano.shape[:2])
            for i in range(m["num_h_pano_layers"]):
                pano = self.self_layer(f"{h}.pano_encoder.layer.{i}", pano, zero)
            emb = emb + pano.mean(dim=1)
            return self.drop(self.ln(emb, f"{h}.layer_norm"), ph)

    # -- one planning step
    def embed_obs(self, ob_img, ob_ang, ob_nav):
        w, ie = self.w, "img_embeddings"
        emb = (self.ln(self.lin(self.drop(ob_img, self.m["feat_dropout"]), f"{ie}.img_linear"),
                       f"{ie}.img_layer_norm")
               + self.ln(self.lin(ob_ang, f"{ie}.ang_linear"), f"{ie}.ang_layer_norm")
               + w["embeddings.token_type_embeddings.weight"][1]
               + w[f"{ie}.nav_type_embedding.weight"][ob_nav])
        return self.drop(self.ln(emb, f"{ie}.layer_norm"), self.m["hidden_dropout_prob"])

    def plan(self, txt, txt_mask, hist, hist_mask, ob_img, ob_ang, ob_nav, ob_mask):
        """(logits (B, N) with -inf at non-actions, state (B, D))."""
        m = self.m
        no_lang_ca = m["no_lang_ca"]
        ext_txt = self.ext(txt_mask)
        ob = self.embed_obs(ob_img, ob_ang, ob_nav)
        visn = torch.cat([hist, ob], dim=1)
        ext_visn = torch.cat([self.ext(hist_mask), self.ext(ob_mask)], dim=-1)
        lang = txt[0] if no_lang_ca else txt
        for i in range(m["num_x_layers"]):
            p = f"encoder.x_layers.{i}"
            if no_lang_ca:
                lang = txt[i]
                lang_x = lang
            else:
                lang_x = self.att_block(f"{p}.visual_attention", "att", lang, visn, ext_visn)
            visn_x = self.att_block(f"{p}.visual_attention", "att", visn, lang, ext_txt)
            if not no_lang_ca:
                lang_x = self.att_block(f"{p}.lang_self_att", "self", lang_x, lang_x, ext_txt)
            visn_x = self.att_block(f"{p}.visn_self_att", "self", visn_x, visn_x, ext_visn)
            if not no_lang_ca:
                lang_x = self.ffn(f"{p}.lang_inter", f"{p}.lang_output", lang_x)
            visn = self.ffn(f"{p}.visn_inter", f"{p}.visn_output", visn_x)
            lang = lang_x
        h = hist.shape[1]
        hist_out, ob_out = visn[:, :h], visn[:, h:]
        head_in = ob_out if no_lang_ca else ob_out * lang[:, :1]
        x = torch.relu(self.lin(head_in, "next_action.net.0"))
        x = self.drop(self.ln(x, "next_action.net.2"), m["pred_head_dropout_prob"])
        logits = self.lin(x, "next_action.net.4").squeeze(-1)
        logits = logits.masked_fill(ob_nav == 0, -math.inf)
        state = hist_out[:, 0] if no_lang_ca else lang[:, 0] * hist_out[:, 0]
        return logits, state

    def critic(self, state):
        x = torch.relu(self.lin(state, "state2value.0", self.cw))
        x = self.drop(x, self.m["critic_dropout"])
        return self.lin(x, "state2value.3", self.cw).squeeze(-1)

