"""HAMT — History Aware Multimodal Transformer (torch), the port of
``vln_hamt_tpu/models/hamt.py``.

Parity target: the reference NavCMT (``finetune_src/models/
vilmodel_cmt.py:610-728``) and its ``Critic`` (``finetune_src/models/
model_HAMT.py``). Submodules carry the reference's names, so
``HAMT.state_dict()`` is a NavCMT state dict: released reference
weights load by name, and ``vln_hamt_tpu/models/convert.py:
convert_navcmt_state_dict`` maps it onto the JAX package's params.
The reference's three string-dispatched forward modes are explicit
methods:

- :meth:`HAMT.encode_text`     — once per episode (mode='language')
- :meth:`HAMT.encode_history`  — one history token per step (mode='history')
- :meth:`HAMT.plan`            — cross-modal step -> action logits + state
                                 (mode='visual'); history arrives as a fixed
                                 (B, T_max+1, D) cache with a length mask.
- :meth:`HAMT.plan_ref`        — REVERIE's step (NavRefCMT,
                                 ``reverie/vlnbert_navref.py``): the objects
                                 join the visual stream, and an object head
                                 scores them beside the action logits; the
                                 model has ``obj_embeddings`` and
                                 ``ref_object`` when ``obj_feat_size > 0``.

Pretraining (``pretrain/model.py``) reads the whole history at once
through :meth:`HAMT.encode_history_seq`, :meth:`HAMT.apply_hist_pos`,
:meth:`HAMT.run_h_layers` and :meth:`HAMT.fuse`, which share their
parameters with the per-step methods; its trunk is built without the
action head (``action_head=False``), whose pretraining twin is a head
of its own.

The model computes in ``ModelConfig.dtype``, float32 or bfloat16 (the
JAX package's ``dtype`` / ``param_dtype=float32`` split, see
``models/layers.py``): in bfloat16 the text and history streams, the
masks and the heads' activations are bf16 while the parameters, the
action logits, the state and the critic's value stay fp32, with the
casts where the JAX package puts them. ``.train()`` turns on the dropouts of the JAX
package (hidden, attention-probability, feature, action-head and critic
dropout; see ``models/layers.py`` for where the random draws come
from), ``.eval()`` turns them off. The ``fix_*`` flags stop gradients as
the JAX package's ``stop_gradient`` calls do, by running the frozen part
under ``torch.no_grad()`` (same gradients, no saved activations).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..configs import ModelConfig
from .layers import (CrossModalLayer, Dropout, Embedding, LayerNorm, Linear,
                     TransformerLayer, TransformerStack, compute_dtype, extend_mask,
                     run_layers, set_compute_dtype)


def _ln(d: int) -> LayerNorm:
    return LayerNorm(d, eps=1e-12)


def _frozen(flag: bool):
    """No gradient through the block when ``flag`` (a stop_gradient on
    its output in the JAX package)."""
    return torch.no_grad() if flag else contextlib.nullcontext()


class TextEmbeddings(nn.Module):
    """word + position + token-type embeddings (vilmodel_cmt.py:39-68).

    The token-type table is shared with observation embeddings (obs
    tokens use type id 1, vilmodel_cmt.py:681-684).
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = Embedding(cfg.vocab_size, d)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, d)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, d)
        self.LayerNorm = LayerNorm(d, eps=cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, txt_ids: torch.Tensor) -> torch.Tensor:
        l = txt_ids.shape[1]
        if l > self.position_embeddings.num_embeddings:
            raise ValueError(f"text length {l} exceeds the position table "
                             f"({self.position_embeddings.num_embeddings})")
        pos_ids = torch.arange(l, device=txt_ids.device)[None, :]
        emb = (self.word_embeddings(txt_ids)
               + self.position_embeddings(pos_ids)
               + self.token_type_embeddings(torch.zeros_like(txt_ids)))
        return self.dropout(self.LayerNorm(emb))


class Encoder(nn.Module):
    """LxmertEncoder (vilmodel_cmt.py:426-452): text, history-only,
    obs-only and cross-modal stacks."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.layer = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_l_layers))
        self.h_layers = (nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_h_layers))
                         if cfg.num_h_layers > 0 else None)
        self.r_layers = (nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_r_layers))
                         if cfg.num_r_layers > 0 else None)
        self.x_layers = nn.ModuleList(CrossModalLayer(cfg) for _ in range(cfg.num_x_layers))


class ImageEmbeddings(nn.Module):
    """Observation embeddings (vilmodel_cmt.py:498-521)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.hidden_size
        self.img_linear = Linear(cfg.image_feat_size, d)
        self.img_layer_norm = _ln(d)
        self.ang_linear = Linear(cfg.angle_feat_size, d)
        self.ang_layer_norm = _ln(d)
        self.nav_type_embedding = Embedding(3, d)
        self.layer_norm = _ln(d)


class HistoryEmbeddings(nn.Module):
    """History embeddings (vilmodel_cmt.py:523-594)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))  # fp32 in every dtype
        self.img_linear = Linear(cfg.image_feat_size, d)
        self.img_layer_norm = _ln(d)
        self.ang_linear = Linear(cfg.angle_feat_size, d)
        self.ang_layer_norm = _ln(d)
        self.position_embeddings = Embedding(cfg.max_action_steps, d)
        self.type_embedding = Embedding(1, d)
        self.layer_norm = _ln(d)
        if cfg.hist_enc_pano:
            self.pano_img_linear = Linear(cfg.image_feat_size, d)
            self.pano_img_layer_norm = _ln(d)
            self.pano_ang_linear = Linear(cfg.angle_feat_size, d)
            self.pano_ang_layer_norm = _ln(d)
            self.pano_encoder = TransformerStack(cfg, cfg.num_h_pano_layers)


class ObjectEmbeddings(nn.Module):
    """REVERIE's object embeddings (reverie/vlnbert_navref.py:12-42)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.hidden_size
        self.img_linear = Linear(cfg.obj_feat_size, d)
        self.img_layer_norm = _ln(d)
        self.ang_linear = Linear(cfg.angle_feat_size, d)
        self.ang_layer_norm = _ln(d)
        self.pos_linear = Linear(cfg.obj_loc_size, d)
        self.pos_layer_norm = _ln(d)
        self.layer_norm = _ln(d)


class MLP2Head(nn.Module):
    """dense -> ReLU -> LN -> [dropout ->] dense, as ``net``: the action
    head (NextActionPrediction, vilmodel_cmt.py:597-607) and the
    pretraining heads (pretrain_cmt.py:13-71); net.0, net.2 and net.4, or
    net.3 without the dropout."""

    def __init__(self, d_in: int, d: int, out: int, dropout: Optional[float]):
        super().__init__()
        layers = [Linear(d_in, d), nn.ReLU(), _ln(d)]
        if dropout is not None:
            layers.append(Dropout(dropout))
        self.net = nn.Sequential(*layers, Linear(d, out))

    def forward(self, x):
        return self.net(x)


class HAMT(nn.Module):
    def __init__(self, cfg: ModelConfig, action_head: bool = True):
        super().__init__()
        self.config = cfg
        self.compute_dtype = compute_dtype(cfg)
        self.embeddings = TextEmbeddings(cfg)
        self.encoder = Encoder(cfg)
        self.img_embeddings = ImageEmbeddings(cfg)
        self.hist_embeddings = HistoryEmbeddings(cfg)
        d = cfg.hidden_size
        self.next_action = MLP2Head(d, d, 1, cfg.pred_head_dropout_prob) if action_head else None
        # REVERIE's object grounding (reverie/vlnbert_navref.py:12-56)
        if cfg.obj_feat_size > 0:
            self.obj_embeddings = ObjectEmbeddings(cfg)
            self.ref_object = MLP2Head(d, d, 1, cfg.pred_head_dropout_prob)
        else:
            self.obj_embeddings = self.ref_object = None
        self.hidden_dropout = Dropout(cfg.hidden_dropout_prob)
        self.feat_drop = Dropout(cfg.feat_dropout)  # visual features (model_HAMT.py:18)
        set_compute_dtype(self, self.compute_dtype)

    # ------------------------------------------------------------------
    def encode_text(self, txt_ids: torch.Tensor, txt_mask: torch.Tensor) -> torch.Tensor:
        """mode='language' (vilmodel_cmt.py:632-653).

        Returns (B, L, D), or (X+1, B, L, D) stacked per-x-layer language
        states when ``no_lang_ca`` (precomputed lang stream). A REVERIE
        model (``obj_feat_size > 0``) returns (1, B, L, D) under
        ``no_lang_ca``: NavRefCMT's language mode has no per-layer states
        (reverie/vlnbert_navref.py:69-84) and :meth:`plan_ref` reads the
        initial encoding only, so the per-layer stack the JAX package
        computes and drops is not computed here.
        """
        cfg = self.config
        ext = extend_mask(txt_mask, self.compute_dtype)
        with _frozen(cfg.fix_lang_embedding or not cfg.update_lang_bert):
            x = self.embeddings(txt_ids)
            x = run_layers(self.encoder.layer, x, ext)
        if cfg.no_lang_ca and self.ref_object is not None:
            return x[None]
        if cfg.no_lang_ca:
            all_states = [x]
            for layer in self.encoder.x_layers:
                x = layer.lang_only(x, ext)
                all_states.append(x)
            return torch.stack(all_states, dim=0)
        return x

    # ------------------------------------------------------------------
    def init_history(self, batch_size: int) -> torch.Tensor:
        """The global [CLS] history token (vilmodel_cmt.py:569-572)."""
        he = self.hist_embeddings
        with _frozen(self.config.fix_hist_embedding):
            type_ids = torch.zeros(batch_size, dtype=torch.long, device=he.cls_token.device)
            cls = he.cls_token.view(1, -1).to(self.compute_dtype) + he.type_embedding(type_ids)
            return self.hidden_dropout(he.layer_norm(cls))

    def encode_history(
        self,
        hist_img: torch.Tensor,  # (B, D_img) current-view feature
        hist_ang: torch.Tensor,  # (B, A) chosen-action angle feature
        step,  # int, 0-d or (B,) integer tensor: the step id
        pano_img: Optional[torch.Tensor] = None,  # (B, V, D_img)
        pano_ang: Optional[torch.Tensor] = None,  # (B, V, A)
    ) -> torch.Tensor:
        """One per-step history token (vilmodel_cmt.py:574-594)."""
        he = self.hist_embeddings
        b = hist_img.shape[0]
        if isinstance(step, int):
            if not 0 <= step < he.position_embeddings.num_embeddings:
                raise ValueError(f"history step {step} outside the position "
                                 f"table ({he.position_embeddings.num_embeddings})")
            step = torch.tensor(step, device=hist_img.device)
        step = step.to(torch.long).expand(b)
        with _frozen(self.config.fix_hist_embedding):
            emb = (he.img_layer_norm(he.img_linear(self.feat_drop(hist_img)))
                   + he.ang_layer_norm(he.ang_linear(hist_ang))
                   + he.position_embeddings(step)
                   + he.type_embedding(torch.zeros_like(step)))
            if self.config.hist_enc_pano:
                pano = (he.pano_img_layer_norm(he.pano_img_linear(self.feat_drop(pano_img)))
                        + he.pano_ang_layer_norm(he.pano_ang_linear(pano_ang)))
                # reference passes an all-zeros additive mask (attend all 36)
                pano = he.pano_encoder(self.hidden_dropout(pano), None)
                emb = emb + pano.mean(dim=1)
            return self.hidden_dropout(he.layer_norm(emb))

    def encode_history_seq(
        self,
        hist_img: torch.Tensor,  # (B, T, D_img)
        hist_ang: torch.Tensor,  # (B, T, A)
        pano_img: Optional[torch.Tensor] = None,  # (B, T, V, D_img)
        pano_ang: Optional[torch.Tensor] = None,  # (B, T, V, A)
        pos_ids: Optional[torch.Tensor] = None,  # (B, T); None: no position
    ) -> torch.Tensor:
        """The whole history at once, for pretraining (pretrain
        vilmodel.py HistoryEmbeddings.forward, :540-575). The panorama
        encoder runs over the (B*T, V, D) stack of every step, padded
        steps included (they carry zero features, not a mask).

        With ``pos_ids=None`` returns the position-free base embedding
        (ITM's shuffled-order negatives reuse it); :meth:`apply_hist_pos`
        adds the positions."""
        he = self.hist_embeddings
        b, t = hist_img.shape[:2]
        type_ids = torch.zeros((b, t), dtype=torch.long, device=hist_img.device)
        emb = (he.img_layer_norm(he.img_linear(self.feat_drop(hist_img)))
               + he.ang_layer_norm(he.ang_linear(hist_ang))
               + he.type_embedding(type_ids))
        if self.config.hist_enc_pano and pano_img is not None:
            pano = (he.pano_img_layer_norm(he.pano_img_linear(self.feat_drop(pano_img)))
                    + he.pano_ang_layer_norm(he.pano_ang_linear(pano_ang)))
            v = pano.shape[2]
            pano = he.pano_encoder(pano.reshape(b * t, v, -1), None)
            emb = emb + pano.view(b, t, v, -1).mean(dim=2)
        if pos_ids is None:
            return emb
        return self.apply_hist_pos(emb, pos_ids)

    def apply_hist_pos(self, base_emb: torch.Tensor, pos_ids: torch.Tensor) -> torch.Tensor:
        """Position, LayerNorm and dropout over a position-free history
        embedding (pretrain vilmodel.py:568-571; ITM's shuffles :702-704)."""
        he = self.hist_embeddings
        return self.hidden_dropout(he.layer_norm(base_emb + he.position_embeddings(pos_ids)))

    def run_h_layers(self, hist_tokens: torch.Tensor, hist_mask: torch.Tensor) -> torch.Tensor:
        """The history-only stack, if the model has one."""
        if self.encoder.h_layers is None:
            return hist_tokens
        return run_layers(self.encoder.h_layers, hist_tokens,
                          extend_mask(hist_mask, self.compute_dtype))

    def fuse(self, txt_embeds: torch.Tensor, txt_mask: torch.Tensor, visn: torch.Tensor,
             visn_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cross-modal stack over any embedded visual stream (pretrain
        path: LxmertEncoder.forward, vilmodel.py:486-494). ``txt_embeds``
        is (B, L, D), or under ``no_lang_ca`` the (X+1, B, L, D) stack of
        :meth:`encode_text`, whose layer ``i`` reads state ``i``; masks
        are (B, L) and (B, M) booleans. Returns (text, visual) outputs."""
        dt = self.compute_dtype
        return self._x_layers(txt_embeds, extend_mask(txt_mask, dt), visn,
                              extend_mask(visn_mask, dt))

    def _x_layers(self, txt_embeds, ext_txt, visn, ext_visn):
        no_lang_ca = self.config.no_lang_ca
        lang = txt_embeds[0] if no_lang_ca else txt_embeds
        for li, layer in enumerate(self.encoder.x_layers):
            if no_lang_ca:
                lang = txt_embeds[li]
            lang, visn = layer(lang, ext_txt, visn, ext_visn)
        return lang, visn

    # ------------------------------------------------------------------
    def embed_obs(self, ob_img, ob_ang, ob_nav) -> torch.Tensor:
        """ImageEmbeddings (vilmodel_cmt.py:498-521): obs token type = 1."""
        ie = self.img_embeddings
        type_emb = self.embeddings.token_type_embeddings(torch.ones_like(ob_nav))
        emb = (ie.img_layer_norm(ie.img_linear(self.feat_drop(ob_img)))
               + ie.ang_layer_norm(ie.ang_linear(ob_ang))
               + type_emb
               + ie.nav_type_embedding(ob_nav))
        return self.hidden_dropout(ie.layer_norm(emb))

    def plan(
        self,
        txt_embeds: torch.Tensor,  # (B, L, D) or (X+1, B, L, D) if no_lang_ca
        txt_mask: torch.Tensor,  # (B, L) bool
        hist_tokens: torch.Tensor,  # (B, H, D) fixed-size history cache
        hist_mask: torch.Tensor,  # (B, H) bool
        ob_img: torch.Tensor,  # (B, N, D_img)
        ob_ang: torch.Tensor,  # (B, N, A)
        ob_nav: torch.Tensor,  # (B, N) int
        ob_mask: torch.Tensor,  # (B, N) bool
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """mode='visual' (vilmodel_cmt.py:663-728): one planning step.

        Returns (act_logits (B, N), state (B, D)). Invalid actions
        (nav type 0) get -inf logits; state is txt[CLS] * hist[CLS]
        (model_HAMT.py:63) or hist[CLS] under no_lang_ca.
        """
        cfg = self.config
        enc = self.encoder
        dt = self.compute_dtype
        ext_hist = extend_mask(hist_mask, dt)
        ext_ob = extend_mask(ob_mask, dt)
        ext_txt = extend_mask(txt_mask, dt)

        hist = hist_tokens
        if enc.h_layers is not None:
            hist = run_layers(enc.h_layers, hist, ext_hist)
        with _frozen(cfg.fix_obs_embedding):
            ob = self.embed_obs(ob_img, ob_ang, ob_nav)
            if enc.r_layers is not None:
                ob = run_layers(enc.r_layers, ob, ext_ob)

        h = hist_tokens.shape[1]
        visn = torch.cat([hist, ob], dim=1)
        visn_mask = torch.cat([ext_hist, ext_ob], dim=-1)

        lang, visn = self._x_layers(txt_embeds, ext_txt, visn, visn_mask)

        hist_out = visn[:, :h]
        ob_out = visn[:, h:]

        # action head (vilmodel_cmt.py:714-726)
        if cfg.no_lang_ca or cfg.act_pred_token == "ob":
            head_in = ob_out
        elif cfg.act_pred_token == "ob_txt":
            head_in = ob_out * lang[:, :1]
        elif cfg.act_pred_token == "ob_hist":
            head_in = ob_out * hist_out[:, :1]
        elif cfg.act_pred_token == "ob_txt_hist":
            head_in = ob_out * (lang[:, :1] + hist_out[:, :1])
        else:
            raise ValueError(f"bad act_pred_token {cfg.act_pred_token!r}")

        logits = self.next_action(head_in).squeeze(-1).float()
        logits = logits.masked_fill(ob_nav == 0, -math.inf)

        if cfg.no_lang_ca:
            state = hist_out[:, 0]
        else:
            state = lang[:, 0] * hist_out[:, 0]
        return logits, state.float()


    # ------------------------------------------------------------------
    def embed_objects(self, obj_fts, obj_angs, obj_pos) -> torch.Tensor:
        """ObjectEmbeddings (reverie/vlnbert_navref.py:31-42): objects carry
        token type 1 (visual) and nav type 2 (stop-like)."""
        oe = self.obj_embeddings
        b, k = obj_fts.shape[:2]
        ones = torch.ones((b, k), dtype=torch.long, device=obj_fts.device)
        emb = (oe.img_layer_norm(oe.img_linear(self.feat_drop(obj_fts)))
               + oe.ang_layer_norm(oe.ang_linear(obj_angs))
               + oe.pos_layer_norm(oe.pos_linear(obj_pos))
               + self.img_embeddings.nav_type_embedding(2 * ones)
               + self.embeddings.token_type_embeddings(ones))
        return self.hidden_dropout(oe.layer_norm(emb))

    def plan_ref(self, txt_embeds, txt_mask, hist_tokens, hist_mask, ob_img, ob_ang, ob_nav,
                 ob_mask, obj_fts, obj_angs, obj_pos, obj_mask
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """REVERIE's planning step (reverie/vlnbert_navref.py:90-158): the
        cross-modal stack over [history; observation; objects], the
        action head over the observation tokens (ob * hist[CLS]) and the
        object head over the object tokens (obj * txt[CLS]).

        Returns (act_logits (B, N), obj_logits (B, K), state (B, D));
        invalid actions and absent objects get -inf. The caller appends
        the largest object logit as the STOP action (reverie/agent.py:
        251-254). Under ``no_lang_ca`` every cross-modal layer and the
        object head see the initial text encoding ``txt_embeds[0]``: the
        layers pass the text stream through unchanged, as NavRefCMT does.
        """
        cfg = self.config
        enc = self.encoder
        dt = self.compute_dtype
        ext_hist = extend_mask(hist_mask, dt)
        ext_ob = extend_mask(ob_mask, dt)
        ext_obj = extend_mask(obj_mask, dt)
        ext_txt = extend_mask(txt_mask, dt)

        hist = hist_tokens
        if enc.h_layers is not None:
            hist = run_layers(enc.h_layers, hist, ext_hist)
        ob = self.embed_obs(ob_img, ob_ang, ob_nav)
        if enc.r_layers is not None:
            ob = run_layers(enc.r_layers, ob, ext_ob)
        obj = self.embed_objects(obj_fts, obj_angs, obj_pos)

        h, n = hist.shape[1], ob.shape[1]
        visn = torch.cat([hist, ob, obj], dim=1)
        visn_mask = torch.cat([ext_hist, ext_ob, ext_obj], dim=-1)
        lang = txt_embeds[0] if cfg.no_lang_ca else txt_embeds
        for layer in enc.x_layers:
            lang, visn = layer(lang, ext_txt, visn, visn_mask)

        hist_out, ob_out, obj_out = visn[:, :h], visn[:, h:h + n], visn[:, h + n:]
        act_logits = self.next_action(ob_out * hist_out[:, :1]).squeeze(-1).float()
        act_logits = act_logits.masked_fill(ob_nav == 0, -math.inf)
        obj_logits = self.ref_object(obj_out * lang[:, :1]).squeeze(-1).float()
        obj_logits = obj_logits.masked_fill(~obj_mask, -math.inf)
        state = hist_out[:, 0] if cfg.no_lang_ca else lang[:, 0] * hist_out[:, 0]
        return act_logits, obj_logits, state.float()


class Critic(nn.Module):
    """768 -> 512 -> 1 value head (model_HAMT.py:258-269): state2value.0
    dense, .1 ReLU, .2 dropout, .3 dense."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.state2value = nn.Sequential(Linear(cfg.hidden_size, 512), nn.ReLU(),
                                         Dropout(cfg.critic_dropout), Linear(512, 1))
        set_compute_dtype(self, compute_dtype(cfg))

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        return self.state2value(state).squeeze(-1).float()


# ----------------------------------------------------------------------
@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers, drawn from ``generator``:
    Dense kernels lecun-normal (truncated at 2 std), biases zero, Embed
    tables normal with variance 1/D, LayerNorm ones/zeros, and the
    history [CLS] token zero (``vln_hamt_tpu/models/hamt.py:109-111``).
    """
    for m in module.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, math.sqrt(1.0 / m.embedding_dim),
                            generator=generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, HistoryEmbeddings):
            nn.init.zeros_(m.cls_token)


def init_hamt(cfg: ModelConfig, seed: int = 0) -> Tuple[HAMT, Critic]:
    """A HAMT and a Critic on the CPU, initialized from ``seed``.

    Built on the meta device first, so construction draws nothing from
    torch's global generator; every weight comes from one seeded
    ``torch.Generator`` and is the same on every machine.
    """
    with torch.device("meta"):
        model, critic = HAMT(cfg), Critic(cfg)
    model.to_empty(device="cpu")
    critic.to_empty(device="cpu")
    g = torch.Generator().manual_seed(seed)
    init_weights_(model, g)
    init_weights_(critic, g)
    return model, critic
