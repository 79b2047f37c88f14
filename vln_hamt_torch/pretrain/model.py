"""Proxy-task pretraining model (torch): the HAMT trunk and the six task
heads, the port of ``vln_hamt_tpu/pretrain/model.py``.

Parity targets: ``pretrain_src/model/vilmodel.py`` (NavPreTrainedModel:
one forward over the text, the whole padded history and, for the action
tasks, the observation) and ``pretrain_src/model/pretrain_cmt.py``
(MultiStepNavCMTPreTraining: per-task heads and losses). The trunk is
the fine-tuning :class:`~vln_hamt_torch.models.hamt.HAMT` without its
action head, under ``bert``; the modules carry the reference's names
(``bert.*``, ``mlm_head.predictions.*``, ``next_action.net.{0,2,4}``,
...), so :meth:`HAMTPretrain.state_dict` is a reference pretrain
``ModelSaver`` file, which ``models/convert.py:load_reference_checkpoint``
reads and fine-tuning grafts (``next_action`` onto the action head).

Every forward has one shape per task (histories padded to
``max_hist_len``, observations to the 37-token pano layout or the
candidate-first width); every attention goes through
``ops/attention.py:fused_attention`` (the CUDA kernels on the card).
Losses are masked means on the device, in fp32 under bfloat16 compute
as well (``ModelConfig.dtype``; the heads run in the compute dtype and
their outputs are cast to fp32 where the JAX package casts them). ITM's
negatives (in-batch indices
and shuffled history orders) come in the batch from the host batcher.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..agents.losses import masked_log_softmax
from ..configs import ModelConfig
from ..data.angle import all_point_angle_feature
from ..models.hamt import HAMT, MLP2Head, init_weights_
from ..models.layers import LayerNorm, Linear, erf_gelu, set_compute_dtype
from ..parallel.mesh import global_sum
from .tasks import TASK_NAMES
from .trajectory_data import IGNORE_ID

Batch = Dict[str, torch.Tensor]


class _Transform(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Predictions(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.transform = _Transform(cfg)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))


class MLMHead(nn.Module):
    """BertOnlyMLMHead (pretrain_cmt.py:96-99, vilmodel.py:288-295):
    dense, erf-GELU, LayerNorm, then the decoder tied to the word
    embeddings, plus a bias. Only ``predictions.transform.*`` and
    ``predictions.bias`` carry weights. The decoder's product runs in the
    compute dtype; its logits are cast to fp32 before the fp32 bias
    (``vln_hamt_tpu/pretrain/model.py:73-76``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.predictions = _Predictions(cfg)

    def forward(self, hidden: torch.Tensor, word_embeddings: torch.Tensor) -> torch.Tensor:
        t = self.predictions.transform
        h = t.LayerNorm(erf_gelu(t.dense(hidden)))
        return (h @ word_embeddings.to(h.dtype).t()).float() + self.predictions.bias


class HAMTPretrain(nn.Module):
    """The trunk and the heads of MultiStepNavCMTPreTraining; one forward
    per task, each returning (loss, aux) with aux the task's metrics as
    device scalars (``n``: the examples or tokens the loss averages).

    Across data-parallel ranks (``data_group``, set by the trainer) a
    training forward divides by the counts of the global batch, summed
    over the group: each rank's loss and metrics are then its part of
    the global batch's, and the parts sum to them (the trainer sums).
    Evaluation divides by its own counts and runs no collective."""

    #: the data-parallel group whose counts the training losses divide by
    data_group = None

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.config = cfg
        d, p = cfg.hidden_size, cfg.pred_head_dropout_prob
        self.bert = HAMT(cfg, action_head=False)
        self.mlm_head = MLMHead(cfg)
        self.next_action = MLP2Head(d, d, 1, p)
        self.regress_action = MLP2Head(d, d, 3, p)  # heading, elevation, progress
        self.sprel_head = MLP2Head(2 * d, d, 2, p)
        self.image_classifier = MLP2Head(d, d, cfg.image_prob_size, None)
        self.itm_head = MLP2Head(d, d, 1, None)
        set_compute_dtype(self, self.bert.compute_dtype)

    # ------------------------------------------------------------------
    def _global(self, count: torch.Tensor) -> torch.Tensor:
        """``count`` summed over the data group in training (the global
        batch's), else itself."""
        return global_sum(count, self.data_group if self.training else None)

    def _count(self, mask: torch.Tensor) -> torch.Tensor:
        return self._global(mask.sum()).clamp(min=1)

    def _history(self, b: Batch, pos_ids: Optional[torch.Tensor] = None):
        """The history steps' embeddings (B, T, D) from the batch."""
        return self.bert.encode_history_seq(b["hist_img"], b["hist_ang"], b.get("hist_pano_img"),
                                            b.get("hist_pano_ang"), pos_ids)

    def _encode(self, b: Batch, with_ob: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """NavPreTrainedModel.forward (vilmodel.py:591-638): the text
        through the text stack, [CLS] and the history tokens, the
        observation for the action tasks, the cross-modal stack over
        [history; observation] against the text. Returns the text, the
        history ([CLS] first) and the observation outputs."""
        bert = self.bert
        txt_ids, txt_mask = b["txt_ids"], b["txt_mask"]
        bsz = txt_ids.shape[0]
        txt = bert.encode_text(txt_ids, txt_mask)
        cls_tok = bert.init_history(bsz)[:, None, :]
        t = b["hist_img"].shape[1]
        pos = torch.arange(t, device=txt_ids.device).expand(bsz, t)
        hist = torch.cat([cls_tok, self._history(b, pos)], dim=1)
        hist_mask = b["hist_mask"]
        hist = bert.run_h_layers(hist, hist_mask)
        if with_ob:
            ob = bert.embed_obs(b["ob_img"], b["ob_ang"], b["ob_nav"])
            visn = torch.cat([hist, ob], dim=1)
            visn_mask = torch.cat([hist_mask, b["ob_mask"]], dim=1)
        else:
            visn, visn_mask = hist, hist_mask
        txt_out, visn_out = bert.fuse(txt, txt_mask, visn, visn_mask)
        h = hist.shape[1]
        return txt_out, visn_out[:, :h], (visn_out[:, h:] if with_ob else None)

    def _weighted(self, b: Batch, per_example: torch.Tensor, correct: torch.Tensor):
        """Mean loss and accuracy over the batch, over the rows that
        ``ex_valid`` keeps when the batch has it (full-split validation's
        wrap-padded rows count nowhere)."""
        if "ex_valid" in b:
            w = b["ex_valid"].float()
            wn = w.sum().clamp(min=1.0)
            return ((per_example * w).sum() / wn,
                    {"acc": (correct.float() * w).sum() / wn, "n": w.sum()})
        if self.data_group is None or not self.training:
            return per_example.mean(), {"acc": correct.float().mean(),
                                        "n": torch.tensor(float(per_example.shape[0]))}
        n = per_example.new_full((), float(per_example.shape[0]))  # no host copy
        total = self._global(n)
        return per_example.sum() / total, {"acc": correct.float().sum() / total, "n": n}

    # ------------------------------------------------------------- MLM
    def forward_mlm(self, b: Batch):
        """Masked LM (pretrain_cmt.py:142-159): cross-entropy over the
        masked tokens; logits at every position (B, L, vocab)."""
        txt_out, _, _ = self._encode(b)
        logits = self.mlm_head(txt_out, self.bert.embeddings.word_embeddings.weight)
        labels = b["txt_labels"]
        valid = labels != IGNORE_ID
        if "ex_valid" in b:
            valid = valid & b["ex_valid"][:, None]
        tgt = torch.where(valid, labels, 0)
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, tgt[..., None]).squeeze(-1)
        n = self._count(valid)
        loss = torch.where(valid, nll, 0.0).sum() / n
        acc = ((logits.argmax(-1) == labels) & valid).sum() / n
        return loss, {"acc": acc, "n": valid.sum()}

    # ------------------------------------------------------------- MRC
    def forward_mrc(self, b: Batch):
        """Masked region classification against the image classifier's
        soft labels: KL over the masked history steps
        (pretrain_cmt.py:224-243)."""
        _, hist_out, _ = self._encode(b)
        logits = self.image_classifier(hist_out[:, 1:])  # [CLS] dropped
        logp = torch.log_softmax(logits.float(), dim=-1)
        targets = b["hist_img_probs"]
        mask = b["hist_mrc_masks"]
        if "ex_valid" in b:
            mask = mask & b["ex_valid"][:, None]
        kl = (targets * (torch.log(targets.clamp(min=1e-12)) - logp)).sum(-1)
        n = self._count(mask)
        loss = torch.where(mask, kl, 0.0).sum() / n
        acc = ((logits.argmax(-1) == targets.argmax(-1)) & mask).sum() / n
        return loss, {"acc": acc, "n": mask.sum()}

    # ------------------------------------------------------------- SAP
    def forward_sap(self, b: Batch):
        """Single-step action prediction, cross-entropy over the
        observation's navigable tokens (pretrain_cmt.py:167-183)."""
        txt_out, _, ob_out = self._encode(b, with_ob=True)
        scores = self.next_action(ob_out * txt_out[:, :1]).squeeze(-1).float()
        scores = scores.masked_fill(b["ob_nav"] == 0, -math.inf)
        labels = b["ob_action_viewindex"]
        nll = -masked_log_softmax(scores).gather(1, labels[:, None]).squeeze(1)
        return self._weighted(b, nll, scores.argmax(-1) == labels)

    # ------------------------------------------------------------- SAR
    def forward_sar(self, b: Batch):
        """Action heading, elevation and progress regression from the
        text [CLS], squared error (pretrain_cmt.py:185-200)."""
        txt_out, _, _ = self._encode(b, with_ob=True)
        pred = self.regress_action(txt_out[:, 0]).float()
        target = torch.cat([b["ob_action_angles"], b["ob_progress"][:, None]], dim=1)
        return self._regression(b, (pred - target) ** 2, ("heading", "elevation", "progress"))

    # ----------------------------------------------------------- SpRel
    def forward_sprel(self, b: Batch):
        """Heading and elevation of the 36 views relative to an anchor
        view, squared error (pretrain_cmt.py:202-222); the observation is
        the pano layout (36 views + STOP)."""
        _, _, ob_out = self._encode(b, with_ob=True)
        anchor = ob_out[torch.arange(ob_out.shape[0], device=ob_out.device),
                        b["sp_anchor_idxs"]][:, None]  # (B, 1, D)
        views = ob_out[:, :-1]  # STOP dropped
        pred = self.sprel_head(torch.cat([anchor.expand_as(views), views], dim=-1)).float()
        return self._regression(b, (pred - b["sp_targets"]) ** 2, ("heading", "elevation"))

    def _regression(self, b: Batch, sq: torch.Tensor, names):
        """Mean squared error and its per-component means (the
        validators' metrics, main_r2r.py:398-453); ``sq`` is (B, C) or
        (B, V, C)."""
        if "ex_valid" in b:
            w = b["ex_valid"].float()
            wn = w.sum().clamp(min=1.0) * (sq.shape[1] if sq.dim() == 3 else 1)
            per_dim = (sq * w.view(-1, *([1] * (sq.dim() - 1)))).sum(
                dim=tuple(range(sq.dim() - 1))) / wn
            n = w.sum()
            loss = per_dim.mean()
        elif self.data_group is None or not self.training:
            per_dim = sq.mean(dim=tuple(range(sq.dim() - 1)))
            n = torch.tensor(float(sq.shape[0]))
            loss = sq.mean()
        else:
            n = sq.new_full((), float(sq.shape[0]))
            count = self._global(n) * (sq.numel() // (sq.shape[0] * sq.shape[-1]))
            per_dim = sq.sum(dim=tuple(range(sq.dim() - 1))) / count
            loss = per_dim.mean()
        aux = {f"{k}_loss": per_dim[i] for i, k in enumerate(names)}
        aux["n"] = n
        return loss, aux

    # ------------------------------------------------------------- ITM
    def forward_itm(self, b: Batch, rows: Optional[Tuple[int, int]] = None):
        """Instruction-trajectory matching (vilmodel.py:640-724,
        pretrain_cmt.py:245-262): the positive pair, in-batch negative
        histories and shuffled-order negatives, a 1-of-(1+K)
        cross-entropy with the positive at 0. The cross-modal stack runs
        over all (1+K) x B pairs at once.

        With ``rows`` = [start, stop) the batch is the global one and the
        rank scores its rows only: every history is encoded, since the
        in-batch negatives index the whole batch, and the ranks'
        gradients sum to the global batch's."""
        bert = self.bert

        def own(x):  # the rank's rows (all of them without ``rows``)
            return x if rows is None else x[rows[0]:rows[1]]

        txt_ids, txt_mask, hist_mask = own(b["txt_ids"]), own(b["txt_mask"]), b["hist_mask"]
        bsz, t = b["hist_img"].shape[:2]
        txt = bert.encode_text(txt_ids, txt_mask)
        cls_tok = bert.init_history(bsz)[:, None, :]
        base = self._history(b)  # position-free

        def with_pos(ids, pick=lambda x: x):
            hist = torch.cat([pick(cls_tok), bert.apply_hist_pos(pick(base), ids)], dim=1)
            return bert.run_h_layers(hist, pick(hist_mask))

        pos_hist = with_pos(torch.arange(t, device=txt_ids.device).expand(bsz, t))
        hists, masks = [own(pos_hist)], [own(hist_mask)]
        if "itm_neg_idxs" in b:  # (B, K1) in-batch negatives
            for k in range(b["itm_neg_idxs"].shape[1]):
                idx = own(b["itm_neg_idxs"])[:, k]
                hists.append(pos_hist[idx])
                masks.append(hist_mask[idx])
        if "itm_shuffled_pos" in b:  # (K2, B, T) shuffled orders
            for ids in b["itm_shuffled_pos"]:
                hists.append(with_pos(own(ids), own))
                masks.append(own(hist_mask))
        bsz = txt_ids.shape[0]
        n = len(hists)
        txt_rep = txt.repeat(1, n, 1, 1) if self.config.no_lang_ca else txt.repeat(n, 1, 1)
        txt_out, hist_out = bert.fuse(txt_rep, txt_mask.repeat(n, 1), torch.cat(hists),
                                      torch.cat(masks))
        scores = self.itm_head(txt_out[:, 0] * hist_out[:, 0]).view(n, bsz).t().float()
        nll = -torch.log_softmax(scores, dim=-1)[:, 0]
        # wrap-padded rows (ex_valid False) still serve as negatives
        valid = {"ex_valid": own(b["ex_valid"])} if "ex_valid" in b else {}
        return self._weighted(valid, nll, scores.argmax(-1) == 0)

    # ------------------------------------------------------------------
    def forward(self, batch: Batch, task: str, feat_table: Optional[torch.Tensor] = None,
                rows: Optional[Tuple[int, int]] = None):
        """Task dispatch (pretrain_cmt.py:101-140). With ``feat_table``
        and an index-mode batch (``hist_node`` present), the feature
        stacks are first gathered on the device from the resident table
        (:func:`expand_index_batch`). ``rows``: ITM's rows of a global
        batch (:meth:`forward_itm`)."""
        if feat_table is not None and "hist_node" in batch:
            batch = expand_index_batch(batch, feat_table, self.config)
        if task not in TASK_NAMES:
            raise ValueError(f"unknown task {task!r}")
        if task == "itm":
            return self.forward_itm(batch, rows)
        if rows is not None:
            raise ValueError(f"only ITM takes the global batch's rows, not {task!r}")
        return getattr(self, f"forward_{task}")(batch)


def expand_index_batch(batch: Batch, feat_table: torch.Tensor, cfg: ModelConfig) -> Batch:
    """Index-mode pretrain batch -> feature-mode batch, on the device.

    The host ships table rows (``hist_node`` (B, H), ``hist_view``,
    ``ob_node`` (B,), ``ob_view`` or ``ob_perm``) and the small angle,
    label and mask arrays; this gathers the (B, H, 36, D) stacks from the
    resident ``feat_table`` (N, 36, image_feat + prob) and reproduces the
    host assembly exactly (``TrajectoryDataset.history_arrays`` /
    ``ob_*_arrays`` and the batcher's MRC input masking and visual /
    angle kills): padded steps zero, MRC-masked step features zero with
    the softmax of the prob tail as labels (r2r_data.py:317-329), the
    STOP token appended, the kills applied, and under the candidate-first
    layout the 37 [views | zero] rows gathered by the host's
    permutation."""
    b = dict(batch)
    d, dev = cfg.image_feat_size, feat_table.device
    ang_tab = torch.as_tensor(all_point_angle_feature(cfg.angle_feat_size),
                              dtype=feat_table.dtype, device=dev)  # (36, 36, A)

    hn, hv = b.pop("hist_node"), b.pop("hist_view")  # (B, H)
    live = torch.arange(hn.shape[1], device=dev)[None, :] < b["hist_len"][:, None]
    rows = feat_table[hn]  # (B, H, 36, D + P)
    sel = rows.gather(2, hv[:, :, None, None].expand(-1, -1, 1, rows.shape[-1]))[:, :, 0]
    hist_img = torch.where(live[..., None], sel[..., :d], 0.0)
    mrc = b.get("hist_mrc_masks")
    if mrc is not None:
        # input-side masking (r2r_tasks.py:138-146) and soft prob labels
        hist_img = torch.where(mrc[..., None], 0.0, hist_img)
        logits = sel[..., d:d + cfg.image_prob_size].float()
        b["hist_img_probs"] = torch.where(live[..., None], torch.softmax(logits, dim=-1), 0.0)
    b["hist_img"] = hist_img
    pano = torch.where(live[..., None, None], rows[..., :d], 0.0)
    if mrc is not None:
        pano = torch.where(mrc[..., None, None], 0.0, pano)
    b["hist_pano_img"] = pano
    b["hist_pano_ang"] = torch.where(live[..., None, None], ang_tab[hv], 0.0)

    if "ob_node" in b:
        views = feat_table[b.pop("ob_node")][..., :d]  # (B, 36, D)
        n_b = views.shape[0]
        padded = torch.cat([views, views.new_zeros((n_b, 1, d))], dim=1)
        if "ob_perm" in b:
            # candidate-first layout: angles, nav types and mask from the host
            perm = b.pop("ob_perm")  # (B, W) in [0, 36]
            ob_img = padded.gather(1, perm[..., None].expand(-1, -1, d))
            ob_ang = b["ob_ang"].to(ang_tab.dtype)
        else:
            ob_img = padded
            ob_ang = torch.cat([ang_tab[b.pop("ob_view")],
                                ang_tab.new_zeros((n_b, 1, cfg.angle_feat_size))], dim=1)
            b["ob_mask"] = torch.ones((n_b, ob_img.shape[1]), dtype=torch.bool, device=dev)
        b["ob_img"] = torch.where(b.pop("ob_kill_v")[:, None, None], 0.0, ob_img)
        b["ob_ang"] = torch.where(b.pop("ob_kill_a")[:, None, None], 0.0, ob_ang)
    return b


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Batch:
    """A host batch as tensors on ``device``: booleans and uint8 (images)
    stay as they are, other integers become int64 (indices), floats
    float32. On the card the copies are issued from pinned memory without
    waiting for them."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        if a.dtype in (np.bool_, np.uint8):
            t = torch.from_numpy(np.ascontiguousarray(a))
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
        else:
            t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t.to(dev)
    return out


def init_pretrain(cfg: ModelConfig, seed: int = 0) -> HAMTPretrain:
    """A :class:`HAMTPretrain` on the CPU, initialized from ``seed`` with
    flax's default initializers (``models/hamt.py:init_weights_``; the MLM
    bias zero), built on the meta device first so that nothing is drawn
    from torch's global generator."""
    with torch.device("meta"):
        model = HAMTPretrain(cfg)
    model.to_empty(device="cpu")
    init_weights_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.mlm_head.predictions.bias.zero_()
    return model
