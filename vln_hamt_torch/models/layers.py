"""Transformer building blocks (torch), the port of
``vln_hamt_tpu/models/layers.py``.

Numerical parity targets with the reference BERT/LXMERT blocks
(``finetune_src/models/vilmodel_cmt.py``):
- erf-based GELU (vilmodel_cmt.py:22-28), NOT the tanh approximation
- LayerNorm eps 1e-12
- additive attention masks of ``(1 - mask) * -10000`` (vilmodel_cmt.py:
  634-636) rather than -inf fills, so converted checkpoints reproduce
  reference logits
- post-LN residual blocks (BertSelfOutput / BertOutput)

Modules are named after the reference's so that a port ``state_dict``
is a reference NavCMT state dict (``models/convert.py``). Every
attention goes through :func:`vln_hamt_torch.ops.fused_attention`: the
CUDA kernels on the card, their plain torch twins on the CPU.

Compute dtype (``ModelConfig.dtype``) follows flax's ``dtype=bfloat16,
param_dtype=float32``: parameters stay fp32 ``nn.Parameter``s under
their reference names (so ``models/convert.py``, checkpoints and the
optimizers see fp32 alone) and :class:`Linear`, :class:`LayerNorm` and
:class:`Embedding` cast at the point of use: a Linear casts its input to
the compute dtype and takes its weight and bias in it from a cache made
once per weight version (so once per pass over the weights, and one
cache serves a whole evaluation), a LayerNorm takes its statistics in
fp32 and returns the compute dtype (flax 0.12's
``force_float32_reductions``), an Embedding returns its rows in it.
:func:`set_compute_dtype` hands the dtype to every such module below a
model; in fp32 every cast is a no-op and no cache is made. Two
elementwise chains run in fp32 and round once, as XLA's fusions do: the
GELU and the residual sum before each post-LN
(``tests/test_torch_bf16.py`` holds the result against the JAX
package's bf16). The bf16 GELU saves its bf16 input for backward and
recomputes the fp32 chain there. The bf16 results and gradients are
bit-identical to casting the weights on every call
(``tests/test_torch_bf16_cache.py``).

Dropout follows ``nn.Module.train()`` / ``.eval()``. In training mode
every draw comes from the :class:`DropoutRNG` that
:func:`set_dropout_rng` hands to the modules (the agent owns it), never
from torch's global generator: :class:`Dropout` masks from its device
generator, the attention kernels' 32-bit counter-hash seeds from its CPU
generator, so choosing a seed never reads the card.

Tensor parallelism (``parallel/mesh.py:shard_model``) splits the
attentions' query / key / value and the feed-forwards' first dense by
output features and the output denses by input features across a model
group, Megatron's layout: each split block enters through
:class:`_CopyToModel` (identity forward, all-reduce of the cotangent)
and leaves through the row-parallel :class:`Linear`'s all-reduce
(:class:`_ReduceFromModel`), its bias added once after the reduce. The
attention then runs its rank's ``heads / model_shards`` heads through
the kernels. The bf16 weight cache casts the rank's block.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..configs import ModelConfig
from ..ops.attention import fused_attention


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The activations' dtype of ``cfg``: bfloat16 or float32."""
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute dtype {cfg.dtype!r}: float32 or bfloat16")
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class _CachedCast(torch.autograd.Function):
    """A parameter's cached low-precision copy as a function of the
    parameter: the forward returns the copy, the backward casts the
    call's cotangent to the parameter's fp32. Each call is a node of its
    own, so the calls' weight gradients sum in fp32 in ``.grad``, as the
    per-call cast's do (a bare cached copy would sum them in bf16)."""

    @staticmethod
    def forward(ctx, param: torch.Tensor, cached: torch.Tensor) -> torch.Tensor:
        return cached.view_as(cached)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.to(torch.float32), None


class _CopyToModel(torch.autograd.Function):
    """Entry of a tensor-parallel block: identity forward, the
    cotangent summed over the model group in backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Exit of a tensor-parallel block: the partial sums summed over the
    model group forward, the cotangent passed through in backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


class Linear(nn.Linear):
    """``nn.Linear`` in the compute dtype (flax ``nn.Dense``): the input
    cast on every call; below fp32 the weight and bias from
    :meth:`low_precision_params`. A row-parallel layer (``reduce_group``
    set) sums its product over the group before adding its bias."""

    compute_dtype = torch.float32
    reduce_group = None
    _cache: Optional[Tuple[tuple, torch.Tensor, torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w, b = ((self.weight, self.bias) if dt == torch.float32
                else self.low_precision_params())
        if self.reduce_group is None:
            return F.linear(x.to(dt), w, b)
        return _ReduceFromModel.apply(F.linear(x.to(dt), w), self.reduce_group) + b

    def low_precision_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The weight and bias in the compute dtype, cast once per version
        of the parameters: an in-place change (an optimizer step, a
        ``load_state_dict``) bumps the version and the next call casts
        anew, so a stale copy is never used; :func:`drop_weight_cache`
        frees the copies at once. Under autograd each copy enters through
        :class:`_CachedCast`."""
        w, b, dt = self.weight, self.bias, self.compute_dtype
        key = (dt, w._version, b._version, w.data_ptr(), b.data_ptr())
        if self._cache is None or self._cache[0] != key:
            with torch.no_grad():
                self._cache = (key, w.to(dt), b.to(dt))
        _, wc, bc = self._cache
        if torch.is_grad_enabled() and w.requires_grad:
            return _CachedCast.apply(w, wc), _CachedCast.apply(b, bc)
        return wc, bc


def drop_weight_cache(module: nn.Module) -> None:
    """Free the low-precision weight copies of every :class:`Linear` below
    ``module`` (after its weights change; the next pass casts anew)."""
    for m in module.modules():
        if isinstance(m, Linear):
            m._cache = None


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with fp32 statistics and affine terms, returning
    the compute dtype (flax ``nn.LayerNorm`` with ``dtype``)."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


class Embedding(nn.Embedding):
    """``nn.Embedding`` whose rows come out in the compute dtype (flax
    ``nn.Embed`` with ``dtype``)."""

    compute_dtype = torch.float32

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Hand the compute dtype to every casting module below ``module``."""
    for m in module.modules():
        if isinstance(m, (Linear, LayerNorm, Embedding)):
            m.compute_dtype = dtype


def _gelu_chain(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


class _LowPrecisionGelu(torch.autograd.Function):
    """:func:`erf_gelu` below fp32: saves its input in its own dtype and
    reruns the fp32 chain under autograd in backward, so the gradient is
    the plain chain's to the bit and no fp32 copy waits for backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return _gelu_chain(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            return torch.autograd.grad(_gelu_chain(xd), xd, grad)[0]


def erf_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * 0.5 * (1 + erf(x / sqrt(2))) — parity vilmodel_cmt.py:22-28 —
    returned in x's dtype, computed in fp32: one rounding where eager bf16
    would round each of its four ops (XLA fuses the chain; rounding each
    op makes the bf16 logits' distance from fp32 half as large again)."""
    if x.dtype == torch.float32 or not (torch.is_grad_enabled() and x.requires_grad):
        return _gelu_chain(x)
    return _LowPrecisionGelu.apply(x)


ACT2FN = {"gelu": erf_gelu, "relu": torch.relu, "swish": nn.functional.silu}


#: seed distance between two ranks' dropout streams
STREAM_STRIDE = 1_000_003


class DropoutRNG:
    """The random streams of training-mode dropout: ``masks``, a generator
    on the compute device for dropout masks, and ``seeds``, a CPU
    generator for the attention kernels' 32-bit seeds. ``streams`` =
    (mask stream, seed stream) offsets them per rank
    (``parallel/mesh.py:Mesh.dropout_streams``); (0, 0) is one rank's."""

    def __init__(self, device: Union[str, torch.device], seed: int,
                 streams: Tuple[int, int] = (0, 0)):
        self.masks = torch.Generator(device=device).manual_seed(
            seed + STREAM_STRIDE * streams[0])
        self.seeds = torch.Generator().manual_seed(seed + 1 + STREAM_STRIDE * streams[1])

    def keep(self, x: torch.Tensor, p: float) -> torch.Tensor:
        """A keep mask like ``x`` with ones at probability ``1 - p``."""
        return torch.empty_like(x).bernoulli_(1.0 - p, generator=self.masks)

    def attention_seed(self) -> int:
        return int(torch.randint(0, 2**32, (), generator=self.seeds))

    def get_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both streams' positions: :meth:`set_state` of them makes the
        next draws repeat the ones that followed (the replay of a
        rollout's dropout)."""
        return self.masks.get_state(), self.seeds.get_state()

    def set_state(self, state: Tuple[torch.Tensor, torch.Tensor]) -> None:
        self.masks.set_state(state[0])
        self.seeds.set_state(state[1])


def _rng(module: nn.Module) -> DropoutRNG:
    if module.rng is None:
        raise RuntimeError(f"{type(module).__name__} in training mode needs a DropoutRNG "
                           "(models.layers.set_dropout_rng)")
    return module.rng


class Dropout(nn.Module):
    """``nn.Dropout`` with its mask drawn from a :class:`DropoutRNG`."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.rng: Optional[DropoutRNG] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        return x * _rng(self).keep(x, self.p) * (1.0 / (1.0 - self.p))


def extend_mask(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, L) bool/int -> (B, 1, 1, L) additive mask with -10000 at pads,
    built in ``dtype`` (bfloat16 rounds it to -9984, as the JAX
    package's)."""
    m = mask.to(dtype)
    return ((1.0 - m) * -10000.0)[:, None, None, :]


class MultiHeadAttention(nn.Module):
    """Q from `hidden`, K/V from `context` (self-attn when identical).

    Covers BertSelfAttention (vilmodel_cmt.py:71-129) and BertOutAttention
    (297-348); the reference's separate classes are the same math.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.num_heads, self.head_dim = cfg.num_attention_heads, cfg.head_dim
        self.dropout_prob = cfg.attention_probs_dropout_prob
        self.rng: Optional[DropoutRNG] = None
        self.tp_group = None  # tensor parallelism: this rank's heads
        width = self.num_heads * self.head_dim
        self.query = Linear(cfg.hidden_size, width)
        self.key = Linear(cfg.hidden_size, width)
        self.value = Linear(cfg.hidden_size, width)

    def forward(self, hidden: torch.Tensor, context: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, lq, _ = hidden.shape
        lk = context.shape[1]
        h, dh = self.num_heads, self.head_dim
        entry = copy_to_model(hidden, self.tp_group)
        context = entry if context is hidden else copy_to_model(context, self.tp_group)
        hidden = entry
        # (B, L, H, Dh) projections seen as (B, H, L, Dh) strided views:
        # the kernel reads them in place, no transpose copies
        q = self.query(hidden).view(b, lq, h, dh).transpose(1, 2)
        k = self.key(context).view(b, lk, h, dh).transpose(1, 2)
        v = self.value(context).view(b, lk, h, dh).transpose(1, 2)
        if attn_mask is None:
            add_mask = hidden.new_zeros((b, lk), dtype=torch.float32)
        else:
            add_mask = attn_mask.reshape(attn_mask.shape[0], -1)
        # attention-probability dropout runs inside the kernel, keyed by
        # a fresh seed per call (layers.py:74-97 of the JAX package); the
        # fp32 output takes the compute dtype (layers.py:96)
        rate = self.dropout_prob if self.training else 0.0
        seed = _rng(self).attention_seed() if rate > 0.0 else None
        out = fused_attention(q, k, v, add_mask, rate, seed)
        return out.transpose(1, 2).reshape(b, lq, h * dh).to(hidden.dtype)


class AttnOutput(nn.Module):
    """dense -> dropout -> LN(x + residual): BertSelfOutput (:132-143), and
    BertOutput (:171-185) when it follows an :class:`Intermediate`."""

    def __init__(self, cfg: ModelConfig, in_size: Optional[int] = None):
        super().__init__()
        self.dense = Linear(in_size or cfg.hidden_size, cfg.hidden_size)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        # the residual sum in fp32, fused into the LayerNorm as XLA fuses it
        return self.LayerNorm(self.dropout(self.dense(x)).float() + residual.float())


class Attention(nn.Module):
    """MHA + output projection/LN (BertAttention / BertXAttention).

    The reference names the attention ``self`` in BertAttention and
    ``att`` in BertXAttention; ``cross`` picks the name so state dicts
    match.
    """

    def __init__(self, cfg: ModelConfig, cross: bool = False):
        super().__init__()
        self._att_name = "att" if cross else "self"
        self.add_module(self._att_name, MultiHeadAttention(cfg))
        self.output = AttnOutput(cfg)

    def forward(self, hidden, context=None, attn_mask=None):
        context = hidden if context is None else context
        attn = getattr(self, self._att_name)(hidden, context, attn_mask)
        return self.output(attn, hidden)


class Intermediate(nn.Module):
    """BertIntermediate (:159-168): dense + activation."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.act = ACT2FN[cfg.hidden_act]
        self.tp_group = None  # tensor parallelism: column-parallel dense

    def forward(self, x):
        return self.act(self.dense(copy_to_model(x, self.tp_group)))


def feed_forward(inter: Intermediate, out: AttnOutput, x: torch.Tensor):
    """FeedForward: BertIntermediate + BertOutput (:159-185).

    A function over the two modules rather than a module of its own,
    because the reference registers the pair under its owner's names
    (``intermediate``/``output`` in BertLayer, ``lang_inter``/
    ``lang_output`` in LXRTXLayer), which the state dicts keep."""
    return out(inter(x), x)


class TransformerLayer(nn.Module):
    """Self-attention block (BertLayer, :188-201)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.attention = Attention(cfg)
        self.intermediate = Intermediate(cfg)
        self.output = AttnOutput(cfg, cfg.intermediate_size)

    def forward(self, x, attn_mask=None):
        x = self.attention(x, None, attn_mask)
        return feed_forward(self.intermediate, self.output, x)


class TransformerStack(nn.Module):
    """N self-attention layers (BertEncoder, :204-234)."""

    def __init__(self, cfg: ModelConfig, num_layers: int):
        super().__init__()
        self.layer = nn.ModuleList(TransformerLayer(cfg) for _ in range(num_layers))

    def forward(self, x, attn_mask=None):
        return run_layers(self.layer, x, attn_mask)


def run_layers(layers, x, attn_mask=None):
    for layer in layers:
        x = layer(x, attn_mask)
    return x


class CrossModalLayer(nn.Module):
    """LXRTX layer (vilmodel_cmt.py:361-424).

    Shared cross-attention applied both directions (the reference reuses
    ``self.visual_attention`` for lang->visn and visn->lang), then
    per-stream self-attention + FFN. ``no_lang_ca`` freezes the language
    stream entirely (its per-layer states are precomputed at text
    encoding time, vilmodel_cmt.py:645-652).
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.no_lang_ca = cfg.no_lang_ca
        self.visual_attention = Attention(cfg, cross=True)
        self.lang_self_att = Attention(cfg)
        self.visn_self_att = Attention(cfg)
        self.lang_inter = Intermediate(cfg)
        self.lang_output = AttnOutput(cfg, cfg.intermediate_size)
        self.visn_inter = Intermediate(cfg)
        self.visn_output = AttnOutput(cfg, cfg.intermediate_size)

    def forward(self, lang, lang_mask, visn, visn_mask
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.no_lang_ca:
            lang_x = lang
        else:
            lang_x = self.visual_attention(lang, visn, visn_mask)
        visn_x = self.visual_attention(visn, lang, lang_mask)

        if not self.no_lang_ca:
            lang_x = self.lang_self_att(lang_x, None, lang_mask)
        visn_x = self.visn_self_att(visn_x, None, visn_mask)

        if self.no_lang_ca:
            lang_out = lang_x
        else:
            lang_out = feed_forward(self.lang_inter, self.lang_output, lang_x)
        return lang_out, feed_forward(self.visn_inter, self.visn_output, visn_x)

    def lang_only(self, lang, lang_mask):
        """The no_lang_ca precompute path (vilmodel_cmt.py:647-651):
        lang self-attention + FFN without any visual input."""
        lang_x = self.lang_self_att(lang, None, lang_mask)
        return feed_forward(self.lang_inter, self.lang_output, lang_x)


def enable_tensor_parallel(module: nn.Module, group, shards: int) -> None:
    """Hand the model group to every block below ``module`` whose weights
    ``parallel/mesh.py:shard_model`` split: the attentions (``heads /
    shards`` heads each) and intermediates enter through
    :func:`copy_to_model`, the output denses reduce."""
    for m in module.modules():
        if isinstance(m, MultiHeadAttention):
            if m.num_heads % shards:
                raise ValueError(f"{m.num_heads} heads do not split {shards} ways")
            m.num_heads //= shards
            m.tp_group = group
        elif isinstance(m, Intermediate):
            m.tp_group = group
        elif isinstance(m, AttnOutput):
            m.dense.reduce_group = group


def set_dropout_rng(module: nn.Module, rng: Optional[DropoutRNG]) -> None:
    """Hand ``rng`` to every dropout site below ``module``: each module
    with an ``rng`` attribute (:class:`Dropout`, the attentions)."""
    for m in module.modules():
        if hasattr(m, "rng"):
            m.rng = rng
