"""Analytic matmul-FLOPs model + MFU accounting for the HAMT programs
(torch port of ``vln_hamt_tpu/utils/flops.py``).

The MFU numerator: dense/attention matmul FLOPs of one update (forward +
backward = 3x forward), excluding elementwise work (LayerNorm, softmax,
the optimizer). The denominator is the dense bf16 tensor-core peak of
the cards the update runs on (one card's times the world size),
whatever the run's compute type, so MFU reads the same across fp32 and
bf16 runs. Used by the fine-tune CLI's throughput logging
(:func:`update_flops_and_peak`).
"""

from __future__ import annotations

import warnings
from typing import Optional, Set, Tuple

# dense bf16 tensor-core peak FLOP/s by torch.cuda.get_device_name()
# substring (lower case): half the figure with sparsity of NVIDIA's H100
# Tensor Core GPU datasheet, rounded down (SXM5 1,979 TFLOP/s, NVL 1,671,
# PCIe 1,513)
_PEAK_BF16 = {
    "h100 80gb hbm3": 989e12,  # H100 SXM5
    "h100 nvl": 835e12,
    "h100 pcie": 756e12,
}
_WARNED: Set[str] = set()  # cards already warned about


def chip_peak_flops(device_name: str) -> float:
    """The dense bf16 peak of the card named ``device_name`` (as
    ``torch.cuda.get_device_name`` gives it); raises on a card the table
    does not hold."""
    low = device_name.lower()
    for sub, peak in _PEAK_BF16.items():
        if sub in low:
            return peak
    raise KeyError(f"no bf16 peak known for {device_name!r}; add it to "
                   "vln_hamt_torch/utils/flops.py:_PEAK_BF16 from the card's datasheet")


def update_flops_and_peak(cfg, device_name: Optional[str], world: int = 1
                          ) -> Tuple[float, Optional[float]]:
    """The fine-tune CLI's MFU terms, as the JAX CLI's
    (``vln_hamt_tpu/run/finetune.py:410-416``): the analytic FLOPs of one
    update of the global batch (both halves of the merged ``sample``
    update; REVERIE's ``max_objects`` object tokens), and the peak of the
    ``world`` cards it runs on. The peak is None on the CPU (no
    ``device_name``) and on a card :data:`_PEAK_BF16` does not hold, which
    is warned about once: a default taken from another card would be a
    wrong figure, so such a run logs ``mfu: null``."""
    n_ob = cfg.env.max_candidates + 1 + 36
    n_obj = cfg.env.max_objects if cfg.model.obj_feat_size > 0 else 0
    lanes = cfg.train.batch_size * (2 if cfg.train.feedback == "sample" else 1)
    flops = analytic_update_flops(cfg, lanes, n_ob, n_obj=n_obj)
    if device_name is None:
        return flops, None
    try:
        return flops, chip_peak_flops(device_name) * world
    except KeyError as err:
        if device_name not in _WARNED:
            _WARNED.add(device_name)
            warnings.warn(f"{err.args[0]}: mfu is logged as null")
        return flops, None


def analytic_update_flops(cfg, batch: int, n_ob: int, n_obj: int = 0) -> float:
    """Matmul FLOPs of one IL update (fwd + bwd = 3x fwd) at ``batch``
    lanes.

    Per-step token counts: visual stream = (T+1) history tokens + n_ob
    obs tokens (+ n_obj REVERIE object tokens); language stream = L
    instruction tokens. Per token per transformer layer: QKVO 4D^2 MACs
    + FFN 2*D*I MACs (+ attention score/value matmuls 2*Lk*D). Cross
    layers add the Q/O and K/V splits across the two streams
    (models/layers.py:CrossModalLayer == vilmodel_cmt.py:361-424).

    The merged 'sample' update runs IL + RL as 2B lanes through the same
    per-step transformer: call with ``2 * batch``.

    The count is the JAX package's: it charges the language half of every
    cross-modal layer at every step and a full backward for every stack.
    Under ``no_lang_ca`` that half runs once per episode, and a frozen
    stack runs no backward, so for such presets (``rxr``, ``r4r``, and the
    frozen text and panorama stacks of ``r2r``) it overstates the work and
    the MFU logged from it (ROADMAP A17).
    """
    m = cfg.model
    d = m.hidden_size
    d2 = float(d * d)
    ffn = 2.0 * d * m.intermediate_size
    L = cfg.env.max_instr_len
    T = cfg.env.max_action_len
    n_v = (T + 1) + n_ob + n_obj

    # text encode: num_l_layers self-attn layers over L tokens
    per_tok_self = 4 * d2 + ffn
    text = m.num_l_layers * L * (per_tok_self + 2.0 * L * d)

    # one step: cross-modal x-layers over (visn | lang)
    visn = (4 * d2 * n_v + 2.0 * n_v * n_v * d      # self-attn
            + 2 * d2 * n_v + 2 * d2 * L             # cross Q/O + K/V
            + 2.0 * n_v * L * d                     # cross scores/values
            + ffn * n_v)
    lang = (4 * d2 * L + 2.0 * L * L * d
            + 2 * d2 * L + 2 * d2 * n_v
            + 2.0 * L * n_v * d
            + ffn * L)
    xstep = m.num_x_layers * (visn + lang)

    # per-step history token: pano transformer over 36 views + linears
    pano = m.num_h_pano_layers * 36 * (per_tok_self + 2.0 * 36 * d)
    pano += 36 * (m.image_feat_size * d + m.angle_feat_size * d)
    head = (n_ob + n_obj) * (d2 + d)  # action and object heads (critic ~d*512)

    fwd_macs = batch * (text + T * (xstep + pano + head))
    return 3.0 * 2.0 * fwd_macs  # x2 MAC->FLOP, x3 fwd+bwd
