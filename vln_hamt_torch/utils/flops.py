"""Analytic matmul-FLOPs model + MFU accounting for the HAMT programs
(torch port of ``vln_hamt_tpu/utils/flops.py``).

The MFU numerator: dense/attention matmul FLOPs of one update (forward +
backward = 3x forward), excluding elementwise work (LayerNorm, softmax,
the optimizer). The denominator is the card's dense bf16 tensor-core
peak, whatever the run's compute type, so MFU reads the same across
fp32 and bf16 runs. Used by the fine-tune CLI's throughput logging.
"""

from __future__ import annotations

# dense bf16 tensor-core peak FLOP/s by torch.cuda.get_device_name()
# substring (lower case); NVIDIA H100 Tensor Core GPU datasheet, SXM5
# part, without sparsity
_PEAK_BF16 = {
    "h100 80gb hbm3": 989e12,
}


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


def analytic_update_flops(cfg, batch: int, n_ob: int) -> float:
    """Matmul FLOPs of one IL update (fwd + bwd = 3x fwd) at ``batch``
    lanes.

    Per-step token counts: visual stream = (T+1) history tokens + n_ob
    obs tokens; language stream = L
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
    n_v = (T + 1) + n_ob

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
    head = n_ob * (d2 + d)  # action head (critic ~d*512)

    fwd_macs = batch * (text + T * (xstep + pano + head))
    return 3.0 * 2.0 * fwd_macs  # x2 MAC->FLOP, x3 fwd+bwd
