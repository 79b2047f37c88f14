"""The floating-point work of HAMT's training update and greedy rollout,
counted from the layer equations and the shapes.

A dense layer over ``n`` rows costs ``2 n in out`` forward; backward
``2 n in out`` for its weight's gradient where the weight trains and as
much again for its input's gradient where the input carries one. An
attention core costs ``4 B H Lq Lk Dh`` forward (scores and the weighted
sum) and ``8 B H Lq Lk Dh`` backward (the probabilities' cotangent, dV,
dQ and dK), run where any of q, k, v carries a gradient; the backward's
recomputed scores, ``2 B H Lq Lk Dh``, are recomputation and kept apart.

Which parts run backward follows the configuration, as upstream's
autograd decides it:

- frozen stacks (``fix_lang_embedding``, ``fix_hist_embedding``) run no
  backward;
- under ``no_lang_ca`` the language half of the cross-modal layers runs
  once per episode, with the text; the visual stream's cross-attention
  still projects the language states at every step;
- the last step's history token is read by no later step and runs no
  backward;
- the critic's bootstrap on the final observation runs no backward.

A rollout charges ``steps`` steps: the caller counts a batch's steps up
to its last stop, as upstream's loop ends, where the port runs all of
``max_action_len``. Elementwise work, LayerNorm and softmax are not
counted.
"""

from __future__ import annotations

from typing import Dict

#: published dense peaks of one H100 SXM (NVIDIA's data sheet, 700 W):
#: float32 outside the tensor cores, and bf16 on them
PEAKS = {"float32": 67e12, "bfloat16": 989e12}


def peak(dtype: str) -> float:
    return PEAKS[dtype]


class Count:
    def __init__(self):
        self.fwd = self.bwd = self.recompute = 0.0
        self.cores = []  # (B, H, Lq, Lk, Dh, backward) of each attention

    def dense(self, n: int, i: int, o: int, w_grad: bool, x_grad: bool) -> None:
        f = 2.0 * n * i * o
        self.fwd += f
        self.bwd += f * (int(w_grad) + int(x_grad))

    def core(self, b: int, h: int, lq: int, lk: int, dh: int, backward: bool) -> None:
        f = 2.0 * b * h * lq * lk * dh
        self.cores.append((b, h, lq, lk, dh, backward))
        self.fwd += 2 * f
        if backward:
            self.bwd += 4 * f
            self.recompute += f


def _attention(c: Count, m: dict, b: int, lq: int, lk: int, train: bool, q_grad: bool,
               kv_grad: bool) -> None:
    """An attention block: q from ``lq`` rows that carry a gradient where
    ``q_grad``, k and v from ``lk`` rows (``kv_grad``), the core, the
    output dense. ``train``: its weights train."""
    d, h = m["hidden_size"], m["num_attention_heads"]
    c.dense(b * lq, d, d, train, q_grad)
    c.dense(b * lk, d, d, train, kv_grad)
    c.dense(b * lk, d, d, train, kv_grad)
    grad = train or q_grad or kv_grad
    c.core(b, h, lq, lk, d // h, grad)
    c.dense(b * lq, d, d, train, grad)


def _ffn(c: Count, m: dict, n: int, train: bool) -> None:
    d, f = m["hidden_size"], m["intermediate_size"]
    c.dense(n, d, f, train, train)
    c.dense(n, f, d, train, train)


def _self_layer(c, m, b, l, train, x_grad):
    _attention(c, m, b, l, l, train, x_grad, x_grad)
    _ffn(c, m, b * l, train)


def text(c: Count, m: dict, env: dict, b: int, train: bool) -> None:
    """The text stack once (and under no_lang_ca the language half)."""
    l = env["max_instr_len"]
    frozen = not train or m["fix_lang_embedding"] or not m["update_lang_bert"]
    for i in range(m["num_l_layers"]):
        _self_layer(c, m, b, l, not frozen, not frozen)
    if m["no_lang_ca"]:
        for _ in range(m["num_x_layers"]):
            _self_layer(c, m, b, l, train, train and not frozen)


def step(c: Count, m: dict, env: dict, b: int, train: bool, hist_backward: bool,
         head: bool = True, critic: bool = True, history: bool = True) -> None:
    """One planning step over ``b`` lanes: observation embedding, the
    cross-modal layers, the action head, the critic and the new history
    token."""
    d, img, ang = m["hidden_size"], m["image_feat_size"], m["angle_feat_size"]
    n_ob = env["max_candidates"] + 1 + env["views"]
    v = env["max_action_len"] + 1 + n_ob
    l = env["max_instr_len"]
    lang_frozen = m["fix_lang_embedding"] or not m["update_lang_bert"]
    c.dense(b * n_ob, img, d, train, False)
    c.dense(b * n_ob, ang, d, train, False)
    for i in range(m["num_x_layers"]):
        # the language states carry a gradient where the text trains, and
        # past the first layer, whose language half trains
        if m["no_lang_ca"]:
            lang_grad = train and not lang_frozen
        else:
            lang_grad = train and (i > 0 or not lang_frozen)
        if not m["no_lang_ca"]:
            _attention(c, m, b, l, v, train, lang_grad, train)
        _attention(c, m, b, v, l, train, train, lang_grad)
        if not m["no_lang_ca"]:
            _attention(c, m, b, l, l, train, train, train)
        _attention(c, m, b, v, v, train, train, train)
        if not m["no_lang_ca"]:
            _ffn(c, m, b * l, train)
        _ffn(c, m, b * v, train)
    if head:
        c.dense(b * n_ob, d, d, train, train)
        c.dense(b * n_ob, d, 1, train, train)
    if critic:
        c.dense(b, d, 512, train, train)
        c.dense(b, 512, 1, train, train)
    if history:
        hist_train = train and hist_backward and not m["fix_hist_embedding"]
        c.dense(b, img, d, hist_train, False)
        c.dense(b, ang, d, hist_train, False)
        c.dense(b * 36, img, d, hist_train, False)
        c.dense(b * 36, ang, d, hist_train, False)
        for _ in range(m["num_h_pano_layers"]):
            _self_layer(c, m, b, 36, hist_train, hist_train)


def update(m: dict, env: dict, rl_lanes: int, il_lanes: int, steps: int,
           count: Count = None) -> Dict[str, float]:
    """The merged sample update: one rollout over the sampled and the
    teacher-forced lanes for ``steps`` steps, the bootstrap over the
    sampled lanes, the backward. Returns ``useful`` (forward and
    backward) and ``recompute``."""
    c = Count() if count is None else count
    b = rl_lanes + il_lanes
    text(c, m, env, b, True)
    for t in range(steps):
        step(c, m, env, b, True, hist_backward=t < steps - 1)
    step(c, m, env, rl_lanes, False, False, history=False)  # the bootstrap
    return {"useful": c.fwd + c.bwd, "recompute": c.recompute}


def rollout(m: dict, env: dict, lanes: int, steps: int, count: Count = None) -> float:
    """One greedy rollout of ``lanes`` for ``steps`` steps, forward only."""
    c = Count() if count is None else count
    text(c, m, env, lanes, False)
    for _ in range(steps):
        step(c, m, env, lanes, False, False)
    return c.fwd
