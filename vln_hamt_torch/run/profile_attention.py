"""The attention kernels against their plain versions and the library calls, by shape.

    python -m vln_hamt_torch.run.profile_attention

For each (Lq, Lk) shape of the R2R main path (the ``r2r`` preset over
the synthetic world of ``run/profile_eval.py``: 12 heads, Dh 64), at the
serving batch of 32 and the training batch of 8, dropout off:

- the forward (fp32): the kernel's device ms per launch, its plain
  version's (``attention_reference``), ``scaled_dot_product_attention``'s,
  the card's bound for the same work, and the kernel's largest error
  against the plain version; weighted over the 279 launches of a greedy
  batch or IL update;
- the backward (fp32 and bf16, the shapes of an IL update): the
  kernel's ms per call with the mask cotangent dm (``ms``, as the
  library yardstick computes it) and without (``ms_no_dm``, as the main
  path calls it), its plain version's (``attention_bwd_reference``), the
  backward of ``scaled_dot_product_attention`` (:func:`sdpa_backward`),
  the bound, and the largest relative error; weighted over the 240
  launches of an IL update.

Prints the card's name and power limit, both kernels' build reports
(registers and spills per instantiation), one JSON line per shape, and
one per kernel and batch with the weighted means. Takes about a minute
on the card, the two builds included.

Also the home of the timing, bound, build-report and input helpers that
``chip_smoke.py`` uses.
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..agents.agent import resolve_device
from ..ops import attention as attn
from .profile_eval import slice_config

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and FLOP/s by
# the inputs' element size: fp32 on the CUDA cores (TF32 off, as the
# port runs), bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 2: 989e12}

Shape = Tuple[int, int]


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn: Callable[[], object], iters: int = 25, warmup: int = 3,
                 hold_cycles: Optional[int] = None) -> float:
    """Device ms per call of ``fn``: ``iters`` calls queued behind a
    sleeping stream and timed between two events, so the host's time to
    issue them (Python, autograd, ctypes) does not count, only the
    device's back-to-back work. The sleep (``hold_cycles`` GPU cycles)
    lasts by default twice the host's time to issue the calls, as the
    last warm-up call took (at 2 GHz; a slower clock sleeps longer), at
    least 2 ms and at most 10^8 cycles. It must outlast the queueing,
    which is checked: a call of many kernels fills the device's launch
    queue (about a thousand launches) and blocks the host, so the run is
    halved until it fits."""
    call_s = 0.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        call_s = time.perf_counter() - t0
    if hold_cycles is None:
        hold_cycles = int(min(max(2 * iters * call_s, 2e-3) * 2e9, 1e8))
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(hold_cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        if iters < 10:
            raise RuntimeError(f"the host took {host_ms} ms to queue {iters} calls")
        return cuda_time_ms(fn, iters // 2, 0, hold_cycles)
    return ev[1].elapsed_time(ev[2]) / iters


def attention_bound_ms(b: int, h: int, lq: int, lk: int, dh: int, elt_bytes: int):
    """Least time for one forward launch, as (bytes ms, operations ms):
    q, k, v read once, the (B, Lk) fp32 mask read once, the fp32 output
    written once, over HBM; and 4*B*H*Lq*Lk*Dh FLOPs over the peak of
    the inputs' type (:data:`PEAK_FLOPS`: bf16 inputs at the tensor
    cores' rate, whatever the kernel computes in)."""
    nbytes = b * h * (lq + 2 * lk) * dh * elt_bytes + b * lk * 4 + b * h * lq * dh * 4
    flops = 4 * b * h * lq * lk * dh
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[elt_bytes] * 1e3


def attention_bwd_bound_ms(b: int, h: int, lq: int, lk: int, dh: int, elt_bytes: int):
    """Least time for one backward launch, as (bytes ms, operations ms):
    q, k, v (input type), g (fp32) and the (B, Lk) fp32 mask read once,
    dq, dk, dv (input type) and dm (fp32) written once; 10*B*H*Lq*Lk*Dh
    FLOPs (the recomputed scores, g v^T, dv, dq and dk) over the peak of
    the inputs' type."""
    qkv = b * h * (lq + 2 * lk) * dh * elt_bytes
    nbytes = 2 * qkv + b * h * lq * dh * 4 + 2 * b * lk * 4
    flops = 10 * b * h * lq * lk * dh
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[elt_bytes] * 1e3


def launch_mix(cfg, remat: bool = False) -> Tuple[collections.Counter, collections.Counter]:
    """Attention launches of the main path by (Lq, Lk): the forward's per
    greedy batch or IL update, and the backward's per IL update (the
    merged sample update's too, at twice the lanes). With ``remat`` the
    forward is an update's under activation recomputation
    (``ModelConfig.remat``, ``agents/rollout.py:remat_step``), ``full``
    or ``dots`` alike: the backward recomputes each step up to its last
    saved activation, so every step's cross-modal attentions run again,
    and its panorama encoder too unless ``fix_hist_embedding`` keeps it
    out of the graph; the text encoding and the backward are unchanged.

    The forward: the text stack once (under ``no_lang_ca`` also the
    cross-modal layers' language half, precomputed once), then per step
    the panorama encoder of the history token and, in each cross-modal
    layer, cross-attention both ways and the two self-attentions (under
    ``no_lang_ca`` only the visual stream's two: visn -> text and visn
    self). The backward: every attention of the cross-modal layers'
    steps; the text stack's unless ``fix_lang_embedding`` (or
    ``update_lang_bert`` off) keeps it out of the graph, and the
    precomputed language half always; the panorama encoder's unless
    ``fix_hist_embedding``, except at the last step, whose history token
    no later step reads.

    Any task preset: R2R-Back's and CVDN's shapes are the family's at
    their lengths; REVERIE's visual stream carries the viewpoint's
    ``max_objects`` object tokens too, and its text (``plan_ref``) has no
    precomputed language half (:func:`text_launches`)."""
    mcfg, t_max = cfg.model, cfg.env.max_action_len
    l_txt, l_pano, l_visn = cfg.env.max_instr_len, 36, visual_tokens(cfg)
    n_x, n_p = mcfg.num_x_layers, mcfg.num_h_pano_layers
    per_step = [(l_visn, l_txt), (l_visn, l_visn)]
    if not mcfg.no_lang_ca:
        per_step += [(l_txt, l_visn), (l_txt, l_txt)]
    fwd, bwd = collections.Counter(), collections.Counter()
    fwd[(l_txt, l_txt)], bwd[(l_txt, l_txt)] = text_launches(mcfg)
    fwd[(l_pano, l_pano)] += t_max * n_p
    if not mcfg.fix_hist_embedding:
        bwd[(l_pano, l_pano)] += (t_max - 1) * n_p
    for shape in per_step:
        fwd[shape] += t_max * n_x * (2 if remat else 1)
        bwd[shape] += t_max * n_x
    if remat and not mcfg.fix_hist_embedding:
        fwd[(l_pano, l_pano)] += t_max * n_p
    return fwd, +bwd


def visual_tokens(cfg) -> int:
    """The cross-modal layers' visual stream: the history cache (T + 1),
    the observation [C candidates | STOP | 36 views] and, for REVERIE,
    the viewpoint's object tokens."""
    n_ob = cfg.env.max_candidates + 1 + 36
    objects = cfg.env.max_objects if cfg.model.obj_feat_size > 0 else 0
    return cfg.env.max_action_len + 1 + n_ob + objects


def text_launches(mcfg) -> Tuple[int, int]:
    """Attention launches of one text encoding (the text stack, and under
    ``no_lang_ca`` the cross-modal layers' language half, precomputed),
    forward and backward: the text stack runs backward unless
    ``fix_lang_embedding`` (or ``update_lang_bert`` off) keeps it out of
    the graph, the precomputed language half always. A REVERIE model
    (``obj_feat_size > 0``) has no language half: ``plan_ref`` reads the
    initial encoding only (``models/hamt.py:HAMT.encode_text``)."""
    text_frozen = mcfg.fix_lang_embedding or not mcfg.update_lang_bert
    lang_once = mcfg.num_x_layers if mcfg.no_lang_ca and mcfg.obj_feat_size <= 0 else 0
    return (mcfg.num_l_layers + lang_once,
            (0 if text_frozen else mcfg.num_l_layers) + lang_once)


def packed_il_mix(cfg, text_cap: int, remat: bool = False
                  ) -> Tuple[collections.Counter, collections.Counter]:
    """Attention launches of one packed IL update by (lanes, Lq, Lk),
    forward and backward (``agents/rollout.py:build_packed_il_forward``):
    :func:`launch_mix`'s IL update (with ``remat`` its recomputed steps),
    with the one text encoding at the pack's ``text_cap`` lanes and every
    per-step attention at the slots (the batch). As in the unpacked
    update, the panorama encoder of the last step takes no backward: no
    later step reads its token."""
    fwd, bwd = launch_mix(cfg, remat)
    s, l_txt = cfg.train.batch_size, cfg.env.max_instr_len
    out = []
    for mix, n_text in zip((fwd, bwd), text_launches(cfg.model)):
        lanes = collections.Counter({(s, *shape): n for shape, n in mix.items()})
        lanes[(s, l_txt, l_txt)] -= n_text
        lanes[(text_cap, l_txt, l_txt)] += n_text
        out.append(+lanes)
    return out[0], out[1]


#: pretraining tasks whose loss reads the text output, and the visual
#: output (pretrain/model.py)
PRETRAIN_TXT_TASKS = ("mlm", "sar", "sap", "itm")
PRETRAIN_VISN_TASKS = ("mrc", "sap", "sprel", "itm")


def pretrain_launch_mix(mcfg, task: str, batch: int, txt_len: int, hist_len: int,
                        ob_width: int = 37, itm_candidates: int = 5
                        ) -> Tuple[collections.Counter, collections.Counter]:
    """Attention launches of one pretraining update of ``task`` by
    (lanes, Lq, Lk), forward and backward (``pretrain/model.py``);
    ``ob_width`` is the dataset's observation width (37, or more under
    the candidate-first layout), which SpRel does not take (it always
    reads the 37-token pano layout).

    The forward: the text stack at ``batch`` lanes (under ``no_lang_ca``
    with the cross-modal layers' language half); the panorama encoder
    over every history step, ``batch * hist_len`` lanes of 36 x 36; the
    history-only stack, once per history order (ITM: the positive and its
    shuffles); and the cross-modal stack over [CLS + history (+ the
    observation for SAP, SAR and SpRel)] against the text, at ``batch``
    lanes, or ``itm_candidates * batch`` for ITM's (1 + K) x B pairs.
    The backward: what reaches the task's loss. A task that reads only
    the text output (MLM, SAR) leaves the last cross-modal layer's visual
    half out, one that reads only the visual output (MRC, SpRel) its
    language half; under ``no_lang_ca`` the visual stream reaches the
    loss only through the visual output, so MLM and SAR train neither it
    nor the history, while the language half runs backward in full (its
    last layer's output, which no layer reads, takes a zero gradient
    through the stacked states, as in fine-tuning). ``fix_lang_embedding``
    keeps the text stack out, as in fine-tuning; ``fix_hist_embedding``
    does not freeze the history stacks here (the JAX package's
    ``encode_history_seq`` has no stop_gradient)."""
    l_txt, t = txt_len, hist_len
    ob = {"sprel": 37, "sap": ob_width, "sar": ob_width}.get(task, 0)
    m = t + 1 + ob
    xb = batch * itm_candidates if task == "itm" else batch
    n_l, n_x, n_h = mcfg.num_l_layers, mcfg.num_x_layers, mcfg.num_h_layers
    n_p = mcfg.num_h_pano_layers if mcfg.hist_enc_pano else 0
    uses_txt, uses_visn = task in PRETRAIN_TXT_TASKS, task in PRETRAIN_VISN_TASKS
    text_frozen = mcfg.fix_lang_embedding or not mcfg.update_lang_bert
    # history orders through the history-only stack: ITM's positive and
    # its shuffles (the in-batch negatives, 2 from a batch of 2 or more,
    # reuse the positive's)
    orders = itm_candidates - (2 if batch > 1 else 0) if task == "itm" else 1
    fwd, bwd = collections.Counter(), collections.Counter()
    fwd[(batch, l_txt, l_txt)] += n_l + (n_x if mcfg.no_lang_ca else 0)
    fwd[(batch * t, 36, 36)] += n_p
    fwd[(batch, t + 1, t + 1)] += n_h * orders
    if mcfg.no_lang_ca:
        cross = {(xb, m, l_txt): "visn", (xb, m, m): "visn"}
        hist_grad = uses_visn
        bwd[(batch, l_txt, l_txt)] += (0 if text_frozen else n_l) + n_x
        for shape in cross:
            fwd[shape] += n_x
            bwd[shape] += n_x if uses_visn else 0
    else:
        cross = {(xb, l_txt, m): "txt", (xb, l_txt, l_txt): "txt",
                 (xb, m, l_txt): "visn", (xb, m, m): "visn"}
        hist_grad = True
        bwd[(batch, l_txt, l_txt)] += 0 if text_frozen else n_l
        for shape, stream in cross.items():
            fwd[shape] += n_x
            used_last = uses_txt if stream == "txt" else uses_visn
            bwd[shape] += n_x - 1 + (1 if used_last else 0)
    if hist_grad:
        bwd[(batch * t, 36, 36)] += n_p
        bwd[(batch, t + 1, t + 1)] += n_h * orders
    return +fwd, +bwd


#: tasks whose image-mode batch holds the observation's 36 views
IMAGE_STEP_TASKS = ("sap", "sar", "sprel")


def image_pretrain_launch_mix(mcfg, vit_cfg, task: str, batch: int, txt_len: int,
                              hist_len: int, itm_candidates: int = 5
                              ) -> Tuple[collections.Counter, collections.Counter]:
    """Attention launches of one end-to-end image pretraining update
    (``pretrain/image_model.py``) by (lanes, Lq, Lk): the trunk's
    :func:`pretrain_launch_mix`, plus the ViT's ``num_layers`` forward
    attentions over every history panorama (``batch * hist_len * 36``
    lanes, no backward: it runs without gradient) and, for a task whose
    batch holds the observation (SAP, SAR, SpRel), its ``num_layers``
    forward and backward attentions over ``batch * 36`` lanes; the ViT's
    length is its patches + the cls token (197 at ViT-B/16 on 224)."""
    fwd, bwd = pretrain_launch_mix(mcfg, task, batch, txt_len, hist_len,
                                   itm_candidates=itm_candidates)
    n, layers = vit_cfg.num_patches + 1, vit_cfg.num_layers
    fwd[(batch * hist_len * 36, n, n)] += layers
    if task in IMAGE_STEP_TASKS:
        fwd[(batch * 36, n, n)] += layers
        # the observation reaches the loss through the visual stream, or
        # through the text when the cross-modal layers attend both ways
        if task in PRETRAIN_VISN_TASKS or not mcfg.no_lang_ca:
            bwd[(batch * 36, n, n)] += layers
    return fwd, bwd


def kernel_counts(mixes: Tuple[Dict[tuple, int], Dict[tuple, int]], dh: int
                  ) -> Dict[str, int]:
    """The launches of a (forward, backward) pair of mixes at head width
    ``dh`` by kernel, as :data:`ops.attention.launch_counts` counts them:
    each shape (its last entry is Lk) on the kernel that
    ``ops/attention.py:fwd_kernel`` / ``bwd_kernel`` routes it to, every
    kernel present (0 where none)."""
    out = dict.fromkeys(attn.launch_counts, 0)
    for mix, route in zip(mixes, (attn.fwd_kernel, attn.bwd_kernel)):
        for shape, n in mix.items():
            out[route(shape[-1], dh)] += n
    return out


def image_pretrain_kernel_counts(mcfg, vit_cfg, task: str, batch: int, txt_len: int,
                                 hist_len: int) -> Dict[str, int]:
    """:func:`image_pretrain_launch_mix` by kernel (:func:`kernel_counts`):
    the trunk's shapes at its head width, the ViT's at the ViT's, which
    differ under ``--tiny`` (16 and 12)."""
    trunk = pretrain_launch_mix(mcfg, task, batch, txt_len, hist_len)
    full = image_pretrain_launch_mix(mcfg, vit_cfg, task, batch, txt_len, hist_len)
    vit = tuple(f - t for f, t in zip(full, trunk))
    out = kernel_counts(trunk, mcfg.head_dim)
    for name, n in kernel_counts(vit, vit_cfg.hidden_size // vit_cfg.num_heads).items():
        out[name] += n
    return out


def bootstrap_mix(cfg) -> collections.Counter:
    """Forward launches of the sample updates' bootstrap value by
    (Lq, Lk): one planning step over the final observation, no
    backward."""
    l_txt, l_visn = cfg.env.max_instr_len, visual_tokens(cfg)
    shapes = [(l_visn, l_txt), (l_visn, l_visn)]
    if not cfg.model.no_lang_ca:
        shapes += [(l_txt, l_visn), (l_txt, l_txt)]
    return collections.Counter({s: cfg.model.num_x_layers for s in shapes})


def kernel_inputs(b: int, h: int, lq: int, lk: int, dh: int, dtype, gen, dev,
                  masked_rows: bool = False):
    """q, k, v as the layer hands them over ((B, H, L, Dh) views of
    (B, L, H, Dh)), a 0 / -10000 mask, and an output cotangent laid out
    as the layer's gradient arrives.

    With ``masked_rows`` every third batch element has all its keys at
    -10000, and q and k lie on a grid of 1/4: their scores, and the
    rounding of score + mask next to -10000 (whose fp32 step is about
    1e-3), are then exact in any summation order, so the kernel and its
    plain twin see the same scores."""
    def view(l, grid):
        x = torch.randn(b, l, h, dh, device=dev, generator=gen)
        return (torch.round(x * 4) / 4 if grid else x).to(dtype).transpose(1, 2)

    q, k, v = view(lq, masked_rows), view(lk, masked_rows), view(lk, False)
    m = torch.where(torch.rand(b, lk, device=dev, generator=gen) < 0.8, 0.0, -10000.0)
    if masked_rows:
        m[::3] = -10000.0
    g = torch.randn(b, lq, h, dh, device=dev, generator=gen).transpose(1, 2)
    return q, k, v, m, g


def element_layout(t: torch.Tensor) -> torch.Tensor:
    """A copy of the (B, H, L, Dh) view ``t`` laid out as the layer's
    (B, L, H, Dh) projection but starting one element past a 16-byte
    boundary, which the key-blocked forward stages by element loads
    (``ops/attention.py:blocked_staging``)."""
    b, h, l, dh = t.shape
    flat = torch.empty(1 + t.numel(), dtype=t.dtype, device=t.device)
    out = flat[1:].view(b, l, h, dh).transpose(1, 2)
    out.copy_(t)
    return out


def staging_name(q, k, v) -> str:
    """How the key-blocked kernels stage q, k and v: "async" (16-byte
    copies) or "element" (element loads). The backward's cotangent always
    goes by 16-byte copies (``ops/attention.py:_kernel_cotangent``)."""
    return "async" if attn.blocked_staging(q, k, v) else "element"


def bwd_blocked_occupancy() -> Dict[str, Dict[int, Dict[str, List[int]]]]:
    """The key-blocked backward's statistics pass and key-block kernel:
    dynamic shared memory per CTA in bytes and CTAs per SM on this card,
    by type and padded head width: {"float32" | "bfloat16": {width:
    {"stats" | "keys": [bytes, ctas]}}}."""
    lib = attn._library("attention_bwd_blocked")
    out = {}
    for name, code in (("float32", 0), ("bfloat16", 1)):
        out[name] = {}
        for width in attn.FWD_HEAD_DIMS:
            out[name][width] = {}
            for kernel, which in (("stats", 0), ("keys", 1)):
                nbytes = ctypes.c_longlong(0)
                ctas = lib.hamt_attention_bwd_blocked_occupancy(code, width, which,
                                                                ctypes.byref(nbytes))
                out[name][width][kernel] = [nbytes.value, ctas]
    return out


def fwd_blocked_occupancy() -> Dict[str, Dict[int, List[int]]]:
    """The key-blocked forward's dynamic shared memory per CTA in bytes
    and CTAs per SM on this card, by type and padded head width:
    {"float32" | "bfloat16": {width: [bytes, ctas]}}."""
    lib = attn._library("attention_fwd_blocked")
    out = {}
    for name, code, widths in (("float32", 0, (16, 32, 64, 128)),
                               ("bfloat16", 1, range(16, 129, 16))):
        out[name] = {}
        for width in widths:
            nbytes = ctypes.c_longlong(0)
            ctas = lib.hamt_attention_fwd_blocked_occupancy(code, width, ctypes.byref(nbytes))
            out[name][width] = [nbytes.value, ctas]
    return out


def time_forward(q, k, v, m) -> Dict[str, float]:
    """Device ms per call of the forward kernel, its plain version and
    ``scaled_dot_product_attention`` on the same inputs (dropout off),
    and the bound of the same work split into bytes and operations."""
    b, h, lq, dh = q.shape
    bytes_ms, flops_ms = attention_bound_ms(b, h, lq, k.shape[2], dh, q.element_size())
    mask4 = m[:, None, None, :].to(q.dtype)
    return {
        "ms": cuda_time_ms(lambda: attn.fused_attention(q, k, v, m)),
        "plain_ms": cuda_time_ms(lambda: attn.attention_reference(q, k, v, m)),
        "library_ms": cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask4)),
        "bytes_ms": bytes_ms, "flops_ms": flops_ms,
    }


def sdpa_backward(q, k, v, m, g):
    """The backward alone of scaled_dot_product_attention with a mask
    that takes a gradient: a function that runs autograd.grad on a
    retained graph (the library yardstick; the port never calls it)."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    mask4 = m[:, None, None, :].to(q.dtype).detach().requires_grad_()
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=mask4)
    return lambda: torch.autograd.grad(out, (*leaves, mask4), g.to(out.dtype),
                                       retain_graph=True)


def time_backward(q, k, v, m, g) -> Dict[str, float]:
    """Device ms per call of the backward kernel with and without the
    mask cotangent, its plain version and the backward of
    ``scaled_dot_product_attention`` on the same inputs (dropout off),
    and the bound of the same work (dm included) split into bytes and
    operations."""
    b, h, lq, dh = q.shape
    bytes_ms, flops_ms = attention_bwd_bound_ms(b, h, lq, k.shape[2], dh, q.element_size())
    return {
        "ms": cuda_time_ms(lambda: attn.attention_bwd(q, k, v, m, g)),
        "ms_no_dm": cuda_time_ms(lambda: attn._launch_bwd(q, k, v, m, g, 0, 0.0, False)),
        "plain_ms": cuda_time_ms(lambda: attn.attention_bwd_reference(q, k, v, m, g)),
        "library_ms": cuda_time_ms(sdpa_backward(q, k, v, m, g)),
        "bytes_ms": bytes_ms, "flops_ms": flops_ms,
    }


def ptxas_report(text: str) -> Dict[str, object]:
    """Registers and spill bytes per kernel entry of an ``-Xptxas -v``
    report, and the largest register count and the total spill bytes
    over all entries."""
    entries, entry = [], None
    for line in text.splitlines():
        name = re.search(r"Compiling entry function '(\S+)'", line)
        if name:
            entry = {"entry": name.group(1)}
            entries.append(entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and entry is not None:
            entry["spill_stores"], entry["spill_loads"] = map(int, spill.groups())
        regs = re.search(r"Used (\d+) registers", line)
        if regs and entry is not None:
            entry["registers"] = int(regs.group(1))
    return {"max_registers": max((e.get("registers", 0) for e in entries), default=0),
            "spill_bytes": sum(e.get("spill_stores", 0) + e.get("spill_loads", 0)
                               for e in entries),
            "entries": entries}


def build_all() -> Dict[str, Dict[str, object]]:
    """Every kernel source built at once (one nvcc each): per kernel its
    nvcc seconds, library path and :func:`ptxas_report`."""
    with ThreadPoolExecutor(len(attn.SOURCES)) as pool:
        builds = dict(zip(attn.SOURCES, pool.map(attn.build_library, attn.SOURCES)))
    return {name: {"seconds": b["seconds"], "library": b["path"], **ptxas_report(b["ptxas"])}
            for name, b in builds.items()}


def weighted(rows: List[dict], mix: Dict[Shape, int], key: Callable[[dict], float],
             dtype: str = "float32") -> float:
    """Mean of ``key`` over rows of ``dtype`` with times (dropout off),
    weighted by the launches of each shape in ``mix``."""
    by_shape = {(r["lq"], r["lk"]): r for r in rows if r["dtype"] == dtype and "ms" in r}
    return sum(n * key(by_shape[s]) for s, n in mix.items()) / sum(mix.values())


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in float32."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def main():
    dev = resolve_device()  # the card; raises without one
    print(nvidia_smi(), flush=True)
    for name, built in build_all().items():
        print(json.dumps({"kernel": name, **built}), flush=True)

    cfg, _ = slice_config(32)
    mix, bwd_mix = launch_mix(cfg)
    h, dh = cfg.model.num_attention_heads, cfg.model.head_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    for b in (32, 8):
        rows = []
        for (lq, lk), n in mix.items():
            q, k, v, m, _ = kernel_inputs(b, h, lq, lk, dh, torch.float32, gen, dev)
            err = (attn.fused_attention(q, k, v, m)
                   - attn.attention_reference(q, k, v, m)).abs().max().item()
            row = {"kernel": "attention_fwd", "batch": b, "lq": lq, "lk": lk,
                   "dtype": "float32", "launches": n, "max_abs_err": err,
                   **time_forward(q, k, v, m)}
            row.update(bound_ms=max(row["bytes_ms"], row["flops_ms"]),
                       over_library=row["ms"] / row["library_ms"])
            print(json.dumps(row), flush=True)
            rows.append(row)
        means = {key: weighted(rows, mix, lambda r: r[key]) for key in
                 ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "flops_ms")}
        print(json.dumps({"kernel": "attention_fwd", "batch": b, "dtype": "float32",
                          "weighted_over": sum(mix.values()), **means}), flush=True)

        rows = []
        for (lq, lk), n in bwd_mix.items():
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, m, g = kernel_inputs(b, h, lq, lk, dh, dtype, gen, dev)
                errs = [rel_err(x, y) for x, y in zip(attn.attention_bwd(q, k, v, m, g),
                                                      attn.attention_bwd_reference(q, k, v, m, g))]
                row = {"kernel": "attention_bwd", "batch": b, "lq": lq, "lk": lk,
                       "dtype": str(dtype).split(".")[1], "launches": n,
                       "max_rel_err": max(errs), **time_backward(q, k, v, m, g)}
                row.update(bound_ms=max(row["bytes_ms"], row["flops_ms"]),
                           over_library=row["ms"] / row["library_ms"])
                print(json.dumps(row), flush=True)
                rows.append(row)
        for dtype in ("float32", "bfloat16"):
            means = {key: weighted(rows, bwd_mix, lambda r: r[key], dtype) for key in
                     ("ms", "ms_no_dm", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                      "flops_ms")}
            print(json.dumps({"kernel": "attention_bwd", "batch": b, "dtype": dtype,
                              "weighted_over": sum(bwd_mix.values()), **means}), flush=True)


if __name__ == "__main__":
    main()
