"""GPU smoke test of the PyTorch/CUDA port (vln_hamt_torch) on one card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   -- card name, count, torch / CUDA versions, nvidia-smi name
               and power limit.
2. build    -- nvcc builds of every kernel of the main paths from this
               checkout's sources, one nvcc per source, all started
               together, with each instantiation's registers and spill
               bytes from the -Xptxas -v reports; meanwhile the weights of
               the slice's, the family presets' and the task variants'
               architectures are drawn, once each (memo_init_hamt: the
               agents of later phases load a copy).
3. kernels  -- each kernel against its plain torch twin on the card at
               the main paths' shapes (batch 32, full width), fp32 and
               bf16, dropout off and on: the attention forward, and the
               attention backward (dq, dk, dv and the mask cotangent dm);
               kernel, plain and library-call times and the card's bound
               for the same work; both kernels checked and timed at the
               training batch of 8 too, each at its training path's
               shapes; edge cases of the query-blocked tiling at batches
               32 and 8 (Lq = Lk = 1, a ragged 33 x 65 query block,
               65 x 65 with batch elements whose keys all read -10000,
               Dh 16 and 128), for the backward also 100 x 100, 250 x 65,
               65 x 250 and 250 x 250 (R4R / CVDN and RxR text lengths)
               and 300 x 65 (more query blocks than a cluster holds);
               and both kernels checked and timed at batch 16, the
               merged sample update's lanes, at the training shapes;
               and both at the `rxr` and `r4r` shapes of phase 10 (lines
               with a "preset" key), each at its preset's batch (8 and 4:
               the greedy batch and the bootstrap) and at twice that
               (16 and 8: the merged update's rollout and its backward);
               and both at the packed IL update's text shape (a line with
               a "packed_text" key): the text stack's 60 x 60 at the
               pack's 30 text rows (r2r's batch 8 and T 15), the backward
               as under fix_lang_embedding off; both kernels timed in fp32
               and bf16 at the serving, training, merged-update, packed
               and pretraining lanes (the summary's bf16 times);
               and both at the task variants' shapes of phase 17 (lines
               with a "preset" key too): R2R-Back's 80-token visual stream
               against 60-token text, CVDN's 80 x 100 and 100 x 100 (r4r's,
               measured once), REVERIE's 85-token stream (65 + 20 objects),
               each at its preset's batch (4, 4, 8) and twice that;
               and both at every pretraining shape of phase 12 (lines with
               a "pretrain" key), each at its lanes: the panorama encoder's
               36 x 36 over 400 lanes, the text's 80 x 80 (and `rxr`'s
               250 x 250) at 16, the cross-modal shapes of the 26-token
               history stream (MLM, MRC, ITM) and of the 63-token history
               + observation stream (SAP, SAR, SpRel; 67 under `rxr`'s
               candidate-first layout) at 16, and ITM's (1 + 4) x 16 = 80
               lanes. Timing, bounds and build reports come from
               vln_hamt_torch/run/profile_attention.py.
4. slice    -- the serving path: full-width R2R greedy evaluation
               (HAMTAgent.eval_split_device, `r2r` preset, fp32, seeded
               random weights) over a synthetic world at batch 32;
               episodes/s, SR/SPL/nDTW, and the kernel launches of that
               run (279 forward launches per batch, no backward).
5. parity   -- the same full-width model and weights at batch 4, once on
               the card and once on the CPU (plain attention): per-step
               logits within tolerance and identical trajectories.
6. train    -- the training path: full-width R2R imitation learning
               (HAMTAgent.train_iteration("teacher"), `r2r` preset, fp32,
               production dropout, adamw lr 1e-5, clip 40, batch 8,
               T = 15) over the same world; 1 warm-up and 2 timed
               updates: IL episodes/s, the losses, and 279 forward and
               240 backward launches per update. Then 8 updates on one
               repeated batch (lr 1e-4, dropout off): the loss must fall.
7. train_parity -- one IL update's loss and every parameter's gradient,
               card against CPU, batch 4, dropout off, same weights and
               batch; with the preset's fix_lang / fix_hist flags (240
               backward launches), and with both off (277: the text and
               panorama backward shapes too).
8. sample   -- the sample training path: full-width R2R IL + A2C
               (HAMTAgent.train_iteration("sample"), the same optimizer,
               production dropout, batch 8, T = 15), merged (8 sampling
               lanes and 8 teacher-forced lanes in one rollout); 1
               warm-up and 2 timed updates: sample episodes/s, the
               losses, peak memory, and 295 forward (279 at 16 lanes, the
               bootstrap's 16 at 8) and 240 backward launches per update.
               Then 2 fused updates (the teacher episode forward, then
               the rollout): 574 forward and 480 backward launches each.
9. sample_parity -- card against CPU, batch 4, dropout off, the same
               weights and batches: the argmax rollout with rewards and
               the bootstrap value (identical trajectories, masks and
               bootstrap mask; rewards, logits, values and last_value
               within tolerance), and the fused IL + A2C loss with the
               argmax policy and every model and critic gradient.

10. family  -- the rest of the R2R family at full width over synthetic
               worlds with each preset's feature width: `rxr` (250-token
               XLM-R text, no_lang_ca, 512-d features, T = 20, batch 8)
               and `r4r` (100-token text, no_lang_ca, T = 30, batch 4),
               both with the text and history stacks trained (their
               kernels are checked and timed in phase 3 at the batches
               and lanes this phase runs them at): per preset one
               warm-up and 2 timed merged
               sample updates (sample episodes/s, losses, peak memory,
               and exactly the launches of launch_mix + bootstrap_mix per
               update), one timed greedy batch (exactly launch_mix's
               forward launches), and card against CPU at batch 2
               (identical greedy trajectories, logits within 1e-3).
               `r2r_last` (r2r's shapes): one greedy batch.
11. files   -- the file-backed path at full `r2r` width: the slice's
               world written as reference connectivity and annotation
               files (train, an aug file, val splits) and read back by
               the CLI's build_real_dataset (load_nav_graphs,
               construct_instrs; features from the world's in-memory DB,
               since the card's machine has no h5py); a reference-format
               agent checkpoint (module.vln_bert.* and the critic) of a
               seeded agent, taken by an agent of another seed through
               init_from_reference: identical greedy trajectories, logits
               within 1e-6; 2 sample updates alternating the GT and aug
               envs, save, and load(resume_optimizer=True) into a fresh
               agent: every parameter and moment and the step equal, the
               greedy batch identical.

12. pretrain -- proxy-task pretraining at full `r2r` width (every stack
               trained, fp32, production dropout, batch 16, adamw 5e-5
               warmup-linear, grad-norm 5, index-mode batches over the
               resident feature table; run/profile_pretrain.py's
               slice_trainer, the CLI's --synthetic): one update per task
               (MLM, MRC, ITM, SAP, SAR, SpRel) as warm-up, each with
               exactly pretrain_launch_mix's launches; 30 timed updates of
               the 5:1:1:1:2:2 mix through the trainer's prefetching
               train_step (examples/s, peak memory, exact launches of the
               draw); card against CPU per task at batch 2, dropout off
               (loss and every gradient, check_grads); one full-split
               validate of the unseen stream; save, then
               HAMTAgent.init_from_pretrain of a fine-tuning agent (nothing
               skipped, the SAP head on the action head) and one greedy
               batch with exactly launch_mix's launches; then one update
               per task at the `rxr` preset (250 tokens, candidate-first
               layout, XLM-R vocabulary), each with exact launches. Then
               the `r2r` preset in bf16 (--bf16): one update per task with
               exact launches, 30 timed updates of the mix (examples/s,
               peak memory, exact launches), and card against CPU per task
               at batch 2 (both bf16, dropout off): the losses of 3
               batches and each gradient of the first within bf16_close
               (BF16_FACTOR times the CPU's bf16-to-fp32 distance plus
               BF16_ATOL, scaled down to the answer's largest entry below
               1) of the fp32 answer, the card's fp32 model on the same
               weights; a bias whose fp32 gradient is zero to rounding
               (bf16_grads_close) against one bf16 step of its weight's;
               each gradient's largest fp32 entry printed beside its bound.
13. bf16    -- bfloat16 compute at full `r2r` width (ModelConfig.dtype,
               the CLI's --bf16; parameters, optimizers and losses fp32):
               greedy evaluation at batch 32 (exactly 279 forward launches
               per batch), 1 warm-up and 2 timed IL updates at batch 8
               (279 / 240), 1 warm-up and 2 timed merged sample updates
               (295 / 240), episodes/s and peak memory of each beside the
               fp32 phases' of this run; 8 updates on one repeated batch
               (dropout off): the loss must fall; card against CPU, both
               bf16, batch 4, dropout off: greedy trajectories identical
               up to steps where the two devices' logits tie within the
               tolerance (each episode's logits compared through its first
               parting step), and the teacher-forced logits, the IL
               losses of 3 batches and every gradient of the first within
               bf16_close of the card's fp32 answer, as in the pretrain
               phase (tests/test_torch_bf16.py's yardstick).
14. packed_il -- packed IL (--packed_il) at full `r2r` width, 8 slots, T
               15, 30 text rows, fp32 and bf16: 1 warm-up and 2 timed
               packed updates, episodes per update and episodes/s beside
               the unpacked IL update's of this run, and exactly
               packed_il_mix's launches (279 forward, the text stack's 9
               at 30 lanes, and 240 backward); on the card a packed
               update's loss and gradients against the unpacked update's
               over the same episodes (fp32, dropout off); card against
               CPU for the packed loss and every gradient at 4 slots.
15. hostloop -- the host-loop evaluators at full `r2r` width, batch 32,
               fp32: eval_split (lock-step), eval_split_packed at
               pipelines 4 and 1 and eval_split_device over the slice's
               world give identical trajectories (viewpoints; headings
               and elevations within 1e-6), episodes/s each, and exactly
               9 attention launches per text encoding (a lock-step batch,
               a packed group's first fill, each 8-row chunk of refilled
               text rows) plus 18 per policy step; the packed evaluator's
               dispatch runs under torch.cuda's sync debug mode "error"
               (it never waits for the card); no_cand_backtrack through
               eval_split and eval_split_packed, identical and never
               revisiting a viewpoint; eval_split without the feature
               table (panoramas shipped per step) identical to it with
               the table. Then bf16: packed against lock-step, each
               episode identical up to the first step where the two
               part, their logits within the bf16 phase's tolerance at
               every step through it.
16. replay  -- the rollout-then-replay sample update at full `r2r` width,
               fp32, production dropout, batch 8, T 15: with the device
               rollout (merged and fused off) and with the host-loop
               rollout (no feature table), one warm-up and 2 timed
               updates each (sample episodes/s, peak memory, and exactly
               the rollout's launches, 279 on the device or 9 + 18 per
               policy step on the host loop, plus 279 + 279 + 16 forward
               for the IL episode, the replay and its bootstrap, and 240
               + 240 backward per update); with dropout on, the replay's
               logits against the rollout's recorded ones within 2e-4;
               card against CPU at batch 4, dropout off: an argmax
               host-loop rollout's episode and rewards, and the replay
               update's loss and every model and critic gradient within
               train_parity's tolerances.
17. variants -- the task variants at full width, fp32, seeded random
               weights, each at its preset's batch over the slice's world
               with the task's items (run/profile_eval.py:slice_agent):
               `r2r_back` (T 30, frozen text and history: 549 forward
               launches per greedy batch, 480 backward per IL update),
               `cvdn` (100-token text, no_lang_ca, T 30: 313 / 311) and
               `reverie` (no_lang_ca, 20 objects per viewpoint, T 15: 159
               / 157; plan_ref reads the initial text encoding, so no
               precomputed language half runs). Per task: one timed
               greedy device-rollout batch with exactly launch_mix's
               forward launches; eval_split, eval_split_packed and
               eval_split_device over 24 items give identical
               trajectories, midstops and predicted objects, with exactly
               their launch formulas, and the task's metrics; one warm-up
               and 2 timed updates each of IL and the merged sample update
               (exact launches, episodes/s, peak memory), for REVERIE 2
               packed IL updates too; the sampling device rollout's
               rewards against the host hooks' on the same draws (within
               1e-6); card against CPU at batch 2, dropout off: identical
               greedy trajectories with logits within 1e-3, the IL loss
               and every gradient within check_grads (REVERIE's object
               logits within 1e-3 too).
18. vision  -- the vision pipeline at full width: the native navsim
               library built with g++ from this checkout (its tables
               against the numpy NavGraph's on the slice's world, every
               successor walk reaching its goal over the shortest
               distance, the sampler's direction bands); both kernels at
               the ViT's 197 x 197 (Dh 64, an all-zero mask) on its lanes,
               against their plain twins in fp32 and bf16, timed with the
               library and the bound: the forward at 36 (one panorama, the
               observation), 144 (the featurizer's 4 panoramas) and 900
               (the history's 25 x 36 images), the backward at 36; the
               featurizer (ViT-B/16 at 224, 1000 classes, 4 panoramas per
               call, run/profile_vision.py's set-up) over panoramas
               rendered by the native sampler from seeded equirects
               through the eval transform, fp32 and bf16: exactly 12
               forward launches per call, images/s through extract and
               with the batch resident on the card, idle share, peak
               memory, and card against CPU on one panorama (features and
               logits within 2e-4 in fp32, bf16 by bf16_close); e2e image
               pretraining (run/image_pretrain.py --synthetic: the r2r
               trunk with ViT-B/16 in the loop, batch 1, 80 tokens, 25
               steps, rangerlars), fp32 and bf16: one update per task with
               exactly image_pretrain_launch_mix's launches, then per task
               the host's batch building and 1 timed update (fp32 and
               bf16; exact launches, examples/s, peak memory; for MLM
               and SAP, one per route through the ViT, the idle share
               from one traced update); card against CPU at 2 history
               steps, dropout off, for MRC and SAP (the history's route
               through the ViT and the observation's): the loss and every
               gradient within train_parity's tolerances.
19. multi_gpu -- rank processes of tests/torch_parallel_harness.py
               (torchrun, bounded by MG_TIMEOUT; a failing or late rank
               fails the phase), the
               r2r preset at full width, dropout off, SGD, against one
               undistributed process; the card count. (a) NCCL, world of
               one: an IL update at batch 8 through the gradient
               all-reduce, bit-equal; the all-reduce of the gradient
               buffer timed, with its bytes. (b) two data ranks sharing
               the card over gloo at global batch 8 (4 lanes each): 3 IL
               and 3 merged sample updates, losses within 2e-5 / 1e-6,
               parameters within 1e-5 of each tensor's largest entry,
               the first IL and the first merged update's summed
               gradients (the critic's too) at the card's gradient bar;
               a greedy evaluation of 32 items sharded over the ranks (16
               lanes each), trajectories identical; launches per rank
               exact (279 / 240 per IL update, 295 / 240 merged, 279 per
               greedy batch); one bf16 IL update by bf16_close; the
               sharded feed's IL update (each rank's env on its shard)
               against one process fed the shards' rows. (c) two model
               ranks (6 heads each), beside (b): an IL update's
               loss, gathered gradients and the logits after it within
               1e-5 relative, a greedy batch's trajectories, launches
               per rank exact, the update's seconds and its all-reduces
               by group. (d) pretraining,
               two data ranks at batch 16: one update per task from the
               same weights, losses and summed gradients at phase 12's
               bars. Both kernels against their plain versions at the
               new shapes: 4 and 16 lanes at 12 heads, 8 and 32 lanes at
               6. (e) episodes/s and the all-reduce's ms per update
               beside nvidia-smi's card and power limit: smoke output
               (both ranks share one card). With two or more cards, NCCL
               one rank per card runs (b)'s updates too.
20. remat   -- activation recomputation (--remat, --remat_policy) at full
               `r2r` width, batch 8, production dropout, fp32 and bf16:
               per dtype three agents from the same weights and streams,
               remat off, `full` and `dots`, each taking one warm-up IL
               update and then one IL, merged, fused and packed IL update
               (the same batches): every update's loss within
               train_parity's bar of remat off's, the parameters' change
               over the updates within its gradient bar (check_grads),
               the dropout masks', attention seeds' and actions' next
               draws equal, and each update's forward and backward
               launches exactly launch_mix(remat) / packed_il_mix(remat)
               (+ bootstrap_mix); peak memory and episodes/s of each
               update printed. The `rxr` merged update, fp32, off, `full`
               and `dots` (one warm-up update, one measured): `full`'s
               peak memory below remat off's. A profile_trace of one
               `full` IL update read back by utils/xprof.analyze: exactly
               the mix's attention forward and backward launches, with no
               lead-in from this script (profile_trace warms its tracer).
21. shapes  -- the shapes past the whole-row kernels, which the key-blocked
               kernels (csrc/attention_blocked.cu, attention_blocked_bwd.cu)
               take: the whole-row kernels' key limits by head width
               (ops/attention.py:FWD_SMEM_MAX_LK, BWD_SMEM_MAX_LK) held
               against the libraries' shared memory; check_fwd_layout and check_bwd_layout
               passing for every head width 1..128 at 15 key rows up to
               1024 (layer views, fp32 and bf16); both kernels once per
               head width 1..128 against their plain versions; both at
               Lk 257, 301, 514 and 577 (Lq = Lk) and Dh 12, 48, 64, 80 and
               128, fp32 and bf16, dropout 0 and 0.1, with one lane's keys
               all at -10000 and a key inside the last key block dropped,
               at phase 3's bars, each call on the key-blocked kernels, and
               both kernels' element loads beside their 16-byte staging at
               every such shape (ops/attention.py:blocked_staging: q, k
               and v copied one element past a 16-byte boundary, and the
               bf16 Dh 12 views);
               then, counts zeroed just before each and read just after,
               one update or call of each JAX CLI configuration that
               reaches them, at full width, with exact launches by kernel
               and a finite loss: run/image_pretrain.py --transform none
               (the ViT at the store's 248 x 330, 301 tokens; SAP),
               run/precompute_features.py --image_size 384 384 on one
               synthetic viewpoint (577 tokens, bf16), run/image_pretrain.py
               --tiny (the ViT's Dh 12; SAP) and run/pretrain.py
               --max_txt_len 300 (MLM at batch 16); ViT-B/16 at 301 and 577
               tokens card against CPU on 2 images (fp32, within 2e-4);
               each key-blocked shape of those runs (lanes, heads, Lq, Lk
               and Dh as the runs gave them) held against its plain
               version in fp32 and bf16 at dropout 0 and 0.1, at phase 3's
               bars, then timed against its plain version, scaled_dot_product_attention and
               the bound, with each row's staging path; both key-blocked
               kernels' shared memory per CTA and CTAs per SM by type and
               padded head width (the backward's statistics pass and
               key-block kernel each); and at the ViT's 197 keys,
               which the whole-row kernels keep, each key-blocked kernel
               timed beside its whole-row one.

The second-to-last line is the kernel summary {"kernels": [...]}, each
kernel at the batch of its main path: the forward's launches from the
serving slice and its times at batch 32, the backward's from the
training slice and its times at batch 8; each also with its launches
per merged and per fused sample update and its times at batch 16, and
per family preset its launches in the family phase and its times
weighted by the merged update's launches (the rollout's and the
backward's at twice the preset's batch, the bootstrap's at the batch),
with the forward's times at the greedy batch beside them; and per
pretraining preset its launches per update of each task, in the timed
mix (`r2r`), and its times weighted by the mix's launches by lanes and
shape; per kernel its bf16 times (``bf16``: per path, weighted by the
path's launches, the bound counting bf16 q, k, v bytes and the tensor
cores' bf16 rate) and launches of
the bf16 phases, and its packed-IL launches and times (``packed_il``);
its launches per batch of each host-loop evaluator (``hostloop``, the
forward) and per replay update (``replay``, by rollout); and per task
variant (``variants``) its launches per greedy batch, IL, merged and
packed update, the launches of phase 17, and its times weighted as the
family's; and its ``vision`` fields: launches per featurize call and per
e2e update of each task, and its times at the ViT's lanes (the
featurizer's 144, the e2e update's 900 and 36), fp32 and bf16. Two more
lines are the key-blocked kernels': launches summed over phase 21's
configuration runs (and per run), times weighted by those runs' launches
by shape, fp32 and bf16 (``bf16``), each shape's staging path, the
build's registers and spill bytes per entry and CTAs per SM, and the
197-key comparison. The family
times and the `rxr` pretraining mix's come in fp32 and bf16 (``bf16``
under each preset). The bf16
phases' lines carry the fp32 peak memory beside the bf16 one and the
device kernels per update in both (torch.profiler, as
run/profile_train.py counts them). Its ``remat`` fields: launches per
update of each phase 20 path in fp32, remat off, `full` and `dots`.
The last is {"ok": true, "device": {...}}.
Every phase before 21 reads the whole-row kernels' counts through
tier_launches, which fails if a key-blocked kernel ran on a path of
preset shapes. Without a CUDA device, or without the rest of the
repository beside it, the script exits non-zero before printing either.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
from concurrent.futures import ThreadPoolExecutor
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from vln_hamt_torch.agents import agent as agent_module
from vln_hamt_torch.agents.agent import HAMTAgent, _PackedEvalGroup
from vln_hamt_torch.agents.losses import IGNORE_ID, il_loss
from vln_hamt_torch.agents.packing import unpack_episodes
from vln_hamt_torch.configs import get_preset
from vln_hamt_torch.models.hamt import HAMT, Critic, init_hamt
from vln_hamt_torch.data.fixtures import export_nav_and_annotations
from vln_hamt_torch.native import navsim
from vln_hamt_torch.ops import attention as attn
from vln_hamt_torch.pretrain.image_model import init_image_pretrain
from vln_hamt_torch.pretrain.model import batch_to_device, init_pretrain
from vln_hamt_torch.run import finetune, precompute_features
from vln_hamt_torch.run.profile_attention import (
    bootstrap_mix, build_all, bwd_blocked_occupancy, cuda_time_ms,
    element_layout, fwd_blocked_occupancy,
    image_pretrain_kernel_counts, image_pretrain_launch_mix, kernel_counts, kernel_inputs,
    launch_mix, nvidia_smi, packed_il_mix, pretrain_launch_mix, rel_err, staging_name,
    text_launches, time_backward, time_forward, weighted)
from vln_hamt_torch.run.profile_eval import kernel_table, slice_agent, slice_config, slice_env
from vln_hamt_torch.run.profile_pretrain import slice_mixes, slice_trainer
from vln_hamt_torch.run.profile_vision import (
    PANOS_PER_BATCH, e2e_args, e2e_batcher, e2e_mixes, pipelined_images_per_s, render_panoramas,
    resident_call_ms, slice_e2e_trainer, slice_featurizer, timed_build_and_updates, traced)
from vln_hamt_torch.utils import xprof
from vln_hamt_torch.utils.logging import profile_trace
from vln_hamt_torch.vision.vit import ViTConfig, vit_base_patch16

B, H, DH = 32, 12, 64
TRAIN_B = 8  # the r2r preset's training batch
MERGED_B = 2 * TRAIN_B  # lanes of the merged sample update's rollout
TOL = {  # forward kernel vs plain twin, max abs error
    (torch.float32, 0.0): 1e-5,  # fp32, another summation order
    (torch.bfloat16, 0.0): 1e-5,  # bf16 inputs widened to fp32 alike on both sides
    (torch.float32, 0.1): 2e-5,  # kept values scaled by 1 / (1 - rate)
    (torch.bfloat16, 0.1): 2e-5,
}
# shapes the query-blocked tilings can get wrong, checked at both
# batches: (Lq, Lk, Dh, every third batch element's keys all at -10000)
EDGE_CASES = ((1, 1, DH, False), (33, 65, DH, False), (65, 65, DH, True),
              (65, 65, 16, False), (65, 65, 128, False))
# and for the backward the lengths past its old limit of 114 tokens (R4R
# and CVDN text, RxR text and its cross-attention with the visual
# tokens), and 300 query rows: more query blocks than a thread-block
# cluster holds, summed through global scratch
BWD_EDGE_CASES = EDGE_CASES + ((100, 100, DH, False), (250, 65, DH, False),
                               (65, 250, DH, False), (250, 250, DH, False),
                               (300, 65, DH, False))
# backward kernel vs plain twin, max abs error over the tensor's max abs
# value. fp32: sums of at most 250 (dq, dk, dv) or 12 x 250 (dm) products
# in another order than cuBLAS's. bf16 dq, dk, dv: both sides round an
# fp32 value to bf16, and a last-bit fp32 difference may flip that
# rounding by one bf16 step, 2^-8 of the value. dm is fp32 always.
BWD_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -8}
BWD_DM_RTOL = 2e-5
PARITY_LOGIT_ATOL = 1e-3  # card vs CPU after 13 fp32 layers per step
# card vs CPU rewards of one rollout: fp32 distances and nDTW, as the
# JAX package holds its device rollout against its host rollout
REWARD_RTOL, REWARD_ATOL = 1e-4, 1e-5
# card vs CPU, one IL update: the loss relative, each gradient tensor
# within 1e-3 of its own largest entry, plus 1e-6 of the model's largest
# gradient for tensors that are zero in exact arithmetic and rounding
# noise on both sides (the attention key biases, the action head's
# LayerNorm and output biases: a softmax ignores a shift of its inputs)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR = 1e-3, 1e-6
# the family presets whose shapes are new to the kernels; r2r_last has r2r's
FAMILY = ("rxr", "r4r")
# the task variants (phase 17), the items each evaluator takes there, and
# the sampling rollout's rewards, device against host hooks, on the card
VARIANTS = ("r2r_back", "cvdn", "reverie")
VARIANT_EVAL_ITEMS = 24
VARIANT_REWARD_ATOL = 1e-6
# one agent's logits against another's with the same weights, the same
# kernels and the same inputs: only the order of host-issued work differs
SAME_WEIGHTS_ATOL = 1e-6
# pretraining: the JAX CLI's batch; its presets; timed updates of the
# mix; the card-against-CPU batch
PRETRAIN_B = 16
PRETRAIN_PRESETS = ("r2r", "rxr")
PRETRAIN_UPDATES = 30
PRETRAIN_PARITY_B = 2
# the tasks whose update is traced for its device kernels, fp32 and bf16:
# the text route and the observation route
PRETRAIN_TRACED = ("mlm", "sap")
# the packed IL update's text rows at r2r's batch 8 and T 15
# (agents/packing.py: max(8 + 1, 8 * 15 // 4))
PACKED_TEXT_CAP = 30
# bf16 card against CPU: the yardstick of tests/test_torch_bf16.py, the
# card's bf16 within BF16_FACTOR times the CPU's bf16-to-fp32 distance
# plus BF16_ATOL (scaled down to the answer's largest entry below 1) of
# the fp32 answer (bf16_close); losses compared over BF16_LOSS_BATCHES
# batches; a bias whose fp32 gradient is at most ZERO_GRAD_RTOL of its
# weight's is zero to rounding (bf16_grads_close)
BF16_FACTOR, BF16_ATOL = 3.0, 1e-3
BF16_LOSS_BATCHES = 3
ZERO_GRAD_RTOL = 1e-4
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
              "feat_dropout": 0.0, "pred_head_dropout_prob": 0.0, "critic_dropout": 0.0}
BF16 = {"dtype": "bfloat16"}
# host-loop evaluators: poses of identical trajectories (headings and
# elevations are functions of the view index on every path)
POSE_ATOL = 1e-6
# timed updates of the fp32 IL and sample paths, and of the bf16 and
# packed ones, after WARMUP_UPDATES (depths cut to keep the script within
# its time limit)
WARMUP_UPDATES = 1
# updates on one repeated batch whose loss must fall (phases 6 and 13)
FIT_UPDATES = 8
TIMED_UPDATES = 2
TIMED_UPDATES_BF16 = 2
VARIANT_TIMED_UPDATES = 1
# the replay update: timed updates per rollout, and replayed against
# recorded logits with dropout on (the JAX package's
# test_rl_replay_matches_rollout_logits bound)
REPLAY_UPDATES = 2
REPLAY_LOGIT_ATOL = 2e-4


# phase 18, the vision pipeline: the ViT's attention lanes (one panorama
# and the observation ViT; the featurizer's 4 panoramas; the history
# ViT's 25 x 36 images at batch 1), forward and, for the observation,
# backward; viewpoints through the pipelined extract (2 calls); resident
# calls timed; card against CPU features and logits in fp32 (the
# repository's parity bar); timed e2e updates per task (bf16's depth cut
# for the script's time limit); the history length of the e2e
# card-against-CPU check and its tasks (bound the CPU's time)
VIT_FWD_LANES = (36, 36 * PANOS_PER_BATCH, 25 * 36)
VIT_BWD_LANES = (36,)
VISION_PANOS = 8
VISION_RESIDENT_ITERS = 6
FEAT_ATOL = 2e-4
E2E_UPDATES = {"float32": 1, "bfloat16": 1}
# the e2e tasks whose update is traced: one per route through the ViT (the
# history alone; the observation with gradient), PERF.md §5's rows
E2E_TRACED = ("mlm", "sap")
E2E_PARITY_HIST = 2
# the e2e card-against-CPU check's tasks: one per route through the ViT
# (MRC: the history without gradient, masked after the ViT; SAP: the
# observation with gradient, ob_v_exists and the STOP row); the trunk's
# tasks are held card against CPU in phase 12, all six e2e tasks against
# the JAX package on the CPU (tests/test_torch_image_pretrain.py)
E2E_PARITY_TASKS = ("mrc", "sap")


# the ModelConfig fields that choose only how a model runs (its dropout
# rates, compute type, recomputation and frozen stacks), never its weights
RUN_ONLY = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
            "pred_head_dropout_prob": 0.0, "feat_dropout": 0.0, "critic_dropout": 0.0,
            "dtype": "float32", "use_pallas_attention": False, "remat": False,
            "remat_policy": "full", "fix_lang_embedding": False,
            "fix_hist_embedding": False, "fix_obs_embedding": False}
# the initial state of each (config but RUN_ONLY, seed) the agents were
# built with
_INITS = {}


def memo_init_hamt(mcfg, seed: int = 0):
    """models/hamt.py:init_hamt, each (config, seed) drawn once, the
    config with its RUN_ONLY fields set to one value: a later agent whose
    config differs only there (another dtype, dropout or remat setting)
    loads a copy of the same state into a model built from its own
    config. Every other field, one that may come to shape the weights
    (initializer_range) too, draws anew. The script builds some 40 agents,
    and drawing each anew was among its largest costs; main() puts this
    in place of the agents' init_hamt (tests/test_torch_smoke_init.py
    holds it equal to init_hamt)."""
    key = (seed, dataclasses.replace(mcfg, **RUN_ONLY))
    if key not in _INITS:
        model, critic = init_hamt(mcfg, seed)
        _INITS[key] = tuple({k: v.clone() for k, v in m.state_dict().items()}
                            for m in (model, critic))
        return model, critic
    with torch.device("meta"):
        model, critic = HAMT(mcfg), Critic(mcfg)
    for m, state in zip((model, critic), _INITS[key]):
        m.to_empty(device="cpu")
        m.load_state_dict(state)
    return model, critic


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def reset_counts() -> None:
    for name in attn.launch_counts:
        attn.launch_counts[name] = 0


def tier_launches(counts=None) -> dict:
    """The whole-row kernels' launches of ``counts`` (the wrappers' counts
    by default), raising if a key-blocked kernel was launched: no path of
    phases 3-20 has a shape past the whole-row kernels'."""
    counts = dict(attn.launch_counts if counts is None else counts)
    blocked = {name: counts.pop(name) for name in attn.BLOCKED}
    if any(blocked.values()):
        raise AssertionError(f"a key-blocked kernel ran on a path of preset shapes: {blocked}")
    return counts


def check_bwd(q, k, v, m, g, seed, rate, where):
    """The backward kernel against its plain twin on the same inputs:
    each output's relative error, raising above its tolerance; and the
    largest absolute error."""
    got = attn.attention_bwd(q, k, v, m, g, seed, rate)
    want = attn.attention_bwd_reference(q, k, v, m, g, seed, rate)
    torch.cuda.synchronize()
    errs, abs_err = {}, 0.0
    for name, x, y in zip(("dq", "dk", "dv", "dm"), got, want):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"backward {name}: {x.shape} {x.dtype} vs "
                                 f"{y.shape} {y.dtype}")
        errs[name] = rel_err(x, y)
        tol = BWD_DM_RTOL if name == "dm" else BWD_RTOL[q.dtype]
        if not errs[name] <= tol:
            raise AssertionError(f"attention backward {where} {q.dtype} rate {rate}: "
                                 f"{name} rel err {errs[name]} > {tol}")
        abs_err = max(abs_err, (x.float() - y.float()).abs().max().item())
    return errs, abs_err


def check_fwd(q, k, v, m, seed, rate, where) -> float:
    """The forward kernel against its plain twin on the same inputs: the
    largest absolute error, raising above its tolerance or on a wrong
    shape or a non-finite value."""
    got = attn.fused_attention(q, k, v, m, dropout_rate=rate, dropout_seed=seed)
    want = attn.attention_reference(q, k, v, m, seed, rate)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"attention {where}: output {tuple(got.shape)} against "
                             f"{tuple(want.shape)}, or not finite")
    err = (got - want).abs().max().item()
    tol = TOL[(q.dtype, rate)]
    if not err <= tol:
        raise AssertionError(f"attention {where} {q.dtype} rate {rate}: "
                             f"max abs err {err} > {tol}")
    return err


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def phase_kernels(dev, fwd_mix, bwd_mix, l_txt):
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd_rows, bwd_rows, fwd_err, bwd_err = [], [], 0.0, 0.0
    seed = 2**31 + 7  # above int32: exercises the 32-bit wrap
    for (lq, lk) in fwd_mix:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, m, g = kernel_inputs(B, H, lq, lk, DH, dtype, gen, dev)
            for rate in (0.0, 0.1):
                err = check_fwd(q, k, v, m, seed, rate, f"B {B} ({lq},{lk})")
                fwd_err = max(fwd_err, err)
                row = {"lq": lq, "lk": lk, "dtype": dtype_name(dtype), "rate": rate,
                       "max_abs_err": err, "tol": TOL[(dtype, rate)]}
                if rate == 0.0:
                    row.update(time_forward(q, k, v, m))
                fwd_rows.append(row)

                # the backward at the same inputs, dropout bits included
                errs, err = check_bwd(q, k, v, m, g, seed, rate, f"B {B} ({lq},{lk})")
                bwd_err = max(bwd_err, err)
                brow = {"lq": lq, "lk": lk, "dtype": dtype_name(dtype), "rate": rate,
                        "rel_err": errs, "rtol": BWD_RTOL[dtype], "dm_rtol": BWD_DM_RTOL}
                if rate == 0.0:
                    brow.update(time_backward(q, k, v, m, g), main_path=(lq, lk) in bwd_mix)
                bwd_rows.append(brow)
    emit("kernels", kernel="attention_fwd", batch=B, heads=H, head_dim=DH, results=fwd_rows)
    emit("kernels", kernel="attention_bwd", batch=B, heads=H, head_dim=DH, results=bwd_rows)

    # the forward at the training batch, which each IL update launches 279
    # times: checked at both rates, timed with dropout off
    fwd8 = []
    for (lq, lk) in fwd_mix:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, m, _ = kernel_inputs(TRAIN_B, H, lq, lk, DH, dtype, gen, dev)
            for rate in (0.0, 0.1):
                err = check_fwd(q, k, v, m, seed, rate, f"B {TRAIN_B} ({lq},{lk})")
                fwd_err = max(fwd_err, err)
                row = {"lq": lq, "lk": lk, "dtype": dtype_name(dtype), "rate": rate,
                       "max_abs_err": err}
                if rate == 0.0:
                    row.update(time_forward(q, k, v, m))
                fwd8.append(row)
    emit("kernels", kernel="attention_fwd", batch=TRAIN_B, heads=H, head_dim=DH, results=fwd8,
         weighted={key: weighted(fwd8, fwd_mix, lambda r: r[key])
                   for key in ("ms", "plain_ms", "library_ms", "bytes_ms", "flops_ms")})

    # the edge cases of the query-blocked tilings, at both batches
    edge, bwd_edge = [], []
    for batch in (B, TRAIN_B):
        for (lq, lk, dh, masked) in BWD_EDGE_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, m, g = kernel_inputs(batch, H, lq, lk, dh, dtype, gen, dev, masked)
                for rate in (0.0, 0.1):
                    where = f"B {batch} ({lq},{lk}) Dh {dh}{' masked rows' if masked else ''}"
                    case = {"batch": batch, "lq": lq, "lk": lk, "head_dim": dh,
                            "masked_rows": masked, "dtype": dtype_name(dtype), "rate": rate}
                    if (lq, lk, dh, masked) in EDGE_CASES:
                        err = check_fwd(q, k, v, m, seed, rate, where)
                        fwd_err = max(fwd_err, err)
                        edge.append({**case, "max_abs_err": err})
                    errs, err = check_bwd(q, k, v, m, g, seed, rate, where)
                    bwd_err = max(bwd_err, err)
                    bwd_edge.append({**case, "rel_err": errs})
    emit("kernels", kernel="attention_fwd", edge_cases=edge)
    emit("kernels", kernel="attention_bwd", edge_cases=bwd_edge)

    # the backward at the training batch and the main path's own shapes:
    # checked at both rates, timed with dropout off
    b8 = []
    for (lq, lk) in bwd_mix:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, m, g = kernel_inputs(TRAIN_B, H, lq, lk, DH, dtype, gen, dev)
            for rate in (0.0, 0.1):
                errs, err = check_bwd(q, k, v, m, g, seed, rate,
                                      f"B {TRAIN_B} ({lq},{lk})")
                bwd_err = max(bwd_err, err)
                row = {"lq": lq, "lk": lk, "dtype": dtype_name(dtype), "rate": rate,
                       "rel_err": errs}
                if rate == 0.0:
                    row.update(time_backward(q, k, v, m, g))
                b8.append(row)
    emit("kernels", kernel="attention_bwd", batch=TRAIN_B, heads=H, head_dim=DH, results=b8)

    # both kernels at the merged sample update's 16 lanes, fp32 and bf16,
    # at the shapes it launches them with: checked at both rates, timed
    # with dropout off
    f16, b16 = [], []
    for (lq, lk) in fwd_mix:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, m, g = kernel_inputs(MERGED_B, H, lq, lk, DH, dtype, gen, dev)
            for rate in (0.0, 0.1):
                where = f"B {MERGED_B} ({lq},{lk})"
                row = {"lq": lq, "lk": lk, "dtype": dtype_name(dtype), "rate": rate,
                       "max_abs_err": check_fwd(q, k, v, m, seed, rate, where)}
                fwd_err = max(fwd_err, row["max_abs_err"])
                if rate == 0.0:
                    row.update(time_forward(q, k, v, m))
                f16.append(row)
                if (lq, lk) not in bwd_mix:
                    continue
                errs, err = check_bwd(q, k, v, m, g, seed, rate, where)
                bwd_err = max(bwd_err, err)
                brow = {"lq": lq, "lk": lk, "dtype": dtype_name(dtype), "rate": rate,
                        "rel_err": errs, "max_abs_err": err}
                if rate == 0.0:
                    brow.update(time_backward(q, k, v, m, g))
                b16.append(brow)
    emit("kernels", kernel="attention_fwd", batch=MERGED_B, heads=H, head_dim=DH, results=f16)
    emit("kernels", kernel="attention_bwd", batch=MERGED_B, heads=H, head_dim=DH, results=b16)

    # the packed IL update's text stack: 60 x 60 at the pack's 30 text
    # rows, forward and (as with fix_lang_embedding off) backward, fp32
    # and bf16, checked at both rates and timed with dropout off
    fpk, bpk = [], []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, m, g = kernel_inputs(PACKED_TEXT_CAP, H, l_txt, l_txt, DH, dtype, gen, dev)
        for rate in (0.0, 0.1):
            where = f"packed text {PACKED_TEXT_CAP} lanes ({l_txt},{l_txt})"
            case = {"lanes": PACKED_TEXT_CAP, "lq": l_txt, "lk": l_txt,
                    "dtype": dtype_name(dtype), "rate": rate}
            err = check_fwd(q, k, v, m, seed, rate, where)
            fwd_err = max(fwd_err, err)
            fpk.append({**case, "max_abs_err": err,
                        **(time_forward(q, k, v, m) if rate == 0.0 else {})})
            errs, err = check_bwd(q, k, v, m, g, seed, rate, where)
            bwd_err = max(bwd_err, err)
            bpk.append({**case, "rel_err": errs, "max_abs_err": err,
                        **(time_backward(q, k, v, m, g) if rate == 0.0 else {})})
    emit("kernels", kernel="attention_fwd", packed_text=[PACKED_TEXT_CAP, l_txt, l_txt],
         heads=H, head_dim=DH, results=fpk)
    emit("kernels", kernel="attention_bwd", packed_text=[PACKED_TEXT_CAP, l_txt, l_txt],
         heads=H, head_dim=DH, results=bpk)
    return (fwd_rows, bwd_rows, fwd8, b8, (f16, b16), (fpk, bpk), fwd_err, bwd_err)


def kernel_times(*parts, dtype: str = "float32"):
    """Times and bound per launch, weighted over the launches by shape of
    each (rows, mix) part: ``rows`` timed at one batch, ``mix`` the
    launches by shape made at that batch; the rows of ``dtype``."""
    total = sum(sum(mix.values()) for _, mix in parts)

    def mean(key):
        return sum(weighted(rows, mix, key, dtype) * sum(mix.values())
                   for rows, mix in parts) / total

    bytes_mean, flops_mean = mean(lambda r: r["bytes_ms"]), mean(lambda r: r["flops_ms"])
    return {
        "ms": mean(lambda r: r["ms"]),
        "plain_ms": mean(lambda r: r["plain_ms"]),
        "bound_ms": mean(lambda r: max(r["bytes_ms"], r["flops_ms"])),
        "bound_by": "bytes" if bytes_mean >= flops_mean else "operations",
        "library_ms": mean(lambda r: r["library_ms"]),
    }


def summary_row(name, source, replaces, launches, max_err, rows, mix, batch, sample,
                family, pretrain, **paths):
    """The kernel's line of the summary: ``launches`` from the run of its
    main path, times and bound from ``rows`` timed at that path's batch
    and shapes, weighted by its launches per shape; ``sample``: its
    launches per merged and fused sample update and its times at the
    merged update's batch; ``family``: per family preset its launches in
    the family phase's merged updates and its times weighted by a merged
    update's launches by shape and lanes; ``pretrain``: per pretraining
    preset its launches per update of each task (and in the timed mix)
    and its times weighted by the mix's launches by lanes and shape;
    ``paths``: further paths' fields (``bf16``, ``packed_il``)."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "batch": batch, "max_abs_err": max_err,
            **kernel_times((rows, mix)), "sample": sample, "family": family,
            "pretrain": pretrain, **paths}


def sample_gradients(agent, il_ep, ins):
    """Loss and named model and critic gradients of the fused sample
    update's loss with the argmax policy (no draws), no step."""
    agent.model.train()
    agent.critic.train()
    loss, _ = agent._fused_sample_loss(il_ep, ins, policy="argmax")
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in agent.model.named_parameters()
             if p.grad is not None}
    grads.update({"critic." + k: p.grad.detach().cpu()
                  for k, p in agent.critic.named_parameters()})
    return loss.item(), grads


def check_grads(grads_g, grads_c, what):
    """Card gradients against CPU ones, each tensor within TRAIN_GRAD_REL
    of its own largest entry plus TRAIN_GRAD_FLOOR of the largest
    gradient; returns the worst error over its tolerance."""
    if grads_g.keys() != grads_c.keys():
        raise AssertionError(f"{what}: gradients on different parameters: "
                             f"{sorted(grads_g.keys() ^ grads_c.keys())}")
    top = max(g.abs().max().item() for g in grads_c.values())
    worst = 0.0
    for name, gc in grads_c.items():
        scale = gc.abs().max().item()
        err = (grads_g[name] - gc).abs().max().item()
        tol = TRAIN_GRAD_REL * scale + TRAIN_GRAD_FLOOR * top
        if not err <= tol:
            raise AssertionError(f"{what}: card vs CPU gradient of {name}: {err} "
                                 f"(max {scale})")
        worst = max(worst, err / tol)
    return worst


def timed_sample_updates(agent, iters):
    """``iters`` sample updates, unsynchronized, from zeroed launch
    counts: their losses (host tensors), wall seconds and launches."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    outs = [agent.train_iteration("sample", sync=False) for _ in range(iters)]
    keys = ("loss", "IL_loss", "RL_loss", "entropy")
    vals = torch.stack([torch.stack([o[k] for k in keys]) for o in outs]).cpu()
    seconds = time.perf_counter() - t0
    launches = tier_launches()
    if not torch.isfinite(vals).all():
        raise AssertionError(f"non-finite sample losses {vals.tolist()}")
    return dict(zip(keys, vals.T)), seconds, launches


def phase_family_kernels(dev, mixes):
    """Both kernels at each family preset's shapes, at its batch (the
    greedy batch and the bootstrap) and at twice it (the merged update's
    rollout and backward), against their plain twins (fp32 and bf16,
    dropout off and on), timed in fp32 and bf16 with dropout off. Per preset a
    dict batch -> (forward rows, backward rows), and the largest forward
    and backward errors over all presets."""
    gen = torch.Generator(device=dev).manual_seed(1)
    seed = 2**31 + 7
    out, ferr, berr = {}, 0.0, 0.0
    done = {}  # (kernel, lanes, Lq, Lk, dtype, rate) -> row: a shape two presets share
    for task, (batch, fwd_mix, bwd_mix) in mixes.items():
        out[task] = {}
        for b in (batch, 2 * batch):
            frows, brows = [], []
            for (lq, lk) in fwd_mix:
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v, m, g = kernel_inputs(b, H, lq, lk, DH, dtype, gen, dev)
                    for rate in (0.0, 0.1):
                        where = f"{task} B {b} ({lq},{lk})"
                        case = {"lq": lq, "lk": lk, "dtype": dtype_name(dtype), "rate": rate}
                        timed = rate == 0.0
                        key = (b, lq, lk, case["dtype"], rate)
                        if ("fwd",) + key not in done:
                            err = check_fwd(q, k, v, m, seed, rate, where)
                            ferr = max(ferr, err)
                            done[("fwd",) + key] = {
                                **case, "max_abs_err": err,
                                **(time_forward(q, k, v, m) if timed else {})}
                        frows.append(done[("fwd",) + key])
                        if (lq, lk) not in bwd_mix:
                            continue
                        if ("bwd",) + key not in done:
                            errs, err = check_bwd(q, k, v, m, g, seed, rate, where)
                            berr = max(berr, err)
                            done[("bwd",) + key] = {
                                **case, "rel_err": errs, "max_abs_err": err,
                                **(time_backward(q, k, v, m, g) if timed else {})}
                        brows.append(done[("bwd",) + key])
            for name, rows, mix in (("attention_fwd", frows, fwd_mix),
                                    ("attention_bwd", brows, bwd_mix)):
                emit("kernels", kernel=name, preset=task, batch=b, heads=H, head_dim=DH,
                     results=rows, weighted=kernel_times((rows, mix)),
                     weighted_bf16=kernel_times((rows, mix), dtype="bfloat16"))
            out[task][b] = (frows, brows)
    return out, ferr, berr


def lane_times(rows_by_shape, mix, dtype: str = "float32"):
    """kernel_times over a mix keyed by (lanes, Lq, Lk): one part per
    lane count, its rows (of ``dtype``) timed at those lanes."""
    parts = []
    for lanes in sorted({s[0] for s in mix}):
        rows = [r for s, r in rows_by_shape.items() if s[0] == lanes]
        parts.append((rows, {(s[1], s[2]): n for s, n in mix.items() if s[0] == lanes}))
    return kernel_times(*parts, dtype=dtype)


def rows_by_lanes(lanes, rows, dtype):
    """Timed rows (dropout off) of one ``dtype`` keyed by (lanes, Lq, Lk)."""
    return {(lanes, r["lq"], r["lk"]): r for r in rows
            if r["dtype"] == dtype and "ms" in r}


def mix_launches(mixes, shares):
    """Expected launches per update of a task mix by (lanes, Lq, Lk),
    forward and backward."""
    fwd, bwd = {}, {}
    for task, (f, b) in mixes.items():
        for out, mix in ((fwd, f), (bwd, b)):
            for shape, n in mix.items():
                out[shape] = out.get(shape, 0.0) + shares[task] * n
    return fwd, bwd


def phase_pretrain_kernels(dev, pmixes):
    """Both kernels at every pretraining shape and lanes of the presets in
    ``pmixes`` ({preset: (per-task mixes, shares)}), against their plain
    twins (fp32 and bf16, dropout off and on), timed in fp32 and bf16 with
    dropout off. Returns the timed rows by dtype and (lanes, Lq, Lk) per
    kernel and the largest forward and backward errors."""
    gen = torch.Generator(device=dev).manual_seed(2)
    seed = 2**31 + 7
    fshapes = sorted({s for mixes, _ in pmixes.values() for f, _ in mixes.values() for s in f})
    bshapes = {s for mixes, _ in pmixes.values() for _, b in mixes.values() for s in b}
    timed = {name: {"float32": {}, "bfloat16": {}} for name in ("attention_fwd",
                                                               "attention_bwd")}
    ferr = berr = 0.0
    for shape in fshapes:
        lanes, lq, lk = shape
        frows, brows = [], []
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, m, g = kernel_inputs(lanes, H, lq, lk, DH, dtype, gen, dev)
            for rate in (0.0, 0.1):
                where = f"pretrain lanes {lanes} ({lq},{lk})"
                case = {"lanes": lanes, "lq": lq, "lk": lk, "dtype": dtype_name(dtype),
                        "rate": rate}
                timing = rate == 0.0
                err = check_fwd(q, k, v, m, seed, rate, where)
                ferr = max(ferr, err)
                frows.append({**case, "max_abs_err": err,
                              **(time_forward(q, k, v, m) if timing else {})})
                if shape not in bshapes:
                    continue
                errs, err = check_bwd(q, k, v, m, g, seed, rate, where)
                berr = max(berr, err)
                brows.append({**case, "rel_err": errs, "max_abs_err": err,
                              **(time_backward(q, k, v, m, g) if timing else {})})
        for name, rows in (("attention_fwd", frows), ("attention_bwd", brows)):
            if rows:
                for row in rows:
                    if "ms" in row:  # dropout off: the timed ones
                        row.update(bound_ms=max(row["bytes_ms"], row["flops_ms"]))
                        timed[name][row["dtype"]][shape] = row
                emit("kernels", kernel=name, pretrain_shape=[lanes, lq, lk], heads=H,
                     head_dim=DH, results=rows)
    for preset, (mixes, shares) in pmixes.items():
        for name, mix in zip(("attention_fwd", "attention_bwd"), mix_launches(mixes, shares)):
            emit("kernels", kernel=name, pretrain=preset, batch=PRETRAIN_B,
                 launches_per_update={t: sum((f if name == "attention_fwd" else b).values())
                                      for t, (f, b) in mixes.items()},
                 weighted_over_mix=lane_times(timed[name]["float32"], mix),
                 weighted_over_mix_bf16=lane_times(timed[name]["bfloat16"], mix, "bfloat16"))
    return timed, ferr, berr


def pretrain_gradients(model, batch, task, table):
    """Loss, metrics and named gradients of one task's forward on a host
    batch, dropout off, no step; the gradients left cleared."""
    model.eval()
    model.zero_grad(set_to_none=True)
    loss, aux = model(batch_to_device(batch, table.device), task, table)
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), {k: float(v.detach()) for k, v in aux.items()}, grads


@torch.no_grad()
def pretrain_loss(model, batch, task, table) -> float:
    """One task's loss on a host batch, dropout off, forward only."""
    model.eval()
    return model(batch_to_device(batch, table.device), task, table)[0].item()


def counted_update(trainer, task, batch, want, what):
    """One update of ``task`` from zeroed launch counts; raises unless it
    launched exactly ``want`` (a (forward, backward) pair of mixes) or
    its loss is not finite. Returns the loss."""
    torch.cuda.synchronize()
    reset_counts()
    loss, _ = trainer.update(task, batch)
    loss = float(loss)
    got = tier_launches()
    per = {"attention_fwd": sum(want[0].values()), "attention_bwd": sum(want[1].values())}
    if got != per or not math.isfinite(loss):
        raise AssertionError(f"{what} {task}: launches {got}, expected {per}; loss {loss}")
    return loss


def phase_pretrain(pmixes, tmp):
    """Pretraining at full r2r width, then its graft into fine-tuning, then
    the rxr preset (see the module docstring). Returns the summary's
    per-kernel pretraining fields (launches and the timed draw's mix)."""
    mixes, _ = pmixes["r2r"]
    trainer, val_batchers = slice_trainer("r2r", batch_size=PRETRAIN_B, seed=0)
    cfg, tasks = trainer.cfg, trainer.scheduler.tasks
    warm = {t: counted_update(trainer, t, trainer.batcher.batch(t, PRETRAIN_B), mixes[t],
                              "pretrain r2r") for t in tasks}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    outs = [trainer.train_step() for _ in range(PRETRAIN_UPDATES)]
    losses = torch.stack([loss for _, loss, _ in outs]).cpu()
    seconds = time.perf_counter() - t0
    launches = tier_launches()
    trainer.close()  # the prefetch thread is done with the batcher
    draw = [task for task, _, _ in outs]
    want = {"attention_fwd": sum(sum(mixes[t][0].values()) for t in draw),
            "attention_bwd": sum(sum(mixes[t][1].values()) for t in draw)}
    if launches != want or not torch.isfinite(losses).all():
        raise AssertionError(f"pretrain mix: launches {launches}, expected {want}; "
                             f"losses {losses.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    draw_mix = mix_launches({t: mixes[t] for t in set(draw)},
                            {t: draw.count(t) / len(draw) for t in set(draw)})
    kernels = task_kernels(trainer, PRETRAIN_TRACED)

    # card against CPU, dropout off, per task at batch 2
    cpu_model = init_pretrain(cfg, seed=0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    cpu_table = trainer._feat_table.cpu()
    parity = {}
    for task in tasks:
        batch = trainer.batcher.batch(task, PRETRAIN_PARITY_B)
        (loss_g, aux_g, grads_g), (loss_c, aux_c, grads_c) = (
            pretrain_gradients(trainer.model, batch, task, trainer._feat_table),
            pretrain_gradients(cpu_model, batch, task, cpu_table))
        loss_err = abs(loss_g - loss_c) / abs(loss_c)
        if not loss_err <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"pretrain {task}: card vs CPU loss {loss_g} vs {loss_c}")
        parity[task] = {"loss_cuda": loss_g, "loss_cpu": loss_c, "loss_rel_err": loss_err,
                        "tensors": len(grads_c),
                        "max_grad_err_over_tol": check_grads(grads_g, grads_c,
                                                             f"pretrain {task}")}
    del cpu_model, cpu_table

    val = trainer.validate(val_batchers["unseen"])
    if set(val) != set(tasks) or not all(
            math.isfinite(v) for stats in val.values() for v in stats.values()):
        raise AssertionError(f"pretrain validate: {val}")

    path = os.path.join(tmp, f"model_step_{trainer.step}.pt")
    trainer.save(path)
    head = trainer.model.next_action.net[0].weight.detach().clone()
    table32 = trainer._feat_table  # the bf16 part's fp32 answer reads it
    del trainer
    torch.cuda.empty_cache()
    fcfg, world = slice_config(TRAIN_B, seed=0)
    agent = HAMTAgent(fcfg, slice_env(fcfg, world, seed=0), seed=1)
    skipped = agent.init_from_pretrain(path)
    if skipped or not torch.equal(agent.model.next_action.net[0].weight, head):
        raise AssertionError(f"init_from_pretrain: skipped {skipped}, or the SAP head did "
                             "not graft onto the action head")
    agent.enable_feature_table()
    greedy_eps, trajs = timed_greedy_batch(agent, sum(launch_mix(fcfg)[0].values()),
                                           "pretrain graft")
    del agent
    emit("pretrain", preset="r2r", hidden=cfg.hidden_size,
         layers=[cfg.num_l_layers, cfg.num_x_layers, cfg.num_h_pano_layers],
         fix_lang_and_hist=[cfg.fix_lang_embedding, cfg.fix_hist_embedding], batch=PRETRAIN_B,
         dropout=[cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob, cfg.feat_dropout],
         warmup_losses=warm, updates=PRETRAIN_UPDATES, draw={t: draw.count(t) for t in tasks},
         seconds=seconds, examples_per_s=PRETRAIN_UPDATES * PRETRAIN_B / seconds,
         ms_per_update=seconds / PRETRAIN_UPDATES * 1e3, loss_mean=losses.mean().item(),
         launches=launches, peak_mem_gb=peak, kernels_per_update=kernels,
         launches_per_update={t: {"attention_fwd": sum(f.values()),
                                  "attention_bwd": sum(b.values())}
                              for t, (f, b) in mixes.items()},
         parity={"batch": PRETRAIN_PARITY_B, "loss_rtol": TRAIN_LOSS_RTOL,
                 "grad_rel_tol": TRAIN_GRAD_REL, "grad_floor": TRAIN_GRAD_FLOOR, **parity},
         validate=val, checkpoint_tensors=len(torch.load(path, weights_only=True)) - 1,
         graft={"skipped": skipped, "greedy_episodes": len(trajs),
                "greedy_episodes_per_s": greedy_eps})

    rmixes, _ = pmixes["rxr"]
    trainer, _ = slice_trainer("rxr", batch_size=PRETRAIN_B, seed=0)
    torch.cuda.reset_peak_memory_stats()
    rxr_losses = {t: counted_update(trainer, t, trainer.batcher.batch(t, PRETRAIN_B),
                                    rmixes[t], "pretrain rxr") for t in trainer.scheduler.tasks}
    rcfg = trainer.cfg
    emit("pretrain", preset="rxr", vocab=rcfg.vocab_size, feat_dim=rcfg.image_feat_size,
         no_lang_ca=rcfg.no_lang_ca, text_len=trainer.batcher.ds.max_txt_len,
         ob_width=trainer.batcher.ds.ob_width, batch=PRETRAIN_B, losses=rxr_losses,
         launches_per_update={t: {"attention_fwd": sum(f.values()),
                                  "attention_bwd": sum(b.values())}
                              for t, (f, b) in rmixes.items()},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    bf16_launches, bf16_mix = phase_pretrain_bf16(mixes, table32, peak, kernels)
    return {name: {"batch": PRETRAIN_B, "updates": PRETRAIN_UPDATES,
                   "launches": launches[name],
                   "launches_per_update": {t: sum(m[i].values()) for t, m in mixes.items()},
                   "rxr_launches_per_update": {t: sum(m[i].values())
                                               for t, m in rmixes.items()},
                   "mix": draw_mix[i], "bf16_launches": bf16_launches[name],
                   "bf16_mix": bf16_mix[i]}
            for i, name in enumerate(("attention_fwd", "attention_bwd"))}


def bf16_close(card, cpu, fp32, what, floor: float = 0.0, mag=None) -> dict:
    """The card's bf16 result against the CPU's (tensors or floats, of one
    shape): max |card - fp32| <= BF16_FACTOR max(max |cpu - fp32|,
    ``floor``) + BF16_ATOL min(1, ``mag``) over the finite entries of the
    fp32 answer, the non-finite ones at the same places; ``mag`` is the
    answer's scale, its largest entry by default, so the absolute term
    stays below a quarter bf16 step of it. Returns the answer's largest
    entry, the card's and the CPU's distances, the bound and the card's
    distance over it."""
    a, b, f = (torch.as_tensor(x).float().cpu() for x in (card, cpu, fp32))
    if not a.shape == b.shape == f.shape:
        raise AssertionError(f"{what}: shapes {a.shape} {b.shape} {f.shape}")
    fin = torch.isfinite(f)
    if not (torch.equal(torch.isfinite(a), fin) and torch.equal(torch.isfinite(b), fin)):
        raise AssertionError(f"{what}: non-finite at different places")
    if not fin.any():
        return {"max_abs": 0.0, "dist": 0.0, "cpu_dist": 0.0, "bound": 0.0, "over_bound": 0.0}
    max_abs = f[fin].abs().max().item()
    dist, cpu_dist = ((x[fin] - f[fin]).abs().max().item() for x in (a, b))
    bound = (BF16_FACTOR * max(cpu_dist, floor)
             + BF16_ATOL * min(1.0, max_abs if mag is None else mag))
    if not dist <= bound:
        raise AssertionError(f"{what}: card bf16 {dist} from fp32 (largest entry {max_abs}, "
                             f"CPU bf16 {cpu_dist}), bound {bound}")
    return {"max_abs": max_abs, "dist": dist, "cpu_dist": cpu_dist, "bound": bound,
            "over_bound": dist / bound if dist else 0.0}


def bias_ratios(grads) -> dict:
    """Per bias with a weight beside it and a non-zero weight gradient:
    the largest entry of its gradient over its weight gradient's."""
    out = {}
    for k, g in grads.items():
        weight = k.rsplit(".", 1)[0] + ".weight"
        if k.endswith(".bias") and weight in grads:
            w = grads[weight].abs().max().item()
            if w > 0:
                out[k] = g.abs().max().item() / w
    return out


def bf16_grads_close(card, cpu, fp32, what) -> dict:
    """bf16_close per gradient tensor. A bias whose fp32 gradient is zero
    to rounding (its largest entry at most ZERO_GRAD_RTOL of its weight
    gradient's) shifts every input of a softmax alike (an attention
    key's, a ranking head's output or the LayerNorm before it): its
    exact gradient is 0, and in bf16 it holds only the rounding of terms
    whose products with the inputs make its weight's gradient. So its
    CPU distance is floored at one bf16 step (2^-8) of its weight
    gradient's largest entry, which is also its scale. Returns the worst
    ratio; those biases with their ratio, and the smallest ratio of the
    other biases; per tensor [largest fp32 entry, card distance, bound]
    (3 significant digits)."""
    if not card.keys() == cpu.keys() == fp32.keys():
        raise AssertionError(f"{what}: gradients on different parameters")
    ratios = bias_ratios(fp32)
    zero = {k: r for k, r in ratios.items() if r <= ZERO_GRAD_RTOL}
    others = [(r, k) for k, r in ratios.items() if k not in zero]
    worst, per = 0.0, {}
    for k in card:
        if k in zero:
            w = fp32[k.rsplit(".", 1)[0] + ".weight"].abs().max().item()
            r = bf16_close(card[k], cpu[k], fp32[k], f"{what} {k}", w * 2.0 ** -8, w)
        else:
            r = bf16_close(card[k], cpu[k], fp32[k], f"{what} {k}")
        worst = max(worst, r["over_bound"])
        per[k] = [float(f"{r[x]:.3g}") for x in ("max_abs", "dist", "bound")]
    return {"max_grad_over_bound": worst,
            "zero_to_rounding": {k: float(f"{r:.3g}") for k, r in sorted(zero.items())},
            "other_biases_min_ratio": [float(f"{min(others)[0]:.3g}"), min(others)[1]]
            if others else None, "grads": per}


def task_kernels(trainer, tasks):
    """Device kernels of one update per task (torch.profiler), on a batch
    built before the trace."""
    out = {}
    for task in tasks:
        batch = trainer.batcher.batch(task, PRETRAIN_B)
        out[task] = kernels_per_call(lambda: trainer.update(task, batch))
    return out


def phase_pretrain_bf16(mixes, table32, fp32_peak, fp32_kernels):
    """The r2r preset's pretraining in bf16 (see the module docstring);
    ``fp32_peak`` and ``fp32_kernels``: the fp32 part's peak memory and
    kernels per update of each task. Returns its launches in the timed
    mix and the draw's mix."""
    trainer, _ = slice_trainer("r2r", batch_size=PRETRAIN_B, seed=0, extra=("--bf16",))
    cfg, tasks = trainer.cfg, trainer.scheduler.tasks
    if cfg.dtype != "bfloat16" or trainer._feat_table.dtype != torch.bfloat16:
        raise AssertionError("--bf16 pretraining: not bf16")
    warm = {t: counted_update(trainer, t, trainer.batcher.batch(t, PRETRAIN_B), mixes[t],
                              "pretrain r2r bf16") for t in tasks}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # as the fp32 part: after the warm-up
    reset_counts()
    t0 = time.perf_counter()
    outs = [trainer.train_step() for _ in range(PRETRAIN_UPDATES)]
    losses = torch.stack([loss for _, loss, _ in outs]).cpu()
    seconds = time.perf_counter() - t0
    launches = tier_launches()
    trainer.close()
    draw = [task for task, _, _ in outs]
    want = {"attention_fwd": sum(sum(mixes[t][0].values()) for t in draw),
            "attention_bwd": sum(sum(mixes[t][1].values()) for t in draw)}
    if launches != want or not torch.isfinite(losses).all():
        raise AssertionError(f"pretrain bf16 mix: launches {launches}, expected {want}; "
                             f"losses {losses.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    draw_mix = mix_launches({t: mixes[t] for t in set(draw)},
                            {t: draw.count(t) / len(draw) for t in set(draw)})
    kernels = task_kernels(trainer, PRETRAIN_TRACED)

    # card against CPU per task at batch 2, both bf16, dropout off; the
    # card's fp32 model on the same weights (and the fp32 table) answers
    t1 = time.perf_counter()
    sd = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    cpu_model, f32_model = init_pretrain(cfg, seed=0), init_pretrain(
        dataclasses.replace(cfg, dtype="float32"), seed=0)
    cpu_model.load_state_dict(sd)
    f32_model.load_state_dict(sd)
    f32_model.cuda()
    cpu_table = trainer._feat_table.cpu()
    parity = {}
    sides = ((trainer.model, trainer._feat_table), (cpu_model, cpu_table), (f32_model, table32))
    for task in tasks:
        batches = [trainer.batcher.batch(task, PRETRAIN_PARITY_B)
                   for _ in range(BF16_LOSS_BATCHES)]
        (lg, _, gg), (lc, _, gc), (lf, _, gf) = (
            pretrain_gradients(model, batches[0], task, table) for model, table in sides)
        # the losses of the further batches, forward only
        (lg, lc, lf) = ([loss] + [pretrain_loss(model, b, task, table) for b in batches[1:]]
                        for loss, (model, table) in zip((lg, lc, lf), sides))
        parity[task] = {"losses_cuda": lg, "losses_cpu": lc, "losses_fp32": lf,
                        "loss": bf16_close(lg, lc, lf, f"pretrain bf16 {task} losses"),
                        "tensors": len(gc), **bf16_grads_close(gg, gc, gf,
                                                               f"pretrain bf16 {task}")}
    del cpu_model, f32_model, cpu_table
    emit("pretrain", preset="r2r", dtype="bfloat16", batch=PRETRAIN_B, warmup_losses=warm,
         updates=PRETRAIN_UPDATES, draw={t: draw.count(t) for t in tasks}, seconds=seconds,
         examples_per_s=PRETRAIN_UPDATES * PRETRAIN_B / seconds,
         ms_per_update=seconds / PRETRAIN_UPDATES * 1e3, loss_mean=losses.mean().item(),
         launches=launches, peak_mem_gb=peak, fp32_peak_mem_gb=fp32_peak,
         kernels_per_update={t: {"float32": fp32_kernels[t], "bfloat16": kernels[t]}
                             for t in PRETRAIN_TRACED},
         parity={"batch": PRETRAIN_PARITY_B, "factor": BF16_FACTOR, "atol": BF16_ATOL,
                 "seconds": time.perf_counter() - t1, **parity})
    del trainer
    torch.cuda.empty_cache()
    return launches, draw_mix


def greedy_batch(agent):
    """The first greedy batch of the agent's env, one device rollout
    decoded on the host: (trajectories, episode, extras), the last two
    on the CPU."""
    agent.model.eval()
    agent.critic.eval()
    agent.env.reset_epoch(shuffle=False)
    ins = agent._device_rollout_args(include_rewards=False)
    with torch.no_grad():  # as eval_split_device calls it
        ep, extras = agent._ensure_device_rollout_fn()(
            ins["txt_ids"], ins["txt_mask"], agent._feat_table, agent._nav_tables,
            ins["start_node"], ins["start_view"], obj_tables=agent._obj_tables)
    trajs = agent._decode_device_trajectories(agent.env, ep, extras)
    return trajs, {k: v.cpu() for k, v in ep.items()}, {k: v.cpu() for k, v in extras.items()}


def compare_rollouts(a, b, atol, what) -> float:
    """Two greedy batches: identical trajectories, logits -inf at the same
    places and within ``atol`` elsewhere; returns the largest logit
    difference."""
    (trajs_a, ep_a, ex_a), (trajs_b, ep_b, ex_b) = a, b
    for key in ("node_idx", "view_index", "actions", "step_mask", "final_node_idx"):
        if not torch.equal(ep_a[key], ep_b[key]):
            raise AssertionError(f"{what}: trajectories differ in {key}")
    if trajs_a != trajs_b:
        raise AssertionError(f"{what}: decoded trajectories differ")
    la, lb = ex_a["rollout_logits"], ex_b["rollout_logits"]
    fin = torch.isfinite(lb)
    if not torch.equal(torch.isfinite(la), fin):
        raise AssertionError(f"{what}: logits are -inf at different places")
    err = (la[fin] - lb[fin]).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"{what}: logits differ by {err} > {atol}")
    return err


def timed_greedy_batch(agent, per_batch, what):
    """One warm-up and one timed greedy batch from zeroed launch counts;
    raises unless the timed one launched exactly ``per_batch`` forward
    kernels and no backward. Returns (episodes/s, trajectories)."""
    greedy_batch(agent)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trajs, _, _ = greedy_batch(agent)
    seconds = time.perf_counter() - t0
    launches = tier_launches()
    if launches != {"attention_fwd": per_batch, "attention_bwd": 0}:
        raise AssertionError(f"{what} greedy batch launches {launches}, expected {per_batch} "
                             "forward")
    return len(trajs) / seconds, trajs


def phase_family(task, mixes):
    """One family preset at full width: merged sample updates (for the
    presets in ``mixes``), a greedy batch, and card against CPU. Returns
    the phase's fields."""
    cfg, world = slice_config(get_preset(task).train.batch_size, seed=0, task=task)
    b, mcfg = cfg.train.batch_size, cfg.model
    fwd_mix, bwd_mix = launch_mix(cfg)
    per_batch = sum(fwd_mix.values())
    agent = HAMTAgent(cfg, slice_env(cfg, world, seed=0), seed=0)
    agent.enable_feature_table()
    fields = {}
    if task in mixes:
        per = {"attention_fwd": per_batch + sum(bootstrap_mix(cfg).values()),
               "attention_bwd": sum(bwd_mix.values())}
        agent.merged_sample_update = True
        agent.train_iteration("sample", sync=False)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        iters = 2
        losses, seconds, launches = timed_sample_updates(agent, iters)
        if launches != {k: n * iters for k, n in per.items()}:
            raise AssertionError(f"{task} merged sample launches {launches} over {iters} "
                                 f"updates, expected {per} per update")
        fields.update(
            feedback=cfg.train.feedback, updates=iters, lanes=2 * b, seconds=seconds,
            sample_episodes_per_s=iters * b / seconds, ms_per_update=seconds / iters * 1e3,
            **{f"{k}_mean": v.mean().item() for k, v in losses.items()},
            launches=launches, launches_per_update=per,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    eps, trajs = timed_greedy_batch(agent, per_batch, task)
    del agent
    fields.update(greedy_episodes_per_s=eps, greedy_launches_per_batch=per_batch)

    pcfg = cfg.replace(train={"batch_size": 2})
    runs = []
    for device in ("cuda", "cpu"):
        pagent = HAMTAgent(pcfg, slice_env(pcfg, world, seed=0), seed=0, device=device)
        pagent.enable_feature_table()
        runs.append(greedy_batch(pagent))
        del pagent
    err = compare_rollouts(*runs, PARITY_LOGIT_ATOL, f"{task} card vs CPU")
    emit("family", preset=task, hidden=mcfg.hidden_size, vocab=mcfg.vocab_size,
         layers=[mcfg.num_l_layers, mcfg.num_x_layers, mcfg.num_h_pano_layers],
         no_lang_ca=mcfg.no_lang_ca, fix_lang_and_hist=[mcfg.fix_lang_embedding,
                                                         mcfg.fix_hist_embedding],
         feat_dim=cfg.env.image_feat_size, text_len=cfg.env.max_instr_len,
         t_max=cfg.env.max_action_len, batch=b,
         shape_mix={f"{lq}x{lk}": n for (lq, lk), n in fwd_mix.items()},
         bwd_shape_mix={f"{lq}x{lk}": n for (lq, lk), n in bwd_mix.items()},
         parity={"batch": 2, "trajectories_identical": True, "max_abs_logit_err": err,
                 "tol": PARITY_LOGIT_ATOL}, **fields)
    return fields


def phase_files(tmp):
    """The file-backed r2r path at full width (see the module docstring)."""
    cfg, world = slice_config(TRAIN_B, seed=0)
    files = export_nav_and_annotations(
        world, tmp, {"train": 0.5, "prevalent_aug": 0.2, "val_train_seen": 0.1,
                     "val_seen": 0.1, "val_unseen": 0.1})
    args = argparse.Namespace(
        anno_dir=files["anno_dir"], connectivity_dir=files["connectivity_dir"],
        img_ft_file=None, aug=os.path.join(files["anno_dir"], "R2R_prevalent_aug_enc.json"),
        test=False, submit=False)
    # the card's machine has no h5py: the features come from the world's
    # in-memory DB, the rest from the files
    cfg, (train_env, aug_env), val_envs = finetune.build_real_dataset(
        get_preset("r2r").replace(train={"batch_size": TRAIN_B}), args, feat_db=world.feat_db)
    for scan, g in world.graphs.items():
        got = train_env.graphs[scan]
        if got.node_ids != g.node_ids or not (got.dist == g.dist).all():
            raise AssertionError(f"files: scan {scan} read back differs from the world")
    val = val_envs["val_unseen"]

    def new_agent(seed):
        a = HAMTAgent(cfg, train_env, seed=seed)
        finetune._share_feature_table(a, train_env, [aug_env, *val_envs.values()])
        return a

    ref = new_agent(0)
    ref_path = os.path.join(tmp, "reference_agent.pt")
    torch.save({"vln_bert": {"state_dict": {"module.vln_bert." + k: v for k, v in
                                            ref.model.state_dict().items()}},
                "critic": {"state_dict": {"module." + k: v for k, v in
                                          ref.critic.state_dict().items()}}}, ref_path)
    agent = HAMTAgent(cfg, train_env, seed=1)
    skipped = agent.init_from_reference(ref_path)
    if skipped:
        raise AssertionError(f"files: init_from_reference skipped {skipped}")
    finetune._share_feature_table(agent, train_env, [aug_env, *val_envs.values()])
    ref.env = agent.env = val
    ref_err = compare_rollouts(greedy_batch(ref), greedy_batch(agent), SAME_WEIGHTS_ATOL,
                               "files: reference checkpoint")
    del ref

    agent.merged_sample_update = True
    order, losses = [], []
    for j in range(2):  # the CLI's alternation within an interval
        agent.env = train_env if j % 2 == 0 else aug_env
        order.append(agent.env.name)
        losses.append(agent.train_iteration("sample")["loss"])
    if order != ["train", "aug"] or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"files: updates on {order}, losses {losses}")
    ckpt = os.path.join(tmp, "latest.pt")
    agent.save(ckpt)
    fresh = new_agent(2)
    if fresh.load(ckpt, resume_optimizer=True) != agent.step or fresh.step != 2:
        raise AssertionError(f"files: resumed step {fresh.step}, saved {agent.step}")
    for mod in ("model", "critic"):
        for (k, x), y in zip(getattr(agent, mod).state_dict().items(),
                             getattr(fresh, mod).state_dict().values()):
            if not torch.equal(x, y):
                raise AssertionError(f"files: resumed {mod} {k} differs")
    moments = 0
    for opt in ("optimizer", "critic_optimizer"):
        src, dst = getattr(agent, opt).state_dict(), getattr(fresh, opt).state_dict()
        if not src["param_groups"][0]["count"] == dst["param_groups"][0]["count"] == 2:
            raise AssertionError(f"files: resumed {opt} count differs")
        if src["state"].keys() != dst["state"].keys():
            raise AssertionError(f"files: resumed {opt} state differs")
        for i, st in src["state"].items():
            for key, x in st.items():
                moments += 1
                if not torch.equal(x, dst["state"][i][key]):
                    raise AssertionError(f"files: resumed {opt} moment {i}.{key} differs")
    agent.env = fresh.env = val
    resume_err = compare_rollouts(greedy_batch(agent), greedy_batch(fresh), 0.0,
                                  "files: resumed checkpoint")
    emit("files", preset="r2r", hidden=cfg.model.hidden_size, batch=TRAIN_B,
         scans=len(train_env.graphs), items={"train": len(train_env.data),
                                            "aug": len(aug_env.data),
                                            **{k: len(e.data) for k, e in val_envs.items()}},
         features="in-memory (no h5py on the card's machine)",
         reference_init={"skipped": skipped, "trajectories_identical": True,
                         "max_abs_logit_err": ref_err, "tol": SAME_WEIGHTS_ATOL},
         updates=order, losses=losses,
         resume={"step": fresh.step, "moments_equal": moments, "params_equal": True,
                 "trajectories_identical": True, "max_abs_logit_err": resume_err})


def il_logits_and_grads(agent, ep):
    """The teacher-forced episode's logits, its IL loss (the agent's
    ``_il_loss``) and every model gradient, in training mode, no step."""
    agent.model.train()
    agent.critic.train()
    out = agent.episode_forward(ep, agent._feat_table)
    loss = (il_loss(out.logits, ep["teacher"].T, IGNORE_ID) * agent.cfg.train.teacher_weight
            / ep["actions"].shape[0])
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in agent.model.named_parameters()
             if p.grad is not None}
    return out.logits.detach().cpu(), loss.item(), grads


@torch.no_grad()
def il_loss_only(agent, ep) -> float:
    """The teacher-forced episode's IL loss, as il_logits_and_grads takes
    it, forward only."""
    agent.model.train()
    out = agent.episode_forward(ep, agent._feat_table)
    return (il_loss(out.logits, ep["teacher"].T, IGNORE_ID) * agent.cfg.train.teacher_weight
            / ep["actions"].shape[0]).item()


def compare_greedy_bf16(a, b, tol, what):
    """Two bf16 greedy batches, the card's (a) and the CPU's (b): each
    episode takes the same actions until the two part, which they may
    only where their logits tie within ``tol``; the logits within ``tol``
    at every step through each episode's first parting step (the same
    history and observation on both sides up to there). Returns the
    largest logit difference and the episodes that parted."""
    (trajs_a, ep_a, ex_a), (trajs_b, ep_b, ex_b) = a, b
    act_a, act_b = ep_a["actions"], ep_b["actions"]
    la, lb = ex_a["rollout_logits"], ex_b["rollout_logits"]  # (T, B, N)
    err, parted = 0.0, 0
    for i in range(act_a.shape[0]):
        diff = (act_a[i] != act_b[i]).nonzero()
        last = int(diff[0]) if len(diff) else act_a.shape[1] - 1
        parted += int(len(diff) > 0)
        if not len(diff) and trajs_a[i] != trajs_b[i]:
            raise AssertionError(f"{what}: episode {i} decodes differently")
        x, y = la[:last + 1, i], lb[:last + 1, i]
        fin = torch.isfinite(y)
        if not torch.equal(torch.isfinite(x), fin):
            raise AssertionError(f"{what}: logits are -inf at different places")
        err = max(err, (x[fin] - y[fin]).abs().max().item())
    if not err <= tol:
        raise AssertionError(f"{what}: logits differ by {err} > {tol}")
    return err, parted


def phase_bf16(cfg, world, per_batch, per_update_bwd, merged_per, fp32):
    """bf16 compute at full r2r width (see the module docstring); ``fp32``:
    the fp32 phases' numbers of this run. Returns the launches of each
    bf16 path."""
    t_phase = time.perf_counter()
    runs, launches = {}, {}

    gcfg = cfg.replace(model=BF16)
    agent = HAMTAgent(gcfg, slice_env(gcfg, world, seed=0), seed=0)
    agent.enable_feature_table()
    if agent._feat_table.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 feature table is {agent._feat_table.dtype}")
    agent.eval_split_device()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    preds = agent.eval_split_device()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches["serving"] = tier_launches()
    batches = len(world.instr_data) // B + 1
    if launches["serving"] != {"attention_fwd": per_batch * batches, "attention_bwd": 0}:
        raise AssertionError(f"bf16 greedy launches {launches['serving']}, expected "
                             f"{per_batch} x {batches} forward")
    metrics, _ = agent.env.eval_metrics(preds)
    if len(preds) != len(world.instr_data) or not all(
            math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"bf16 greedy: {len(preds)} predictions, metrics {metrics}")
    runs["serving"] = {"batch": B, "episodes_per_s": len(preds) / seconds,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                       "launches_per_batch": per_batch, "sr": metrics["sr"]}
    del agent

    tcfg = cfg.replace(model=BF16, train={"batch_size": TRAIN_B, "feedback": "teacher"})
    agent = HAMTAgent(tcfg, slice_env(tcfg, world, seed=0), seed=0)
    agent.enable_feature_table()
    for _ in range(WARMUP_UPDATES):  # warm-up
        agent.train_iteration("teacher", sync=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = TIMED_UPDATES_BF16
    reset_counts()
    t0 = time.perf_counter()
    losses = torch.stack([agent.train_iteration("teacher", sync=False)["loss"]
                          for _ in range(iters)]).cpu()
    seconds = time.perf_counter() - t0
    launches["il"] = tier_launches()
    want = {"attention_fwd": per_batch * iters, "attention_bwd": per_update_bwd * iters}
    if launches["il"] != want or not torch.isfinite(losses).all():
        raise AssertionError(f"bf16 IL launches {launches['il']} != {want}, or losses "
                             f"{losses.tolist()}")
    runs["il"] = {"batch": TRAIN_B, "updates": iters, "episodes_per_s": iters * TRAIN_B / seconds,
                  "ms_per_update": seconds / iters * 1e3, "loss_mean": losses.mean().item(),
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                  "kernels_per_update": kernels_per_call(
                      lambda: agent.train_iteration("teacher"))}
    del agent

    scfg = cfg.replace(model=BF16, train={"batch_size": TRAIN_B, "feedback": "sample"})
    agent = HAMTAgent(scfg, slice_env(scfg, world, seed=0), seed=0)
    agent.merged_sample_update = True
    agent.enable_feature_table()
    for _ in range(WARMUP_UPDATES):  # warm-up
        agent.train_iteration("sample", sync=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, launches["sample"] = timed_sample_updates(agent, iters)
    if launches["sample"] != {k: n * iters for k, n in merged_per.items()}:
        raise AssertionError(f"bf16 merged sample launches {launches['sample']} over {iters} "
                             f"updates, expected {merged_per} per update")
    runs["sample"] = {"batch": TRAIN_B, "lanes": MERGED_B, "updates": iters,
                      "episodes_per_s": iters * TRAIN_B / seconds,
                      "ms_per_update": seconds / iters * 1e3,
                      **{f"{k}_mean": v.mean().item() for k, v in losses.items()},
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                      "kernels_per_update": kernels_per_call(
                          lambda: agent.train_iteration("sample"))}
    del agent

    # one repeated batch, dropout off, lr 1e-4: the loss must fall
    ocfg = tcfg.replace(model=NO_DROPOUT, train={"lr": 1e-4})
    agent = HAMTAgent(ocfg, slice_env(ocfg, world, seed=0), seed=0)
    agent.enable_feature_table()
    ep = agent._ep_to_device(agent.env.teacher_episode())
    fit = torch.stack([agent._il_update(ep, 1.0) for _ in range(FIT_UPDATES)]).cpu()
    if not torch.isfinite(fit).all() or not fit[-1] < fit[0]:
        raise AssertionError(f"bf16: {FIT_UPDATES} updates on one batch did not lower the "
                             f"loss: {fit.tolist()}")
    del agent
    emit("bf16", preset="r2r", hidden=cfg.model.hidden_size, **runs,
         fp32=fp32, bf16_over_fp32_episodes_per_s={
             k: runs[k]["episodes_per_s"] / fp32[k]["episodes_per_s"] for k in runs},
         bf16_over_fp32_peak_mem={k: runs[k]["peak_mem_gb"] / fp32[k]["peak_mem_gb"]
                                  for k in runs},
         kernels_per_update={k: {"float32": fp32[k]["kernels_per_update"],
                                 "bfloat16": runs[k]["kernels_per_update"]}
                             for k in ("il", "sample")},
         launches=launches, overfit_losses=fit.tolist(),
         seconds=time.perf_counter() - t_phase)
    bf16_runs = runs

    # card against CPU, both bf16, batch 4, dropout off; the card's fp32
    # model on the same weights and episode is the fp32 answer
    t_parity = time.perf_counter()
    pcfg = cfg.replace(model={**NO_DROPOUT, **BF16}, train={"batch_size": 4,
                                                           "feedback": "teacher"})
    res = {}
    for name, device, c in (("cuda", "cuda", pcfg), ("cpu", "cpu", pcfg),
                            ("fp32", "cuda", pcfg.replace(model={"dtype": "float32"}))):
        pagent = HAMTAgent(c, slice_env(c, world, seed=0), seed=0, device=device)
        pagent.enable_feature_table()
        greedy = greedy_batch(pagent) if name != "fp32" else None
        pagent.env.reset_epoch(shuffle=False)  # the first batch, on every agent
        ep = pagent._ep_to_device(pagent.env.teacher_episode())
        logits, loss, grads = il_logits_and_grads(pagent, ep)
        # the IL losses of the further batches, forward only
        losses = [loss] + [il_loss_only(pagent, pagent._ep_to_device(
            pagent.env.teacher_episode())) for _ in range(BF16_LOSS_BATCHES - 1)]
        res[name] = (greedy, logits, losses, grads)
        del pagent
    (g_greedy, g_logits, g_loss, g_grads), (c_greedy, c_logits, c_loss, c_grads), (
        _, f_logits, f_loss, f_grads) = res["cuda"], res["cpu"], res["fp32"]
    logits = bf16_close(g_logits, c_logits, f_logits, "bf16 teacher-forced logits")
    tol = logits["bound"]
    greedy_err, parted = compare_greedy_bf16(g_greedy, c_greedy, tol, "bf16 card vs CPU")
    emit("bf16_parity", batch=4, factor=BF16_FACTOR, atol=BF16_ATOL,
         teacher_forced_logits=logits, greedy_max_abs_logit_err=greedy_err,
         greedy_episodes_parted=parted, losses_cuda=g_loss, losses_cpu=c_loss,
         losses_fp32=f_loss, loss=bf16_close(g_loss, c_loss, f_loss, "bf16 IL losses"),
         tensors=len(c_grads), **bf16_grads_close(g_grads, c_grads, f_grads, "bf16 IL"),
         seconds=time.perf_counter() - t_parity)
    return launches, bf16_runs, tol


def loss_and_grads(agent, loss_fn):
    """loss_fn()'s value and every model gradient, in training mode, no
    step; the gradients left cleared."""
    agent.model.train()
    agent.critic.train()
    agent.model.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in agent.model.named_parameters()
             if p.grad is not None}
    agent.model.zero_grad(set_to_none=True)
    return loss.item(), grads


def phase_packed(cfg, world, pmix, unpacked):
    """Packed IL at full r2r width (see the module docstring); ``unpacked``:
    the unpacked IL update's episodes/s of this run by dtype. Returns the
    packed updates' launches by dtype."""
    t_phase = time.perf_counter()
    per = {"attention_fwd": sum(pmix[0].values()), "attention_bwd": sum(pmix[1].values())}
    runs, launches = {}, {}
    iters = TIMED_UPDATES_BF16
    for dtype in ("float32", "bfloat16"):
        pcfg = cfg.replace(model={"dtype": dtype},
                           train={"batch_size": TRAIN_B, "feedback": "teacher"})
        agent = HAMTAgent(pcfg, slice_env(pcfg, world, seed=0), seed=0)
        agent.enable_feature_table()
        agent.enable_packed_il()
        if agent._packer.text_cap != PACKED_TEXT_CAP:
            raise AssertionError(f"packed text rows {agent._packer.text_cap}")
        for _ in range(WARMUP_UPDATES):  # warm-up
            agent.train_iteration("teacher", sync=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        outs = [agent.train_iteration("teacher", sync=False) for _ in range(iters)]
        losses = torch.stack([o["loss"] for o in outs]).cpu()
        seconds = time.perf_counter() - t0
        launches[dtype] = tier_launches()
        if launches[dtype] != {k: n * iters for k, n in per.items()} or not torch.isfinite(
                losses).all():
            raise AssertionError(f"packed IL {dtype}: launches {launches[dtype]}, expected "
                                 f"{per} per update; losses {losses.tolist()}")
        episodes = sum(o["episodes"] for o in outs)
        runs[dtype] = {"updates": iters, "episodes": episodes,
                       "episodes_per_update": episodes / iters,
                       "episodes_per_s": episodes / seconds,
                       "unpacked_episodes_per_s": unpacked[dtype],
                       "over_unpacked": episodes / seconds / unpacked[dtype],
                       "ms_per_update": seconds / iters * 1e3,
                       "loss_mean": losses.mean().item(),
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
        del agent
    emit("packed_il", preset="r2r", slots=TRAIN_B, t_max=cfg.env.max_action_len,
         text_rows=PACKED_TEXT_CAP, **runs, launches=launches, launches_per_update=per,
         shape_mix={f"{lanes}:{lq}x{lk}": n for (lanes, lq, lk), n in pmix[0].items()},
         bwd_shape_mix={f"{lanes}:{lq}x{lk}": n for (lanes, lq, lk), n in pmix[1].items()},
         seconds=time.perf_counter() - t_phase)

    # on the card: a packed update against the unpacked update over the
    # same episodes, fp32, dropout off
    t_grads = time.perf_counter()
    gcfg = cfg.replace(model=NO_DROPOUT, train={"batch_size": TRAIN_B, "feedback": "teacher"})
    agent = HAMTAgent(gcfg, slice_env(gcfg, world, seed=0), seed=0)
    agent.enable_feature_table()
    agent.enable_packed_il()
    pack = agent._packer.next_pack()
    n_eps = float(pack["n_episodes"])
    ep = agent._pack_to_device(unpack_episodes(pack, cfg.env.max_action_len,
                                               agent.env.spec.stop_slot))
    lp, gp = loss_and_grads(agent, lambda: agent._packed_il_loss(agent._pack_to_device(pack),
                                                                 n_eps, 1.0))
    lu, gu = loss_and_grads(agent, lambda: agent._il_loss(ep, 1.0))
    del agent
    if not abs(lp - lu) <= TRAIN_LOSS_RTOL * abs(lu):
        raise AssertionError(f"packed loss {lp} against unpacked {lu}")
    equiv = check_grads(gp, gu, "packed against unpacked")

    # card against CPU at 4 slots, fp32, dropout off
    ccfg = gcfg.replace(train={"batch_size": 4})
    res = {}
    for device in ("cuda", "cpu"):
        pagent = HAMTAgent(ccfg, slice_env(ccfg, world, seed=0), seed=0, device=device)
        pagent.enable_feature_table()
        pagent.enable_packed_il()
        pk = pagent._packer.next_pack()
        res[device] = (int(pk["n_episodes"]), *loss_and_grads(
            pagent, lambda: pagent._packed_il_loss(pagent._pack_to_device(pk),
                                                   float(pk["n_episodes"]),
                                                   pagent.cfg.train.teacher_weight)))
        del pagent
    (n_g, loss_g, grads_g), (n_c, loss_c, grads_c) = res["cuda"], res["cpu"]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    if n_g != n_c or not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"packed card vs CPU: {n_g} / {n_c} episodes, loss {loss_g} vs "
                             f"{loss_c}")
    emit("packed_il_parity", episodes=int(n_eps), loss_packed=lp, loss_unpacked=lu,
         packed_vs_unpacked_max_grad_err_over_tol=equiv, slots_cpu=4, episodes_cpu=n_c,
         loss_cuda=loss_g, loss_cpu=loss_c, loss_rel_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL,
         tensors=len(grads_c), max_grad_err_over_tol=check_grads(grads_g, grads_c,
                                                                  "packed card vs CPU"),
         grad_rel_tol=TRAIN_GRAD_REL, grad_floor=TRAIN_GRAD_FLOOR,
         seconds=time.perf_counter() - t_grads)
    return launches


def kernels_per_call(fn) -> int:
    """Device kernels one call of ``fn`` launches, from a torch.profiler
    trace as run/profile_train.py counts them (the device's activity only:
    the host's events would count nothing and take most of the parse)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(n for *_, n in kernel_table(prof)[0])


class HostLoopCounter:
    """Counts an agent's host-loop policy steps and text encodings, the
    calls whose attention launches the evaluators' formulas count."""

    def __init__(self, agent):
        self.steps = self.texts = 0
        step, encode = agent._policy_step, agent.model.encode_text

        def counted_step(*args, **kw):
            self.steps += 1
            return step(*args, **kw)

        def counted_encode(*args, **kw):
            self.texts += 1
            return encode(*args, **kw)

        agent._policy_step, agent.model.encode_text = counted_step, counted_encode

    def reset(self) -> None:
        self.steps = self.texts = 0


class LogitRecorder:
    """Keeps the host-loop policy steps' logits (host copies) by
    (instr_id, step) of each live slot, the first record of each (the
    kept prediction's); ``rec`` is emptied by the caller per run."""

    def __init__(self, agent):
        self.rec = {}
        step, packed_step = agent._policy_step, agent._packed_policy_step
        group = []

        def packed(g, step_ins):  # the packed step's env: its group's
            group.append(g)
            try:
                return packed_step(g, step_ins)
            finally:
                group.pop()

        def recorded(*args, **kw):
            out = step(*args, **kw)
            env = group[-1].env if group else agent.env
            t = args[4].expand(len(env.batch)).tolist()
            live, logits = kw["live"].tolist(), out[1].float().cpu()
            for i, item in enumerate(env.batch):
                if live[i]:
                    self.rec.setdefault((item["instr_id"], t[i]), logits[i])
            return out

        agent._policy_step, agent._packed_policy_step = recorded, packed


def by_instr(preds):
    return {p["instr_id"]: p["trajectory"] for p in preds}


def same_trajectories(a, b, what) -> None:
    """Identical predictions: the same items and viewpoints, headings and
    elevations within POSE_ATOL."""
    a, b = by_instr(a), by_instr(b)
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: different items predicted")
    for k in a:
        if [x[0] for x in a[k]] != [x[0] for x in b[k]] or any(
                abs(ha - hb) > POSE_ATOL or abs(ea - eb) > POSE_ATOL
                for (_, ha, ea), (_, hb, eb) in zip(a[k], b[k])):
            raise AssertionError(f"{what}: trajectories of {k} differ: {a[k]} vs {b[k]}")


def revisits(preds) -> int:
    return sum(len(vps) - len(set(vps)) for vps in
               ([x[0] for x in p["trajectory"]] for p in preds))


def compare_hostloop_bf16(a, b, rec_a, rec_b, t_max, tol, what):
    """Two bf16 evaluations of one split: each episode takes the same path
    until the two part, and their logits agree within ``tol`` at every
    step through the first parting step (the same history and observation
    on both sides up to there). Returns the largest logit difference and
    the episodes that parted."""
    a, b = by_instr(a), by_instr(b)
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: different items predicted")
    err, parted = 0.0, 0
    for k in a:
        va, vb = [x[0] for x in a[k]], [x[0] for x in b[k]]
        last = t_max - 1
        if va != vb:
            n = next((i for i in range(min(len(va), len(vb))) if va[i] != vb[i]),
                     min(len(va), len(vb)))
            last, parted = n - 1, parted + 1
        for s in range(last + 1):
            if (k, s) not in rec_a and (k, s) not in rec_b and va == vb:
                continue
            x, y = rec_a[(k, s)], rec_b[(k, s)]
            fin = torch.isfinite(y)
            if not torch.equal(torch.isfinite(x), fin):
                raise AssertionError(f"{what}: logits of {k} step {s} -inf at other places")
            err = max(err, (x[fin] - y[fin]).abs().max().item())
    if not err <= tol:
        raise AssertionError(f"{what}: logits differ by {err} > {tol}")
    return err, parted


def timed_eval(agent, count, fn, per_batch, text, per_step, what):
    """One evaluation from zeroed counts: its predictions, seconds and
    launches, raising unless the forward launches are the formula's: the
    device rollout's ``per_batch`` per text encoding (one per batch), a
    host loop's ``text`` per text encoding plus ``per_step`` per policy
    step; no backward."""
    torch.cuda.synchronize()
    reset_counts()
    count.reset()
    t0 = time.perf_counter()
    preds = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = tier_launches()
    formula = (per_batch * count.texts if count.steps == 0
               else text * count.texts + per_step * count.steps)
    if got != {"attention_fwd": formula, "attention_bwd": 0}:
        raise AssertionError(f"{what}: launches {got}, formula {formula} ({count.texts} text "
                             f"encodings, {count.steps} policy steps)")
    return preds, seconds, {"measured": got["attention_fwd"], "formula": formula,
                            "text_encodings": count.texts, "policy_steps": count.steps}


def phase_hostloop(cfg, world, per_batch, bf16_tol):
    """The host-loop evaluators at full r2r width (see the module
    docstring); ``bf16_tol``: the bf16 phase's logit tolerance. Returns
    each evaluator's fp32 launches."""
    t_phase = time.perf_counter()
    t_max = cfg.env.max_action_len
    text = text_launches(cfg.model)[0]
    per_step = (per_batch - text) // t_max
    n_items = len(world.instr_data)

    agent = HAMTAgent(cfg, slice_env(cfg, world, seed=0), seed=0)
    agent.enable_feature_table()
    count = HostLoopCounter(agent)
    # warm-up (pinned host blocks, the allocator), with every dispatch of
    # the packed evaluator under the sync debug mode: a wait for the card
    # there raises
    dispatch = _PackedEvalGroup.dispatch
    torch.cuda.set_sync_debug_mode("error")
    try:  # the mode is live: a read of the card raises
        torch.ones(1, device="cuda").item()
        raise AssertionError("sync debug mode let .item() pass")
    except RuntimeError:
        pass
    finally:
        torch.cuda.set_sync_debug_mode("default")

    def strict_dispatch(group):
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch(group)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    _PackedEvalGroup.dispatch = strict_dispatch
    try:
        agent.eval_split_packed(pipeline=4)
    finally:
        _PackedEvalGroup.dispatch = dispatch
    runs, preds, launches = {}, {}, {}
    for name, fn in (("lockstep", agent.eval_split),
                     ("packed_p4", lambda: agent.eval_split_packed(pipeline=4)),
                     ("packed_p1", lambda: agent.eval_split_packed(pipeline=1)),
                     ("device", agent.eval_split_device)):
        preds[name], seconds, launches[name] = timed_eval(
            agent, count, fn, per_batch, text, per_step, f"hostloop {name}")
        if len(preds[name]) != n_items:
            raise AssertionError(f"hostloop {name}: {len(preds[name])} predictions for "
                                 f"{n_items} items")
        runs[name] = {"seconds": seconds, "episodes_per_s": n_items / seconds}
    for name in ("packed_p4", "packed_p1", "device"):
        same_trajectories(preds["lockstep"], preds[name], f"hostloop: lockstep vs {name}")
    metrics, _ = agent.env.eval_metrics(preds["lockstep"])

    nb = {"lockstep": agent.eval_split(no_cand_backtrack=True),
          "packed_p4": agent.eval_split_packed(no_cand_backtrack=True)}
    same_trajectories(nb["lockstep"], nb["packed_p4"], "hostloop no_cand_backtrack")
    if revisits(nb["lockstep"]):
        raise AssertionError(f"no_cand_backtrack: {revisits(nb['lockstep'])} revisits")
    del agent

    bare = HAMTAgent(cfg, slice_env(cfg, world, seed=0), seed=0)  # the same weights
    count = HostLoopCounter(bare)
    p, seconds, launches["lockstep_no_table"] = timed_eval(
        bare, count, bare.eval_split, per_batch, text, per_step, "hostloop without the table")
    same_trajectories(preds["lockstep"], p, "hostloop: lockstep with vs without the table")
    runs["lockstep_no_table"] = {"seconds": seconds, "episodes_per_s": n_items / seconds}
    del bare

    bcfg = cfg.replace(model=BF16)
    agent = HAMTAgent(bcfg, slice_env(bcfg, world, seed=0), seed=0)
    agent.enable_feature_table()
    count = HostLoopCounter(agent)
    recorder = LogitRecorder(agent)
    bpreds, recs, blaunches = {}, {}, {}
    for name, fn in (("lockstep", agent.eval_split), ("packed_p4", agent.eval_split_packed)):
        recorder.rec = recs[name] = {}
        bpreds[name], _, blaunches[name] = timed_eval(agent, count, fn, per_batch, text,
                                                      per_step, f"hostloop bf16 {name}")
    del agent
    err, parted = compare_hostloop_bf16(bpreds["lockstep"], bpreds["packed_p4"],
                                        recs["lockstep"], recs["packed_p4"], t_max, bf16_tol,
                                        "hostloop bf16 packed vs lockstep")
    emit("hostloop", preset="r2r", hidden=cfg.model.hidden_size, batch=B, t_max=t_max,
         episodes=n_items, **runs, launches=launches,
         launches_formula={"per_text_encoding": text, "per_policy_step": per_step},
         trajectories_identical=True, pose_atol=POSE_ATOL, sr=metrics["sr"],
         revisits_greedy=revisits(preds["lockstep"]),
         no_cand_backtrack={"trajectories_identical": True, "revisits": 0},
         bf16={"launches": blaunches, "max_abs_logit_err": err, "tol": bf16_tol,
               "episodes_parted": parted},
         seconds=time.perf_counter() - t_phase)
    return launches


def replay_gradients(agent, il_ep, extras, start):
    """The replay update's loss and every model and critic gradient, in
    training mode, no step."""
    agent.model.train()
    agent.critic.train()
    loss, _ = agent._replay_sample_loss(il_ep, extras["ep"], extras, start)
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in agent.model.named_parameters()
             if p.grad is not None}
    grads.update({"critic." + k: p.grad.detach().cpu()
                  for k, p in agent.critic.named_parameters()})
    return loss.item(), grads


def phase_replay(cfg, world, per_batch, per_update_bwd, boot):
    """The rollout-then-replay sample update at full r2r width (see the
    module docstring). Returns its launches per update by rollout."""
    t_phase = time.perf_counter()
    text = text_launches(cfg.model)[0]
    per_step = (per_batch - text) // cfg.env.max_action_len
    scfg = cfg.replace(train={"batch_size": TRAIN_B, "feedback": "sample"})
    runs, per_update = {}, {}
    iters = REPLAY_UPDATES
    for name, table in (("device_rollout", True), ("host_loop", False)):
        agent = HAMTAgent(scfg, slice_env(scfg, world, seed=0), seed=0)
        agent.merged_sample_update = agent.fused_sample_update = False
        if table:
            agent.enable_feature_table()
        count = HostLoopCounter(agent)
        agent.train_iteration("sample", sync=False)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        count.reset()
        losses, seconds, launches = timed_sample_updates(agent, iters)
        # the rollout (the device's whole batch, or the host loop's text
        # and policy steps), then the IL episode, the replay and its
        # bootstrap forward, and the IL episode's and the replay's backward
        rollout = per_batch * iters if table else text * iters + per_step * count.steps
        if count.texts != 3 * iters:  # the rollout's, the IL episode's and the replay's
            raise AssertionError(f"replay {name}: {count.texts} text encodings")
        want = {"attention_fwd": rollout + (2 * per_batch + boot) * iters,
                "attention_bwd": 2 * per_update_bwd * iters}
        if launches != want:
            raise AssertionError(f"replay {name}: launches {launches}, expected {want}")
        per_update[name] = {k: v / iters for k, v in launches.items()}
        runs[name] = {"updates": iters, "seconds": seconds,
                      "sample_episodes_per_s": iters * TRAIN_B / seconds,
                      "ms_per_update": seconds / iters * 1e3,
                      **{f"{k}_mean": v.mean().item() for k, v in losses.items()},
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                      "launches": launches, "launches_per_update": per_update[name],
                      "rollout_policy_steps": count.steps}
        # dropout on: the replay from the rollout's dropout state
        ep, ex, start = agent._sample_for_replay(table)
        rec = ex["rollout_logits"]
        with torch.no_grad():
            agent.dropout_rng.set_state(start)
            replay = agent.episode_forward(ep, agent._feat_table).logits[: rec.shape[0]]
        fin = torch.isfinite(rec)
        if not torch.equal(torch.isfinite(replay), fin):
            raise AssertionError(f"replay {name}: logits -inf at other places")
        err = (replay[fin] - rec[fin]).abs().max().item()
        if not err <= REPLAY_LOGIT_ATOL:
            raise AssertionError(f"replay {name}: replayed logits {err} from the rollout's")
        runs[name]["replayed_logits_max_abs_err"] = err
        del agent

    # card against CPU, batch 4, dropout off: an argmax host-loop rollout
    # (the sampling draws of two devices differ) and the replay update
    pcfg = cfg.replace(model=NO_DROPOUT, train={"batch_size": 4, "feedback": "sample"})
    res = {}
    for device in ("cuda", "cpu"):
        pagent = HAMTAgent(pcfg, slice_env(pcfg, world, seed=0), seed=0, device=device)
        pagent.enable_feature_table()
        il_ep = pagent._ep_to_device(pagent.env.teacher_episode())
        pagent.model.train()
        pagent.critic.train()
        start = pagent.dropout_rng.get_state()
        _, ex = pagent.interactive_rollout("argmax", record_for_replay=True)
        loss, grads = replay_gradients(pagent, il_ep, ex, start)
        res[device] = ({k: ex["ep"][k].cpu() for k in ("node_idx", "actions", "step_mask")},
                       ex["rewards"].cpu(), loss, grads)
        del pagent
    (ep_g, rw_g, loss_g, grads_g), (ep_c, rw_c, loss_c, grads_c) = res["cuda"], res["cpu"]
    for key in ep_c:
        if not torch.equal(ep_g[key], ep_c[key]):
            raise AssertionError(f"replay parity: card and CPU rollouts differ in {key}")
    if not torch.allclose(rw_g, rw_c, rtol=REWARD_RTOL, atol=REWARD_ATOL):
        raise AssertionError(f"replay parity: rewards {rw_g.tolist()} vs {rw_c.tolist()}")
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"replay parity: card vs CPU loss {loss_g} vs {loss_c}")
    emit("replay", preset="r2r", hidden=cfg.model.hidden_size, batch=TRAIN_B,
         t_max=cfg.env.max_action_len, **runs, replay_logit_atol=REPLAY_LOGIT_ATOL,
         parity={"batch": 4, "trajectories_identical": True,
                 "reward_max_abs_err": (rw_g - rw_c).abs().max().item(),
                 "loss_cuda": loss_g, "loss_cpu": loss_c, "loss_rel_err": loss_err,
                 "loss_rtol": TRAIN_LOSS_RTOL, "tensors": len(grads_c),
                 "max_grad_err_over_tol": check_grads(grads_g, grads_c, "replay update"),
                 "grad_rel_tol": TRAIN_GRAD_REL, "grad_floor": TRAIN_GRAD_FLOOR},
         seconds=time.perf_counter() - t_phase)
    return per_update


def variant_il_grads(agent, ep):
    """The teacher-forced episode's logits (REVERIE's object logits too),
    the agent's IL loss (REVERIE: the dual CE) and every model gradient,
    in training mode, no step."""
    agent.model.train()
    agent.critic.train()
    out = agent.episode_forward(ep, agent._feat_table, agent._obj_tables)
    loss = (agent._ce(out.logits, out.obj_logits, ep) * agent.cfg.train.teacher_weight
            / ep["actions"].shape[0])
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in agent.model.named_parameters()
             if p.grad is not None}
    obj = None if out.obj_logits is None else out.obj_logits.detach().cpu()
    return out.logits.detach().cpu(), obj, loss.item(), grads


def timed_updates(agent, feedback, iters, per_update, what):
    """One warm-up and ``iters`` timed updates of ``feedback`` from zeroed
    launch counts, unsynchronized; raises unless each launched exactly
    ``per_update``. Returns episodes/s, ms per update, peak GB and the
    episodes per update (packed IL's vary)."""
    agent.train_iteration(feedback, sync=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    outs = [agent.train_iteration(feedback, sync=False) for _ in range(iters)]
    losses = torch.stack([o["loss"] for o in outs]).cpu()
    seconds = time.perf_counter() - t0
    launches = tier_launches()
    if launches != {k: n * iters for k, n in per_update.items()}:
        raise AssertionError(f"{what}: launches {launches} over {iters} updates, expected "
                             f"{per_update} per update")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{what}: non-finite losses {losses.tolist()}")
    episodes = sum(o.get("episodes", agent.cfg.train.batch_size) for o in outs)
    return {"episodes_per_s": episodes / seconds, "ms_per_update": seconds / iters * 1e3,
            "episodes_per_update": episodes / iters, "loss_mean": losses.mean().item(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "launches_per_update": per_update}


def same_extras(a, b, keys, what) -> None:
    """The predictions' task extras (midstop, predObjId) equal per item."""
    a = {p["instr_id"]: [p.get(k) for k in keys] for p in a}
    b = {p["instr_id"]: [p.get(k) for k in keys] for p in b}
    if a != b:
        raise AssertionError(f"{what}: {keys} differ")


def phase_variants(task):
    """One task variant at full width (see the module docstring, phase
    17). Returns the phase's launches per path."""
    t_phase = time.perf_counter()
    cfg, world = slice_config(get_preset(task).train.batch_size, seed=0, task=task)
    b, t_max, mcfg = cfg.train.batch_size, cfg.env.max_action_len, cfg.model
    fwd_mix, bwd_mix = launch_mix(cfg)
    per_batch, per_bwd = sum(fwd_mix.values()), sum(bwd_mix.values())
    boot = sum(bootstrap_mix(cfg).values())
    extras = {"r2r_back": ("midstop",), "cvdn": (), "reverie": ("predObjId",)}[task]

    agent = slice_agent(cfg, world, seed=0)
    agent.enable_feature_table()
    eps, _ = timed_greedy_batch(agent, per_batch, task)
    # the three evaluators over the first items, with their launch formulas
    env = agent.env.clone_shell(list(agent.env.data)[:VARIANT_EVAL_ITEMS])
    text = text_launches(mcfg)[0]
    per_step = (per_batch - text) // t_max
    count = HostLoopCounter(agent)
    preds, evals = {}, {}
    for name, fn in (("lockstep", lambda: agent.eval_split(env)),
                     ("packed", lambda: agent.eval_split_packed(env)),
                     ("device", lambda: agent.eval_split_device(env))):
        preds[name], seconds, launches = timed_eval(agent, count, fn, per_batch, text,
                                                    per_step, f"{task} {name}")
        if len(preds[name]) != VARIANT_EVAL_ITEMS:
            raise AssertionError(f"{task} {name}: {len(preds[name])} predictions")
        evals[name] = {"episodes_per_s": VARIANT_EVAL_ITEMS / seconds, "launches": launches}
    for name in ("packed", "device"):
        same_trajectories(preds["lockstep"], preds[name], f"{task}: lockstep vs {name}")
        same_extras(preds["lockstep"], preds[name], extras, f"{task}: lockstep vs {name}")
    metrics, _ = env.eval_metrics(preds["device"])
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{task}: bad metrics {metrics}")

    updates = {"il": timed_updates(agent, "teacher", VARIANT_TIMED_UPDATES,
                                   {"attention_fwd": per_batch, "attention_bwd": per_bwd},
                                   f"{task} IL")}
    agent.merged_sample_update = True
    updates["merged"] = timed_updates(agent, "sample", VARIANT_TIMED_UPDATES,
                                      {"attention_fwd": per_batch + boot,
                                       "attention_bwd": per_bwd}, f"{task} merged")
    if task == "reverie":
        agent.enable_packed_il()
        pmix = packed_il_mix(cfg, agent._packer.text_cap)
        updates["packed_il"] = timed_updates(
            agent, "teacher", VARIANT_TIMED_UPDATES,
            {"attention_fwd": sum(pmix[0].values()), "attention_bwd": sum(pmix[1].values())},
            f"{task} packed IL")
        updates["packed_il"]["text_rows"] = agent._packer.text_cap
    del agent

    # card against CPU at batch 2, dropout off; then on the card the
    # sampling device rollout's rewards against the host hooks' on the
    # same batch and draws (the env's resampling generator and the action
    # generator rewound before each side)
    pcfg = cfg.replace(model=NO_DROPOUT, train={"batch_size": 2})
    res = {}
    for device in ("cuda", "cpu"):
        pagent = slice_agent(pcfg, world, seed=0, device=device)
        pagent.enable_feature_table()
        greedy = greedy_batch(pagent)
        res[device] = (greedy, *variant_il_grads(pagent, pagent._teacher_episode()))
        if device == "cpu":
            del pagent
            continue
        env, reward_err, stops = pagent.env, 0.0, 0
        np_rng = getattr(env, "_np_rng", None)
        for draw in range(3):
            rec = {}
            for side in ("host", "device"):
                if side == "host" and np_rng is not None:
                    state = np_rng.bit_generator.state
                elif np_rng is not None:
                    np_rng.bit_generator.state = state
                pagent.action_rng.manual_seed(draw)
                env.reset_epoch()
                if side == "host":
                    _, hx = pagent.interactive_rollout("sample", record_for_replay=True)
                    rec[side] = (hx["ep"], hx)
                else:
                    ins = pagent._device_rollout_args()
                    with torch.no_grad():
                        rec[side] = pagent._rollout(ins, ins["txt_ids"], ins["txt_mask"],
                                                    "sample")
            (hep, hx), (dep, dx) = rec["host"], rec["device"]
            for key in ("actions", "step_mask", "node_idx"):
                if not torch.equal(hep[key], dep[key]):
                    raise AssertionError(f"{task}: host and device rollouts differ in {key}")
            if not torch.equal(hx["bootstrap_mask"], dx["bootstrap_mask"]):
                raise AssertionError(f"{task}: host and device episode ends differ")
            reward_err = max(reward_err, (hx["rewards"] - dx["rewards"]).abs().max().item())
            stops += int((dep["actions"][dep["step_mask"]] == pagent.stop_action).sum())
        if not reward_err <= VARIANT_REWARD_ATOL:
            raise AssertionError(f"{task}: device rewards off the host hooks' by {reward_err}")
        del pagent
    (g_c, lg_c, ol_c, loss_c, grads_c), (g_p, lg_p, ol_p, loss_p, grads_p) = (res["cuda"],
                                                                             res["cpu"])
    logit_err = compare_rollouts(g_c, g_p, PARITY_LOGIT_ATOL, f"{task} card vs CPU")
    il_errs = {}
    for name, x, y in (("il_logits", lg_c, lg_p), ("il_obj_logits", ol_c, ol_p)):
        if y is None:
            continue
        fin = torch.isfinite(y)
        if not torch.equal(torch.isfinite(x), fin):
            raise AssertionError(f"{task}: card and CPU {name} -inf at other places")
        il_errs[name] = (x[fin] - y[fin]).abs().max().item()
        if not il_errs[name] <= PARITY_LOGIT_ATOL:
            raise AssertionError(f"{task}: card vs CPU {name} differ by {il_errs[name]}")
    loss_err = abs(loss_c - loss_p) / abs(loss_p)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{task}: card vs CPU IL loss {loss_c} vs {loss_p}")
    worst = check_grads(grads_c, grads_p, f"{task} IL update")
    emit("variants", preset=task, hidden=mcfg.hidden_size, no_lang_ca=mcfg.no_lang_ca,
         fix_lang_and_hist=[mcfg.fix_lang_embedding, mcfg.fix_hist_embedding],
         objects=cfg.env.max_objects if mcfg.obj_feat_size > 0 else 0,
         text_len=cfg.env.max_instr_len, t_max=t_max, batch=b,
         shape_mix={f"{lq}x{lk}": n for (lq, lk), n in fwd_mix.items()},
         bwd_shape_mix={f"{lq}x{lk}": n for (lq, lk), n in bwd_mix.items()},
         greedy_episodes_per_s=eps, greedy_launches_per_batch=per_batch,
         evaluators=evals, eval_items=VARIANT_EVAL_ITEMS, trajectories_identical=True,
         extras_identical=list(extras), metrics=metrics, updates=updates,
         rewards={"max_abs_err": reward_err, "atol": VARIANT_REWARD_ATOL, "draws": 3,
                  "stops": stops},
         parity={"batch": 2, "trajectories_identical": True, "max_abs_logit_err": logit_err,
                 **{f"max_abs_{k}_err": v for k, v in il_errs.items()}, "tol": PARITY_LOGIT_ATOL,
                 "loss_rel_err": loss_err, "tensors": len(grads_p),
                 "max_grad_err_over_tol": worst},
         seconds=time.perf_counter() - t_phase)
    return {"greedy": per_batch, **{k: v["launches_per_update"] for k, v in updates.items()}}


def phase_vit_kernels(dev, vit_cfg):
    """Both kernels at the ViT's shape ((1 + patches) x (1 + patches), its
    heads and Dh) and lanes, against their plain twins with dropout off
    and an all-zero mask, as the ViT calls them; timed in fp32 and bf16
    with the library and the bound. Returns the timed rows by kernel,
    dtype and (lanes, Lq, Lk), and the largest forward and backward
    errors."""
    gen = torch.Generator(device=dev).manual_seed(3)
    n, h = vit_cfg.num_patches + 1, vit_cfg.num_heads
    dh = vit_cfg.hidden_size // h
    timed = {name: {"float32": {}, "bfloat16": {}} for name in ("attention_fwd",
                                                               "attention_bwd")}
    ferr = berr = 0.0
    for lanes in VIT_FWD_LANES:
        frows, brows = [], []
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, m, g = kernel_inputs(lanes, h, n, n, dh, dtype, gen, dev)
            m = torch.zeros_like(m)
            where = f"ViT lanes {lanes} ({n},{n})"
            case = {"lanes": lanes, "lq": n, "lk": n, "dtype": dtype_name(dtype), "rate": 0.0}
            err = check_fwd(q, k, v, m, 0, 0.0, where)
            ferr = max(ferr, err)
            row = {**case, "max_abs_err": err, **time_forward(q, k, v, m)}
            row.update(bound_ms=max(row["bytes_ms"], row["flops_ms"]))
            frows.append(row)
            timed["attention_fwd"][case["dtype"]][(lanes, n, n)] = row
            if lanes in VIT_BWD_LANES:
                errs, err = check_bwd(q, k, v, m, g, 0, 0.0, where)
                berr = max(berr, err)
                row = {**case, "rel_err": errs, "max_abs_err": err,
                       **time_backward(q, k, v, m, g)}
                row.update(bound_ms=max(row["bytes_ms"], row["flops_ms"]))
                brows.append(row)
                timed["attention_bwd"][case["dtype"]][(lanes, n, n)] = row
            del q, k, v, m, g
        for name, rows in (("attention_fwd", frows), ("attention_bwd", brows)):
            if rows:
                emit("kernels", kernel=name, vit_shape=[lanes, n, n], heads=h, head_dim=dh,
                     results=rows)
    torch.cuda.empty_cache()
    return timed, ferr, berr


def check_native(world):
    """The port's navsim build, its tables against the numpy NavGraph's on
    the slice's world (distances, neighbour tables, every successor walk
    reaching its goal over the shortest distance), and the sampler's
    direction bands (tests/test_native.py's geometry)."""
    t0 = time.perf_counter()
    lib = navsim.build_library()
    build_s = time.perf_counter() - t0
    walks = 0
    for scan, g in world.graphs.items():
        ng = navsim.NativeNavGraph(g.positions, g.adj)
        if not (torch.allclose(torch.from_numpy(ng.dist), torch.from_numpy(g.dist), rtol=1e-6)
                and (ng.nbr_index == g.nbr_index).all()
                and (ng.nbr_point_id == g.nbr_point_id).all()
                and abs(ng.nbr_heading - g.nbr_heading).max() <= 1e-6
                and abs(ng.nbr_elevation - g.nbr_elevation).max() <= 1e-6):
            raise AssertionError(f"native tables of {scan} differ from the numpy NavGraph's")
        for src in range(g.num_nodes):
            for dst in range(g.num_nodes):
                cur, total = src, 0.0
                for _ in range(g.num_nodes):
                    if cur == dst:
                        break
                    nxt = int(ng.next_hop[cur, dst])
                    total += float(g.dist[cur, nxt]) if g.adj[cur, nxt] else math.inf
                    cur = nxt
                if cur != dst or not math.isclose(total, float(g.dist[src, dst]),
                                                  rel_tol=1e-5, abs_tol=1e-6):
                    raise AssertionError(f"native next_hop of {scan}: {src} -> {dst} walks "
                                         f"{total} to {cur}, shortest {g.dist[src, dst]}")
                walks += 1
    eq = np.full((64, 128, 3), 10, np.uint8)
    eq[:16, :, 2] = 255
    eq[21:42, 60:68, 0] = 255
    eq[21:42, 92:100, 1] = 255
    views = navsim.sample_panorama(eq, math.pi / 3, 32, 24)
    bands = {"north_red": float(views[12, 10:14, 14:18, 0].mean()),
             "east_green": float(views[15, 10:14, 14:18, 1].mean()),
             "up_blue": float(views[24:, :, :, 2].mean()),
             "horizon_blue": float(views[12:24, :, :, 2].mean())}
    if not (bands["north_red"] > 150 and bands["east_green"] > 150
            and bands["up_blue"] > bands["horizon_blue"]):
        raise AssertionError(f"panorama sampler's direction bands: {bands}")
    emit("vision", part="native", library=os.path.basename(lib), build_seconds=build_s,
         scans=len(world.graphs), nodes=sum(g.num_nodes for g in world.graphs.values()),
         successor_walks=walks, bands=bands)


def phase_featurizer():
    """ViT-B/16 feature extraction at full width, fp32 and bf16 (see the
    module docstring, phase 18). Returns its fields for the summary."""
    panos = render_panoramas(PANOS_PER_BATCH, seed=0)
    card, runs = {}, {}
    for dtype in ("float32", "bfloat16"):
        feat = slice_featurizer(dtype, seed=0)
        vcfg = feat.vit.config
        d, width = vcfg.hidden_size, vcfg.hidden_size + vcfg.num_classes
        per_call = {"attention_fwd": vcfg.num_layers, "attention_bwd": 0}
        feat.featurize_images(panos[0])[0].cpu()  # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()
        reset_counts()
        out = feat.extract(("synth", f"vp{i}", p) for i, p in enumerate(panos))
        launches = tier_launches()
        if launches != per_call:
            raise AssertionError(f"featurizer {dtype}: launches {launches} for one call of "
                                 f"{PANOS_PER_BATCH} panoramas, expected {per_call}")
        if sorted(out) != [f"synth_vp{i}" for i in range(PANOS_PER_BATCH)] or not all(
                m.shape == (36, width) and math.isfinite(float(m.sum()))
                for m in out.values()):
            raise AssertionError(f"featurizer {dtype}: output {[m.shape for m in out.values()]}")
        card[dtype] = out["synth_vp0"]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ips, _ = pipelined_images_per_s(feat, panos, VISION_PANOS)
        launches = tier_launches()
        want = {"attention_fwd": vcfg.num_layers * VISION_PANOS // PANOS_PER_BATCH,
                "attention_bwd": 0}
        if launches != want:
            raise AssertionError(f"featurizer {dtype} pipelined: launches {launches}, "
                                 f"expected {want}")
        resident = feat.to_device(np.concatenate(panos))
        call_ms = resident_call_ms(feat, resident, VISION_RESIDENT_ITERS)
        kernels, groups, whole = traced(lambda: feat.featurize_device(resident)[0].cpu(),
                                        {"attention_fwd": vcfg.num_layers})
        kernel_ms = sum(ms for _, ms, _ in kernels)
        runs[dtype] = {"images_per_s_pipelined": ips,
                       "images_per_s_resident": 36 * PANOS_PER_BATCH / call_ms * 1e3,
                       "call_ms_resident": call_ms, "kernel_ms_per_call": kernel_ms,
                       "idle_share_resident": 1.0 - kernel_ms / call_ms, "groups": groups,
                       "trace_whole": whole, "kernels_per_call": sum(n for *_, n in kernels),
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                       "launches": launches}
        del feat, resident
        torch.cuda.empty_cache()
    # card against CPU on one panorama: the same seeded weights
    t0 = time.perf_counter()
    cpu = {}
    for dtype in ("float32", "bfloat16"):
        feat = slice_featurizer(dtype, seed=0, device="cpu")
        f, logits = feat.featurize_images(panos[0])
        cpu[dtype] = torch.cat([f, logits], dim=1).numpy()
        del feat
    c32, g32 = torch.from_numpy(cpu["float32"]), torch.from_numpy(card["float32"])
    errs = {"features": (g32[:, :d] - c32[:, :d]).abs().max().item(),
            "logits": (g32[:, d:] - c32[:, d:]).abs().max().item()}
    if not max(errs.values()) <= FEAT_ATOL:
        raise AssertionError(f"featurizer fp32 card vs CPU: {errs} > {FEAT_ATOL}")
    bf16 = {part: bf16_close(card["bfloat16"][:, sl], cpu["bfloat16"][:, sl],
                             card["float32"][:, sl], f"featurizer bf16 {part}")
            for part, sl in (("features", slice(0, d)), ("logits", slice(d, None)))}
    emit("vision", part="featurizer", image=list(vcfg.img_size), hidden=d,
         layers=vcfg.num_layers, heads=vcfg.num_heads, classes=vcfg.num_classes,
         panos_per_call=PANOS_PER_BATCH, viewpoints=VISION_PANOS, launches_per_call=per_call,
         runs=runs, parity={"fp32_max_abs_err": errs, "atol": FEAT_ATOL, "bf16": bf16,
                            "cpu_seconds": time.perf_counter() - t0})
    return {"launches_per_call": vcfg.num_layers, "lanes": 36 * PANOS_PER_BATCH, "runs": runs}


def e2e_gradients(model, batch, task, device):
    """Loss and named gradients of one e2e task forward on a host batch,
    dropout off, no step; the gradients left cleared."""
    model.eval()
    model.zero_grad(set_to_none=True)
    loss, _ = model(batch_to_device(batch, device), task)
    loss.backward()
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def e2e_parity(trainer):
    """Card against CPU at E2E_PARITY_HIST history steps, fp32, dropout off:
    ``trainer``'s model and a copy of its weights on the CPU, over the
    CLI's batcher at that length; for each of E2E_PARITY_TASKS the loss
    and every gradient, and its exact launches on the card."""
    t0 = time.perf_counter()
    batcher, pargs = e2e_batcher(("--max_hist_len", str(E2E_PARITY_HIST)))
    cfg, vit_cfg = trainer.cfg, trainer.model.vit_config
    cpu_model = init_image_pretrain(cfg, vit_cfg, seed=1)
    cpu_model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    parity = {}
    for task in E2E_PARITY_TASKS:
        batch = batcher.batch(task, pargs.batch_size)
        reset_counts()
        loss_g, grads_g = e2e_gradients(trainer.model, batch, task, trainer.device)
        launches = tier_launches()
        mix = image_pretrain_launch_mix(cfg, vit_cfg, task, pargs.batch_size, pargs.max_txt_len,
                                        E2E_PARITY_HIST)
        want = {name: sum(m.values()) for name, m in zip(("attention_fwd", "attention_bwd"), mix)}
        if launches != want:
            raise AssertionError(f"e2e parity {task}: launches {launches}, expected {want}")
        loss_c, grads_c = e2e_gradients(cpu_model, batch, task, "cpu")
        loss_err = abs(loss_g - loss_c) / abs(loss_c)
        if not loss_err <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"e2e {task}: card vs CPU loss {loss_g} vs {loss_c}")
        parity[task] = {"loss_cuda": loss_g, "loss_cpu": loss_c, "loss_rel_err": loss_err,
                        "tensors": len(grads_c), "vit_tensors": sum(
                            k.startswith("vit.") for k in grads_c),
                        "max_grad_err_over_tol": check_grads(grads_g, grads_c, f"e2e {task}")}
    return {"hist_len": E2E_PARITY_HIST, "loss_rtol": TRAIN_LOSS_RTOL,
            "grad_rel_tol": TRAIN_GRAD_REL, "grad_floor": TRAIN_GRAD_FLOOR,
            "seconds": time.perf_counter() - t0, **parity}


def phase_e2e():
    """End-to-end image pretraining at full width (see the module
    docstring, phase 18). Returns its launches per task for the summary."""
    args = e2e_args()
    runs, parity = {}, None
    for dtype, extra in (("float32", ()), ("bfloat16", ("--bf16",))):
        trainer, _ = slice_e2e_trainer(extra)
        mixes = e2e_mixes(trainer, args)
        tasks = trainer.scheduler.tasks
        warm = {t: counted_update(trainer, t, trainer.batcher.batch(t, args.batch_size),
                                  mixes[t], f"e2e {dtype}") for t in tasks}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_task, n = {}, E2E_UPDATES[dtype]
        for task in tasks:
            reset_counts()
            t = timed_build_and_updates(trainer, task, n, args.batch_size)
            launches = tier_launches()
            want = {name: n * sum(m.values())
                    for name, m in zip(("attention_fwd", "attention_bwd"), mixes[task])}
            if launches != want:
                raise AssertionError(f"e2e {dtype} {task}: launches {launches} over {n} "
                                     f"updates, expected {want}")
            per_task[task] = {**t, "examples_per_s_update": 1e3 / t["update_ms"],
                              "examples_per_s_in_series": 1e3 / (t["update_ms"]
                                                                 + t["build_ms"]),
                              "launches_per_update": {k: v // n for k, v in launches.items()}}
            if task not in E2E_TRACED:
                continue
            batch = trainer.batcher.batch(task, args.batch_size)
            kernels, groups, whole = traced(
                lambda: float(trainer.update(task, batch)[0]),
                {name: sum(m.values()) for name, m in zip(("attention_fwd", "attention_bwd"),
                                                          mixes[task])})
            kernel_ms = sum(ms for _, ms, _ in kernels)
            per_task[task].update(kernel_ms=kernel_ms, groups=groups, trace_whole=whole,
                                  idle_share=1.0 - kernel_ms / t["update_ms"],
                                  kernels_per_update=sum(c for *_, c in kernels))
        runs[dtype] = {"updates_per_task": n, "warmup_losses": warm, "tasks": per_task,
                       "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
        cfg, vit_cfg = trainer.cfg, trainer.model.vit_config
        if dtype == "float32":
            parity = e2e_parity(trainer)
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
    emit("vision", part="e2e", preset="r2r", hidden=cfg.hidden_size,
         vit=[vit_cfg.hidden_size, vit_cfg.num_layers, vit_cfg.num_heads],
         vit_image=list(vit_cfg.img_size), store_image=list(args.image_size),
         batch=args.batch_size, grad_accum=args.grad_accum, optim=args.optim,
         text_len=args.max_txt_len, hist_len=args.max_hist_len, runs=runs,
         launches_per_update={t: {"attention_fwd": sum(f.values()),
                                  "attention_bwd": sum(b.values())}
                              for t, (f, b) in mixes.items()}, parity=parity)
    return {"launches_per_update": {t: [sum(f.values()), sum(b.values())]
                                    for t, (f, b) in mixes.items()}, "runs": runs}


def phase_vision(world):
    """Phase 18: the native library, both kernels at the ViT's shapes, the
    featurizer and e2e image pretraining. Returns the summary's vision
    field per kernel."""
    t_phase = time.perf_counter()
    check_native(world)
    vit_cfg = ViTConfig()  # ViT-B/16 at 224, both paths' ViT
    timed, ferr, berr = phase_vit_kernels(torch.device("cuda"), vit_cfg)
    feat = phase_featurizer()
    e2e = phase_e2e()
    n, layers = vit_cfg.num_patches + 1, vit_cfg.num_layers
    hist, ob = (25 * 36, n, n), (36, n, n)
    fmix = {(feat["lanes"], n, n): layers}
    out = {}
    for name in ("attention_fwd", "attention_bwd"):
        rows = timed[name]
        e2e_mix = {hist: layers, ob: layers} if name == "attention_fwd" else {ob: layers}
        out[name] = {
            "max_abs_err": ferr if name == "attention_fwd" else berr,
            "e2e": {"launches_per_update": {t: lb[0 if name == "attention_fwd" else 1]
                                            for t, lb in e2e["launches_per_update"].items()},
                    "vit_lanes": sorted(s[0] for s in e2e_mix),
                    **lane_times(rows["float32"], e2e_mix),
                    "bf16": lane_times(rows["bfloat16"], e2e_mix, "bfloat16")}}
        if name == "attention_fwd":
            out[name]["featurizer"] = {"launches_per_call": feat["launches_per_call"],
                                       "launches": feat["runs"]["float32"]["launches"][name],
                                       "lanes": feat["lanes"], **lane_times(rows["float32"], fmix),
                                       "bf16": lane_times(rows["bfloat16"], fmix, "bfloat16")}
    emit("vision", seconds=time.perf_counter() - t_phase)
    return out


# phase 19, multi-GPU: rank processes of tests/torch_parallel_harness.py,
# bounded by MG_TIMEOUT seconds, against one undistributed process at the
# same settings (dropout off, SGD, the preset at full width). Two ranks
# share the one card over gloo; one rank runs NCCL's own collectives.
MG_TIMEOUT = 240
MG_STEPS = "il,il,il,merged,merged,merged"
# SGD's rate: its steps are linear in the gradients, so the parameters
# compare; each step moves them by about 1e-4 of their scale here
MG_LR = "1e-4"
MG_EVAL_B, MG_EVAL_ITEMS = 32, 32
MG_RTOL, MG_ATOL = 2e-5, 1e-6  # losses, two ranks against one (the CPU tests' bar)
MG_PARAM_RTOL = 1e-5  # parameters after the updates, of each tensor's largest entry
TP_HEADS = H // 2


def alongside(tmp, tag, ranks, *argv, backend="gloo"):
    """:func:`parallel_run` of rank processes started on a thread (the
    caller runs the one-process reference meanwhile): a future of its
    result."""
    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(parallel_run, tmp, tag, ranks, *argv, backend=backend)
    pool.shutdown(wait=False)
    return fut


def parallel_run(tmp, tag, ranks, *argv, backend="gloo"):
    """tests/torch_parallel_harness.py over ``argv``: ``ranks`` rank
    processes, or with 0 this process (undistributed, on the card); its
    result, with the run's ``wall_seconds``."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    import torch_parallel_harness as harness

    out = os.path.join(tmp, f"{tag}.json")
    argv = [*argv, "--backend", backend, "--out", out]
    t0 = time.perf_counter()
    if ranks:
        harness.spawn(argv, ranks, MG_TIMEOUT)
    else:
        threads = torch.get_num_threads()
        try:
            harness.main(argv)
        finally:
            torch.set_num_threads(threads)
    with open(out) as f:
        return {**json.load(f), "wall_seconds": time.perf_counter() - t0}


def mg_losses_close(got, want, what, rtol=MG_RTOL, atol=MG_ATOL) -> float:
    """Every step's loss and parts within tolerance, a part's on the scale
    of the step's loss (A2C's loss is a small sum of larger terms); the
    worst error over its tolerance."""
    if [s for s, _ in got["losses"]] != [s for s, _ in want["losses"]]:
        raise AssertionError(f"{what}: steps {got['losses']} vs {want['losses']}")
    worst = 0.0
    for (step, g), (_, w) in zip(got["losses"], want["losses"]):
        for k, v in w.items():
            tol = rtol * max(abs(v), abs(w["loss"])) + atol
            if not abs(g[k] - v) <= tol:
                raise AssertionError(f"{what}: {step} {k} {g[k]} vs {v}")
            worst = max(worst, abs(g[k] - v) / tol)
    return worst


def mg_arrays_close(got_path, want_path, rtol, what, floor=1e-6) -> float:
    """Each tensor of two .npz files within ``rtol`` of its largest entry
    plus ``floor`` of the largest entry of all; the worst error over its
    tolerance."""
    got, want = np.load(got_path), np.load(want_path)
    if sorted(got.files) != sorted(want.files):
        raise AssertionError(f"{what}: different tensors")
    want = {k: want[k] for k in want.files}  # each array read from the file once
    top = max(float(np.abs(w).max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        tol = rtol * float(np.abs(w).max()) + floor * top
        if not err <= tol:
            raise AssertionError(f"{what}: {k} off by {err} (tolerance {tol})")
        worst = max(worst, err / tol if tol else 0.0)
    return worst


def mg_launches(res, want, what):
    """Each rank's launches per step equal ``want`` (per step name)."""
    for rank, steps in enumerate(res["launches_per_rank"]):
        for (step, _), got in zip(res["losses"], steps):
            if tier_launches(got) != want[step]:
                raise AssertionError(f"{what}: rank {rank} {step} launches {got}, "
                                     f"expected {want[step]}")


def mg_kernels(dev, mix, bwd_mix):
    """Both kernels against their plain versions at the multi-GPU paths'
    new shapes (fp32 and bf16, dropout 0 and 0.1; timed in both without
    dropout): per data rank at 4 lanes (IL) and 16 (greedy), per model
    rank at 6 heads (IL at 8 lanes, greedy at 32)."""
    gen = torch.Generator(device=dev).manual_seed(19)
    seed = 2**31 + 19
    rows = {}
    fwd_err = bwd_err = 0.0
    for tag, b, h, with_bwd in (("dp_il", TRAIN_B // 2, H, True), ("dp_greedy", B // 2, H, False),
                                ("tp_il", TRAIN_B, TP_HEADS, True),
                                ("tp_greedy", B, TP_HEADS, False)):
        f_rows, b_rows = [], []
        for (lq, lk) in mix:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, m, g = kernel_inputs(b, h, lq, lk, DH, dtype, gen, dev)
                for rate in (0.0, 0.1):
                    where = f"{tag} B {b} H {h} ({lq},{lk})"
                    err = check_fwd(q, k, v, m, seed, rate, where)
                    fwd_err = max(fwd_err, err)
                    row = {"lq": lq, "lk": lk, "dtype": dtype_name(dtype), "rate": rate,
                           "max_abs_err": err}
                    if rate == 0.0:
                        row.update(time_forward(q, k, v, m))
                    f_rows.append(row)
                    if with_bwd and (lq, lk) in bwd_mix:
                        errs, err = check_bwd(q, k, v, m, g, seed, rate, where)
                        bwd_err = max(bwd_err, err)
                        brow = {"lq": lq, "lk": lk, "dtype": dtype_name(dtype), "rate": rate,
                                "rel_err": errs}
                        if rate == 0.0:
                            brow.update(time_backward(q, k, v, m, g))
                        b_rows.append(brow)
        emit("multi_gpu", kernels=tag, batch=b, heads=h, head_dim=DH,
             attention_fwd=f_rows, attention_bwd=b_rows)
        rows[tag] = (b, h, f_rows, b_rows)
    return rows, fwd_err, bwd_err


def phase_multi_gpu(dev, mix, bwd_mix, per_batch, per_update_bwd, merged_per):
    """Phase 19 (see the module docstring); returns each kernel's
    multi-GPU fields for the summary and the kernels' largest errors."""
    smi = nvidia_smi()
    n_cards = torch.cuda.device_count()
    emit("multi_gpu", cards=n_cards, nvidia_smi=smi)
    kern, fwd_err, bwd_err = mg_kernels(dev, mix, bwd_mix)
    il_per = {"attention_fwd": per_batch, "attention_bwd": per_update_bwd}
    per_step = {"il": il_per, "merged": merged_per}
    full = ("--batch", str(TRAIN_B), "--lr", MG_LR)
    with tempfile.TemporaryDirectory() as tmp:
        p = lambda name: os.path.join(tmp, name)  # noqa: E731

        ev = ("--eval", "device", "--eval_batch", str(MG_EVAL_B), "--val_items",
              str(MG_EVAL_ITEMS))
        # (b) and (c) first, side by side, their times kept (four ranks
        # share the card: smoke output). (b): two data ranks over gloo, 3 IL
        # and 3 merged sample updates at global batch 8 (4 lanes per rank),
        # the greedy evaluation of a split sharded over the ranks (16 lanes
        # each), and the gradients of the first IL and the first merged
        # update. (c): two model ranks, its update timed. This process
        # meanwhile runs the references of (b), (c), the bf16 IL update and
        # the sharded feed
        tp_args = (*full, "--steps", "il", "--eval", "device", "--eval_batch", str(TRAIN_B),
                   "--val_items", str(TRAIN_B))
        grads_at = ("--grads_steps", f"0,{MG_STEPS.split(',').index('merged')}")
        tp = alongside(tmp, "c2", 2, *tp_args, "--model_shards", "2",
                       "--grads_out", p("c2g.npz"), "--logits_out", p("c2l.npy"))
        dp_run = alongside(tmp, "b2", 2, *full, "--steps", MG_STEPS, *ev,
                           "--params_out", p("b2.npz"), "--grads_out", p("b2g.npz"),
                           *grads_at, "--time_allreduce", "5")
        want = parallel_run(tmp, "b0", 0, *full, "--steps", MG_STEPS, *ev,
                            "--params_out", p("b0.npz"), "--grads_out", p("b0g.npz"),
                            *grads_at)
        tp0 = parallel_run(tmp, "c0", 0, *tp_args, "--grads_out", p("c0g.npz"),
                           "--logits_out", p("c0l.npy"))
        bf0 = parallel_run(tmp, "bf0", 0, *full, "--bf16", "--steps", "il")
        shard0 = parallel_run(tmp, "bs0", 0, *full, "--sharded_feed", "2", "--steps", "il")
        got, tp = dp_run.result(), tp.result()
        seconds_b, seconds_bc = got["wall_seconds"], tp["wall_seconds"]
        # then the rest side by side: the ranks' processes of (a), the bf16
        # IL update, the sharded feed and (d) at once, (d)'s reference in
        # this process meanwhile
        t0 = time.perf_counter()
        pt = ("--pretrain", "--batch", str(PRETRAIN_B), "--lr", "0")
        nccl = alongside(tmp, "a1", 1, *full, "--steps", "il", "--grads_out", p("a1g.npz"),
                         "--time_allreduce", "10", backend="nccl")
        bf2 = alongside(tmp, "bf2", 2, *full, "--bf16", "--steps", "il")
        shard = alongside(tmp, "bs", 2, *full, "--sharded_feed", "2", "--steps", "il")
        pt2 = alongside(tmp, "d2", 2, *pt, "--grads_out", p("d2.npz"))
        pt0 = parallel_run(tmp, "d0", 0, *pt, "--grads_out", p("d0.npz"))

        # (a) NCCL, one rank: the IL update through the gradient all-reduce,
        # bit-equal to the undistributed one (b0's first: its loss and the
        # gradients it steps with)
        nccl = nccl.result()
        a0, a1 = np.load(p("b0g.npz")), np.load(p("a1g.npz"))
        diff = max(float(np.abs(a0[k] - a1[k]).max()) for k in a1.files)
        if nccl["losses"] != want["losses"][:1] or diff != 0.0:
            raise AssertionError(f"NCCL world of one: loss {nccl['losses']} vs "
                                 f"{want['losses'][:1]}, gradients off by {diff}")
        emit("multi_gpu", part="a", backend="nccl", world=1, batch=TRAIN_B,
             loss=nccl["losses"][0][1]["loss"], max_grad_diff=diff,
             allreduce_ms=nccl["allreduce"]["ms"], allreduce_bytes=nccl["allreduce"]["bytes"],
             launches=nccl["launches"][0])

        # (b)'s checks
        loss_worst = mg_losses_close(got, want, "data parallel")
        param_worst = mg_arrays_close(p("b2.npz"), p("b0.npz"), MG_PARAM_RTOL, "data parallel")
        # the first IL and the first merged update's gradients summed over
        # the ranks (the model's and the critic's: A2C's global normalisers),
        # at the card's gradient bar (4 lanes' products round otherwise
        # than 8 lanes')
        grad_worst = mg_arrays_close(p("b2g.npz"), p("b0g.npz"), TRAIN_GRAD_REL,
                                     "data-parallel gradients", floor=TRAIN_GRAD_FLOOR)
        if got["traj"] != want["traj"] or len(want["traj"]) != MG_EVAL_ITEMS:
            raise AssertionError("data-parallel greedy eval: trajectories differ")
        mg_launches(got, per_step, "data parallel")
        local_eval = MG_EVAL_B // 2
        eval_batches = (MG_EVAL_ITEMS // 2) // local_eval + 1
        if tier_launches(got["eval_launches"]) != {"attention_fwd": per_batch * eval_batches,
                                    "attention_bwd": 0}:
            raise AssertionError(f"data-parallel eval launches {got['eval_launches']}")
        # episodes/s over each kind's updates after its first
        timed = {s: [(t, e) for (n, _), t, e in zip(got["losses"], got["seconds"],
                                                     got["episodes"]) if n == s][1:]
                 for s in ("il", "merged")}
        dp = {f"{s}_episodes_per_s": sum(e for _, e in te) / sum(t for t, _ in te)
              for s, te in timed.items()}
        dp.update(allreduce_ms=got["allreduce"]["ms"], allreduce_bytes=got["allreduce"]["bytes"])
        emit("multi_gpu", part="b", backend="gloo", ranks=2, batch=TRAIN_B,
             lanes_per_rank=TRAIN_B // 2, steps=MG_STEPS, losses=got["losses"],
             loss_worst_over_tol=loss_worst, param_worst_over_tol=param_worst,
             grad_worst_over_tol=grad_worst, grad_rel_tol=TRAIN_GRAD_REL, lr=float(MG_LR),
             eval_items=MG_EVAL_ITEMS, eval_batch=MG_EVAL_B, trajectories_identical=True,
             launches_per_rank=got["launches_per_rank"], eval_launches=got["eval_launches"],
             **dp, nvidia_smi=smi, seconds=seconds_b)
        # one bf16 IL update, two ranks against one (the fp32 answer b0's);
        # the sharded feed: each rank's env holds its rows of b0's first batch
        close = bf16_close(bf2.result()["losses"][0][1]["loss"], bf0["losses"][0][1]["loss"],
                           want["losses"][0][1]["loss"], "data-parallel bf16 IL loss")
        shard = shard.result()
        mg_losses_close(shard, shard0, "sharded feed")
        mg_launches(shard, per_step, "sharded feed")
        emit("multi_gpu", part="b", bf16_il=close, sharded_feed_loss=shard["losses"][0][1],
             allreduces_per_update=got["allreduces"])

        if n_cards >= 2 and TRAIN_B % n_cards == 0:  # NCCL, one rank per card
            nccl = parallel_run(tmp, "bn", n_cards, *full, "--steps", MG_STEPS,
                                backend="nccl")
            emit("multi_gpu", part="b", backend="nccl", ranks=n_cards,
                 loss_worst_over_tol=mg_losses_close(nccl, want, f"NCCL on {n_cards} cards"))
            mg_launches(nccl, per_step, f"NCCL on {n_cards} cards")

        # (c) two model ranks: 6 heads each; the IL update's loss and
        # gathered gradients, the logits after it and a greedy batch
        got = tp
        tp_loss = mg_losses_close(got, tp0, "tensor parallel", rtol=1e-5)
        tp_grads = mg_arrays_close(p("c2g.npz"), p("c0g.npz"), 1e-5, "tensor parallel grads")
        lg, lw = np.load(p("c2l.npy")), np.load(p("c0l.npy"))
        fin = np.isfinite(lw)
        if not np.array_equal(np.isfinite(lg), fin):
            raise AssertionError("tensor parallel: logits -inf at other places")
        logit_err = float(np.abs(lg[fin] - lw[fin]).max())
        if not logit_err <= 1e-5 * float(np.abs(lw[fin]).max()):
            raise AssertionError(f"tensor parallel: logits off by {logit_err}")
        if got["traj"] != tp0["traj"]:
            raise AssertionError("tensor parallel: greedy trajectories differ")
        mg_launches(got, per_step, "tensor parallel")
        if tier_launches(got["eval_launches"]) != {"attention_fwd": per_batch * 2,
                                                   "attention_bwd": 0}:
            raise AssertionError(f"tensor-parallel eval launches {got['eval_launches']}")
        emit("multi_gpu", part="c", ranks=2, heads_per_rank=TP_HEADS, batch=TRAIN_B,
             loss=got["losses"][0][1]["loss"], loss_worst_over_tol=tp_loss,
             grad_worst_over_tol=tp_grads, logit_max_abs_err=logit_err,
             launches_per_rank=got["launches_per_rank"], eval_launches=got["eval_launches"],
             seconds_per_il_update=got["seconds"][0],
             allreduces_per_update=got["allreduces"][0], seconds_with_b=seconds_bc)

        # (d) pretraining, two data ranks at batch 16 (8 each): one update
        # per task from the same weights (lr 0), losses and summed gradients
        got = pt2.result()
        pt_loss = mg_losses_close(got, pt0, "pretraining", rtol=TRAIN_LOSS_RTOL, atol=0.0)
        pt_grads = mg_arrays_close(p("d2.npz"), p("d0.npz"), TRAIN_GRAD_REL,
                                   "pretraining grads", floor=TRAIN_GRAD_FLOOR)
        emit("multi_gpu", part="d", ranks=2, batch=PRETRAIN_B, losses=got["losses"],
             loss_worst_over_tol=pt_loss, grad_worst_over_tol=pt_grads,
             launches_per_rank=got["launches_per_rank"],
             seconds_side_by_side=time.perf_counter() - t0)

    # (e) the numbers, smoke output: both ranks share one card
    emit("multi_gpu", part="e", **dp, nvidia_smi=smi, note="two ranks on one card")
    out = {}
    for i, name in enumerate(("attention_fwd", "attention_bwd")):
        m = mix if i == 0 else bwd_mix
        fields = {}
        for tag, (b, h, f_rows, b_rows) in kern.items():
            rows = f_rows if i == 0 else b_rows
            if rows:
                fields[tag] = {"batch": b, "heads": h, **kernel_times((rows, m)),
                               "bf16": kernel_times((rows, m), dtype="bfloat16")}
        fields["launches_per_rank"] = {"il": il_per[name], "merged": merged_per[name],
                                       "greedy_batch": per_batch if i == 0 else 0}
        out[name] = fields
    return out, fwd_err, bwd_err


# phase 20: remat off and under each policy; the updates each agent takes
# after a warm-up IL update (compared too)
REMAT_MODES = (None, "full", "dots")
REMAT_PATHS = ("il", "merged", "fused", "packed")


def remat_per_update(cfg, path, remat):
    """Attention launches of one update of ``path`` with or without
    recomputation: launch_mix(remat) per episode loop (two in the fused
    update) and the sample updates' bootstrap, or packed_il_mix(remat)."""
    if path == "packed":
        pf, pb = packed_il_mix(cfg, PACKED_TEXT_CAP, remat)
        return {"attention_fwd": sum(pf.values()), "attention_bwd": sum(pb.values())}
    fwd, bwd = (sum(m.values()) for m in launch_mix(cfg, remat))
    loops = 2 if path == "fused" else 1
    boot = sum(bootstrap_mix(cfg).values()) if path != "il" else 0
    return {"attention_fwd": loops * fwd + boot, "attention_bwd": loops * bwd}


def remat_update(agent, path):
    """One update of ``path`` from zeroed launch counts and peak memory:
    its loss, episodes, wall time, peak memory and launches."""
    if path == "packed" and not agent.packed_il:
        agent.enable_packed_il()
    agent.merged_sample_update = path == "merged"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = agent.train_iteration("sample" if path in ("merged", "fused") else "teacher")
    seconds = time.perf_counter() - t0  # the losses were read back: the update is done
    episodes = out.get("episodes", agent.cfg.train.batch_size)
    return {"loss": out["loss"], "episodes": episodes, "ms": seconds * 1e3,
            "episodes_per_s": episodes / seconds,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "launches": tier_launches()}


def remat_params(agent):
    """The model's and the critic's state, copied to the host."""
    return {**{k: v.detach().to("cpu", copy=True) for k, v in agent.model.state_dict().items()},
            **{"critic." + k: v.detach().to("cpu", copy=True)
               for k, v in agent.critic.state_dict().items()}}


def next_draws(agent):
    """The next draws of every stream: a dropout mask, an attention seed,
    an action noise row."""
    dev = agent.device
    return (agent.dropout_rng.keep(torch.zeros(4096, device=dev), 0.5).cpu(),
            agent.dropout_rng.attention_seed(),
            torch.rand(64, generator=agent.action_rng, device=dev).cpu())


def remat_xprof(agent, cfg):
    """A profile_trace of one IL update under remat, read back by
    utils/xprof: exactly the mix's attention launches."""
    agent.packed_il = False
    want = remat_per_update(cfg, "il", True)
    with tempfile.TemporaryDirectory() as tdir:
        with profile_trace(tdir):  # its own warm-up keeps every device event
            agent.train_iteration("teacher")
        res = xprof.analyze(tdir, top=5)
    cats = {c["category"]: c["launches"] for c in res["categories"]}
    got = {"attention_fwd": cats["attention_fwd_kernel"],
           "attention_bwd": cats["attention_bwd_kernel"]}
    if got != want:
        raise AssertionError(f"xprof of a remat IL update: {got}, expected {want}")
    emit("remat", xprof={"launches": got, "device_ms": res["device_us"] / 1e3,
                         "busy_ms": res["busy_us"] / 1e3, "span_ms": res["span_us"] / 1e3,
                         "idle_share_in_span": res["idle_share"], "gaps": res["gaps"],
                         "categories": res["categories"], "top": res["top"]})


def phase_remat(cfg, world, smi):
    """Phase 20 (see the module docstring); returns the fp32 launches per
    update of each path by mode (off, ``full``, ``dots``) for the summary."""
    per_update = {}
    for dtype in ("float32", "bfloat16"):
        base = None  # remat off's updates, parameter change and next draws
        for mode in REMAT_MODES:
            t_agent = time.perf_counter()
            rcfg = cfg.replace(model={"dtype": dtype, "remat": mode is not None,
                                      "remat_policy": mode or "full"},
                               train={"batch_size": TRAIN_B, "feedback": "teacher"})
            agent = HAMTAgent(rcfg, slice_env(rcfg, world, seed=0), seed=0)
            agent.enable_feature_table()
            before = remat_params(agent)
            runs = {}
            for path in ("warm-up",) + REMAT_PATHS:
                kind = "il" if path == "warm-up" else path
                runs[path] = got = remat_update(agent, kind)
                want = remat_per_update(rcfg, kind, mode is not None)
                if got["launches"] != want:
                    raise AssertionError(f"remat {mode} {dtype} {path}: launches "
                                         f"{got['launches']}, expected {want}")
            if agent._packer.text_cap != PACKED_TEXT_CAP:
                raise AssertionError(f"packed text rows {agent._packer.text_cap}")
            after = remat_params(agent)
            delta = {k: after[k].float() - before[k].float() for k in after}
            draws = next_draws(agent)
            if mode == "full" and dtype == "float32":
                remat_xprof(agent, rcfg)
            del agent
            if dtype == "float32":
                per_update[mode or "off"] = {p: runs[p]["launches"] for p in REMAT_PATHS}
            checks = {}
            if base is None:
                base = (runs, delta, draws)
            else:
                for path, r in runs.items():
                    want = base[0][path]["loss"]
                    if not abs(r["loss"] - want) <= TRAIN_LOSS_RTOL * abs(want):
                        raise AssertionError(f"remat {mode} {dtype} {path}: loss {r['loss']}, "
                                             f"remat off {want}")
                if not (torch.equal(draws[0], base[2][0]) and draws[1] == base[2][1]
                        and torch.equal(draws[2], base[2][2])):
                    raise AssertionError(f"remat {mode} {dtype}: the streams' next draws "
                                         "differ from remat off's")
                checks = {"param_change_worst_over_tol": check_grads(
                    delta, base[1], f"remat {mode} {dtype} parameter change"),
                    "losses_max_rel_err": max(
                        abs(r["loss"] - base[0][p]["loss"]) / abs(base[0][p]["loss"])
                        for p, r in runs.items()),
                    "streams_equal": True}
            emit("remat", preset="r2r", dtype=dtype, remat=mode or "off", batch=TRAIN_B,
                 dropout=[rcfg.model.hidden_dropout_prob,
                          rcfg.model.attention_probs_dropout_prob],
                 updates=runs, **checks, nvidia_smi=smi,
                 seconds=time.perf_counter() - t_agent)

    # the rxr merged update's peak memory, fp32: off, full, dots
    xcfg, xworld = slice_config(get_preset("rxr").train.batch_size, seed=0, task="rxr")
    peaks = {}
    t_rxr = time.perf_counter()
    for mode in REMAT_MODES:
        rcfg = xcfg.replace(model={"remat": mode is not None, "remat_policy": mode or "full"},
                            train={"feedback": "sample"})
        agent = HAMTAgent(rcfg, slice_env(rcfg, xworld, seed=0), seed=0)
        agent.enable_feature_table()
        remat_update(agent, "merged")  # warm-up: the optimizers' moments
        peaks[mode or "off"] = r = remat_update(agent, "merged")
        want = remat_per_update(rcfg, "merged", mode is not None)
        if r["launches"] != want:
            raise AssertionError(f"rxr remat {mode}: launches {r['launches']}, expected {want}")
        del agent
    if not peaks["full"]["peak_mem_gb"] < peaks["off"]["peak_mem_gb"]:
        raise AssertionError(f"rxr merged update: remat full peaks at "
                             f"{peaks['full']['peak_mem_gb']} GB, remat off at "
                             f"{peaks['off']['peak_mem_gb']} GB")
    emit("remat", preset="rxr", update="merged", dtype="float32",
         batch=xcfg.train.batch_size, lanes=2 * xcfg.train.batch_size, runs=peaks,
         full_over_off_peak=peaks["full"]["peak_mem_gb"] / peaks["off"]["peak_mem_gb"],
         nvidia_smi=smi, seconds=time.perf_counter() - t_rxr)
    return per_update


# phase 21, the shapes past the whole-row kernels, which the key-blocked
# kernels take: the key rows and head widths both are held at against
# their plain versions (SHAPE_LANES lanes of SHAPE_HEADS heads, the first
# lane's keys all at -10000 and one more key inside the last key block
# at -10000); the query and key rows each head width 1..128 is launched
# at once; the key rows every head width's layout checks run at; the
# ViT-B/16 featurizer's lanes at 197 keys, where the key-blocked kernels
# are timed beside the whole-row ones; the task of the e2e updates (the
# observation with gradient: both kernels); the pretraining CLI's text
# length and task; the featurizer's image size; the ViT's card-against-
# CPU images (phase 18's bar)
SHAPE_LKS = (257, 301, 514, 577)
SHAPE_DHS = (12, 48, 64, 80, 128)
SHAPE_LANES, SHAPE_HEADS = 3, 4
SWEEP_LQ, SWEEP_LK = 9, 70
LAYOUT_LKS = (1, 40, 41, 72, 73, 160, 161, 192, 193, 256, 257, 301, 514, 577, 1024)
VIT197_LANES = {"attention_fwd": 36 * PANOS_PER_BATCH, "attention_bwd": 36}
SHAPE_E2E_TASK = "sap"
LONG_TEXT, LONG_TEXT_TASK = 300, "mlm"
FEAT_IMAGE = 384
VIT_PARITY_IMAGES = 2


def phase_shape_routes(dev):
    """Phase 21's routes: the whole-row kernels' key limits by head width
    (``ops/attention.py:FWD_SMEM_MAX_LK``, ``BWD_SMEM_MAX_LK``, else
    FWD_MAX_LK) against their libraries' shared memory: the limit within
    MAX_SMEM_BYTES, one key more past it, so no routed shape can fail the
    launch for its shared memory; every head
    width 1..128 at LAYOUT_LKS, as the layer's views in fp32 and bf16,
    through check_fwd_layout and check_bwd_layout; and both kernels once
    per head width (SWEEP_LQ x SWEEP_LK, fp32, dropout 0.1) against their
    plain versions. Returns the largest errors."""
    libs = ((attn._library("attention_fwd").hamt_attention_smem_bytes, attn.FWD_SMEM_MAX_LK),
            (attn._library("attention_bwd").hamt_attention_bwd_smem_bytes,
             attn.BWD_SMEM_MAX_LK))
    for smem, limits in libs:
        for dh in attn.FWD_HEAD_DIMS:
            lk = limits.get(dh, attn.FWD_MAX_LK)
            if not (smem(lk, dh) <= attn.MAX_SMEM_BYTES
                    and (lk == attn.FWD_MAX_LK or smem(lk + 1, dh) > attn.MAX_SMEM_BYTES)):
                raise AssertionError(f"{smem.__name__} at Dh {dh}: {smem(lk, dh)} B at the "
                                     f"route's limit Lk {lk}, {smem(lk + 1, dh)} B past it")
    routes = collections.Counter()
    for dh in range(1, attn.MAX_HEAD_DIM + 1):
        for lk in LAYOUT_LKS:
            for dtype in (torch.float32, torch.bfloat16):
                def view(l, t=dtype):  # (B, L, 3 * Dh) as (B, 3, L, Dh)
                    return torch.empty(2, l, 3 * dh, dtype=t, device=dev).view(
                        2, l, 3, dh).transpose(1, 2)
                q, k, g = view(SWEEP_LQ), view(lk), view(SWEEP_LQ, torch.float32)
                attn.check_fwd_layout(q, k, k)
                attn.check_bwd_layout(q, k, k, g)
            routes[f"{attn.fwd_kernel(lk, dh)} / {attn.bwd_kernel(lk, dh)}"] += 1
    gen = torch.Generator(device=dev).manual_seed(21)
    ferr = berr = 0.0
    for dh in range(1, attn.MAX_HEAD_DIM + 1):
        q, k, v, m, g = kernel_inputs(2, 3, SWEEP_LQ, SWEEP_LK, dh, torch.float32, gen, dev,
                                      masked_rows=True)
        where = f"({SWEEP_LQ},{SWEEP_LK}) Dh {dh}"
        ferr = max(ferr, check_fwd(q, k, v, m, 2**31 + 7, 0.1, where))
        berr = max(berr, check_bwd(q, k, v, m, g, 2**31 + 7, 0.1, where)[1])
    emit("shapes", part="routes", key_limits_hold=True,
         layout_checks=len(LAYOUT_LKS) * attn.MAX_HEAD_DIM * 2, routes=dict(routes),
         head_widths_launched=attn.MAX_HEAD_DIM, max_abs_err={"fwd": ferr, "bwd": berr})
    return ferr, berr


def phase_shape_kernels(dev):
    """Both key-blocked kernels against their plain versions at every Lk
    of SHAPE_LKS (Lq = Lk) and Dh of SHAPE_DHS, fp32 and bf16, dropout 0
    and 0.1, at phase 3's bars; each call launches exactly the key-blocked
    kernel. The layer's views take both kernels' 16-byte staging of q, k
    and v where a head is a multiple of 16 bytes; there both run again on
    copies one element past a 16-byte boundary, their element loads (the
    bf16 Dh 12 views take them as they lie). Returns the largest errors."""
    gen = torch.Generator(device=dev).manual_seed(21)
    seed = 2**31 + 7
    rows, ferr, berr = [], 0.0, 0.0
    want = {"attention_fwd": 0, "attention_bwd": 0, "attention_fwd_blocked": 1,
            "attention_bwd_blocked": 1}
    want_fwd = dict(want, attention_bwd_blocked=0)
    want_bwd = dict(want, attention_fwd_blocked=0)
    for lk in SHAPE_LKS:
        for dh in SHAPE_DHS:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, m, g = kernel_inputs(SHAPE_LANES, SHAPE_HEADS, lk, lk, dh, dtype, gen,
                                              dev, masked_rows=True)
                m[1:, lk - 2] = -10000.0  # a key inside the last key block
                staging = staging_name(q, k, v)
                shifted = (None if staging == "element"
                           else tuple(element_layout(x) for x in (q, k, v)))
                for rate in (0.0, 0.1):
                    where = f"key-blocked ({lk},{lk}) Dh {dh}"
                    reset_counts()
                    err = check_fwd(q, k, v, m, seed, rate, where)
                    errs, aerr = check_bwd(q, k, v, m, g, seed, rate, where)
                    if dict(attn.launch_counts) != want:
                        raise AssertionError(f"{where}: launches {attn.launch_counts}")
                    ferr, berr = max(ferr, err), max(berr, aerr)
                    row = {"lk": lk, "head_dim": dh, "dtype": dtype_name(dtype), "rate": rate,
                           "staging": staging, "max_abs_err": err, "rel_err": errs}
                    if shifted is not None:
                        where_e = f"{where}, element loads"
                        reset_counts()
                        row["element_max_abs_err"] = check_fwd(*shifted, m, seed, rate, where_e)
                        if dict(attn.launch_counts) != want_fwd:
                            raise AssertionError(f"{where_e}: launches {attn.launch_counts}")
                        reset_counts()
                        row["element_rel_err"], eerr = check_bwd(*shifted, m, g, seed, rate,
                                                                 where_e)
                        if dict(attn.launch_counts) != want_bwd:
                            raise AssertionError(f"{where_e}: backward launches "
                                                 f"{attn.launch_counts}")
                        ferr = max(ferr, row["element_max_abs_err"])
                        berr = max(berr, eerr)
                    rows.append(row)
    emit("shapes", part="kernels", lanes=SHAPE_LANES, heads=SHAPE_HEADS, tol=dict(
        fwd={f"{dtype_name(d)} {r}": t for (d, r), t in TOL.items()},
        bwd={dtype_name(d): t for d, t in BWD_RTOL.items()}, dm=BWD_DM_RTOL), results=rows)
    return ferr, berr


def blocked_shapes(mixes, heads, dh):
    """The shapes of a (forward, backward) pair of launch mixes by (lanes,
    Lq, Lk) that the key-blocked kernels take, by kernel: {name: {(lanes,
    heads, Lq, Lk, Dh): launches}}."""
    out = {name: collections.Counter() for name in attn.BLOCKED}
    for mix, route in zip(mixes, (attn.fwd_kernel, attn.bwd_kernel)):
        for (lanes, lq, lk), n in mix.items():
            name = route(lk, dh)
            if name in out:
                out[name][(lanes, heads, lq, lk, dh)] += n
    return out


def counted_run(fn, want, what):
    """``fn()`` (a loss, or a dict of finite outputs) with every count set
    to 0 just before and read just after: its launches equal ``want`` by
    kernel. Returns the loss or outputs and the launches."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = dict(attn.launch_counts)
    finite = (math.isfinite(out) if isinstance(out, float)
              else all(np.isfinite(x).all() for x in out.values()))
    if got != want or not finite:
        raise AssertionError(f"{what}: launches {got}, expected {want}; finite {finite}")
    return out, got


def shape_e2e(extra):
    """One e2e image-pretraining update of SHAPE_E2E_TASK of the CLI at
    ``extra`` (``--transform none``: the ViT at the store's 248 x 330, 301
    tokens; ``--tiny``: the ViT's Dh 12) on the card. Returns its line and
    its key-blocked shapes."""
    args = e2e_args(extra)
    trainer, _ = slice_e2e_trainer(extra)
    vit, task = trainer.model.vit_config, SHAPE_E2E_TASK
    mix_args = (task, args.batch_size, args.max_txt_len, args.max_hist_len)
    trunk = pretrain_launch_mix(trainer.cfg, *mix_args)
    vit_mix = tuple(a - b for a, b in zip(
        image_pretrain_launch_mix(trainer.cfg, vit, *mix_args), trunk))
    batch = trainer.batcher.batch(task, args.batch_size)
    loss, got = counted_run(lambda: float(trainer.update(task, batch)[0]),
                            image_pretrain_kernel_counts(trainer.cfg, vit, *mix_args),
                            f"e2e {' '.join(extra)} {task}")
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    line = {"cli": "run/image_pretrain.py --synthetic " + " ".join(extra), "task": task,
            "vit": [vit.hidden_size, vit.num_layers, vit.num_heads], "image": list(vit.img_size),
            "tokens": vit.num_patches + 1, "loss": loss, "launches": got}
    return line, blocked_shapes(vit_mix, vit.num_heads, vit.hidden_size // vit.num_heads)


def shape_featurize():
    """One ``run/precompute_features.py --synthetic 1 --image_size 384 384``
    call (its defaults otherwise: bf16, the timm eval transform) on the
    card through its own set-up: 577 tokens. Returns its line and its
    key-blocked shapes."""
    args = precompute_features.parse_args(
        ["--synthetic", "1", "--image_size", str(FEAT_IMAGE), str(FEAT_IMAGE),
         "--output_file", "unused.hdf5"])
    feat, source, _ = precompute_features.build(args)
    vit = feat.vit.config
    n, dh = vit.num_patches + 1, vit.hidden_size // vit.num_heads
    mix = ({(36, n, n): vit.num_layers}, {})
    out, got = counted_run(lambda: {k: np.asarray(v) for k, v in feat.extract(source).items()},
                           kernel_counts(mix, dh), "precompute_features 384")
    if [v.shape for v in out.values()] != [(36, vit.hidden_size + vit.num_classes)]:
        raise AssertionError(f"precompute_features 384: {[v.shape for v in out.values()]}")
    del feat
    torch.cuda.empty_cache()
    line = {"cli": "run/precompute_features.py --synthetic 1 --image_size 384 384",
            "dtype": vit.dtype, "tokens": n, "viewpoints": len(out), "launches": got,
            "features_max_abs": float(max(np.abs(v).max() for v in out.values()))}
    return line, blocked_shapes(mix, vit.num_heads, dh)


def shape_long_text():
    """One ``run/pretrain.py --synthetic --max_txt_len 300`` update of
    LONG_TEXT_TASK at full `r2r` width and the CLI's batch on the card.
    Returns its line and its key-blocked shapes."""
    extra = ("--max_txt_len", str(LONG_TEXT))
    trainer, _ = slice_trainer("r2r", batch_size=PRETRAIN_B, seed=0, extra=extra)
    mixes, _ = slice_mixes("r2r", PRETRAIN_B, extra)
    cfg, task = trainer.cfg, LONG_TEXT_TASK
    batch = trainer.batcher.batch(task, PRETRAIN_B)
    loss, got = counted_run(lambda: float(trainer.update(task, batch)[0]),
                            kernel_counts(mixes[task], cfg.head_dim),
                            f"pretrain --max_txt_len {LONG_TEXT} {task}")
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    line = {"cli": f"run/pretrain.py --synthetic --max_txt_len {LONG_TEXT}", "task": task,
            "batch": PRETRAIN_B, "loss": loss, "launches": got}
    return line, blocked_shapes(mixes[task], cfg.num_attention_heads, cfg.head_dim)


def shape_vit_parity(dev):
    """ViT-B/16 at 248 x 330 (301 tokens) and 384 x 384 (577), fp32, on
    VIT_PARITY_IMAGES images: the card's features and logits within
    FEAT_ATOL of the CPU's, the card's attention all key-blocked."""
    out = {}
    for size in ((248, 330), (FEAT_IMAGE, FEAT_IMAGE)):
        vit = vit_base_patch16(img_size=size)
        cfg = vit.config
        n = cfg.num_patches + 1
        images = torch.from_numpy(np.random.default_rng(21).standard_normal(
            (VIT_PARITY_IMAGES, *size, 3)).astype(np.float32))
        with torch.no_grad():
            want = [x.numpy() for x in vit(images)]
            vit.to(dev)
            got, _ = counted_run(
                lambda: dict(zip(("features", "logits"),
                                 (x.cpu().numpy() for x in vit(images.to(dev))))),
                kernel_counts(({(VIT_PARITY_IMAGES, n, n): cfg.num_layers}, {}),
                              cfg.hidden_size // cfg.num_heads), f"ViT at {size}")
        errs = {k: float(np.abs(got[k] - w).max()) for k, w in zip(got, want)}
        if not max(errs.values()) <= FEAT_ATOL:
            raise AssertionError(f"ViT at {size}, card vs CPU: {errs} > {FEAT_ATOL}")
        out[f"{size[0]}x{size[1]}"] = {"tokens": n, "max_abs_err": errs}
        del vit
    return {"images": VIT_PARITY_IMAGES, "atol": FEAT_ATOL, **out}


def blocked_rows(dev, shapes):
    """Each key-blocked shape of the configurations' runs held against its
    plain version at dropout 0 and 0.1 (phase 3's bars), then timed in
    fp32 and bf16 against its plain version, scaled_dot_product_attention
    and the bound (dropout off): {kernel: [rows]}, each row with the run's
    launches of its shape, and the largest errors {kernel: err}."""
    gen = torch.Generator(device=dev).manual_seed(22)
    rows = {name: [] for name in attn.BLOCKED}
    errs = dict.fromkeys(attn.BLOCKED, 0.0)
    for name, mix in shapes.items():
        fwd = name == "attention_fwd_blocked"
        for (lanes, heads, lq, lk, dh), n in mix.items():
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, m, g = kernel_inputs(lanes, heads, lq, lk, dh, dtype, gen, dev)
                where = f"{name} {lanes} x {heads} ({lq},{lk}) Dh {dh}"
                err = {rate: (check_fwd(q, k, v, m, 2**31 + 7, rate, where) if fwd
                              else check_bwd(q, k, v, m, g, 2**31 + 7, rate, where)[1])
                       for rate in (0.0, 0.1)}
                errs[name] = max(errs[name], *err.values())
                torch.cuda.empty_cache()  # the plain versions' scores at 900 lanes
                t = time_forward(q, k, v, m) if fwd else time_backward(q, k, v, m, g)
                rows[name].append({"lanes": lanes, "heads": heads, "lq": lq, "lk": lk,
                                   "head_dim": dh, "dtype": dtype_name(dtype), "launches": n,
                                   "staging": staging_name(q, k, v), "max_abs_err": err,
                                   "bound_ms": max(t["bytes_ms"], t["flops_ms"]), **t})
                del q, k, v, m, g
    return rows, errs


def blocked_times(rows, dtype):
    """The rows' times and bound of ``dtype``, weighted by their launches."""
    rows = [r for r in rows if r["dtype"] == dtype]
    total = sum(r["launches"] for r in rows)
    mean = lambda key: sum(r["launches"] * key(r) for r in rows) / total  # noqa: E731
    bytes_ms, flops_ms = mean(lambda r: r["bytes_ms"]), mean(lambda r: r["flops_ms"])
    return {"ms": mean(lambda r: r["ms"]), "plain_ms": mean(lambda r: r["plain_ms"]),
            "bound_ms": mean(lambda r: r["bound_ms"]),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": mean(lambda r: r["library_ms"])}


def vit197_times(dev):
    """At the ViT's 197 keys (the featurizer's lanes forward, the e2e
    observation's backward; Dh 64, fp32 and bf16, dropout off), which the
    whole-row kernels take, each key-blocked kernel timed beside its
    whole-row one, in turns: a finding for later work, not a route."""
    gen = torch.Generator(device=dev).manual_seed(23)
    out = {}
    for tier, lanes in VIT197_LANES.items():
        blocked = tier + "_blocked"
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, m, g = kernel_inputs(lanes, H, 197, 197, DH, dtype, gen, dev)
            if tier == "attention_fwd":
                calls = {name: (lambda name=name: attn._launch(q, k, v, m, 0, 0.0, name))
                         for name in (tier, blocked)}
            else:
                calls = {name: (lambda name=name: attn._launch_bwd(q, k, v, m, g, 0, 0.0,
                                                                   False, name))
                         for name in (tier, blocked)}
            times = {name: [] for name in calls}
            for name in (tier, blocked, blocked, tier):
                times[name].append(cuda_time_ms(calls[name]))
            out[f"{blocked} {dtype_name(dtype)}"] = {
                "lanes": lanes, "ms": min(times[blocked]), "whole_row_ms": min(times[tier])}
    return out


def phase_shapes(dev, builds):
    """Phase 21 (see the module docstring); ``builds`` are phase 2's build
    reports by kernel. Returns the summary's lines of the key-blocked
    kernels."""
    t_phase = time.perf_counter()
    ferr, berr = phase_shape_routes(dev)
    e1, e2 = phase_shape_kernels(dev)
    ferr, berr = max(ferr, e1), max(berr, e2)
    runs, shapes = [], {name: collections.Counter() for name in attn.BLOCKED}
    for run in (lambda: shape_e2e(("--transform", "none")), shape_featurize,
                lambda: shape_e2e(("--tiny",)), shape_long_text):
        line, blocked = run()
        emit("shapes", part="run", **line)
        runs.append(line)
        for name in attn.BLOCKED:
            shapes[name].update(blocked[name])
    launches = {name: sum(r["launches"][name] for r in runs) for name in attn.BLOCKED}
    if not all(launches.values()):
        raise AssertionError(f"the configurations' runs missed a key-blocked kernel: {launches}")
    parity = shape_vit_parity(dev)
    rows, errs = blocked_rows(dev, shapes)
    ferr = max(ferr, errs["attention_fwd_blocked"])
    berr = max(berr, errs["attention_bwd_blocked"])
    vit197 = vit197_times(dev)
    occupancy = {"attention_fwd_blocked": fwd_blocked_occupancy(),
                 "attention_bwd_blocked": bwd_blocked_occupancy()}
    emit("shapes", part="times", smi=nvidia_smi(), rows=rows, vit197=vit197, vit_parity=parity,
         occupancy=occupancy, seconds=time.perf_counter() - t_phase)
    sources = {"attention_fwd_blocked": ("vln_hamt_torch/csrc/attention_blocked.cu",
                                         "vln_hamt_tpu/ops/attention.py:53", ferr),
               "attention_bwd_blocked": ("vln_hamt_torch/csrc/attention_blocked_bwd.cu",
                                         "vln_hamt_tpu/ops/attention.py:85", berr)}
    return [{"name": name, "route": "cuda", "source": src, "replaces": replaces,
             "launches": launches[name], "max_abs_err": err,
             **blocked_times(rows[name], "float32"),
             "bf16": blocked_times(rows[name], "bfloat16"),
             "runs": {r["cli"]: r["launches"][name] for r in runs},
             "shapes": [[r[k] for k in ("lanes", "heads", "lq", "lk", "head_dim")]
                        for r in rows[name] if r["dtype"] == "float32"],
             "staging": [[r[k] for k in ("lanes", "heads", "lq", "lk", "head_dim", "dtype",
                                          "staging")] for r in rows[name]],
             "build": {"max_registers": builds[name]["max_registers"],
                       "spill_bytes": builds[name]["spill_bytes"],
                       "entries": builds[name]["entries"]},
             "ctas_per_sm": occupancy[name],
             "vit197": {k: t for k, t in vit197.items() if k.startswith(name)}}
            for name, (src, replaces, err) in sources.items()]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    marks = []  # (phase, start): the seconds of each phase go on the timing line
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ------------------------------------------------------------ device
    marks.append(("device", time.perf_counter()))
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi)

    # ------------------------------------------------------------- build
    marks.append(("build", time.perf_counter()))
    t0 = time.perf_counter()
    agent_module.init_hamt = memo_init_hamt
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(build_all)  # nvcc's processes, all at once
        # meanwhile, on this thread, the weights of the architectures the
        # phases build agents of: the slice's, the family presets' and the
        # task variants'
        cfg, world = slice_config(B, seed=0)
        for task in (None,) + FAMILY + VARIANTS:
            wcfg = cfg if task is None else slice_config(
                get_preset(task).train.batch_size, seed=0, task=task)[0]
            memo_init_hamt(wcfg.model, 0)
        init_seconds = time.perf_counter() - t0
        builds = pending.result()
        for name, built in builds.items():  # registers and spills per instantiation
            emit("build", kernel=name, **built)
    emit("build", wall_seconds=time.perf_counter() - t0, weight_init_seconds=init_seconds)

    # ------------------------------------------------- the slice's world
    mcfg, t_max = cfg.model, cfg.env.max_action_len
    # attention launches by (Lq, Lk): the forward's per greedy batch or IL
    # update, the backward's per IL update
    mix, bwd_mix = launch_mix(cfg)
    per_batch, per_update_bwd = sum(mix.values()), sum(bwd_mix.values())
    if per_batch != 279 or per_update_bwd != 240:
        raise AssertionError(f"launch mix {mix} / {bwd_mix}: expected 279 and 240")

    # ----------------------------------------------------------- kernels
    marks.append(("kernels", time.perf_counter()))
    # timed at each main path's batch: the forward at the serving slice's
    # 32, the backward at the training slice's 8
    (fwd_rows, _, fwd8_rows, bwd_rows, (f16_rows, b16_rows), (fpk_rows, bpk_rows), fwd_err,
     bwd_err) = phase_kernels(dev, mix, bwd_mix, cfg.env.max_instr_len)
    # and at the family presets' and the task variants' shapes, each at
    # its preset's batch and at the merged update's twice as many lanes
    family_mixes, boot_mixes = {}, {}
    for task in FAMILY + VARIANTS:
        fcfg, _ = slice_config(get_preset(task).train.batch_size, seed=0, task=task)
        family_mixes[task] = (fcfg.train.batch_size, *launch_mix(fcfg))
        boot_mixes[task] = bootstrap_mix(fcfg)
    family_kernels, ferr, berr = phase_family_kernels(dev, family_mixes)
    fwd_err, bwd_err = max(fwd_err, ferr), max(bwd_err, berr)
    # and at the pretraining shapes and lanes of both presets
    pretrain_mixes = {p: slice_mixes(p, PRETRAIN_B) for p in PRETRAIN_PRESETS}
    pretrain_kernels, ferr, berr = phase_pretrain_kernels(dev, pretrain_mixes)
    fwd_err, bwd_err = max(fwd_err, ferr), max(bwd_err, berr)

    # ------------------------------------------------------------- slice
    marks.append(("slice", time.perf_counter()))
    env = slice_env(cfg, world, seed=0)
    agent = HAMTAgent(cfg, env, seed=0)  # the card, by default
    agent.enable_feature_table()
    agent.eval_split_device()  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    preds = agent.eval_split_device()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    slice_launches = tier_launches()
    # the fp32 numbers the bf16 phase stands beside
    fp32 = {"serving": {"episodes_per_s": len(preds) / seconds,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}}
    batches = len(world.instr_data) // B + 1  # iterate until an instr_id repeats
    if slice_launches != {"attention_fwd": per_batch * batches, "attention_bwd": 0}:
        raise AssertionError(f"attention launches {slice_launches} != 279 x {batches} batches "
                             f"and no backward (per batch by shape: {mix})")
    metrics, _ = env.eval_metrics(preds)
    if len(preds) != len(world.instr_data):
        raise AssertionError(f"{len(preds)} predictions for {len(world.instr_data)} items")
    starts = {it["instr_id"]: it["path"][0] for it in world.instr_data}
    if any(p["trajectory"][0][0] != starts[p["instr_id"]] for p in preds):
        raise AssertionError("a trajectory does not begin at its start viewpoint")
    if not all(math.isfinite(v) for v in metrics.values()) or not 0 <= metrics["sr"] <= 100:
        raise AssertionError(f"bad metrics {metrics}")
    emit("slice", preset="r2r", hidden=mcfg.hidden_size, layers=[mcfg.num_l_layers,
         mcfg.num_x_layers, mcfg.num_h_pano_layers], batch=B, t_max=t_max,
         episodes=len(preds), rollouts=batches * B, seconds=seconds,
         episodes_per_s=len(preds) / seconds, rollouts_per_s=batches * B / seconds,
         sr=metrics["sr"], spl=metrics["spl"], ndtw=metrics["nDTW"],
         peak_mem_gb=fp32["serving"]["peak_mem_gb"],
         launches=slice_launches, launches_per_batch=per_batch, shape_mix=
         {f"{lq}x{lk}": n for (lq, lk), n in mix.items()},
         attention_ms_per_batch=weighted(fwd_rows, mix, lambda r: r["ms"]) * per_batch)
    del agent

    # ------------------------------------------------------------ parity
    marks.append(("parity", time.perf_counter()))
    small = cfg.replace(train={"batch_size": 4})
    runs = []
    for device in ("cuda", "cpu"):
        pagent = HAMTAgent(small, slice_env(small, world, seed=0), seed=0, device=device)
        pagent.enable_feature_table()
        runs.append(greedy_batch(pagent))
        del pagent
    logit_err = compare_rollouts(*runs, PARITY_LOGIT_ATOL, "parity: card vs CPU")
    emit("parity", batch=4, t_max=t_max, max_abs_logit_err=logit_err,
         tol=PARITY_LOGIT_ATOL, trajectories_identical=True)
    del runs

    # ------------------------------------------------------------- train
    marks.append(("train", time.perf_counter()))
    tcfg = cfg.replace(train={"batch_size": TRAIN_B, "feedback": "teacher"})
    tr = tcfg.train
    if (tr.optim, tr.lr, tr.grad_clip, tr.weight_decay) != ("adamw", 1e-5, 40.0, 0.0):
        raise AssertionError(f"the r2r preset's optimizer changed: {tr}")
    agent = HAMTAgent(tcfg, slice_env(tcfg, world, seed=0), seed=0)
    agent.enable_feature_table()
    for _ in range(WARMUP_UPDATES):  # warm-up: allocator, cuBLAS workspaces
        agent.train_iteration("teacher", sync=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = TIMED_UPDATES
    reset_counts()
    t0 = time.perf_counter()
    losses = [agent.train_iteration("teacher", sync=False)["loss"] for _ in range(iters)]
    losses = torch.stack(losses).cpu()  # waits for the last update
    seconds = time.perf_counter() - t0
    train_launches = tier_launches()
    want = {"attention_fwd": per_batch * iters, "attention_bwd": per_update_bwd * iters}
    if train_launches != want:
        raise AssertionError(f"IL launches {train_launches} != {want} "
                             f"(279 forward, 240 backward per update)")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite IL losses {losses.tolist()}")
    fp32["il"] = {"episodes_per_s": iters * TRAIN_B / seconds,
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                  "kernels_per_update": kernels_per_call(
                      lambda: agent.train_iteration("teacher"))}
    emit("train", preset="r2r", hidden=mcfg.hidden_size, batch=TRAIN_B, t_max=t_max,
         optim=tr.optim, lr=tr.lr, grad_clip=tr.grad_clip,
         dropout=[mcfg.hidden_dropout_prob, mcfg.attention_probs_dropout_prob,
                  mcfg.feat_dropout], updates=iters, seconds=seconds,
         il_episodes_per_s=iters * TRAIN_B / seconds, ms_per_update=seconds / iters * 1e3,
         loss_mean=losses.mean().item(), loss_first=losses[0].item(),
         loss_last=losses[-1].item(), launches=train_launches,
         launches_per_update={k: v / iters for k, v in train_launches.items()},
         bwd_shape_mix={f"{lq}x{lk}": n for (lq, lk), n in bwd_mix.items()},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    del agent

    # one repeated batch, dropout off, lr 1e-4: the loss must fall
    ocfg = tcfg.replace(model=NO_DROPOUT, train={"lr": 1e-4})
    agent = HAMTAgent(ocfg, slice_env(ocfg, world, seed=0), seed=0)
    agent.enable_feature_table()
    ep = agent._ep_to_device(agent.env.teacher_episode())
    fit = torch.stack([agent._il_update(ep, 1.0) for _ in range(FIT_UPDATES)]).cpu()
    if not torch.isfinite(fit).all() or not fit[-1] < fit[0]:
        raise AssertionError(f"{FIT_UPDATES} updates on one batch did not lower the loss: "
                             f"{fit.tolist()}")
    emit("train", overfit_losses=fit.tolist())
    del agent

    # ------------------------------------------------------ train_parity
    marks.append(("train_parity", time.perf_counter()))
    pcfg = cfg.replace(model=NO_DROPOUT, train={"batch_size": 4, "feedback": "teacher"})
    for fix in (True, False):
        fcfg = pcfg.replace(model={"fix_lang_embedding": fix, "fix_hist_embedding": fix})
        res = {}
        reset_counts()
        for device in ("cuda", "cpu"):
            pagent = HAMTAgent(fcfg, slice_env(fcfg, world, seed=0), seed=0, device=device)
            pagent.enable_feature_table()
            res[device] = il_logits_and_grads(
                pagent, pagent._ep_to_device(pagent.env.teacher_episode()))[1:]
            del pagent
        counts = tier_launches()
        (loss_g, grads_g), (loss_c, grads_c) = res["cuda"], res["cpu"]
        loss_err = abs(loss_g - loss_c) / abs(loss_c)
        if not loss_err <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"card vs CPU IL loss {loss_g} vs {loss_c}")
        worst = check_grads(grads_g, grads_c, "IL update")
        # with the flags off the text stack and the panorama encoder run
        # backward too, except at the last step: its history token is
        # never read, so autograd skips that encoder (the JAX package's
        # scan runs it on a zero cotangent)
        want_bwd = per_update_bwd + (0 if fix else mcfg.num_l_layers
                                     + (t_max - 1) * mcfg.num_h_pano_layers)
        if counts != {"attention_fwd": per_batch, "attention_bwd": want_bwd}:
            raise AssertionError(f"train_parity launches {counts}, expected "
                                 f"{per_batch} / {want_bwd}")
        emit("train_parity", fix_lang_and_hist=fix, batch=4, loss_cuda=loss_g, loss_cpu=loss_c,
             loss_rel_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL, tensors=len(grads_c),
             max_grad_err_over_tol=worst, grad_rel_tol=TRAIN_GRAD_REL,
             grad_floor=TRAIN_GRAD_FLOOR, launches=counts)

    # ------------------------------------------------------------ sample
    marks.append(("sample", time.perf_counter()))
    # IL + A2C on the same optimizer and dropout as `train`; merged first
    # (the CLI's default), then fused
    scfg = cfg.replace(train={"batch_size": TRAIN_B, "feedback": "sample"})
    agent = HAMTAgent(scfg, slice_env(scfg, world, seed=0), seed=0)
    agent.merged_sample_update = True
    agent.enable_feature_table()
    for _ in range(WARMUP_UPDATES):  # warm-up
        agent.train_iteration("sample", sync=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = TIMED_UPDATES
    losses, seconds, merged_launches = timed_sample_updates(agent, iters)
    # the rollout at 16 lanes (279) and the bootstrap at the 8 RL lanes
    # (4 cross-modal layers x 4 attentions); the backward of the
    # cross-modal layers at 16 lanes
    boot = 4 * mcfg.num_x_layers
    merged_per = {"attention_fwd": per_batch + boot, "attention_bwd": per_update_bwd}
    if merged_launches != {k: n * iters for k, n in merged_per.items()}:
        raise AssertionError(f"merged sample launches {merged_launches} over {iters} "
                             f"updates, expected {merged_per} per update")
    fp32["sample"] = {"episodes_per_s": iters * TRAIN_B / seconds,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                      "kernels_per_update": kernels_per_call(
                          lambda: agent.train_iteration("sample"))}
    emit("sample", update="merged", preset="r2r", hidden=mcfg.hidden_size, batch=TRAIN_B,
         lanes=MERGED_B, t_max=t_max, optim=tr.optim, lr=tr.lr, grad_clip=tr.grad_clip,
         ml_weight=scfg.train.ml_weight, updates=iters, seconds=seconds,
         sample_episodes_per_s=iters * TRAIN_B / seconds,
         ms_per_update=seconds / iters * 1e3,
         **{f"{k}_mean": v.mean().item() for k, v in losses.items()},
         launches=merged_launches, launches_per_update=merged_per,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)

    agent.merged_sample_update = False  # the fused update, the class default
    agent.train_iteration("sample", sync=False)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    fused_iters = 2
    losses, seconds, fused_launches = timed_sample_updates(agent, fused_iters)
    fused_per = {"attention_fwd": 2 * per_batch + boot, "attention_bwd": 2 * per_update_bwd}
    if fused_launches != {k: n * fused_iters for k, n in fused_per.items()}:
        raise AssertionError(f"fused sample launches {fused_launches} over {fused_iters} "
                             f"updates, expected {fused_per} per update")
    emit("sample", update="fused", batch=TRAIN_B, updates=fused_iters, seconds=seconds,
         sample_episodes_per_s=fused_iters * TRAIN_B / seconds,
         ms_per_update=seconds / fused_iters * 1e3,
         **{f"{k}_mean": v.mean().item() for k, v in losses.items()},
         launches=fused_launches, launches_per_update=fused_per,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    del agent

    # ----------------------------------------------------- sample_parity
    marks.append(("sample_parity", time.perf_counter()))
    # one rewarded argmax rollout, then the fused loss on the next batch
    # (the update's host order: teacher episode, then the rollout's reset)
    spcfg = cfg.replace(model=NO_DROPOUT, train={"batch_size": 4, "feedback": "sample"})
    res = {}
    reset_counts()
    for device in ("cuda", "cpu"):
        pagent = HAMTAgent(spcfg, slice_env(spcfg, world, seed=0), seed=0, device=device)
        pagent.enable_feature_table()
        ins = pagent._device_rollout_args()
        with torch.no_grad():
            ep, ex = pagent._rollout(ins, ins["txt_ids"], ins["txt_mask"], "argmax")
        il_ep = pagent._ep_to_device(pagent.env.teacher_episode())
        loss, grads = sample_gradients(pagent, il_ep, pagent._device_rollout_args())
        res[device] = ({k: v.cpu() for k, v in ep.items()},
                       {k: v.cpu() for k, v in ex.items()}, loss, grads)
        del pagent
    counts = tier_launches()
    (ep_g, ex_g, loss_g, grads_g), (ep_c, ex_c, loss_c, grads_c) = res["cuda"], res["cpu"]
    for key in ("node_idx", "view_index", "actions", "step_mask", "final_node_idx"):
        if not torch.equal(ep_g[key], ep_c[key]):
            raise AssertionError(f"sample_parity: card and CPU trajectories differ in {key}")
    for key in ("masks", "bootstrap_mask"):
        if not torch.equal(ex_g[key], ex_c[key]):
            raise AssertionError(f"sample_parity: card and CPU {key} differ")
    if not torch.allclose(ex_g["rewards"], ex_c["rewards"], rtol=REWARD_RTOL,
                          atol=REWARD_ATOL):
        raise AssertionError(f"sample_parity: rewards {ex_g['rewards'].tolist()} vs "
                             f"{ex_c['rewards'].tolist()}")
    lg, lc = ex_g["rollout_logits"], ex_c["rollout_logits"]
    fin = torch.isfinite(lc)
    if not torch.equal(torch.isfinite(lg), fin):
        raise AssertionError("sample_parity: logits are -inf at different places")
    errs = {"rollout_logits": (lg[fin] - lc[fin]).abs().max().item()}
    errs.update({k: (ex_g[k] - ex_c[k]).abs().max().item() for k in ("values", "last_value")})
    if not max(errs.values()) <= PARITY_LOGIT_ATOL:
        raise AssertionError(f"sample_parity: card vs CPU {errs}")
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"card vs CPU fused sample loss {loss_g} vs {loss_c}")
    worst = check_grads(grads_g, grads_c, "fused sample update")
    # the rewarded rollout and its bootstrap, then the fused update's IL
    # episode, rollout and bootstrap, and their backward
    want = {"attention_fwd": 3 * per_batch + 2 * boot, "attention_bwd": 2 * per_update_bwd}
    if counts != want:
        raise AssertionError(f"sample_parity launches {counts}, expected {want}")
    emit("sample_parity", batch=4, t_max=t_max, trajectories_identical=True,
         steps=int(ex_c["masks"].sum().item()),
         reward_max_abs_err=(ex_g["rewards"] - ex_c["rewards"]).abs().max().item(),
         max_abs_err=errs, tol=PARITY_LOGIT_ATOL, loss_cuda=loss_g, loss_cpu=loss_c,
         loss_rel_err=loss_err, loss_rtol=TRAIN_LOSS_RTOL, tensors=len(grads_c),
         max_grad_err_over_tol=worst, launches=counts)

    # -------------------------------------------------------------- bf16
    marks.append(("bf16", time.perf_counter()))
    bf16_launches, bf16_runs, bf16_tol = phase_bf16(cfg, world, per_batch, per_update_bwd,
                                                    merged_per, fp32)

    # --------------------------------------------------------- packed_il
    marks.append(("packed_il", time.perf_counter()))
    packed_mix = packed_il_mix(tcfg, PACKED_TEXT_CAP)
    if (sum(packed_mix[0].values()), sum(packed_mix[1].values())) != (per_batch,
                                                                     per_update_bwd):
        raise AssertionError(f"packed launch mix {packed_mix}: expected 279 and 240")
    packed_launches = phase_packed(cfg, world, packed_mix, {
        "float32": fp32["il"]["episodes_per_s"],
        "bfloat16": bf16_runs["il"]["episodes_per_s"]})

    # ---------------------------------------------------------- hostloop
    marks.append(("hostloop", time.perf_counter()))
    hostloop_launches = phase_hostloop(cfg, world, per_batch, bf16_tol)

    # ------------------------------------------------------------ replay
    marks.append(("replay", time.perf_counter()))
    replay_per_update = phase_replay(cfg, world, per_batch, per_update_bwd, boot)

    # ------------------------------------------------------------ family
    marks.append(("family", time.perf_counter()))
    family_runs = {task: phase_family(task, family_mixes) for task in FAMILY + ("r2r_last",)}

    # ---------------------------------------------------------- variants
    marks.append(("variants", time.perf_counter()))
    variant_runs = {task: phase_variants(task) for task in VARIANTS}

    # ------------------------------------------------------------- files
    marks.append(("files", time.perf_counter()))
    with tempfile.TemporaryDirectory() as tmp:
        phase_files(tmp)

    # ---------------------------------------------------------- pretrain
    marks.append(("pretrain", time.perf_counter()))
    with tempfile.TemporaryDirectory() as tmp:
        pretrain_runs = phase_pretrain(pretrain_mixes, tmp)
    # ------------------------------------------------------------ vision
    marks.append(("vision", time.perf_counter()))
    vision = phase_vision(world)
    # --------------------------------------------------------- multi_gpu
    marks.append(("multi_gpu", time.perf_counter()))
    multi_gpu, ferr, berr = phase_multi_gpu(dev, mix, bwd_mix, per_batch, per_update_bwd,
                                            merged_per)
    fwd_err, bwd_err = max(fwd_err, ferr), max(bwd_err, berr)
    # ------------------------------------------------------------- remat
    marks.append(("remat", time.perf_counter()))
    remat = phase_remat(cfg, world, smi)
    # ------------------------------------------------------------ shapes
    marks.append(("shapes", time.perf_counter()))
    blocked_lines = phase_shapes(dev, builds)
    marks.append(("summary", time.perf_counter()))

    pretrain = {}
    for name, run in pretrain_runs.items():
        rxr_mixes, rxr_shares = pretrain_mixes["rxr"]
        rxr_mix = mix_launches(rxr_mixes, rxr_shares)[0 if name == "attention_fwd" else 1]
        pretrain[name] = {
            "r2r": {k: v for k, v in run.items() if k in ("batch", "updates", "launches",
                                                          "launches_per_update")}
            | lane_times(pretrain_kernels[name]["float32"], run["mix"]),
            "rxr": {"launches_per_update": run["rxr_launches_per_update"]}
            | lane_times(pretrain_kernels[name]["float32"], rxr_mix)
            | {"bf16": lane_times(pretrain_kernels[name]["bfloat16"], rxr_mix, "bfloat16")}}

    sample = {
        name: {"launches_per_update": {"merged": merged_per[name], "fused": fused_per[name]},
               "batch": MERGED_B, **kernel_times((rows, m))}
        for name, rows, m in (("attention_fwd", f16_rows, mix),
                              ("attention_bwd", b16_rows, bwd_mix))}
    # per family preset, times weighted by the merged update's launches:
    # the rollout's forward and the backward at 2 x batch lanes, the
    # bootstrap's forward at the batch; the forward at the greedy batch too
    # (the variants' likewise, with their phase 17 launches per path)
    family = {"attention_fwd": {}, "attention_bwd": {}}
    variants = {"attention_fwd": {}, "attention_bwd": {}}
    for task, (batch, fwd_mix, fam_bwd_mix) in family_mixes.items():
        (f1, _), (f2, b2) = family_kernels[task][batch], family_kernels[task][2 * batch]
        out = variants if task in VARIANTS else family
        for name, parts in (("attention_fwd", ((f2, fwd_mix), (f1, boot_mixes[task]))),
                            ("attention_bwd", ((b2, fam_bwd_mix),))):
            if task in VARIANTS:  # phase 17's launches per greedy batch and update
                launches = {"launches_per": {
                    path: per if path == "greedy" else per[name]
                    for path, per in variant_runs[task].items()
                    if path != "greedy" or name == "attention_fwd"}}
            else:
                launches = {"launches": family_runs[task]["launches"][name],
                            "launches_per_merged_update":
                                family_runs[task]["launches_per_update"][name]}
            out[name][task] = {"batch": batch, "lanes": 2 * batch, **launches,
                               **kernel_times(*parts),
                               "bf16": kernel_times(*parts, dtype="bfloat16")}
        out["attention_fwd"][task]["greedy"] = {
            "batch": batch, **kernel_times((f1, fwd_mix)),
            "bf16": kernel_times((f1, fwd_mix), dtype="bfloat16")}
    # bf16: per path the bf16 phases' launches and the times weighted by
    # the path's launches (bf16 rows; the bound counts bf16 q, k, v bytes
    # and the tensor cores' bf16 rate);
    # packed IL: its launches by dtype and its times over its lanes
    packed_rows = {
        "attention_fwd": {dt: rows_by_lanes(TRAIN_B, fwd8_rows, dt)
                          | rows_by_lanes(PACKED_TEXT_CAP, fpk_rows, dt)
                          for dt in ("float32", "bfloat16")},
        "attention_bwd": {dt: rows_by_lanes(TRAIN_B, bwd_rows, dt)
                          | rows_by_lanes(PACKED_TEXT_CAP, bpk_rows, dt)
                          for dt in ("float32", "bfloat16")}}
    bf = "bfloat16"
    extra = {}
    for i, (name, r8, r16, m) in enumerate((("attention_fwd", fwd8_rows, f16_rows, mix),
                                            ("attention_bwd", bwd_rows, b16_rows, bwd_mix))):
        paths = {"il": {"batch": TRAIN_B, **kernel_times((r8, m), dtype=bf)},
                 "sample": {"batch": MERGED_B, **kernel_times((r16, m), dtype=bf)},
                 "pretrain": lane_times(pretrain_kernels[name][bf],
                                        pretrain_runs[name]["bf16_mix"], bf),
                 "packed_il": lane_times(packed_rows[name][bf], packed_mix[i], bf)}
        if name == "attention_fwd":
            paths = {"serving": {"batch": B, **kernel_times((fwd_rows, mix), dtype=bf)},
                     **paths}
        extra[name] = {
            "bf16": {"launches": {**{p: bf16_launches[p][name] for p in bf16_launches},
                                  "pretrain": pretrain_runs[name]["bf16_launches"],
                                  "packed_il": packed_launches[bf][name]}, **paths},
            "packed_il": {"launches": packed_launches["float32"][name],
                          "launches_per_update": sum(packed_mix[i].values()),
                          "text_rows": PACKED_TEXT_CAP,
                          **lane_times(packed_rows[name]["float32"], packed_mix[i])},
            "replay": {rollout: per[name] for rollout, per in replay_per_update.items()}}
        if name == "attention_fwd":
            extra[name]["hostloop"] = hostloop_launches
        extra[name]["variants"] = variants[name]
        extra[name]["vision"] = vision[name]
        extra[name]["multi_gpu"] = multi_gpu[name]
        extra[name]["remat"] = {"launches_per_update": {
            mode: {path: per[path][name] for path in REMAT_PATHS}
            for mode, per in remat.items()}}
    summary = {"kernels": [
        summary_row("attention_fwd", "vln_hamt_torch/csrc/attention.cu",
                    "vln_hamt_tpu/ops/attention.py:53",  # _attn_kernel
                    slice_launches["attention_fwd"], fwd_err, fwd_rows, mix, B,
                    sample["attention_fwd"], family["attention_fwd"], pretrain["attention_fwd"],
                    **extra["attention_fwd"]),
        summary_row("attention_bwd", "vln_hamt_torch/csrc/attention_bwd.cu",
                    "vln_hamt_tpu/ops/attention.py:85",  # _attn_bwd_kernel
                    train_launches["attention_bwd"], bwd_err, bwd_rows, bwd_mix, TRAIN_B,
                    sample["attention_bwd"], family["attention_bwd"], pretrain["attention_bwd"],
                    **extra["attention_bwd"]),
        *blocked_lines,
    ]}
    marks.append(("end", time.perf_counter()))
    emit("timing", seconds={a: t1 - t0 for (a, t0), (_, t1) in zip(marks, marks[1:])},
         total_seconds=marks[-1][1] - marks[0][1])
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
