"""The CUDA attention kernel against its plain torch twin, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the device and
skips where there is none (decided at run time, never at collection, so
every pytest worker collects the same tests). Run on a CUDA machine with
``python -m pytest tests/test_torch_gpu.py -q --noconftest`` (the
repository's conftest imports JAX, which the port does not need).
"""

import pytest
import torch

from vln_hamt_torch.ops import attention as tops
from vln_hamt_torch.run.profile_attention import element_layout, kernel_inputs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain twin in full fp32
    return torch.device("cuda")


# fp32 at rate 0: a few ulps of O(1) outputs from another summation
# order. bf16 inputs are widened to fp32 identically on both sides, so
# the same bound holds; with dropout the kept values are scaled by
# 1 / (1 - rate), which scales the error with them.
TOL = {(torch.float32, 0.0): 1e-5, (torch.bfloat16, 0.0): 1e-5,
       (torch.float32, 0.1): 2e-5, (torch.bfloat16, 0.1): 2e-5}


# (Lq, Lk, Dh, masked rows): the main path's shapes and RxR's text, then
# what the query-blocked tiling could get wrong -- one key, a ragged last
# query block, batch elements whose keys all read -10000 (inputs on a
# grid where those scores are exact), the smallest and largest head width
_FWD_CASES = [pytest.param(lq, lk, 64, False, id=f"{lq}-{lk}") for lq, lk in
              [(60, 60), (36, 36), (60, 64), (64, 60), (250, 250)]] + [
    pytest.param(1, 1, 64, False, id="1-1"),
    pytest.param(33, 65, 64, False, id="33-65"),
    pytest.param(65, 65, 64, True, id="65-65-masked_rows"),
    pytest.param(65, 65, 16, False, id="65-65-dh16"),
    pytest.param(65, 65, 128, False, id="65-65-dh128"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("lq,lk,dh,masked", _FWD_CASES)
def test_kernel_matches_plain(cuda, dtype, rate, lq, lk, dh, masked):
    g = torch.Generator(device=cuda).manual_seed(lq * 1000 + lk)
    b, h = 4, 12
    q, k, v, m, _ = kernel_inputs(b, h, lq, lk, dh, dtype, g, cuda, masked_rows=masked)
    seed = 2**31 + 11
    n0 = tops.launch_counts["attention_fwd"]
    got = tops.fused_attention(q, k, v, m, dropout_rate=rate, dropout_seed=seed)
    torch.cuda.synchronize()
    assert tops.launch_counts["attention_fwd"] == n0 + 1
    want = tops.attention_reference(q, k, v, m, seed, rate)
    assert got.shape == want.shape == (b, h, lq, dh)
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= TOL[(dtype, rate)], err


def test_misaligned_views_raise(cuda):
    """Views the whole-row kernel's 16-byte loads cannot take raise before
    any launch (a q 4 bytes past a 16-byte boundary), as does a head width
    past the kernels' 128."""
    b, h, l, dh = 2, 12, 60, 64
    flat = torch.randn(1 + b * l * h * dh, device=cuda)
    q = flat[1:].view(b, l, h, dh).transpose(1, 2)
    k = torch.randn(b, l, h, dh, device=cuda).transpose(1, 2)
    m = torch.zeros(b, l, device=cuda)
    wide = torch.randn(b, h, l, 144, device=cuda)
    before = dict(tops.launch_counts)
    with pytest.raises(ValueError, match="16-byte boundary"):
        tops.fused_attention(q, k, k, m)
    with pytest.raises(ValueError, match="up to 128"):
        tops.fused_attention(wide, wide, wide, m)
    assert tops.launch_counts == before


# (Lq, Lk, Dh, masked rows) of the key-blocked kernels: keys past 256
# (the ViT at 248 x 330 and 384 x 384, long text), head widths outside the
# whole-row kernels' (the --tiny ViT's 12, 48, 80), Dh 128 past the
# whole-row tiles' shared memory, a ragged last key block with batch
# elements whose keys all read -10000, and one key
_BLOCKED_CASES = [pytest.param(lq, lk, dh, masked, id=f"{lq}-{lk}-dh{dh}" + ("-masked" if masked
                                                                            else ""))
                  for lq, lk, dh, masked in
                  [(301, 301, 64, False), (577, 577, 64, False), (40, 257, 64, True),
                   (65, 300, 12, False), (33, 197, 48, True), (20, 514, 80, False),
                   (70, 200, 128, False), (5, 1, 12, False)]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("lq,lk,dh,masked", _BLOCKED_CASES)
def test_blocked_kernels_match_plain(cuda, dtype, rate, lq, lk, dh, masked):
    """Both key-blocked kernels against their plain twins, each launched
    once and the whole-row kernels not at all."""
    g = torch.Generator(device=cuda).manual_seed(lq * 1000 + lk + dh)
    q, k, v, m, cot = kernel_inputs(3, 4, lq, lk, dh, dtype, g, cuda, masked_rows=masked)
    seed = 2**31 + 11
    before = dict(tops.launch_counts)
    got = tops.fused_attention(q, k, v, m, dropout_rate=rate, dropout_seed=seed)
    grads = tops.attention_bwd(q, k, v, m, cot, seed, rate)
    torch.cuda.synchronize()
    assert {n: tops.launch_counts[n] - before[n] for n in before} == {
        "attention_fwd": 0, "attention_bwd": 0, "attention_fwd_blocked": 1,
        "attention_bwd_blocked": 1}
    want = tops.attention_reference(q, k, v, m, seed, rate)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL[(dtype, rate)]
    want = tops.attention_bwd_reference(q, k, v, m, cot, seed, rate)
    for name, x, y in zip(("dq", "dk", "dv", "dm"), grads, want):
        assert x.shape == y.shape and x.dtype == y.dtype and torch.isfinite(x).all(), name
        err = _rel_err(x, y)
        assert err <= (BWD_DM_RTOL if name == "dm" else BWD_RTOL[dtype]), (name, err)


# (Lq, Lk, Dh, masked rows) at which the key-blocked forward's two staging
# paths are held against its plain version: the history ViT's 301 tokens,
# the --tiny ViT's Dh 12 (in bf16 its heads lie 24 bytes apart, which no
# 16-byte copy reads: element loads even as the layer lays them out), a
# ragged last key block with batch elements whose keys all read -10000
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["layer", "element"])
@pytest.mark.parametrize("lq,lk,dh,masked", [(301, 301, 64, False), (65, 301, 12, False),
                                             (40, 257, 80, True)],
                         ids=["301-301-dh64", "65-301-dh12", "40-257-dh80-masked"])
def test_blocked_forward_staging_paths(cuda, dtype, rate, layout, lq, lk, dh, masked):
    """The key-blocked forward by 16-byte copies (the layer's views where
    a head is a multiple of 16 bytes) and by element loads (views that are
    not, and copies shifted off the 16-byte boundary) against its plain
    twin, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(lq * 1000 + lk + dh)
    q, k, v, m, _ = kernel_inputs(3, 4, lq, lk, dh, dtype, g, cuda, masked_rows=masked)
    if layout == "element":
        q, k, v = (element_layout(x) for x in (q, k, v))
    async_ok = layout == "layer" and dh * q.element_size() % 16 == 0
    assert tops.blocked_staging(q, k, v) == int(async_ok)
    seed = 2**31 + 11
    before = tops.launch_counts["attention_fwd_blocked"]
    got = tops.fused_attention(q, k, v, m, dropout_rate=rate, dropout_seed=seed)
    torch.cuda.synchronize()
    assert tops.launch_counts["attention_fwd_blocked"] == before + 1
    want = tops.attention_reference(q, k, v, m, seed, rate)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL[(dtype, rate)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("layout", ["layer", "element"])
@pytest.mark.parametrize("lq,lk,dh,masked", [(301, 301, 64, False), (65, 301, 12, False),
                                             (40, 257, 80, True), (33, 300, 6, False),
                                             (301, 301, 10, True)],
                         ids=["301-301-dh64", "65-301-dh12", "40-257-dh80-masked",
                              "33-300-dh6", "301-301-dh10-masked"])
def test_blocked_backward_staging_paths(cuda, dtype, rate, layout, lq, lk, dh, masked):
    """The key-blocked backward with q, k and v by 16-byte copies (the
    layer's views where a head is a multiple of 16 bytes) and by element
    loads (views that are not, and copies shifted off the 16-byte
    boundary), against its plain twin, one launch each. g always goes by
    16-byte copies: at Dh 6 and 10 from _kernel_cotangent's copy with
    padded rows, and at 301 query rows over several query blocks of the
    statistics pass, which splits bf16 G."""
    g = torch.Generator(device=cuda).manual_seed(lq * 1000 + lk + dh)
    q, k, v, m, cot = kernel_inputs(3, 4, lq, lk, dh, dtype, g, cuda, masked_rows=masked)
    if layout == "element":
        q, k, v = (element_layout(x) for x in (q, k, v))
    async_ok = layout == "layer" and dh * q.element_size() % 16 == 0
    assert tops.blocked_staging(q, k, v) == int(async_ok)
    assert tops._misalignment("g", tops._kernel_cotangent(cot)) is None
    seed = 2**31 + 11
    before = tops.launch_counts["attention_bwd_blocked"]
    grads = tops.attention_bwd(q, k, v, m, cot, seed, rate)
    torch.cuda.synchronize()
    assert tops.launch_counts["attention_bwd_blocked"] == before + 1
    want = tops.attention_bwd_reference(q, k, v, m, cot, seed, rate)
    for name, x, y in zip(("dq", "dk", "dv", "dm"), grads, want):
        assert x.shape == y.shape and x.dtype == y.dtype and torch.isfinite(x).all(), name
        err = _rel_err(x, y)
        assert err <= (BWD_DM_RTOL if name == "dm" else BWD_RTOL[dtype]), (name, err)


def _rel_err(got, want):
    """max |got - want| over max |want|, in float32."""
    got, want = got.float(), want.float()
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


# Backward, relative to each tensor's largest value. fp32: sums of at
# most 250 products (dq, dk, dv) or 12 x 250 terms (dm) in another order
# than cuBLAS's, each rounding within 6e-8 of the terms' scale. bf16
# outputs: both sides round an fp32 value to bf16, and a last-bit
# difference in fp32 may flip that rounding by one bf16 step, 2^-8 of
# the value. dm is fp32 in both cases.
BWD_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -8}
BWD_DM_RTOL = 2e-5

# (Lq, Lk, Dh, masked rows): the training path's shapes, the forward's
# edge cases, then lengths past the old one-CTA-per-head limit of 114
# tokens -- R4R and CVDN text (100), RxR text (250) and its
# cross-attention with the 65 visual tokens -- and 300 query rows, more
# query blocks than a thread-block cluster holds (the global-scratch sum)
_BWD_CASES = [pytest.param(lq, lk, 64, False, id=f"{lq}-{lk}") for lq, lk in
              [(60, 60), (36, 36), (60, 65), (65, 60), (65, 65)]] + _FWD_CASES[5:] + [
    pytest.param(lq, lk, 64, False, id=f"{lq}-{lk}") for lq, lk in
    [(100, 100), (250, 65), (65, 250), (250, 250), (300, 65)]]


@pytest.mark.parametrize("batch", [8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("lq,lk,dh,masked", _BWD_CASES)
def test_backward_kernel_matches_plain(cuda, batch, dtype, rate, lq, lk, dh, masked):
    g = torch.Generator(device=cuda).manual_seed(lq * 1000 + lk + 7)
    q, k, v, m, cot = kernel_inputs(batch, 12, lq, lk, dh, dtype, g, cuda, masked_rows=masked)
    seed = 2**31 + 11
    n0 = tops.launch_counts["attention_bwd"]
    got = tops.attention_bwd(q, k, v, m, cot, seed, rate)
    torch.cuda.synchronize()
    assert tops.launch_counts["attention_bwd"] == n0 + 1
    want = tops.attention_bwd_reference(q, k, v, m, cot, seed, rate)
    for name, x, y in zip(("dq", "dk", "dv", "dm"), got, want):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        assert torch.isfinite(x).all(), name
        err = _rel_err(x, y)
        print(f"bwd B {batch} {lq}x{lk} Dh {dh} {dtype} rate {rate} {name}: rel err {err:.3g}")
        assert err <= (BWD_DM_RTOL if name == "dm" else BWD_RTOL[dtype]), (name, err)


@pytest.mark.parametrize("lk,dh,kernel", [
    (257, 64, "attention_bwd_blocked"),  # past the whole-row kernel's 256 keys
    (168, 128, "attention_bwd_blocked"),  # at Dh 128 the whole-row tiles fit up to Lk 160
    (160, 128, "attention_bwd"),
])
def test_backward_takes_every_length(cuda, lk, dh, kernel):
    """The lengths the whole-row backward refuses run in the key-blocked
    one; the longest key row it takes at Dh 128 stays in it."""
    b, h, lq = 2, 12, 40
    q, cot = (torch.randn(b, h, lq, dh, device=cuda) for _ in range(2))
    k = torch.randn(b, h, lk, dh, device=cuda)
    m = torch.zeros(b, lk, device=cuda)
    n0 = tops.launch_counts[kernel]
    got = tops.attention_bwd(q, k, k, m, cot)
    want = tops.attention_bwd_reference(q, k, k, m, cot)
    assert all(_rel_err(x, y) <= BWD_RTOL[torch.float32] for x, y in zip(got[:3], want))
    assert tops.launch_counts[kernel] == n0 + 1


def test_autograd_function_launches_both_kernels(cuda):
    """fused_attention on CUDA tensors that require grad: the forward and
    backward kernels run once each, and the gradients are the twins'."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, h, lq, lk, dh = 2, 12, 65, 60, 64
    q = torch.randn(b, lq, h * dh, device=cuda, generator=g).requires_grad_()
    kv = torch.randn(b, lk, h * dh, device=cuda, generator=g).requires_grad_()
    m = torch.where(torch.rand(b, lk, device=cuda, generator=g) < 0.8, 0.0, -10000.0)
    m.requires_grad_()
    split = lambda x, l: x.view(b, l, h, dh).transpose(1, 2)
    before = dict(tops.launch_counts)
    out = tops.fused_attention(split(q, lq), split(kv, lk), split(kv * 2, lk), m,
                               dropout_rate=0.1, dropout_seed=123)
    out.transpose(1, 2).reshape(b, lq, h * dh).pow(2).sum().backward()
    torch.cuda.synchronize()
    assert tops.launch_counts["attention_fwd"] == before["attention_fwd"] + 1
    assert tops.launch_counts["attention_bwd"] == before["attention_bwd"] + 1
    got = (q.grad, kv.grad, m.grad)
    q2, kv2, m2 = (x.detach().clone().requires_grad_() for x in (q, kv, m))
    ref = tops.attention_reference(split(q2, lq), split(kv2, lk), split(kv2 * 2, lk), m2,
                                   123, 0.1)
    ref.transpose(1, 2).reshape(b, lq, h * dh).pow(2).sum().backward()
    for x, y in zip(got, (q2.grad, kv2.grad, m2.grad)):
        assert _rel_err(x, y) <= 1e-4


def test_backward_without_mask_gradient(cuda):
    """A mask that takes no gradient (the model's masks never do): the
    backward kernel skips dm and still gives the twin's dq, dk, dv."""
    g = torch.Generator(device=cuda).manual_seed(5)
    b, h, lq, lk, dh = 2, 12, 65, 60, 64
    q, k, v = (torch.randn(b, h, l, dh, device=cuda, generator=g).requires_grad_()
               for l in (lq, lk, lk))
    m = torch.where(torch.rand(b, lk, device=cuda, generator=g) < 0.8, 0.0, -10000.0)
    cot = torch.randn(b, h, lq, dh, device=cuda, generator=g)
    n0 = tops.launch_counts["attention_bwd"]
    out = tops.fused_attention(q, k, v, m, dropout_rate=0.1, dropout_seed=9)
    got = torch.autograd.grad(out, (q, k, v), cot)
    torch.cuda.synchronize()
    assert tops.launch_counts["attention_bwd"] == n0 + 1
    want = tops.attention_bwd_reference(q.detach(), k.detach(), v.detach(), m, cot, 9, 0.1)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(x, y) <= BWD_RTOL[torch.float32], name


def test_pretraining_update_per_task_on_the_card(cuda):
    """One tiny pretraining update of each task through both kernels:
    exactly pretrain_launch_mix's launches, and the card's loss (dropout
    off) against the CPU's on the same weights and batch."""
    from vln_hamt_torch.pretrain import init_pretrain
    from vln_hamt_torch.pretrain.model import batch_to_device
    from vln_hamt_torch.run.profile_attention import pretrain_launch_mix
    from vln_hamt_torch.run.profile_pretrain import slice_trainer

    trainer, _ = slice_trainer("r2r", batch_size=4, device=cuda, extra=("--tiny",))
    ds = trainer.batcher.ds
    cpu = init_pretrain(trainer.cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    cpu.eval()
    for task in trainer.scheduler.tasks:
        batch = trainer.batcher.batch(task, 4)
        fwd, bwd = pretrain_launch_mix(trainer.cfg, task, 4, ds.max_txt_len, ds.max_hist_len,
                                       ds.ob_width)
        n0 = dict(tops.launch_counts)
        trainer.update(task, batch)
        torch.cuda.synchronize()
        assert {k: tops.launch_counts[k] - n0[k] for k in n0} == {
            "attention_fwd": sum(fwd.values()), "attention_bwd": sum(bwd.values()),
            "attention_fwd_blocked": 0, "attention_bwd_blocked": 0}, task
        cpu.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
        trainer.model.eval()
        with torch.no_grad():
            got = trainer.model(batch_to_device(batch, cuda), task, trainer._feat_table)[0]
            want = cpu(batch_to_device(batch, "cpu"), task, trainer._feat_table.cpu())[0]
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5, msg=task)
    trainer.close()


def test_bf16_layer_launches_both_kernels(cuda):
    """A bf16 transformer layer on the card: its attention reads bf16 q,
    k, v through the forward kernel and takes its gradient through the
    backward kernel, once each; the output is bf16, and it agrees with
    the same layer in bf16 on the CPU to bf16's precision."""
    from vln_hamt_torch.configs import ModelConfig
    from vln_hamt_torch.models.layers import (TransformerLayer, extend_mask,
                                              set_compute_dtype)

    cfg = ModelConfig(hidden_size=64, num_attention_heads=4, intermediate_size=128,
                      dtype="bfloat16", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    layer = TransformerLayer(cfg)
    set_compute_dtype(layer, torch.bfloat16)
    x = torch.randn(3, 20, 64)
    mask = torch.ones(3, 20, dtype=torch.bool)
    mask[1, 15:] = False
    outs = {}
    for dev in ("cpu", cuda):
        lay = TransformerLayer(cfg).to(dev)
        lay.load_state_dict(layer.state_dict())
        set_compute_dtype(lay, torch.bfloat16)
        xi = x.detach().to(dev).requires_grad_()
        n0 = dict(tops.launch_counts)
        out = lay(xi, extend_mask(mask.to(dev), torch.bfloat16))
        out.float().pow(2).sum().backward()
        if dev == cuda:
            torch.cuda.synchronize()
            assert {k: tops.launch_counts[k] - n0[k] for k in n0} == {
                "attention_fwd": 1, "attention_bwd": 1, "attention_fwd_blocked": 0,
                "attention_bwd_blocked": 0}
        assert out.dtype == torch.bfloat16 and xi.grad.dtype == torch.float32
        outs[str(dev)] = (out.float().cpu(), xi.grad.cpu())
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert _rel_err(got, want) <= 2.0 ** -6


def test_packed_il_update_launches_on_the_card(cuda):
    """One tiny packed IL update on the card, in fp32 and bf16: exactly
    packed_il_mix's launches, and a finite loss."""
    from vln_hamt_torch.agents.agent import HAMTAgent
    from vln_hamt_torch.run.profile_attention import packed_il_mix
    from vln_hamt_torch.run.finetune import build_synthetic_dataset
    from vln_hamt_torch.configs import get_preset

    for dtype in ("float32", "bfloat16"):
        cfg = get_preset("r2r").replace(
            model={"hidden_size": 64, "num_attention_heads": 4, "intermediate_size": 128,
                   "num_l_layers": 2, "num_x_layers": 1, "num_h_pano_layers": 1,
                   "image_feat_size": 32, "max_position_embeddings": 128,
                   "max_action_steps": 32, "dtype": dtype},
            env={"max_action_len": 12, "max_instr_len": 32, "image_feat_size": 32},
            train={"batch_size": 4, "feedback": "teacher"})
        cfg, env, _ = build_synthetic_dataset(cfg)
        agent = HAMTAgent(cfg, env, seed=0, device=cuda)
        agent.enable_feature_table()
        agent.enable_packed_il()
        fwd, bwd = packed_il_mix(cfg, agent._packer.text_cap)
        n0 = dict(tops.launch_counts)
        out = agent.train_iteration("teacher")
        assert {k: tops.launch_counts[k] - n0[k] for k in n0} == {
            "attention_fwd": sum(fwd.values()), "attention_bwd": sum(bwd.values()),
            "attention_fwd_blocked": 0, "attention_bwd_blocked": 0}, dtype
        assert out["episodes"] >= 4 and torch.isfinite(torch.tensor(out["loss"]))


def test_vit_runs_its_attention_through_both_kernels(cuda):
    """A ViT at Dh 64 (2 heads of 64, 197 tokens) on the card against the
    same weights on the CPU: features and logits within 2e-4, one forward
    launch per block, and with gradient one backward launch per block;
    the tiny CLI's Dh 12 runs on the card through the key-blocked forward,
    one launch per block, within 2e-4 of the CPU."""
    from vln_hamt_torch.vision.vit import ViTConfig, init_vit

    cfg = ViTConfig(hidden_size=128, num_layers=2, num_heads=2, num_classes=10)
    vit_cpu = init_vit(cfg, seed=0).eval()
    vit = init_vit(cfg, seed=0).to(cuda).eval()
    x = torch.randn(3, 224, 224, 3, generator=torch.Generator().manual_seed(0))
    n0 = dict(tops.launch_counts)
    f, logits = vit(x.to(cuda))
    with torch.no_grad():
        fc, lc = vit_cpu(x)
    torch.testing.assert_close(f.detach().cpu(), fc, rtol=0, atol=2e-4)
    torch.testing.assert_close(logits.detach().cpu(), lc, rtol=0, atol=2e-4)
    (f.sum() + logits.sum()).backward()
    torch.cuda.synchronize()
    assert tops.launch_counts["attention_fwd"] == n0["attention_fwd"] + 2
    assert tops.launch_counts["attention_bwd"] == n0["attention_bwd"] + 2
    tiny_cfg = ViTConfig(img_size=(32, 32), hidden_size=48, num_layers=1, num_heads=4)
    tiny_cpu = init_vit(tiny_cfg, seed=0).eval()
    tiny = init_vit(tiny_cfg, seed=0).to(cuda).eval()
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    n0 = dict(tops.launch_counts)
    with torch.no_grad():
        got, want = tiny(x.to(cuda)), tiny_cpu(x)
    torch.cuda.synchronize()
    assert tops.launch_counts["attention_fwd_blocked"] == n0["attention_fwd_blocked"] + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=2e-4)


def test_span_holds_its_kernel_on_the_profiler_clock(cuda):
    """In a device-only profiler window, a span around a sleep kernel and
    the wait for it holds the kernel's device interval, the span's times
    put on the profiler's clock by ``SpanRecorder.to_profiler_ns``."""
    from torch.profiler import ProfilerActivity, profile

    from vln_hamt_torch.utils.logging import SpanRecorder, span

    with profile(activities=[ProfilerActivity.CUDA]):  # the tracer's cold start, dropped
        for _ in range(100):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    with SpanRecorder(keep=True) as rec:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                with span("sleep"):
                    torch.cuda._sleep(5_000_000)  # cycles: a few ms
                    torch.cuda.synchronize()
    kernels = sorted((e.start_ns(), e.end_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if "CUDA" in str(e.device_type()) and not e.is_user_annotation())
    kept = [r for r in rec.records if r.name == "sleep"]
    assert len(kernels) == len(kept) == 3, kernels
    for (k0, k1, _), r in zip(kernels, kept):
        s0, s1 = rec.to_profiler_ns(r.start_ns), rec.to_profiler_ns(r.end_ns)
        print(f"sleep kernel {(k1 - k0) / 1e6:.3f} ms; span opens {(k0 - s0) / 1e3:.1f} us "
              f"before it, closes {(s1 - k1) / 1e3:.1f} us after it")
        assert s0 <= k0 and k1 <= s1
