"""The port's REVERIE agent against the JAX package's on the same weights:
``plan_ref``'s action and object logits and state; the host loop's
object-grounded rollout (trajectories, predicted objects, rewards); the
device rollout against the port's host loop and, with the object table,
against the plain path; the three greedy evaluators; packed against
unpacked IL; and a REVERIE reference checkpoint (the NavRefModel wrapper)
taken by ``init_from_reference``. The teacher episode's dual CE and its
gradients, and the updates, are in tests/test_torch_reverie_updates.py.
Set-up from tests/test_torch_variants.py: tiny sizes, dropout off unless
stated, one thread."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import SIZES, _inputs
from test_torch_replay import assert_logits_close
from test_torch_sample import REWARD_ATOL
from test_torch_train import (_fast_init_hamt_params,
                              train_test_setup)  # noqa: F401 (autouse fixture)
from test_torch_variants import OBJ_FEAT, port_agent, variant_pair
from vln_hamt_tpu.configs import ModelConfig as JaxModelConfig
from vln_hamt_tpu.models.hamt import HAMT as JaxHAMT
from vln_hamt_torch.agents.packing import unpack_episodes
from vln_hamt_torch.configs import ModelConfig
from vln_hamt_torch.models.convert import params_from_flax
from vln_hamt_torch.models.hamt import init_hamt

K = 5  # objects per viewpoint in the model test


def preds_of(preds):
    return {p["instr_id"]: ([x[0] for x in p["trajectory"]], p.get("predObjId"))
            for p in preds}


@pytest.mark.parametrize("no_lang_ca", [False, True], ids=["ob_txt", "no_lang_ca"])
def test_plan_ref_matches_jax(no_lang_ca):
    """plan_ref on the JAX model's weights (object embeddings and the
    ref_object head through params_from_flax): action and object logits
    (-inf at the same places) and the state within 2e-4; under
    no_lang_ca the port's text states are the initial encoding alone."""
    sizes = dict(SIZES, obj_feat_size=OBJ_FEAT, no_lang_ca=no_lang_ca)
    jcfg = JaxModelConfig(**sizes)
    x = _inputs()
    b = x["txt_ids"].shape[0]
    _, _, params, _ = _fast_init_hamt_params(jcfg, jax.random.PRNGKey(0), 36,
                                             x["ob_img"].shape[1], x["txt_ids"].shape[1],
                                             x["hist_tokens"].shape[1])
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    obj = {"obj_fts": rng.standard_normal((b, K, OBJ_FEAT)).astype(np.float32),
           "obj_angs": rng.standard_normal((b, K, 4)).astype(np.float32),
           "obj_pos": rng.random((b, K, 5)).astype(np.float32),
           "obj_mask": np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool)}
    names = ("hist_tokens", "hist_mask", "ob_img", "ob_ang", "ob_nav", "ob_mask")
    jm = JaxHAMT(jcfg)
    apply = lambda method, *a: jm.apply({"params": params}, *a, method=method)  # noqa: E731
    j = {k: jnp.asarray(v) for k, v in {**x, **obj}.items()}
    want = apply(JaxHAMT.plan_ref, apply(JaxHAMT.encode_text, j["txt_ids"], j["txt_mask"]),
                 j["txt_mask"], *(j[n] for n in names + tuple(obj)))

    cfg = ModelConfig(**sizes)
    model, _ = init_hamt(cfg, seed=1)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in params_from_flax(params, cfg).items()}, strict=True)
    model.eval()
    t = {k: torch.from_numpy(v) for k, v in {**x, **obj}.items()}
    with torch.no_grad():
        txt = model.encode_text(t["txt_ids"], t["txt_mask"])
        got = model.plan_ref(txt, t["txt_mask"], *(t[n] for n in names + tuple(obj)))
    assert txt.dim() == (4 if no_lang_ca else 3) and (not no_lang_ca or txt.shape[0] == 1)
    for name, g, w in zip(("act_logits", "obj_logits", "state"), got, want):
        assert_logits_close(g, w, name)
    assert np.isinf(got[1].numpy()[0, 3:]).all()


@pytest.mark.parametrize("mode", ["argmax", "teacher"])
def test_host_rollout_matches_jax(mode):
    """The host loop over the same batch, argmax (with rewards) and
    teacher-forced: the same trajectories and predicted objects, actions
    (the object stop as the appended slot), live masks and bootstrap
    mask; the rewards exactly equal; logits within 2e-4."""
    jagent, agent = variant_pair("reverie", no_lang_ca=True)
    jtraj, jx = jagent.interactive_rollout(mode, jax.random.PRNGKey(0), deterministic=True,
                                           record_for_replay=True)
    traj, x = agent.interactive_rollout(mode, record_for_replay=True)
    assert traj == jtraj and all("predObjId" in tr for tr in traj)
    for k in ("actions", "step_mask", "node_idx", "final_node_idx"):
        np.testing.assert_array_equal(x["ep"][k].numpy(), np.asarray(jx["ep"][k]), err_msg=k)
    for k in ("rewards", "masks", "bootstrap_mask"):
        np.testing.assert_array_equal(x[k].numpy(), np.asarray(jx[k]), err_msg=k)
    assert_logits_close(x["rollout_logits"], jx["rollout_logits"], "logits")
    if mode == "teacher":  # the teacher stops on the object slot
        acts = x["ep"]["actions"].numpy()[x["ep"]["step_mask"].numpy()]
        assert (acts == agent.stop_action).any()


def test_device_rollout_matches_host_and_plain_path():
    """The sampling device rollout (plan_ref over the object tables, the
    object-stop slot, the multi-goal distance slab) against the port's
    host loop from the same generator state, two batches: actions, masks
    and bootstrap mask equal, rewards within 1e-5, logits within 2e-4;
    and host-loop rollouts with the tables equal those without them
    (objects shipped from the env). The object logits are raised by 2 in
    all three, so the random policy takes the object stop."""
    host, dev, bare = (port_agent("reverie"), port_agent("reverie"),
                       port_agent("reverie", table=False))
    for a in (host, dev, bare):
        plan_ref = a.model.plan_ref
        a.model.plan_ref = lambda *args, f=plan_ref: (lambda o: (o[0], o[1] + 2.0, o[2]))(
            f(*args))
    stops = 0
    for batch in range(2):
        for a in (host, dev, bare):
            a.action_rng.manual_seed(batch)
        _, hx = host.interactive_rollout("sample", record_for_replay=True)
        _, bx = bare.interactive_rollout("sample", record_for_replay=True)
        ins = dev._device_rollout_args()
        with torch.no_grad():
            dep, dx = dev._ensure_device_rollout_fn()(
                ins["txt_ids"], ins["txt_mask"], dev._feat_table, dev._nav_tables,
                ins["start_node"], ins["start_view"], ins["offs"], ins["task_inputs"],
                policy="sample", compute_rewards=True, generator=dev.action_rng,
                obj_tables=dev._obj_tables)
        for k in ("actions", "step_mask", "node_idx", "final_node_idx"):
            np.testing.assert_array_equal(hx["ep"][k].numpy(), dep[k].numpy(), err_msg=k)
        for k in ("actions", "step_mask", "view_index"):
            np.testing.assert_array_equal(hx["ep"][k].numpy(), bx["ep"][k].numpy(), err_msg=k)
        for k in ("masks", "bootstrap_mask"):
            np.testing.assert_array_equal(hx[k].numpy(), dx[k].numpy(), err_msg=k)
        np.testing.assert_allclose(hx["rewards"].numpy(), dx["rewards"].numpy(), rtol=0,
                                   atol=REWARD_ATOL)
        np.testing.assert_array_equal(hx["rewards"].numpy(), bx["rewards"].numpy())
        t_used = hx["rollout_logits"].shape[0]
        assert_logits_close(hx["rollout_logits"], dx["rollout_logits"][:t_used].numpy(), "dev")
        assert_logits_close(hx["rollout_logits"], bx["rollout_logits"].numpy(), "no table")
        acts = dep["actions"].numpy()[dep["step_mask"].numpy()]
        stops += int((acts == dev.stop_action).sum())
    assert stops > 0


def test_evaluators_match_jax():
    """Greedy trajectories and predicted objects: the port's lock-step
    evaluator equals the JAX package's (and the metrics), the packed
    evaluator at pipelines 1 and 2 and the device rollout equal the
    lock-step's, and so does lock-step evaluation without the tables."""
    jagent, agent = variant_pair("reverie", no_lang_ca=True)
    lock = agent.eval_split()
    want = preds_of(jagent.eval_split())
    assert preds_of(lock) == want and len(want) == len(agent.env.data)
    assert agent.env.eval_metrics(lock)[0] == jagent.env.eval_metrics(lock)[0]
    for pipeline in (1, 2):
        assert preds_of(agent.eval_split_packed(pipeline=pipeline)) == want, pipeline
    assert preds_of(agent.eval_split_device()) == want
    bare = port_agent("reverie", table=False, no_lang_ca=True)
    bare.model.load_state_dict(agent.model.state_dict())
    assert preds_of(bare.eval_split()) == want
    assert preds_of(bare.eval_split_fast()) == want  # the packed evaluator


def test_packed_il_equals_unpacked():
    """A pack of REVERIE teacher episodes (object targets per cell): its
    dual-CE loss and every gradient equal the unpacked episodes' loss
    (the unpacked estimator divides by its batch, the episode count)."""
    agent = port_agent("reverie")
    agent.enable_packed_il()
    pack = agent._packer.next_pack()
    assert int(pack["n_episodes"]) >= agent.env.batch_size
    assert (pack["ref_teacher"][pack["live"]] >= 0).any()
    ep = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in unpack_episodes(
        pack, agent.env.max_action_len, agent.stop_action).items()}
    ep = {k: v.long() if v.dtype == torch.int32 else v for k, v in ep.items()}
    agent.model.train()
    agent.critic.train()

    def loss_and_grads(loss_fn):
        agent.model.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        return loss.item(), {k: p.grad.clone() for k, p in agent.model.named_parameters()
                             if p.grad is not None}

    lp, gp = loss_and_grads(lambda: agent._packed_il_loss(
        agent._pack_to_device(pack), float(pack["n_episodes"]), 1.0))
    lu, gu = loss_and_grads(lambda: agent._il_loss(ep, 1.0))
    np.testing.assert_allclose(lp, lu, rtol=1e-5)
    assert gp.keys() == gu.keys() and any(k.startswith("ref_object") for k in gp)
    for k in gu:
        np.testing.assert_allclose(gp[k].numpy(), gu[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    out = agent.train_iteration("teacher")
    assert np.isfinite(out["loss"]) and out["episodes"] >= agent.env.batch_size


def test_reference_checkpoint_round_trip(tmp_path):
    """A REVERIE agent save in the reference's layout (NavRefModel's
    NavRefCMT under module.vln_bert., obj_embeddings.* and ref_object.*,
    and the critic) taken by an agent of another seed: nothing skipped,
    every tensor equal, the same greedy predictions."""
    src, dst = port_agent("reverie", seed=3), port_agent("reverie", seed=4)
    torch.save({
        "vln_bert": {"epoch": 1, "state_dict": {"module.vln_bert." + k: v for k, v in
                                                src.model.state_dict().items()}},
        "critic": {"epoch": 1, "state_dict": {"module." + k: v for k, v in
                                              src.critic.state_dict().items()}}},
        tmp_path / "navref.pt")
    assert any(k.startswith("obj_embeddings.") for k in src.model.state_dict())
    assert dst.init_from_reference(str(tmp_path / "navref.pt")) == []
    for a, b in ((src.model, dst.model), (src.critic, dst.critic)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k
    assert preds_of(dst.eval_split_device()) == preds_of(src.eval_split_device())
