"""The port's sampling rollout against the JAX package: the nDTW DP row,
the reward's cost slabs, the rewarded greedy rollout with its bootstrap,
the merged update's teacher-forced lanes; on the port alone, Gumbel-max
sampling and the ``sample`` training CLI. Gradients of the ``sample``
update are in tests/test_torch_sample_grads.py. Set-up from
tests/test_torch_train.py: tiny sizes, dropout off, one thread."""

import jax
import numpy as np
import pytest
import torch

from test_torch_train import (WORLD, make_env, make_pair, tiny_cfg,
                              train_test_setup)  # noqa: F401 (autouse fixture)
from vln_hamt_tpu.agents.rollout import _dp_extend as jax_dp_extend
from vln_hamt_tpu.eval.metrics import IncrementalNDTW as JaxIncrementalNDTW
from vln_hamt_torch.agents.agent import HAMTAgent
from vln_hamt_torch.agents.rollout import _dp_extend, gumbel_max
from vln_hamt_torch.configs import HAMTConfig
from vln_hamt_torch.data.fixtures import make_synthetic_world
from vln_hamt_torch.env import ObsSpec, R2RNavEnv
from vln_hamt_torch.eval.metrics import IncrementalNDTW
from vln_hamt_torch.run import finetune

# fp32 through the tiny model, as tests/test_agent.py:136 holds the
# device rollout against the host rollout
ATOL = 2e-4
REWARD_RTOL, REWARD_ATOL = 1e-4, 1e-5


def jax_rollout(jagent, il=None, **kw):
    """The JAX agent's rewarded device rollout over its env's next batch
    (deterministic), as its ``sample`` update prepares it: the teacher
    episode first when ``il`` lanes are wanted, then the env reset."""
    jil = jagent._ep_to_device(jagent.env.teacher_episode()) if il else None
    fn = jagent._ensure_device_rollout_fn()
    ins, tkeys = jagent._device_rollout_args()
    txt_ids, txt_mask = ins["txt_ids"], ins["txt_mask"]
    if il:
        txt_ids = np.concatenate([txt_ids, jil["txt_ids"]])
        txt_mask = np.concatenate([txt_mask, jil["txt_mask"]])
        kw["il"] = {k: jil[k] for k in ("node_idx", "view_index", "actions", "step_mask")}
    st = jagent.state
    ep, extras = fn(st.params, st.cparams, txt_ids, txt_mask, jax.random.PRNGKey(0),
                    jagent._feat_table, jagent._nav_tables, ins["start_node"],
                    ins["start_view"], ins["offs"], {k: ins[k] for k in tkeys},
                    deterministic=True, compute_bootstrap=True, **kw)
    return jil, ins, ep, extras


def assert_logits_close(got, want, name):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, name
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL, rtol=0, err_msg=name)


# ------------------------------------------------------------- nDTW row
def test_dp_extend_matches_jax_and_incremental_ndtw():
    """Random rows with inf-padded reference columns against the JAX
    _dp_extend; and a random walk against the port's IncrementalNDTW
    (as tests/test_metrics.py holds the JAX one)."""
    rng = np.random.default_rng(0)
    b, r = 6, 7
    dp = rng.uniform(0, 20, (b, r + 1)).astype(np.float32)
    dp[:, 0] = np.inf
    cost = rng.uniform(0, 10, (b, r)).astype(np.float32)
    for i, n in enumerate((7, 5, 3, 1, 7, 2)):  # reference lengths: pad the rest
        dp[i, n + 1:] = np.inf
        cost[i, n:] = np.inf
    got = _dp_extend(torch.from_numpy(dp), torch.from_numpy(cost)).numpy()
    want = np.asarray(jax_dp_extend(jax.numpy.asarray(dp), jax.numpy.asarray(cost)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert not np.isnan(got).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)

    n, b, r, steps = 20, 5, 6, 10
    pos = rng.standard_normal((n, 3)) * 4
    dist = np.sqrt(((pos[:, None] - pos[None]) ** 2).sum(-1)).astype(np.float32)
    refs = [rng.integers(0, n, r).tolist() for _ in range(b)]
    nodes = rng.integers(0, n, b).tolist()
    inc = IncrementalNDTW([dist] * b, refs, nodes)
    cost = lambda nodes: torch.from_numpy(
        np.stack([dist[nd, refs[i]] for i, nd in enumerate(nodes)]))
    row = torch.full((b, r + 1), np.inf)
    row[:, 0] = 0.0
    row = _dp_extend(row, cost(nodes))
    for _ in range(steps):
        nodes = rng.integers(0, n, b).tolist()
        for i in range(b):
            inc.update(i, nodes[i])
        row = _dp_extend(row, cost(nodes))
        np.testing.assert_allclose(np.exp(-row.numpy()[:, r] / (3.0 * r)),
                                   [inc.value(i) for i in range(b)], rtol=1e-5)


# ------------------------------------------------------------ host prep
def test_device_rollout_inputs_match_jax(tiny_world):
    """Start poses, scan offsets and the cost slabs (inf-padded) of one
    batch are the JAX agent's."""
    jagent, agent = make_pair(tiny_world)
    assert (agent._n_scan_max, agent._ref_max) == (jagent._n_scan_max, jagent._ref_max)
    jins, tkeys = jagent._device_rollout_args()
    ins = agent._device_rollout_args()
    assert sorted(tkeys) == sorted(ins["task_inputs"]) == ["ref_cost", "ref_len"]
    for k in ("txt_ids", "txt_mask", "start_node", "start_view", "offs"):
        np.testing.assert_array_equal(ins[k].numpy(), np.asarray(jins[k]), err_msg=k)
    for k in tkeys:
        got, want = ins["task_inputs"][k].numpy(), np.asarray(jins[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert np.isinf(ins["task_inputs"]["ref_cost"].numpy()).any()  # padding present
    # greedy evaluation ships no slabs (GT-less test splits)
    assert "task_inputs" not in agent._device_rollout_args(include_rewards=False)


# ------------------------------------------------------ rewarded rollout
def test_rewarded_rollout_matches_jax(tiny_world):
    """The argmax rollout with rewards and the bootstrap value against
    the JAX rollout_raw on the same batch: trajectories, masks and the
    bootstrap mask equal; logits, values, last_value and rewards within
    the tolerances of tests/test_agent.py:136."""
    jagent, agent = make_pair(tiny_world)
    _, _, jep, jex = jax_rollout(jagent, policy="argmax", compute_rewards=True)
    ins = agent._device_rollout_args()
    with torch.no_grad():
        ep, ex = agent._rollout(ins, ins["txt_ids"], ins["txt_mask"], "argmax")
    for k in ("node_idx", "view_index", "actions", "step_mask", "final_node_idx",
              "final_view_index"):
        np.testing.assert_array_equal(ep[k].numpy(), np.asarray(jep[k]), err_msg=k)
    assert set(ex) == set(jex)
    for k in ("masks", "bootstrap_mask"):
        np.testing.assert_array_equal(ex[k].numpy(), np.asarray(jex[k]), err_msg=k)
    np.testing.assert_allclose(ex["rewards"].numpy(), np.asarray(jex["rewards"]),
                               rtol=REWARD_RTOL, atol=REWARD_ATOL)
    assert_logits_close(ex["rollout_logits"], jex["rollout_logits"], "rollout_logits")
    for k in ("values", "last_value"):
        np.testing.assert_allclose(ex[k].numpy(), np.asarray(jex[k]), atol=ATOL, rtol=0,
                                   err_msg=k)
    # the batch walks: moves past the first step, and non-zero rewards
    assert ex["masks"].numpy()[1:].any() and np.abs(ex["rewards"].numpy()).sum() > 0


def host_rewards(env, ep, offs, stop):
    """The R2R shaping of the JAX agent's host rollout
    (``HAMTAgent._step_rewards``, agent_cmt.py:407-445) over a recorded
    episode: the goal distance from the graph, nDTW from the JAX
    package's IncrementalNDTW, extended on every live move."""
    nodes = np.concatenate([ep["node_idx"].numpy(), ep["final_node_idx"].numpy()[:, None]],
                           axis=1)
    actions, live = ep["actions"].numpy(), ep["step_mask"].numpy()
    out = np.zeros(actions.shape, np.float32)
    for i, item in enumerate(env.batch):
        g = env.graphs[item["scan"]]
        ref = g.indices(item["path"])
        node = nodes[i, 0] - offs[i]
        ndtw = JaxIncrementalNDTW([g.dist], [ref], [node])
        last_dist, last_ndtw = g.dist[node, ref[-1]], ndtw.value(0)
        for t in range(actions.shape[1]):
            if not live[i, t]:
                continue
            node = nodes[i, t + 1] - offs[i]
            if actions[i, t] != stop:
                ndtw.update(0, node)
            cur, dist = ndtw.value(0), g.dist[node, ref[-1]]
            if actions[i, t] == stop:
                out[i, t] = 2.0 + cur * 2.0 if dist < 3.0 else -2.0
            else:
                out[i, t] = (1.0 if dist < last_dist else -1.0) + cur - last_ndtw
                if last_dist <= 1.0 and dist > last_dist:
                    out[i, t] -= (1.0 - last_dist) * 2.0
            last_dist, last_ndtw = dist, cur
    return out.T


def test_sampled_rollout_rewards_follow_host_shaping():
    """Sampled rollouts over several batches: every reward, stops
    included, is the host shaping's for the trajectory drawn."""
    world = make_synthetic_world(**WORLD)
    cfg = tiny_cfg(HAMTConfig, world)
    agent = HAMTAgent(cfg, make_env(R2RNavEnv, ObsSpec, world, cfg), seed=0, device="cpu")
    agent.enable_feature_table()
    stop = agent._nav_tables["nbr_global"].shape[1]
    stops = 0
    for _ in range(4):
        ins = agent._device_rollout_args()
        with torch.no_grad():
            ep, ex = agent._rollout(ins, ins["txt_ids"], ins["txt_mask"], "sample")
        want = host_rewards(agent.env, ep, ins["offs"].numpy(), stop)
        np.testing.assert_allclose(ex["rewards"].numpy(), want, rtol=REWARD_RTOL,
                                   atol=REWARD_ATOL)
        stops += int((ep["actions"].numpy() == stop)[ep["step_mask"].numpy()].sum())
    assert stops > 0


# ---------------------------------------------------------- merged lanes
def test_merged_il_lanes_match_episode_forward(tiny_world):
    """The merged rollout's teacher-forced lanes: their logits equal the
    port's and the JAX package's episode forward on the same teacher
    episode, and the merged IL loss equals the JAX _il_loss (as
    tests/test_agent.py:196 holds the JAX merged scan)."""
    jagent, agent = make_pair(tiny_world)
    jil, _, _, jex = jax_rollout(jagent, il=True, policy="sample", compute_rewards=True)
    il_ep = agent._ep_to_device(agent.env.teacher_episode())
    ins = agent._device_rollout_args()
    with torch.no_grad():
        loss, aux = agent._merged_sample_loss(il_ep, ins)
        _, ex = agent._rollout(ins, torch.cat([ins["txt_ids"], il_ep["txt_ids"]]),
                               torch.cat([ins["txt_mask"], il_ep["txt_mask"]]), "sample",
                               il={k: il_ep[k] for k in ("node_idx", "view_index",
                                                         "actions", "step_mask")})
        ref = agent.episode_forward(il_ep, agent._feat_table).logits
    st = jagent.state
    jref = jax.jit(lambda p, c, e, table: jagent.episode_forward(
        p, c, e, jax.random.PRNGKey(0), deterministic=True, feat_table=table).logits)(
        st.params, st.cparams, jil, jagent._feat_table)
    assert_logits_close(ex["il_logits"], ref.numpy(), "il_logits vs port")
    assert_logits_close(ex["il_logits"], jex["il_logits"], "il_logits vs JAX merged")
    assert_logits_close(ex["il_logits"], jref, "il_logits vs JAX episode")
    jloss, _ = jagent._il_loss(st.params, st.cparams, jil, jax.random.PRNGKey(1),
                               agent.cfg.train.ml_weight, jagent._feat_table)
    np.testing.assert_allclose(aux["IL_loss"].item(), float(jloss), rtol=1e-5)
    assert np.isfinite(loss.item())


# ------------------------------------------------------------ Gumbel-max
def test_gumbel_max_frequencies_and_mask():
    """20 000 draws of one row: frequencies within 0.01 of the softmax;
    a masked (-inf) slot never drawn."""
    inf = float("inf")
    logits = torch.tensor([1.0, 0.5, -0.3, -inf, 2.0, 0.0, -inf])
    gen = torch.Generator().manual_seed(0)
    draws = gumbel_max(logits.expand(20_000, -1), gen)
    freq = np.bincount(draws.numpy(), minlength=logits.numel()) / 20_000
    p = torch.softmax(logits, dim=-1).numpy()
    np.testing.assert_allclose(freq, p, atol=0.01)
    assert freq[3] == 0 and freq[6] == 0


def test_gumbel_max_draws_from_its_generator():
    """The same generator seed gives the same draws, another seed others,
    and torch's global generator is not touched."""
    logits = torch.randn(64, 9)
    state = torch.random.get_rng_state()
    a = gumbel_max(logits, torch.Generator().manual_seed(3))
    b = gumbel_max(logits, torch.Generator().manual_seed(3))
    c = gumbel_max(logits, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(state, torch.random.get_rng_state())


# --------------------------------------------------------------- the CLI
@pytest.mark.parametrize("argv", [[], ["--no_merged_sample"]], ids=["merged", "fused"])
def test_cli_sample_training_on_cpu(tmp_path, argv):
    """The preset's default feedback trains, merged or fused; each
    interval's line carries the mean IL and RL losses and the entropy."""
    best = finetune.main(["--task", "r2r", "--synthetic", "--tiny", "--cpu", "--iters", "4",
                          "--log_every", "2", "--output_dir", str(tmp_path)] + argv)
    assert 0.0 <= best["sr"] <= 100.0 and best["iter"] in (2, 4)
    lines = [ln for ln in (tmp_path / "train.txt").read_text().splitlines()
             if "RL_loss=" in ln]
    assert len(lines) == 2
    for ln in lines:
        fields = dict(f.split("=") for f in ln.split(": ", 1)[1].split(", "))
        assert {"loss", "IL_loss", "RL_loss", "entropy", "eps_per_sec"} <= fields.keys()
        assert all(np.isfinite(float(v)) for v in fields.values())
