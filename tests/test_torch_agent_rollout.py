"""The port's greedy and sampled rollouts, its evaluation and its
``test_vln`` CLI against the JAX package's, on the synthetic environment,
with the JAX policy's weights carried across (the CLI's metrics against
tools/test_vln.py's are in tests/test_torch_agent_rollout_cli.py).

Greedy rollouts branch on an argmax, so a 1e-6 logit error at a near-tie
could send the two packages down different paths.  Each test therefore
holds the port's logits and log-softmax against JAX's teacher-forced along
JAX's own trajectory (rtol 1e-4 / atol 2e-5, the -1e9 entries exactly),
checks that every decision there has a top-2 margin above 1e-3, and then
requires equal actions and equal per-episode metrics."""

import os

import jax
import numpy as np
import pytest
import torch

from vln_ver_tpu.agent import PolicyConfig as JPolicyConfig
from vln_ver_tpu.agent import VLNPolicy as JVLNPolicy
from vln_ver_tpu.agent import init_memory
from vln_ver_tpu.agent import env as jenv
from vln_ver_tpu.agent import rollout as jroll
from vln_ver_tpu_torch.agent import env as tenv
from vln_ver_tpu_torch.agent import policy as tpol
from vln_ver_tpu_torch.agent import rollout as troll
from vln_ver_tpu_torch.agent.memory import EpisodicMemory
from vln_ver_tpu_torch.convert import policy_state_dict_from_jax
from vln_ver_tpu_torch.parallel.mesh import Mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL, MARGIN = 1e-4, 2e-5, 1e-3
KW = dict(embed_dims=32, num_heads=4, fusion_layers=1, text_layers=1,
          ffn_dim=64, vocab_size=100, max_text_len=16, max_nodes=12,
          bev_z=2, bev_h=4, bev_w=4, num_query_tokens=2)
BEV_NUM = 2 * 4 * 4
N_EPISODES = 6


def _init_jax(cfg, env, objects, seed, scale):
    """JAX params as tools/test_vln.py initialises them, every leaf then
    perturbed by ``scale`` so the logits are decisive."""
    obs = env.observe(env.reset(0))
    policy = JVLNPolicy(cfg)
    params = jax.device_get(policy.init(
        jax.random.PRNGKey(seed), obs["instruction"][None],
        obs["instruction"][None] > 0, obs["volume"][None],
        init_memory(1, cfg.max_nodes, cfg.embed_dims), obs["cur_pos"][None],
        obs["cur_slot"][None],
        **(dict(obj_feats=obs["obj_feats"][None],
                obj_valid=obs["obj_valid"][None]) if objects else {})))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.float32), params)
    return policy, params


@pytest.fixture(scope="module", params=[False, True], ids=["r2r", "reverie"])
def agents(request, tmp_path_factory):
    objects = request.param
    root = str(tmp_path_factory.mktemp("synvln"))
    syn = dict(num_scans=2, nodes_per_scan=9, num_episodes=N_EPISODES,
               bev_num=BEV_NUM, embed_dims=KW["embed_dims"],
               max_text_len=KW["max_text_len"], seed=5,
               with_objects=objects)
    made_j = jenv.make_synthetic_vln(root, **syn)
    made_t = tenv.make_synthetic_vln(root, **syn)
    obj_j = made_j[3] if objects else None
    obj_t = made_t[3] if objects else None
    env_j = jenv.R2REnv(*made_j[:3], max_nodes=KW["max_nodes"], objects=obj_j)
    env_t = tenv.R2REnv(*made_t[:3], max_nodes=KW["max_nodes"], objects=obj_t)
    jcfg, tcfg = JPolicyConfig(**KW), tpol.PolicyConfig(**KW)
    jp, params = _init_jax(jcfg, env_j, objects, seed=1, scale=0.2)
    tp = tpol.VLNPolicy(tcfg, grounding=objects)
    tp.load_state_dict(policy_state_dict_from_jax(params, tcfg), strict=True)
    return dict(env_j=env_j, env_t=env_t, jp=jp, params=params,
                tp=tp.eval(), jcfg=jcfg, tcfg=tcfg, objects=objects)


def _port_step(tp, obs, mem):
    obj = {}
    if "obj_feats" in obs:
        obj = dict(obj_feats=torch.from_numpy(obs["obj_feats"][None]),
                   obj_valid=torch.from_numpy(obs["obj_valid"][None]))
    ins = torch.from_numpy(obs["instruction"][None])
    with torch.no_grad():
        return tp(ins, ins > 0, torch.from_numpy(obs["volume"][None]),
                  EpisodicMemory(*[torch.from_numpy(np.array(x))
                                   for x in mem]),
                  torch.from_numpy(obs["cur_pos"][None]),
                  torch.from_numpy(obs["cur_slot"][None]), **obj)


def _top2_margin(logits):
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def _teacher_forced(a):
    """Hold the port against JAX along JAX's greedy trajectories; returns
    JAX's per-episode metrics."""
    step = jroll.policy_step_fn(a["jp"])
    metrics = []
    for i in range(N_EPISODES):
        m, trace = jroll.run_episode(a["jp"], a["params"], a["env_j"], i,
                                     a["jcfg"], greedy=True,
                                     collect_teacher=True)
        metrics.append(m)
        for r in trace:
            obs, mem = r["obs"], r["memory"]
            obj = ({} if "obj_feats" not in obs else dict(
                obj_feats=obs["obj_feats"][None],
                obj_valid=obs["obj_valid"][None]))
            want = step(a["params"], obs["instruction"][None],
                        obs["instruction"][None] > 0, obs["volume"][None],
                        jax.tree_util.tree_map(np.asarray, mem),
                        obs["cur_pos"][None], obs["cur_slot"][None], **obj)
            got = _port_step(a["tp"], obs, mem)
            wl = np.asarray(want.logits)
            np.testing.assert_allclose(got.logits.numpy(), wl, rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(
                torch.log_softmax(got.logits, -1).numpy(),
                np.asarray(jax.nn.log_softmax(want.logits, -1)), rtol=RTOL,
                atol=ATOL)
            np.testing.assert_allclose(got.state_pred.numpy(),
                                       np.asarray(want.state_pred),
                                       rtol=RTOL, atol=ATOL)
            assert _top2_margin(wl[0]) > MARGIN, (i, wl)
            if obj:
                np.testing.assert_allclose(got.obj_logits.numpy(),
                                           np.asarray(want.obj_logits),
                                           rtol=RTOL, atol=ATOL)
    return metrics


def test_greedy_rollouts_match_jax(agents):
    a = agents
    ref = _teacher_forced(a)
    got = troll.episode_metrics(a["tp"], a["env_t"], a["tcfg"])
    assert got == ref
    if a["objects"]:
        assert all("rgs" in m and "rgspl" in m for m in got)
    # the means, as jax's evaluate aggregates them
    want = jroll.evaluate(a["jp"], a["params"], a["env_j"], a["jcfg"])
    assert troll.evaluate(a["tp"], a["env_t"], a["tcfg"]) == want


@pytest.mark.parametrize("batch", [4, 8])
def test_batched_matches_sequential_and_jax(agents, batch):
    """Lockstep batches (uneven episode lengths, frozen rows, a padded
    final batch) give the sequential run's per-episode metrics, and
    JAX's batched means."""
    a = agents
    seq = troll.episode_metrics(a["tp"], a["env_t"], a["tcfg"])
    bat = troll.episode_metrics(a["tp"], a["env_t"], a["tcfg"],
                                batch_size=batch)
    assert bat == seq
    _, traces = troll.run_episodes_batched(
        a["tp"], a["env_t"], list(range(N_EPISODES)), a["tcfg"],
        collect_teacher=True)
    assert len({len(t) for t in traces}) > 1, "expected uneven lengths"
    want = jroll.evaluate_batched(a["jp"], a["params"], a["env_j"],
                                  a["jcfg"], batch_size=batch)
    got = troll.evaluate_batched(a["tp"], a["env_t"], a["tcfg"],
                                 batch_size=batch)
    assert got == want


class _Recording(tenv.R2REnv):
    """Records each (state, action) the rollout takes."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.taken = []

    def step(self, state, action):
        arrs = self.memory_arrays(state)
        self.taken.append((int(state["slot_of"][state["cur"]]),
                           arrs["valid"].copy(), action))
        super().step(state, action)


def test_sampled_rollouts_reproducible_and_unmasked(agents):
    a = agents
    e = a["env_t"]
    env = _Recording(e.episodes, e.graphs, e.ver, max_nodes=e.max_nodes,
                     objects=e.objects)
    runs = []
    for _ in range(2):
        env.taken = []
        gen = torch.Generator().manual_seed(11)
        m, _ = troll.run_episodes_batched(a["tp"], env, [0, 1, 2, 3],
                                          a["tcfg"], greedy=False,
                                          generator=gen)
        m1, _ = troll.run_episode(a["tp"], env, 4, a["tcfg"], greedy=False,
                                  generator=gen)
        runs.append((m + [m1], list(env.taken)))
    assert runs[0][0] == runs[1][0]
    assert [t[2] for t in runs[0][1]] == [t[2] for t in runs[1][1]]
    for cur, valid, action in runs[0][1]:
        assert action == 0 or (valid[action - 1] and action - 1 != cur)
    with pytest.raises(ValueError, match="Generator"):
        troll.run_episode(a["tp"], env, 0, a["tcfg"], greedy=False)
    with pytest.raises(ValueError, match="Generator"):
        troll.run_episodes_batched(a["tp"], env, [0, 1], a["tcfg"],
                                   greedy=False)
    with pytest.raises(ValueError, match="not divisible by mesh size 2"):
        troll.evaluate_batched(a["tp"], env, a["tcfg"], batch_size=3,
                               mesh=Mesh((2, 1), 0, 0))


def test_sampling_follows_softmax():
    logits = torch.tensor([[1.0, 0.2, -1e9, 0.7, -0.5]])
    gen = torch.Generator().manual_seed(0)
    draws = troll._sample(logits.expand(40000, -1), gen)
    freq = np.bincount(draws, minlength=5) / len(draws)
    want = torch.softmax(logits, -1)[0].numpy()
    assert freq[2] == 0.0
    np.testing.assert_allclose(freq, want, atol=0.01)


def test_rollout_times_split_the_host_loop(agents):
    a = agents
    times = {}
    troll.evaluate_batched(a["tp"], a["env_t"], a["tcfg"], batch_size=4,
                           times=times)
    assert set(times) == {"env", "memory", "upload", "policy",
                          "policy_calls", "decisions"}
    assert times["policy_calls"] >= 1
    assert times["decisions"] >= N_EPISODES
    assert all(times[k] > 0 for k in ("env", "memory", "upload", "policy"))


# -- the CLI ---------------------------------------------------------------

def test_test_vln_cli_refuses_mesh_and_missing_cuda(tmp_path):
    from vln_ver_tpu_torch import test_vln
    # a mesh the world (one process) cannot hold
    with pytest.raises(ValueError, match="needs 2 processes"):
        test_vln.main(["--checkpoint", str(tmp_path), "--synthetic",
                       "--mesh", "2", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            test_vln.main(["--checkpoint", str(tmp_path), "--synthetic",
                           "--work-dir", str(tmp_path)])
    with pytest.raises(FileNotFoundError):
        test_vln.main(["--checkpoint", str(tmp_path / "none"), "--synthetic",
                       "--device", "cpu", "--work-dir", str(tmp_path)])
