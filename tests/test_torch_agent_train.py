"""The port's agent training against the JAX package on the CPU, on shared
weights (a JAX parameter tree mapped through ``policy_state_dict_from_jax``,
which is linear, so it maps gradients too):

* ``imitation_step_loss``'s parts (rtol 1e-4) and every gradient against
  ``jax.value_and_grad`` (rtol 1e-3, atol 1e-5), for both architectures,
  with and without REVERIE objects, and with ``state_targets``;
* eight clip + AdamW updates on fixed batches of JAX's teacher records
  (losses within rtol 2e-4, parameter drift within 2.5 % in relative L2:
  the bounds of tests/test_torch_train.py);
* the teacher records and stacked batches equal JAX's exactly;
* dropout: the identity in ``eval()``; in ``train()`` one attention mask
  shared across batch and heads, keep about 0.9, scale 1 / 0.9; the
  imitation loss runs with dropout off in either mode;
* the update: optax's clip 40 and AdamW with weight decay 1e-4 on every
  parameter.

The config is tests/test_dagger.py's tiny one; fp32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vln_ver_tpu.agent import PolicyConfig as JPolicyConfig
from vln_ver_tpu.agent import VLNPolicy as JVLNPolicy
from vln_ver_tpu.agent.env import R2REnv as JR2REnv
from vln_ver_tpu.agent.env import make_synthetic_vln as jmake_synthetic_vln
from vln_ver_tpu.agent.pretrain import collect_teacher_trace as jcollect
from vln_ver_tpu.agent.pretrain import stack_records as jstack
from vln_ver_tpu.agent.rollout import imitation_step_loss as jimitation_loss
from vln_ver_tpu_torch.agent.attention import MultiHeadAttention
from vln_ver_tpu_torch.agent.env import R2REnv, make_synthetic_vln
from vln_ver_tpu_torch.agent.policy import PolicyConfig, VLNPolicy
from vln_ver_tpu_torch.agent.pretrain import (collect_teacher_trace,
                                              stack_records)
from vln_ver_tpu_torch.agent.rollout import imitation_step_loss
from vln_ver_tpu_torch.agent.update import make_train_state, update
from vln_ver_tpu_torch.convert import policy_state_dict_from_jax
from vln_ver_tpu_torch.utils.params import drift_rel_l2, grads_by_name

KW = dict(embed_dims=32, num_heads=4, fusion_layers=1, text_layers=1,
          ffn_dim=64, vocab_size=100, max_text_len=16, max_nodes=12,
          bev_z=2, bev_h=4, bev_w=4, num_query_tokens=2)
BEV_NUM = 2 * 4 * 4
N_EPISODES = 8
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3, 1e-5


def make_envs(root, objects=False, seed=3):
    """The JAX package's environment and the port's, from one seed."""
    kw = dict(num_scans=2, nodes_per_scan=9, num_episodes=N_EPISODES,
              bev_num=BEV_NUM, embed_dims=KW["embed_dims"],
              max_text_len=KW["max_text_len"], seed=seed,
              with_objects=objects)
    envs = []
    for make, env_cls in ((jmake_synthetic_vln, JR2REnv),
                          (make_synthetic_vln, R2REnv)):
        made = make(str(root / env_cls.__module__), **kw)
        envs.append(env_cls(*made[:3], max_nodes=KW["max_nodes"],
                            objects=made[3] if objects else None))
    return envs


def teacher_records(env, collect, cfg):
    return [r for i in range(len(env.episodes))
            for r in collect(env, i, cfg)]


def both_records(root, objects):
    """(objects, JAX records, port records) of every episode's teacher
    trace."""
    jenv, env = make_envs(root, objects)
    return (objects, teacher_records(jenv, jcollect, None),
            teacher_records(env, collect_teacher_trace, None))


@pytest.fixture(scope="module", params=[False, True],
                ids=["r2r", "reverie"])
def records(request, tmp_path_factory):
    return both_records(tmp_path_factory.mktemp("agent"), request.param)


@pytest.fixture(scope="module")
def r2r_records(tmp_path_factory):
    return both_records(tmp_path_factory.mktemp("agent_r2r"), False)


def fill_params(shapes, cfg, seed=0):
    """Random values for a flax parameter tree of ``shapes``: LayerNorm
    scales 1 + N(0, 0.05), kernels of variance 1 / fan_in, the token table
    N(0, 1), every other leaf N(0, 0.05) (flax starts biases at 0: a
    nonzero one shows its mapping)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        a = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "scale":
            return 1 + np.float32(0.05) * a
        if leaf == "embedding":
            return a
        if leaf == "kernel":   # Dense (in, out); attention: C in or out
            fan_in = s.shape[0] if len(s.shape) == 2 else cfg.embed_dims
            return a / np.float32(np.sqrt(fan_in))
        return np.float32(0.05) * a
    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_params(cfg, batch, objects, seed=0):
    """A JAX policy's parameter tree (its shapes from ``eval_shape``),
    filled by :func:`fill_params`."""
    obj = (dict(obj_feats=batch["obj_feats"][:1],
                obj_valid=batch["obj_valid"][:1]) if objects else {})
    shapes = jax.eval_shape(
        JVLNPolicy(cfg).init, jax.random.PRNGKey(seed),
        batch["instruction"][:1], batch["instruction"][:1] > 0,
        batch["volume"][:1], jax.tree.map(lambda x: x[:1], batch["memory"]),
        batch["cur_pos"][:1], batch["cur_slot"][:1], **obj)
    return fill_params(shapes, cfg, seed)


def port_policy(tcfg, params, objects):
    tp = VLNPolicy(tcfg, grounding=objects)
    tp.load_state_dict(policy_state_dict_from_jax(params, tcfg), strict=True)
    return tp


def assert_grads_match(model, jgrads, what):
    for name, g in grads_by_name(model).items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{what}: {name}")


def _cfgs(arch):
    kw = dict(KW, text_arch=arch, fusion_arch=arch)
    return JPolicyConfig(**kw), PolicyConfig(**kw)


@pytest.mark.parametrize("arch", ["preln", "bert"])
def test_imitation_loss_and_grads_match_jax(records, arch):
    check_imitation_against_jax(records, arch, state_targets=False)


def test_imitation_loss_with_state_targets_matches_jax(r2r_records):
    check_imitation_against_jax(r2r_records, "preln", state_targets=True)


def check_imitation_against_jax(records, arch, state_targets):
    objects, jrecs, recs = records
    jcfg, tcfg = _cfgs(arch)
    jbatch, batch = jstack(jrecs[:8]), stack_records(recs[:8])
    params = jax_params(jcfg, jbatch, objects)
    targets = (np.random.default_rng(5).standard_normal((8, 5)).astype(
        np.float32) if state_targets else None)

    (jtotal, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jimitation_loss(JVLNPolicy(jcfg), p, jbatch, targets),
        has_aux=True))(params)
    tp = port_policy(tcfg, params, objects)
    total, parts = imitation_step_loss(
        tp, batch, None if targets is None else torch.from_numpy(targets))
    total.backward()

    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=LOSS_RTOL)
    for k, v in parts.items():
        np.testing.assert_allclose(float(v), float(jparts[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert (float(parts["ground_nll"]) > 0) == objects
    assert (float(parts["state_mse"]) > 0) == state_targets
    assert_grads_match(tp, policy_state_dict_from_jax(jgrads, tcfg),
                       f"{arch} objects={objects}")


def test_update_trajectory_matches_jax(r2r_records):
    """Eight updates of clip 40 + AdamW on fixed batches of JAX's records:
    JAX's optax chain against the port's update."""
    objects, jrecs, recs = r2r_records
    jcfg, tcfg = _cfgs("preln")
    lr, n = 1e-3, 8
    # overlapping windows of 8 records over the episodes' steps
    starts = [(3 * i) % (len(jrecs) - 8) for i in range(n)]
    params = jax_params(jcfg, jstack(jrecs[:8]), objects)

    jpol = JVLNPolicy(jcfg)
    tx = optax.chain(optax.clip_by_global_norm(40.0), optax.adamw(lr))
    opt_state = tx.init(params)

    @jax.jit
    def jupdate(p, o, batch):
        (loss, _), g = jax.value_and_grad(
            lambda q: jimitation_loss(jpol, q, batch), has_aux=True)(p)
        ups, o2 = tx.update(g, o, p)
        return optax.apply_updates(p, ups), o2, loss

    jp, jlosses = params, []
    for s in starts:
        jp, opt_state, loss = jupdate(jp, opt_state, jstack(jrecs[s:s + 8]))
        jlosses.append(float(loss))

    tp = port_policy(tcfg, params, objects)
    init = {k: v.clone() for k, v in tp.state_dict().items()}
    state = make_train_state(tp, lr)
    losses = []
    for s in starts:
        batch = stack_records(recs[s:s + 8])
        loss, _, _ = update(state, lambda: imitation_step_loss(tp, batch))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=2e-4)
    final_jax = policy_state_dict_from_jax(jax.device_get(jp), tcfg)
    rel, worst = drift_rel_l2(init, tp.state_dict(), final_jax, exclude=())
    assert rel < 0.025, (rel, worst)


def test_records_and_batches_equal_jax(records):
    objects, jrecs, recs = records
    assert len(recs) == len(jrecs) > 8
    for a, b in zip(recs, jrecs):
        assert a["teacher"] == b["teacher"]
        assert a["obs"].keys() == b["obs"].keys()
        for k in a["obs"]:
            np.testing.assert_array_equal(np.asarray(a["obs"][k]),
                                          np.asarray(b["obs"][k]), err_msg=k)
        for x, y in zip(a["memory"], b["memory"]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    batch, jbatch = stack_records(recs[:11]), jstack(jrecs[:11])
    assert batch.keys() == jbatch.keys()
    assert ("gt_obj" in batch) == objects
    for k in batch:
        leaves = (zip(batch[k], jbatch[k]) if k == "memory"
                  else [(batch[k], jbatch[k])])
        for got, want in leaves:
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype, k
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)


def _one_hot_attention(b=3, lq=64, lk=8, heads=4, rate=0.1):
    """An attention whose output is its weights: zero query and key
    projections (uniform weights 1/lk), identity value and output
    projections, and key i the one-hot e_i in every head's channels."""
    d = lk
    attn = MultiHeadAttention(heads * d, heads, dropout_rate=rate)
    with torch.no_grad():
        for lin in (attn.query, attn.key, attn.value, attn.out):
            lin.bias.zero_()
            lin.weight.zero_()
        attn.value.weight.copy_(torch.eye(heads * d))
        attn.out.weight.copy_(torch.eye(heads * d))
    keys = torch.eye(d).repeat(1, heads)[None].expand(b, -1, -1)
    q = torch.zeros(b, lq, heads * d)

    def weights():
        with torch.no_grad():
            y = attn(q, keys)
        return y.view(b, lq, heads, d).permute(0, 2, 1, 3)  # (B, h, Lq, Lk)
    return attn, weights


def test_attention_dropout_is_one_mask_shared_by_batch_and_heads():
    attn, weights = _one_hot_attention()
    attn.eval()
    torch.testing.assert_close(weights(), torch.full((3, 4, 64, 8), 1 / 8))
    attn.train()
    torch.manual_seed(0)
    kept = []
    for _ in range(20):
        w = weights()
        # one (Lq, Lk) mask for every batch row and head
        assert torch.equal(w, w[:1, :1].expand_as(w))
        # every weight dropped, or kept and scaled by 1 / keep
        kept_w = w[w > 0]
        torch.testing.assert_close(kept_w, torch.full_like(kept_w,
                                                           1 / 8 / 0.9))
        kept.append(float((w[0, 0] > 0).float().mean()))
    assert abs(np.mean(kept) - 0.9) < 0.01, np.mean(kept)


@pytest.mark.parametrize("arch", ["preln", "bert"])
def test_policy_dropout_train_and_eval(records, arch):
    objects, _, recs = records
    tcfg = PolicyConfig(**dict(KW, text_arch=arch, fusion_arch=arch))
    off = dataclasses.replace(tcfg, dropout_rate=0.0)
    from vln_ver_tpu_torch.agent.policy import build_policy
    pol = build_policy(tcfg, "cpu", seed=1, grounding=objects)
    ref = build_policy(off, "cpu", seed=1, grounding=objects).train()
    batch = stack_records(recs[:8])
    args = (batch["instruction"], batch["instruction"] > 0, batch["volume"],
            batch["memory"], batch["cur_pos"], batch["cur_slot"])
    with torch.no_grad():
        # eval(): the identity, whatever the rate
        assert torch.equal(pol.eval()(*args).logits, ref(*args).logits)
        torch.manual_seed(1)
        a = pol.train()(*args).logits
        b = pol(*args).logits
    assert not torch.equal(a, b)
    assert torch.isfinite(a).all()
    # the imitation loss runs dropout off in either mode, and puts the
    # mode back
    la, _ = imitation_step_loss(pol, batch)
    assert pol.training
    lb, _ = imitation_step_loss(pol.eval(), batch)
    assert not pol.training
    assert float(la) == float(lb)


def test_update_is_optax_clip_40_and_adamw_decay_on_every_parameter():
    from vln_ver_tpu_torch.agent import update as upd
    model = torch.nn.Linear(3, 2)
    state = upd.make_train_state(model, 1e-3)
    group = state.optimizer.param_groups[0]
    assert group["weight_decay"] == 1e-4 == upd.WEIGHT_DECAY
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert len(group["params"]) == 2 and len(state.optimizer.param_groups) == 1
    assert state.tc.grad_clip_norm == 40.0
    assert {state.schedule(s) for s in (0, 1, 10 ** 6)} == {
        float(np.float32(1e-3))}
    # one update against optax's on the same gradient (clipped: norm > 40)
    w0 = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.full((4, 3), 30.0)
    loss, _, gnorm = upd.update(state, lambda: (
        (model(x) ** 2).sum(), {}))
    assert float(gnorm) > 40
    p = {k: v.numpy() for k, v in w0.items()}
    g = jax.grad(lambda q: jnp.sum((x.numpy() @ q["weight"].T
                                    + q["bias"]) ** 2))(p)
    tx = optax.chain(optax.clip_by_global_norm(40.0), optax.adamw(1e-3))
    ups, _ = tx.update(g, tx.init(p), p)
    want = optax.apply_updates(p, ups)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
