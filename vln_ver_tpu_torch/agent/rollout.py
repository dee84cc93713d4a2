"""Episode rollouts, greedy and sampled, and the imitation loss (PyTorch
port of ``vln_ver_tpu/agent/rollout.py``).

Graph stepping stays on the host; each decision step makes one host build
of the episodic memory, one upload and one policy call on the policy's
device, under ``torch.inference_mode()``.  The module is called as it is:
no compile step and no cache of compiled steps.

Greedy rollouts take the first largest logit, on the host, as the JAX
package does.  Sampled rollouts draw from ``softmax(logits)`` with an
explicit ``torch.Generator``; ``jax.random`` draws cannot be matched, so
they are held by distribution, not draw for draw.

``times``, where given, is a dict that gathers host seconds per stage of
the rollout loop: ``"env"`` (reset, observe, teacher, step, metrics),
``"memory"`` (``env.memory_arrays``), ``"upload"`` (stacking the batch and
copying it to the device), ``"policy"`` (the call and the copy of its
logits back, which waits for the device), and counts ``"policy_calls"``
and ``"decisions"`` (the actions taken by episodes still running).

:func:`imitation_step_loss` is the DAgger trainer's objective
(``train_vln.py``): the rollouts collect teacher traces under inference
mode, ``pretrain.stack_records`` stacks and uploads them, and the loss runs
the policy on that batch with gradients and with dropout off.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..parallel.mesh import global_mean
from ..parallel.multihost import allgather_objects, shard_indices
from .env import R2REnv
from .memory import memory_from_arrays
from .policy import (PolicyConfig, VLNPolicy, dropout_off,
                     masked_grounding_ce)

_POLICY_KEYS = ("instruction", "volume", "cur_pos", "cur_slot", "obj_feats",
                "obj_valid")


def _tick(times: Optional[Dict], key: str, t0: float) -> float:
    """Add the host seconds since ``t0`` to ``times[key]``; returns now."""
    now = time.perf_counter()
    if times is not None:
        times[key] = times.get(key, 0.0) + now - t0
    return now


def _count(times: Optional[Dict], key: str, n: int) -> None:
    if times is not None:
        times[key] = times.get(key, 0) + n


def _policy_step(policy: VLNPolicy, obs_rows: List[Dict], arrs_rows,
                 text_feats, times, t0):
    """Upload one step's batch and call the policy; returns (output,
    host logits, time stamp)."""
    device = next(policy.parameters()).device
    b = {k: torch.from_numpy(np.stack([o[k] for o in obs_rows])).to(device)
         for k in _POLICY_KEYS if k in obs_rows[0]}
    mem = memory_from_arrays(arrs_rows, device=device)
    t0 = _tick(times, "upload", t0)
    obj_kw = {}
    if "obj_feats" in b:
        obj_kw = dict(obj_feats=b["obj_feats"], obj_valid=b["obj_valid"])
    out = policy(b["instruction"], b["instruction"] > 0, b["volume"], mem,
                 b["cur_pos"], b["cur_slot"], text_feats=text_feats,
                 **obj_kw)
    logits = out.logits.float().cpu().numpy()
    _count(times, "policy_calls", 1)
    return out, logits, _tick(times, "policy", t0)


def _sample(logits: torch.Tensor, generator: torch.Generator) -> np.ndarray:
    """One action per row from softmax(logits), drawn with ``generator``
    on its device; masked actions (-1e9) have probability 0."""
    probs = torch.softmax(logits.float().to(generator.device), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].cpu(
        ).numpy()


def _ground(env: R2REnv, state: Dict, obj_logits_row) -> None:
    """REVERIE: ground the referred object at the stop viewpoint."""
    pred = int(np.argmax(obj_logits_row))
    token = f"{state['ep']['scan']}_{state['cur']}"
    entry = (env.objects or {}).get(token)
    if entry is not None and pred < len(entry["ids"]):
        state["pred_obj_id"] = entry["ids"][pred]


@torch.inference_mode()
def run_episode(policy: VLNPolicy, env: R2REnv, ep_idx: int,
                cfg: PolicyConfig, greedy: bool = True,
                generator: Optional[torch.Generator] = None,
                collect_teacher: bool = False,
                times: Optional[Dict] = None):
    """Roll one episode; returns (metrics, trace) where trace holds per-step
    (obs, teacher action, host memory) when ``collect_teacher``."""
    if not greedy and generator is None:
        raise ValueError("sampled rollout (greedy=False) requires a "
                         "torch.Generator")
    t = time.perf_counter()
    state = env.reset(ep_idx)
    text_feats = None
    trace: List[Dict] = []
    while not state["done"]:
        obs = env.observe(state)
        t = _tick(times, "env", t)
        # memory = pure function of env state (visited nodes carry pooled
        # VER, frontiers are position-only): correct under slot recycling
        arrs = env.memory_arrays(state)
        t = _tick(times, "memory", t)
        out, logits, t = _policy_step(policy, [obs], [arrs], text_feats,
                                      times, t)
        text_feats = out.text_feats
        if collect_teacher:
            trace.append(dict(obs=obs, teacher=env.teacher_action(state),
                              memory=memory_from_arrays([arrs], host=True)))
        action = (int(np.argmax(logits[0])) if greedy
                  else int(_sample(out.logits, generator)[0]))
        if action == 0 and out.obj_logits is not None:
            _ground(env, state, out.obj_logits[0].float().cpu().numpy())
        env.step(state, action)
        _count(times, "decisions", 1)
    metrics = env.metrics(state)
    _tick(times, "env", t)
    return metrics, trace


@torch.inference_mode()
def run_episodes_batched(policy: VLNPolicy, env: R2REnv, ep_idxs,
                         cfg: PolicyConfig, greedy: bool = True,
                         generator: Optional[torch.Generator] = None,
                         collect_teacher: bool = False,
                         times: Optional[Dict] = None):
    """Lockstep-batched rollouts: one policy call per step for B episodes
    (the policy is row-independent, so per-episode results match
    :func:`run_episode`'s).

    Graph stepping stays host-side per episode; finished episodes are
    frozen (their rows still flow through the batch with their last
    observation, outputs ignored).  The instruction features of the first
    step are passed back in at every later step.  Returns (metrics_list,
    traces_list) parallel to ``ep_idxs``."""
    if not greedy and generator is None:
        raise ValueError("sampled rollout (greedy=False) requires a "
                         "torch.Generator")
    t = time.perf_counter()
    states = [env.reset(i) for i in ep_idxs]
    text_feats = None
    traces = [[] for _ in ep_idxs]
    last_obs = [env.observe(s) for s in states]
    while not all(s["done"] for s in states):
        active = [not s["done"] for s in states]
        obs = [env.observe(s) if a else o
               for s, a, o in zip(states, active, last_obs)]
        last_obs = obs
        t = _tick(times, "env", t)
        # finished episodes rebuild from their frozen final state —
        # identical rows, outputs ignored
        batch_arrs = [env.memory_arrays(s) for s in states]
        t = _tick(times, "memory", t)
        out, logits, t = _policy_step(policy, obs, batch_arrs, text_feats,
                                      times, t)
        text_feats = out.text_feats
        sampled = None if greedy else _sample(out.logits, generator)
        obj_logits = (None if out.obj_logits is None
                      else out.obj_logits.float().cpu().numpy())
        for i, s in enumerate(states):
            if not active[i]:
                continue
            if collect_teacher:
                traces[i].append(dict(
                    obs=obs[i], teacher=env.teacher_action(s),
                    memory=memory_from_arrays([batch_arrs[i]], host=True)))
            action = (int(np.argmax(logits[i])) if greedy
                      else int(sampled[i]))
            if action == 0 and obj_logits is not None:
                _ground(env, s, obj_logits[i])
            env.step(s, action)
        _count(times, "decisions", sum(active))
    metrics = [env.metrics(s) for s in states]
    _tick(times, "env", t)
    return metrics, traces


def episode_metrics(policy: VLNPolicy, env: R2REnv, cfg: PolicyConfig,
                    limit: Optional[int] = None,
                    batch_size: Optional[int] = None,
                    times: Optional[Dict] = None,
                    mesh=None) -> List[Dict[str, float]]:
    """Per-episode greedy metrics of the first ``limit`` episodes: one
    episode at a time, or lockstep batches of ``batch_size``, the short
    final batch padded by repeating its last episode (padding rows'
    metrics are dropped).

    With ``mesh`` (an ``(N, 1)`` ``parallel.mesh.Mesh``; every rank calls
    this) the ranks split the episodes in contiguous blocks, each running
    lockstep batches of ``batch_size / N`` over its block, and every rank
    gets every episode's metrics, in episode order."""
    n = min(len(env.episodes), limit or len(env.episodes))
    episodes = range(n)
    if mesh is not None:
        if batch_size is None or batch_size % mesh.data_size:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"mesh size {mesh.data_size}")
        batch_size //= mesh.data_size
        episodes = shard_indices(n, mesh.data_index, mesh.data_size)
    if batch_size is None:
        out = [run_episode(policy, env, i, cfg, greedy=True,
                           times=times)[0] for i in episodes]
    else:
        out = []
        for lo in range(0, len(episodes), batch_size):
            idxs = list(episodes[lo:lo + batch_size])
            real = len(idxs)
            idxs += [idxs[-1]] * (batch_size - real)
            metrics, _ = run_episodes_batched(policy, env, idxs, cfg,
                                              greedy=True, times=times)
            out.extend(metrics[:real])
    if mesh is not None:
        out = [m for part in allgather_objects(out, mesh.data_group)
               for m in part]
    return out


def mean_metrics(per_episode: List[Dict[str, float]]) -> Dict[str, float]:
    """Sums in episode order over the episodes that have each key, divided
    by the number of episodes (the JAX package's aggregation)."""
    agg: Dict[str, float] = {}
    for m in per_episode:
        for k, v in m.items():
            agg[k] = agg.get(k, 0.0) + v
    return {k: v / len(per_episode) for k, v in agg.items()}


def evaluate(policy: VLNPolicy, env: R2REnv, cfg: PolicyConfig,
             limit: Optional[int] = None,
             times: Optional[Dict] = None) -> Dict[str, float]:
    """Mean greedy metrics, one episode at a time."""
    return mean_metrics(episode_metrics(policy, env, cfg, limit,
                                        times=times))


def evaluate_batched(policy: VLNPolicy, env: R2REnv, cfg: PolicyConfig,
                     limit: Optional[int] = None, batch_size: int = 8,
                     mesh=None,
                     times: Optional[Dict] = None) -> Dict[str, float]:
    """:func:`evaluate` through lockstep batches of ``batch_size``
    episodes, split over ``mesh``'s ranks where given
    (:func:`episode_metrics`); per-episode metrics are :func:`evaluate`'s."""
    return mean_metrics(episode_metrics(policy, env, cfg, limit,
                                        batch_size=batch_size, times=times,
                                        mesh=mesh))


def imitation_step_loss(policy: VLNPolicy, batch: Dict,
                        state_targets: Optional[torch.Tensor] = None):
    """Cross-entropy to the teacher actions of one decision-step batch
    (``pretrain.stack_records``: instruction (B, L), volume (B, nvox, C),
    memory, cur_pos (B, 3), cur_slot (B,), teacher (B,), and obj_feats /
    obj_valid / gt_obj with REVERIE objects), plus 0.5 x the volume-state
    MSE against ``state_targets`` (B, 5) where given, plus the grounding
    cross-entropy where the batch has ``gt_obj``.  Returns (total, parts).

    The policy runs with dropout off whatever its mode, as the JAX
    package's ``policy.apply`` does with no ``deterministic=False``;
    gradients flow."""
    obj_kw = {}
    if "obj_feats" in batch:
        obj_kw = dict(obj_feats=batch["obj_feats"],
                      obj_valid=batch["obj_valid"])
    with dropout_off(policy):
        out = policy(batch["instruction"], batch["instruction"] > 0,
                     batch["volume"], batch["memory"], batch["cur_pos"],
                     batch["cur_slot"], **obj_kw)
    logp = torch.log_softmax(out.logits, dim=-1)
    # means over the global batch under a data-parallel update
    teacher_logp = torch.gather(logp, 1, batch["teacher"].long()[:, None])
    nll = global_mean(-teacher_logp.sum(), teacher_logp.numel())
    zero = nll.new_zeros(())
    aux = (zero if state_targets is None else global_mean(
        ((out.state_pred - state_targets) ** 2).sum(), state_targets.numel()))
    ground = zero
    if out.obj_logits is not None and "gt_obj" in batch:
        ground = masked_grounding_ce(out.obj_logits, batch["gt_obj"])
    return (nll + 0.5 * aux + ground,
            dict(action_nll=nll, state_mse=aux, ground_nll=ground))
