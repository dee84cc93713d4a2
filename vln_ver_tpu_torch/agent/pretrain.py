"""VLN pretraining: DUET-lineage proxy tasks over offline episodes (PyTorch
port of ``vln_ver_tpu/agent/pretrain.py``).

Before imitation / DAgger training the cross-modal stack is trained on
offline instruction-path data with proxy objectives, all with equal
weights:

* **MLM** — masked language modelling on instructions, vision-conditioned:
  the masked instruction runs through the shared text encoder, the current
  viewpoint's VER volume through the shared tokenizer and local fusion
  blocks, and a pretrain-only cross-attention and head predict the masked
  tokens from the fused volume tokens (the head is dropped at finetune).
* **SAP** — single-step action prediction: the full policy predicts the
  teacher's next action on offline teacher trajectories.
* **OG** — object grounding (REVERIE), where the batch has ``gt_obj``.
* **VSE** — volume state estimation, where the batch has state targets.

:class:`VLNPretrainModel` holds the actual :class:`VLNPolicy` under the
name ``policy``, so the ``policy.`` subtree of its state dict loads into
the finetuning policy (:func:`extract_policy_params`,
``train_vln --init-from-pretrain``).  Pretraining runs the model in
``train()``, with dropout, as JAX's ``pretrain_loss`` runs with
``deterministic=False``.

Offline data: teacher-driven traces (no policy involved) from
:func:`collect_teacher_trace`, batched and uploaded by
:func:`stack_records`, the one batch contract of both trainers.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Dense, LayerNorm
from .attention import MultiHeadAttention
from .env import R2REnv
from .memory import EpisodicMemory, memory_from_arrays
from .policy import (PolicyConfig, VLNPolicy, masked_grounding_ce,
                     random_state_dict)


def mask_tokens(generator: torch.Generator, tokens: torch.Tensor,
                vocab_size: int, mask_id: int = 1, mask_prob: float = 0.15,
                special_ids: tuple = ()):
    """BERT-recipe masking: of the ``mask_prob`` selected positions, 80 %
    become ``mask_id``, 10 % a random id in ``[2, vocab_size)`` and 10 %
    stay as they are; the draws come from ``generator`` (on the tokens'
    device).

    Returns (masked_tokens, targets, target_mask).  Pad (token 0) and any
    ``special_ids`` ([CLS] / [SEP] with a WordPiece vocab) are never
    selected; ``targets`` is ``tokens``, supervised only where
    ``target_mask``."""
    shape, dev = tokens.shape, tokens.device
    is_real = tokens > 0
    for sid in special_ids:
        is_real &= tokens != sid
    sel = (torch.rand(shape, generator=generator, device=dev)
           < mask_prob) & is_real
    op = torch.rand(shape, generator=generator, device=dev)
    rand_tok = torch.randint(2, vocab_size, shape, generator=generator,
                             device=dev, dtype=tokens.dtype)
    masked = torch.where(sel & (op < 0.8), mask_id, tokens)
    masked = torch.where(sel & (op >= 0.8) & (op < 0.9), rand_tok, masked)
    return masked, tokens, sel


class VLNPretrainModel(nn.Module):
    """The policy plus the pretrain-only MLM head, under flax's names."""

    def __init__(self, cfg: PolicyConfig, grounding: bool = False):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.embed_dims, cfg.dtype
        self.policy = VLNPolicy(cfg, grounding=grounding)
        # text attends the fused volume tokens, then a BERT-style
        # transform head predicts the vocabulary
        self.mlm_cross = MultiHeadAttention(c, cfg.num_heads, dt,
                                            cfg.dropout_rate)
        self.mlm_ln = LayerNorm(c, dt)
        self.mlm_dense = Dense(c, c, dt)
        self.mlm_ln2 = LayerNorm(c, dt)
        self.mlm_out = Dense(c, cfg.vocab_size, torch.float32)

    def mlm_logits(self, masked_tokens, text_mask, volume,
                   vol_tokens=None) -> torch.Tensor:
        """(B, L, vocab) vision-conditioned MLM prediction, in fp32."""
        x_loc, text_feats, _ = self.policy.local_fusion(
            masked_tokens, text_mask, volume, vol_tokens=vol_tokens)
        h = self.mlm_ln(text_feats + self.mlm_cross(text_feats, x_loc))
        # flax's nn.gelu: the tanh approximation
        h = self.mlm_ln2(F.gelu(self.mlm_dense(h), approximate="tanh"))
        return self.mlm_out(h)

    def forward(self, batch: Dict, masked_tokens, mlm_targets,
                mlm_mask) -> Dict[str, torch.Tensor]:
        """Every proxy loss of one offline decision-step batch
        (:func:`stack_records`; ``state_targets`` (B, 5) optional)."""
        text_mask = batch["instruction"] > 0
        obj_kw = {}
        if "obj_feats" in batch:
            obj_kw = dict(obj_feats=batch["obj_feats"],
                          obj_valid=batch["obj_valid"])
        # the volume's tokens do not depend on the text: computed once for
        # the SAP pass (clean text) and the MLM pass (masked text)
        vol_tokens = self.policy.tokenize_volume(batch["volume"])
        out = self.policy(batch["instruction"], text_mask, batch["volume"],
                          batch["memory"], batch["cur_pos"],
                          batch["cur_slot"], vol_tokens=vol_tokens,
                          **obj_kw)
        logp = torch.log_softmax(out.logits, dim=-1)
        sap = -torch.gather(logp, 1,
                            batch["teacher"].long()[:, None]).mean()

        logits = self.mlm_logits(masked_tokens, text_mask, batch["volume"],
                                 vol_tokens=vol_tokens)
        lp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(lp, -1, mlm_targets.long()[..., None])[..., 0]
        mlm = (torch.where(mlm_mask, nll, 0.0).sum()
               / mlm_mask.sum().clamp(min=1))

        losses = dict(sap=sap, mlm=mlm)
        if out.obj_logits is not None and "gt_obj" in batch:
            losses["og"] = masked_grounding_ce(out.obj_logits,
                                               batch["gt_obj"])
        if "state_targets" in batch:
            losses["vse"] = torch.mean(
                (out.state_pred - batch["state_targets"]) ** 2)
        return losses


def pretrain_loss(model: VLNPretrainModel, batch: Dict,
                  generator: torch.Generator, mask_id: int = 1,
                  special_ids: tuple = ()):
    """Total pretraining loss (equal task weights, DUET-style) and its
    parts; the instruction is masked with draws from ``generator``, and
    dropout follows the model's mode (``train()`` in ``pretrain_vln``)."""
    masked, targets, sel = mask_tokens(generator, batch["instruction"],
                                       model.cfg.vocab_size,
                                       mask_id=mask_id,
                                       special_ids=special_ids)
    losses = model(batch, masked, targets, sel)
    return sum(losses.values()), losses


def collect_teacher_trace(env: R2REnv, ep_idx: int,
                          cfg: PolicyConfig) -> List[Dict]:
    """Offline teacher trajectory: records shaped as
    ``rollout.run_episode(collect_teacher=True)`` traces, stepping with the
    teacher's action (no policy involved; the episodic memory is a
    function of the environment's state), the memory kept on the host."""
    state = env.reset(ep_idx)
    trace: List[Dict] = []
    while not state["done"]:
        obs = env.observe(state)
        mem = memory_from_arrays([env.memory_arrays(state)], host=True)
        teacher = env.teacher_action(state)
        trace.append(dict(obs=obs, teacher=teacher, memory=mem))
        env.step(state, teacher)
    return trace


def stack_records(recs: List[Dict], device="cpu") -> Dict:
    """Stack per-step records into one batch on the host and upload it to
    ``device``, one copy a leaf: the batch contract of both trainers."""
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    obs0 = recs[0]["obs"]
    batch = dict(
        instruction=up(np.stack([r["obs"]["instruction"] for r in recs])),
        volume=up(np.stack([r["obs"]["volume"] for r in recs])),
        memory=EpisodicMemory(*[up(np.concatenate(leaves, axis=0))
                                for leaves in zip(*[r["memory"]
                                                    for r in recs])]),
        cur_pos=up(np.stack([r["obs"]["cur_pos"] for r in recs])),
        cur_slot=up(np.asarray([r["obs"]["cur_slot"] for r in recs],
                               np.int32)),
        teacher=up(np.asarray([r["teacher"] for r in recs], np.int32)))
    if "obj_feats" in obs0:
        batch["obj_feats"] = up(np.stack([r["obs"]["obj_feats"]
                                          for r in recs]))
        batch["obj_valid"] = up(np.stack([r["obs"]["obj_valid"]
                                          for r in recs]))
        batch["gt_obj"] = up(np.asarray([r["obs"]["gt_obj"] for r in recs],
                                        np.int32))
    return batch


def init_pretrain_params(model: VLNPretrainModel,
                         seed: int) -> VLNPretrainModel:
    """Load random weights from ``np.random.default_rng(seed)``
    (``policy.random_state_dict``'s distributions) into ``model``,
    strictly; returns it."""
    model.load_state_dict(random_state_dict(model, seed), strict=True)
    return model


def extract_policy_params(state_dict: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """A :class:`VLNPretrainModel` state dict -> the ``VLNPolicy`` state
    dict for finetuning (the pretrain-only MLM head is dropped, as DUET
    does)."""
    return {k[len("policy."):]: v for k, v in state_dict.items()
            if k.startswith("policy.")}
