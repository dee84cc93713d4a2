"""Dual-scale cross-modal VLN policy over VER volumes (PyTorch port of
``vln_ver_tpu/agent/policy.py``).

A *local* branch grounds the instruction in the current viewpoint's VER
volume (fine-grained 3D context + volume state estimation); a *global*
branch scores the episodic-memory nodes (topological map) for the next
action.  The action space is {stop} ∪ {memory nodes}, masked by validity —
DUET's global action space.  Every shape is static.

Module and parameter names are the flax ones, so the JAX parameters map one
to one (:func:`vln_ver_tpu_torch.convert.policy_state_dict_from_jax`), and
the port follows flax's lazy parameters: the JAX module declares a
``fuse_gate`` it never calls, so its tree has none and neither has this
module; ``ground_proj`` exists only in a policy built with
``grounding=True``, the counterpart of a JAX policy initialised with
``obj_feats`` (REVERIE).

Dropout sits at the JAX module's places and rate (``dropout_rate``, 0.1):
active in ``train()``, the identity in ``eval()``.  Attention drops its
weights with one mask shared across batch and heads (flax's
``broadcast_dropout``, ``attention.py``); a ``bert`` fusion block drops
each of its three sublayers' outputs before its post-LN, a ``preln`` one
only its FFN's output.  Evaluation and the imitation update run the
policy with dropout off, as JAX's ``policy.apply`` does by default;
pretraining runs it on (``pretrain.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Dense, Dropout, LayerNorm
from ..parallel.mesh import global_mean
from .attention import MultiHeadAttention
from .memory import EpisodicMemory
from .text import TextEncoder
from .ver import VERTokenizer, VolumeStateHead

MASKED_LOGIT = -1e9


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    embed_dims: int = 768
    num_heads: int = 8
    fusion_layers: int = 4
    text_layers: int = 4
    ffn_dim: int = 1536
    vocab_size: int = 4000
    max_text_len: int = 80
    max_nodes: int = 32
    bev_z: int = 4
    bev_h: int = 15
    bev_w: int = 15
    num_query_tokens: int = 8
    dropout_rate: float = 0.1
    dtype: torch.dtype = torch.float32
    # "preln" trains from scratch; "bert" matches HF BertModel's layout
    text_arch: str = "preln"
    # the text branch's FFN width; None = ffn_dim
    text_ffn_dim: Optional[int] = None
    # fusion blocks: "preln" (self -> cross -> ffn, pre-LN) or "bert", the
    # LXMERT/DUET cross-modal x-layer (cross -> self -> ffn, post-LN)
    fusion_arch: str = "preln"


class PolicyOutput(NamedTuple):
    logits: torch.Tensor       # (B, 1 + max_nodes): [stop, nodes...]
    state_pred: torch.Tensor   # (B, 5) volume state estimation
    text_feats: torch.Tensor   # (B, L, C) (reusable across steps)
    # REVERIE object grounding scores (B, max_objects); None when the
    # step was called without candidate objects
    obj_logits: Optional[torch.Tensor] = None


class _FusionBlock(nn.Module):
    def __init__(self, cfg: PolicyConfig):
        super().__init__()
        if cfg.fusion_arch not in ("preln", "bert"):
            raise ValueError(f"fusion arch {cfg.fusion_arch!r}: 'preln' or "
                             "'bert'")
        c, dt, p = cfg.embed_dims, cfg.dtype, cfg.dropout_rate
        self.arch = cfg.fusion_arch
        self.self_attn = MultiHeadAttention(c, cfg.num_heads, dt, p)
        self.cross_attn = MultiHeadAttention(c, cfg.num_heads, dt, p)
        self.ln_sa = LayerNorm(c, dt)
        self.ln_ca = LayerNorm(c, dt)
        self.ln_ffn = LayerNorm(c, dt)
        self.fc1 = Dense(c, cfg.ffn_dim, dt)
        self.fc2 = Dense(cfg.ffn_dim, c, dt)
        self.dropout = Dropout(p)

    def forward(self, x, x_mask, text, text_mask):
        # a query row of an invalid node masks every key: flax's min-fill
        # softmax averages it uniformly (attention.py)
        sa_mask = x_mask[:, None, None, :] & x_mask[:, None, :, None]
        ca_mask = text_mask[:, None, None, :]
        drop = self.dropout
        if self.arch == "bert":
            x = self.ln_ca(x + drop(self.cross_attn(x, text, ca_mask)))
            x = self.ln_sa(x + drop(self.self_attn(x, x, sa_mask)))
            y = self.fc2(F.gelu(self.fc1(x)))
            return self.ln_ffn(x + drop(y))
        y = self.ln_sa(x)
        x = x + self.self_attn(y, y, sa_mask)
        x = x + self.cross_attn(self.ln_ca(x), text, ca_mask)
        y = self.fc2(F.gelu(self.fc1(self.ln_ffn(x)), approximate="tanh"))
        return x + drop(y)


class VLNPolicy(nn.Module):
    def __init__(self, cfg: PolicyConfig, grounding: bool = False):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.embed_dims, cfg.dtype
        self.text_encoder = TextEncoder(
            vocab_size=cfg.vocab_size, embed_dims=c,
            num_layers=cfg.text_layers, num_heads=cfg.num_heads,
            ffn_dim=cfg.text_ffn_dim or cfg.ffn_dim,
            max_len=cfg.max_text_len, dropout_rate=cfg.dropout_rate,
            dtype=dt, arch=cfg.text_arch)
        self.ver_tokenizer = VERTokenizer(
            embed_dims=c, bev_z=cfg.bev_z, bev_h=cfg.bev_h,
            bev_w=cfg.bev_w, num_query_tokens=cfg.num_query_tokens,
            dropout_rate=cfg.dropout_rate, dtype=dt)
        self.volume_state_head = VolumeStateHead(c, dt)
        for i in range(cfg.fusion_layers):
            self.add_module(f"local_block_{i}", _FusionBlock(cfg))
        for i in range(cfg.fusion_layers):
            self.add_module(f"global_block_{i}", _FusionBlock(cfg))
        self.stop_token = nn.Parameter(torch.empty(c))
        self.visited_embed = nn.Parameter(torch.empty(2, c))
        self.pos_mlp = Dense(3, c, dt)
        self.local_ctx_proj = Dense(c, c, dt)
        self.score_head = Dense(c, 1, torch.float32)
        if grounding:
            # REVERIE: instruction-conditioned local context scores the
            # candidate objects at the stop viewpoint (RGS metric)
            self.ground_proj = Dense(c, c, dt)

    def _blocks(self, kind: str):
        return [getattr(self, f"{kind}_block_{i}")
                for i in range(self.cfg.fusion_layers)]

    def encode_text(self, tokens, text_mask):
        return self.text_encoder(tokens, text_mask)

    def tokenize_volume(self, volume):
        """VER volume -> (B, T, C) tokens (text-independent)."""
        return self.ver_tokenizer(volume)

    def local_fusion(self, tokens, text_mask, volume,
                     text_feats: Optional[torch.Tensor] = None,
                     vol_tokens: Optional[torch.Tensor] = None):
        """Instruction-grounded VER volume tokens.

        Returns (x_loc (B, T, C) fused volume tokens, text_feats (B, L, C),
        state_pred (B, 5))."""
        if text_feats is None:
            text_feats = self.encode_text(tokens, text_mask)
        local_tokens = (vol_tokens if vol_tokens is not None
                        else self.ver_tokenizer(volume))
        state_pred = self.volume_state_head(local_tokens)
        lmask = torch.ones(local_tokens.shape[:2], dtype=torch.bool,
                           device=local_tokens.device)
        x_loc = local_tokens
        for blk in self._blocks("local"):
            x_loc = blk(x_loc, lmask, text_feats, text_mask)
        return x_loc, text_feats, state_pred

    def forward(self, tokens, text_mask, volume, memory: EpisodicMemory,
                cur_pos, cur_node_idx,
                text_feats: Optional[torch.Tensor] = None,
                vol_tokens: Optional[torch.Tensor] = None,
                obj_feats: Optional[torch.Tensor] = None,
                obj_valid: Optional[torch.Tensor] = None) -> PolicyOutput:
        """One decision step.

        tokens (B, L) int / text_mask (B, L) bool; volume (B, bev_num, C) —
        the current viewpoint's VER; memory — episodic map; cur_pos (B, 3);
        cur_node_idx (B,) slot of the current node; obj_feats
        (B, max_objects, C) + obj_valid (B, max_objects) — candidate
        objects at the current viewpoint (REVERIE grounding).
        """
        cfg = self.cfg
        dt = cfg.dtype
        b = tokens.shape[0]
        # -- local branch: instruction <-> current VER volume
        x_loc, text_feats, state_pred = self.local_fusion(
            tokens, text_mask, volume, text_feats=text_feats,
            vol_tokens=vol_tokens)
        local_ctx = self.local_ctx_proj(x_loc.mean(dim=1))   # (B, C)

        # -- global branch: instruction <-> episodic memory nodes
        rel = memory.positions - cur_pos[:, None, :]
        node_tok = (memory.features.to(dt) + self.pos_mlp(rel.to(dt))
                    + self.visited_embed[memory.visited.long()])
        # the stop token is grounded in the local context (the stop
        # decision depends on the fine-grained volume, not just the map)
        stop = (self.stop_token.to(dt)[None, None, :].expand(b, 1, -1)
                + local_ctx[:, None, :])
        x = torch.cat([stop, node_tok], dim=1)              # (B, 1+N, C)
        xmask = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                      device=x.device), memory.valid], dim=1)
        for blk in self._blocks("global"):
            x = blk(x, xmask, text_feats, text_mask)

        obj_logits = None
        if obj_feats is not None:
            if not hasattr(self, "ground_proj"):
                raise ValueError("obj_feats given to a policy built without "
                                 "grounding=True (no ground_proj)")
            # dot-product grounding: the instruction-grounded local context
            # against each candidate object's feature
            g = self.ground_proj(local_ctx)                   # (B, C)
            obj_logits = torch.einsum("bc,boc->bo", g.float(),
                                      obj_feats.float())
            obj_logits = obj_logits / math.sqrt(float(cfg.embed_dims))
            if obj_valid is not None:
                obj_logits = torch.where(obj_valid, obj_logits, MASKED_LOGIT)

        logits = self.score_head(x).squeeze(-1)              # (B, 1+N) fp32
        # action mask: stop always allowed; nodes must exist and not be the
        # current node (DUET global action space)
        slots = torch.arange(cfg.max_nodes, device=logits.device)
        node_ok = memory.valid & (slots[None, :] != cur_node_idx[:, None])
        ok = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                   device=logits.device), node_ok], dim=1)
        logits = torch.where(ok, logits, MASKED_LOGIT)
        return PolicyOutput(logits, state_pred, text_feats, obj_logits)


def masked_grounding_ce(obj_logits: torch.Tensor,
                        gt_obj: torch.Tensor) -> torch.Tensor:
    """REVERIE grounding cross-entropy averaged over the steps whose
    viewpoint holds the referred object (``gt_obj >= 0``; -1 rows
    contribute nothing)."""
    has = gt_obj >= 0
    glogp = torch.log_softmax(obj_logits, dim=-1)
    picked = torch.gather(glogp, 1, gt_obj.clamp(min=0).long()[:, None])[:, 0]
    # over the global batch's grounded steps under a data-parallel update
    return global_mean(-torch.where(has, picked, 0.0).sum(), has.sum())


@contextlib.contextmanager
def dropout_off(module: nn.Module):
    """Run the block with ``module`` in ``eval()`` (dropout off; autograd
    untouched), then put back the mode it had."""
    was = module.training
    module.eval()
    try:
        yield module
    finally:
        module.train(was)


def random_state_dict(policy: nn.Module,
                      seed: int) -> Dict[str, torch.Tensor]:
    """Random weights for ``policy`` (a :class:`VLNPolicy`, or a module
    built of the same kinds of layers, such as
    ``pretrain.VLNPretrainModel``) from ``np.random.default_rng(seed)``,
    in ``state_dict`` order: LayerNorm scales 1 and biases 0 (flax's
    init), Dense kernels normal with variance 1/fan_in and biases normal
    with std 0.02, the token table normal with std 1 (flax ``nn.Embed``),
    every other parameter normal with std 0.02."""
    rng = np.random.default_rng(seed)
    kinds = {}
    for mname, mod in policy.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            kinds[f"{mname}.{pname}" if mname else pname] = (type(mod), pname)
    out = {}
    for name, p in policy.state_dict().items():
        kind, pname = kinds[name]
        shape = tuple(p.shape)
        if issubclass(kind, nn.LayerNorm):
            arr = (np.ones if pname == "weight" else np.zeros)(shape,
                                                               np.float32)
        else:
            std = 0.02
            if issubclass(kind, Dense) and pname == "weight":
                std = 1.0 / math.sqrt(shape[1])
            elif issubclass(kind, nn.Embedding):
                std = 1.0
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(
                std)
        out[name] = torch.from_numpy(arr)
    return out


def build_policy(cfg: PolicyConfig, device="cuda", seed: int = 0,
                 grounding: bool = False) -> VLNPolicy:
    """A policy with :func:`random_state_dict` weights from ``seed``, drawn
    on the host (one seed gives the same weights on every device), loaded
    strictly through ``load_state_dict`` and moved to ``device``, in eval
    mode."""
    policy = VLNPolicy(cfg, grounding=grounding)
    policy.load_state_dict(random_state_dict(policy, seed), strict=True)
    return policy.to(device).eval()
