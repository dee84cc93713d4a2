"""Input augmentation: GridMask on the ViT patch grid (PyTorch port of
``vln_ver_tpu/augment.py``).

The reference wires image-space GridMask (models/utils/grid_mask.py:70-124,
use_grid_mask=True) into its (bypassed) backbone.  With precomputed patch
features the analog masks the 14 x 14 patch grid directly: a random-phase
stripe grid zeroes about (1 - ratio)^2 of the patches, with probability
``prob`` per sample.
"""

from __future__ import annotations

import torch


def grid_mask_features(generator: torch.Generator, features: torch.Tensor,
                       ratio: float = 0.5, prob: float = 0.7,
                       max_period: int = 8) -> torch.Tensor:
    """features (B, cams, H, W, C) -> the same with masked patches zeroed.

    Per sample, drawn from ``generator`` (on the CPU, then moved to the
    features' device): whether to mask (probability ``prob``), a period
    ``d`` uniform in [2, max_period], and phases ``ox``, ``oy`` uniform
    over [0, d) (:func:`grid_mask_from_draws` builds the mask).  The draws
    are not ``jax.random``'s; the distributions are."""
    b = features.shape[0]
    apply = torch.rand(b, generator=generator) < prob
    d = torch.randint(2, max_period + 1, (b,), generator=generator)
    ox = torch.floor(torch.rand(b, generator=generator) * d).long()
    oy = torch.floor(torch.rand(b, generator=generator) * d).long()
    dev = features.device
    return grid_mask_from_draws(features, apply.to(dev), d.to(dev),
                                ox.to(dev), oy.to(dev), ratio)


def grid_mask_from_draws(features: torch.Tensor, apply: torch.Tensor,
                         d: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                         ratio: float = 0.5) -> torch.Tensor:
    """The mask for given draws, each (B,): ``apply`` (bool), the period
    ``d``, the phases ``ox`` and ``oy`` in [0, d).  A patch (y, x) of a
    masked sample is zeroed where both ``(y + oy) % d`` and ``(x + ox) %
    d`` reach the keep band, whose width rounds as the reference's does
    (grid_mask.py:93: ``min(max(int(d * ratio + 0.5), 1), d - 1)``)."""
    _, _, h, w, _ = features.shape
    keep = torch.minimum(torch.clamp_min(torch.floor(
        d.float() * ratio + 0.5).long(), 1), d - 1)[:, None, None]
    ys = torch.arange(h, device=features.device)[None, :, None]
    xs = torch.arange(w, device=features.device)[None, None, :]
    dd = d[:, None, None]
    masked = (((ys + oy[:, None, None]) % dd >= keep)
              & ((xs + ox[:, None, None]) % dd >= keep))  # (B, H, W)
    keep_mask = torch.where(apply[:, None, None], ~masked,
                            torch.ones_like(masked))
    return features * keep_mask[:, None, :, :, None].to(features.dtype)
