"""Which parameters training leaves without a gradient, and how far two
training runs drifted apart, on the port's ``state_dict`` names (the
port's own copy of ``vln_ver_tpu/utils/params.py``'s key lists)."""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

# No gradient path at all in a det+occ config without add_layout: the
# positional encoding is inert on the active path, and the layout query
# table is built but unused by the loss.  Autograd gives them no gradient;
# the train step gives them a zero one, so AdamW only decays them, as
# optax does.
NOGRAD_PARAM_KEYS = ("positional_encoding", "query_layout_embedding")

# A structurally zero gradient that autograd still produces: the decoder
# self-attention's key bias (q . (k + b) shifts every logit of a query by
# the same q . b, which the softmax cancels).  Adam turns its fp32 noise
# into +-lr steps, so its drift is noise on both sides.  The port packs it
# as the middle third of ``in_proj_bias``.
PACKED_KEY_BIAS = "attn.in_proj_bias"


def _signal(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` without the elements whose drift is noise."""
    t = t.detach().double().flatten()
    if name.endswith(PACKED_KEY_BIAS):
        e = t.numel() // 3
        t = torch.cat([t[:e], t[2 * e:]])
    return t


def drift_rel_l2(init: Mapping[str, torch.Tensor],
                 a: Mapping[str, torch.Tensor],
                 b: Mapping[str, torch.Tensor],
                 exclude=NOGRAD_PARAM_KEYS
                 ) -> Tuple[float, Tuple[float, Optional[str]]]:
    """Relative-L2 agreement of two parameter drifts from a common init:
    ``||(a - init) - (b - init)|| / ||b - init||`` over every parameter not
    in ``exclude``, and the worst single parameter ``(rel, name)``."""
    num2 = den2 = 0.0
    worst: Tuple[float, Optional[str]] = (0.0, None)
    for k in init:
        if any(s in k for s in exclude):
            continue
        da = _signal(k, a[k]) - _signal(k, init[k])
        db = _signal(k, b[k]) - _signal(k, init[k])
        num = float(torch.linalg.vector_norm(da - db))
        den = float(torch.linalg.vector_norm(db)) + 1e-30
        num2 += num ** 2
        den2 += den ** 2
        if num / den > worst[0]:
            worst = (num / den, k)
    return (num2 ** 0.5) / max(den2 ** 0.5, 1e-30), worst


def grads_by_name(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """{parameter name: its gradient}, zeros where autograd left none."""
    return {n: (p.grad.detach() if p.grad is not None
                else torch.zeros_like(p))
            for n, p in model.named_parameters()}


@contextlib.contextmanager
def relu_masks(model: nn.Module, record: Optional[List[torch.Tensor]] = None,
               pin: Optional[List[torch.Tensor]] = None):
    """Within the block, every ``nn.ReLU`` of ``model`` appends its output's
    sign mask (on the CPU, in call order) to ``record``, or, given the masks
    of another run in ``pin``, passes its input through those masks instead
    of its own.  Yields a one-element list that counts the elements where
    the pinned mask differs from the ReLU's own.

    A gradient comparison of two runs that differ by rounding needs this: a
    pre-activation within rounding of 0 takes the ReLU's other side on one
    of them, and where the loss's gradient is concentrated on a few queries
    (the matched ones) that one element moves a whole weight gradient by
    percents.  With the masks pinned both runs differentiate the same
    linear piece; the forward moves by at most that pre-activation."""
    flips = [0]
    calls = itertools.count()

    def hook(mod, args, out):
        i = next(calls)
        if record is not None:
            record.append((out > 0).cpu())
        if pin is None:
            return None
        mask = pin[i].to(out.device)
        flips[0] += int((mask != (out > 0)).sum())
        return args[0] * mask

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, nn.ReLU)]
    try:
        yield flips
    finally:
        for h in handles:
            h.remove()
