"""The policy's step on the card held against the CPU port: record every
call a policy makes (its inputs and outputs copied to the host), then
replay each call on a CPU copy of the policy with the same weights and
compare.

The bounds are those of fp32 on the card with TF32 off: the logits, their
log-softmax over the unmasked actions and ``state_pred`` within ``RTOL`` /
``ATOL``, the ``-1e9`` action-mask entries equal, and the greedy action
equal wherever the top-2 logit margin exceeds ``MARGIN`` (below it an
error of 1e-6 may flip an argmax).  A mismatch raises ``AssertionError``.

A trainer's update is held the same way (:func:`loss_and_grads`,
:func:`hold_update`): one forward and backward on each device from the
same weights and batch, dropout off, the ReLUs of the card's run pinned to
the CPU's masks (``utils.params.relu_masks``); every loss within
``LOSS_RTOL``, every parameter's gradient and the global norm within
``GRAD_REL_L2`` in relative L2.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn
from torch.utils._pytree import tree_map

from ..utils.params import grads_by_name, relu_masks

RTOL = ATOL = 1e-4
MARGIN = 1e-3
MASKED = -1e9
LOSS_RTOL = GRAD_REL_L2 = 1e-4
# an absolute floor on a gradient's L2 difference: it takes the gradients
# that are zero by structure (an attention key bias, whose shift of a
# query row's logits the softmax cancels) to their fp32 noise
GRAD_FLOOR = 1e-7


def tensors(fn, tree):
    """``fn`` applied to every tensor of a (nested) call's inputs or
    outputs; the rest as it is."""
    return tree_map(lambda x: fn(x) if isinstance(x, torch.Tensor) else x,
                    tree)


def to_host(tree):
    return tensors(lambda t: t.detach().cpu(), tree)


class PolicyCalls:
    """Forward hooks on the policy, as a context manager: ``calls``
    gathers ``[args, kwargs, output]`` of every call on the host."""

    def __init__(self, policy):
        self.calls: List[list] = []

        def pre(mod, args, kwargs):
            self.calls.append([to_host(args), to_host(kwargs)])

        def post(mod, args, kwargs, out):
            self.calls[-1].append(to_host(out))

        self._hooks = [policy.register_forward_pre_hook(pre, with_kwargs=True),
                       policy.register_forward_hook(post, with_kwargs=True)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        return False


def _within(name, got, ref, rtol, atol) -> float:
    if got.shape != ref.shape:
        raise AssertionError(f"card vs CPU policy step: {name} shape "
                             f"{tuple(got.shape)} vs {tuple(ref.shape)}")
    diff = (got.double() - ref.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if not bool(torch.all(diff <= atol + rtol * ref.double().abs())):
        raise AssertionError(f"card vs CPU policy step: {name} max_abs_err "
                             f"{err:.3e} over rtol={rtol}, atol={atol}")
    return err


def hold_call(card_out, cpu_out, rtol: float = RTOL, atol: float = ATOL,
              margin: float = MARGIN) -> Dict:
    """One call's outputs on the card against the CPU's.  Returns the
    largest error of each output (``logits``, ``log_softmax``,
    ``state_pred``), the top-2 margins of the rows whose greedy actions
    were compared (``margins``) and the count of near-tie rows skipped
    (``near``)."""
    cl, gl = cpu_out.logits, card_out.logits.detach().cpu()
    masked = cl == MASKED
    if not torch.equal(masked, gl == MASKED):
        raise AssertionError("card vs CPU policy step: the action masks "
                             "differ")
    errs = dict(
        logits=_within("logits", gl[~masked], cl[~masked], rtol, atol),
        log_softmax=_within("log_softmax",
                            torch.log_softmax(gl, -1)[~masked],
                            torch.log_softmax(cl, -1)[~masked], rtol, atol),
        state_pred=_within("state_pred", card_out.state_pred.detach().cpu(),
                           cpu_out.state_pred, rtol, atol))
    top2 = torch.topk(cl, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    rows = (gap > margin).nonzero()[:, 0]
    if not torch.equal(gl[rows].argmax(-1), cl[rows].argmax(-1)):
        raise AssertionError(f"card vs CPU policy step: greedy actions "
                             f"differ at a top-2 margin over {margin}")
    return dict(errs, margins=gap[rows].tolist(),
                near=int(cl.shape[0] - len(rows)))


def replay(calls, cpu_policy, rtol: float = RTOL, atol: float = ATOL,
           margin: float = MARGIN) -> Dict:
    """Every recorded call again on ``cpu_policy``, each held by
    :func:`hold_call`.  Returns the worst error of each output
    (``worst``), the calls replayed (``steps``), the rows whose greedy
    actions were compared (``compared``), the near-tie rows skipped
    (``near``) and the smallest compared margin (``min_margin``)."""
    worst = dict(logits=0.0, log_softmax=0.0, state_pred=0.0)
    margins, near = [], 0
    with torch.inference_mode():
        for args, kwargs, card_out in calls:
            held = hold_call(card_out, cpu_policy(*args, **kwargs), rtol,
                             atol, margin)
            for k in worst:
                worst[k] = max(worst[k], held[k])
            margins += held["margins"]
            near += held["near"]
    return dict(worst=worst, steps=len(calls), compared=len(margins),
                near=near, min_margin=min(margins, default=float("inf")))


def loss_and_grads(model: nn.Module, loss_fn: Callable,
                   record: Optional[List] = None,
                   pin: Optional[List] = None) -> Dict:
    """One forward (``loss_fn() -> (total, parts)``) and backward on
    ``model``, no optimizer step.  Returns ``parts`` (floats, with
    ``"total"``), ``grads`` ({name: gradient on the host}, zeros where
    autograd left none), ``gnorm`` (their global norm) and ``flips`` (the
    ReLU elements where a pinned mask overrode the run's own);
    ``record`` / ``pin``: the ReLU masks (``utils.params.relu_masks``)."""
    model.zero_grad(set_to_none=True)
    with relu_masks(model, record=record, pin=pin) as flips:
        total, parts = loss_fn()
    total.backward()
    grads = {n: g.detach().cpu() for n, g in grads_by_name(model).items()}
    model.zero_grad(set_to_none=True)
    gnorm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.double()) for g in grads.values()])))
    return dict(parts={"total": float(total.detach()),
                       **{k: float(v.detach()) for k, v in parts.items()}},
                grads=grads, gnorm=gnorm, flips=flips[0])


def hold_update(got: Dict, ref: Dict, loss_rtol: float = LOSS_RTOL,
                grad_tol: float = GRAD_REL_L2) -> Dict:
    """Two :func:`loss_and_grads` results, the card's (``got``) against the
    CPU's (``ref``): the same loss keys, each within ``loss_rtol``; each
    parameter's gradient within ``grad_tol`` of its L2 norm (plus
    ``GRAD_FLOOR``); the global norm within ``grad_tol``.  Returns the
    worst relative loss difference and its key (``loss``), the worst
    relative gradient L2 difference among the gradients the relative bound
    binds and its parameter (``grad``), and the global norm's (``gnorm``);
    raises ``AssertionError`` on a mismatch."""
    if set(got["parts"]) != set(ref["parts"]):
        raise AssertionError(f"card vs CPU update: losses "
                             f"{sorted(got['parts'])} vs "
                             f"{sorted(ref['parts'])}")
    loss = max((abs(got["parts"][k] - v) / max(abs(v), 1e-12), k)
               for k, v in ref["parts"].items())
    bad = [k for k, v in ref["parts"].items()
           if abs(got["parts"][k] - v) > loss_rtol * abs(v)]
    grad, failed = (0.0, None), []
    for n, r in ref["grads"].items():
        diff = float(torch.linalg.vector_norm((got["grads"][n] - r).double()))
        norm = float(torch.linalg.vector_norm(r.double()))
        if diff > grad_tol * norm + GRAD_FLOOR:
            failed.append(n)
        if grad_tol * norm > GRAD_FLOOR and diff / norm > grad[0]:
            grad = (diff / norm, n)
    gnorm = abs(got["gnorm"] - ref["gnorm"]) / max(ref["gnorm"], 1e-30)
    if bad or failed or gnorm > grad_tol:
        raise AssertionError(
            f"card vs CPU update: losses {bad} over rtol {loss_rtol}, "
            f"gradients {failed[:5]} over {grad_tol} in relative L2, global "
            f"norm {gnorm:.3e}")
    return dict(loss=loss, grad=grad, gnorm=gnorm)
