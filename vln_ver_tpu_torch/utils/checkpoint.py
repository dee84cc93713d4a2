"""Train checkpoints on ``torch.save`` (PyTorch port of
``vln_ver_tpu/utils/checkpoint.py``).

A checkpoint is the directory ``<ckpt_dir>/step_NNNNNNNN`` holding

* ``model.pth``: the model's state_dict under the reference names, what
  :func:`vln_ver_tpu_torch.convert.load_checkpoint` and
  ``python -m vln_ver_tpu_torch.test --checkpoint`` read;
* ``train_state.pth``: the AdamW state and the step.

A tensor-parallel state is written and read in its replicated layout, so
its files are those of a replicated state and resume under any grid.

A model-only checkpoint (:func:`save_model`, for instance the VLN
policy's, which ``python -m vln_ver_tpu_torch.test_vln --checkpoint``
reads) is the same directory with ``model.pth`` alone.

It is written under a temporary name in the same directory and renamed
into place, so a write in flight, or one a crash left behind, is never
taken for a step.  The state is copied to the host when the save is asked
for: the next step updates the parameters in place.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from ..parallel.tensor import gathered

_STEP_RE = re.compile(r"^step_(\d+)$")
MODEL_FILE = "model.pth"
STATE_FILE = "train_state.pth"


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def host_snapshot(state) -> Dict:
    """A host copy of a :class:`~vln_ver_tpu_torch.train.TrainState`.  A
    tensor-parallel state must be in its replicated layout
    (``parallel.tensor.gathered``), so that the files are those of a
    replicated state."""
    tp = getattr(state, "tp", None)
    if tp is not None and not (tp.params_full and tp.moments_full):
        raise RuntimeError("a sharded train state is saved inside "
                           "parallel.tensor.gathered(state)")
    return {"model": _to_host(state.model.state_dict()),
            "optimizer": _to_host(state.optimizer.state_dict()),
            "step": int(state.step)}


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def _write(ckpt_dir: str, step: int, snap: Dict) -> str:
    final = step_dir(ckpt_dir, step)
    tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
    os.makedirs(tmp)
    torch.save(snap["model"], os.path.join(tmp, MODEL_FILE))
    if "optimizer" in snap:
        torch.save({"optimizer": snap["optimizer"], "step": snap["step"]},
                   os.path.join(tmp, STATE_FILE))
    if os.path.isdir(final):          # a save of the same step replaces it
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save_state(ckpt_dir: str, step: int, state) -> str:
    """Write ``state`` as step ``step``, synchronously; returns the path."""
    return _write(ckpt_dir, step, host_snapshot(state))


def save_model(ckpt_dir: str, step: int, model) -> str:
    """Write ``model``'s state_dict alone as step ``step`` (``model.pth``
    in the step directory), synchronously; returns the path."""
    return _write(ckpt_dir, step, {"model": _to_host(model.state_dict())})


def load_model(path: str, model):
    """Load :func:`model_file`'s state_dict into ``model``, strictly, on
    the device of its parameters; returns ``model``."""
    dev = next(model.parameters()).device
    model.load_state_dict(torch.load(model_file(path), map_location=dev,
                                     weights_only=True), strict=True)
    return model


class AsyncSaver:
    """Checkpoint writes on a background thread: :meth:`save` takes the
    host snapshot and returns, the serialisation and the disk I/O overlap
    the next steps.  :meth:`wait` (or leaving the ``with`` block) must run
    before the process exits or a restore of the step in flight; it
    re-raises a failed write."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt_writer")
        self._pending: List[Future] = []

    def save(self, ckpt_dir: str, step: int, state) -> str:
        snap = host_snapshot(state)
        self._pending.append(self._pool.submit(_write, ckpt_dir, step, snap))
        return step_dir(ckpt_dir, step)

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
        return False


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest COMPLETED step in ``ckpt_dir``: only exact
    ``step_NNNNNNNN`` directories count, never a temporary one."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(d))
             and os.path.isdir(os.path.join(ckpt_dir, d))]
    return max(steps) if steps else None


def restore_state(ckpt_dir: str, step: Optional[int], state):
    """Load step ``step`` of ``ckpt_dir`` into ``state`` (its model, its
    optimizer and its step count), in place; returns ``state``.  A
    tensor-parallel state takes its slices of the full tensors (every rank
    calls this)."""
    if step is None:
        raise FileNotFoundError(
            f"no completed checkpoint (step_NNNNNNNN) under {ckpt_dir}")
    path = step_dir(ckpt_dir, step)
    dev = next(state.model.parameters()).device
    with gathered(state):
        state.model.load_state_dict(torch.load(
            os.path.join(path, MODEL_FILE), map_location=dev,
            weights_only=True))
        saved = torch.load(os.path.join(path, STATE_FILE), map_location=dev,
                           weights_only=True)
        state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state


def model_file(path: str) -> str:
    """The model state_dict file behind ``path``: a ``.pth`` file as it
    is, a step directory's ``model.pth``, or the latest completed step's
    of a checkpoint directory."""
    if os.path.isfile(path):
        return path
    if os.path.isfile(os.path.join(path, MODEL_FILE)):
        return os.path.join(path, MODEL_FILE)
    step = latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return os.path.join(step_dir(path, step), MODEL_FILE)
