"""Strip a training checkpoint to the model's weights for release
(PyTorch port of ``tools/publish_model.py``, the reference's
tools/model_converters/publish_model.py).

    python -m vln_ver_tpu_torch.publish_model work_dirs/vocc/ckpt OUT_DIR
        [--device cuda|cpu]

Takes the latest completed step's ``model.pth`` (the optimizer state in
``train_state.pth`` is left behind) and writes it as
``OUT_DIR/ver_params-<digest>.pth``, ``<digest>`` the first 8 hex digits
of the SHA-256 over its tensors' bytes in sorted key order, with the
checkpoint directory's ``meta.json`` (config text and classes) beside it
as ``ver_params-<digest>.meta.json``.  The file loads strictly into the
model (``convert.load_checkpoint``, ``test --checkpoint``).  The weights
are read on the host: ``--device`` is taken as every CLI of the port
takes it, and only checked.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m vln_ver_tpu_torch.publish_model")
    p.add_argument("ckpt_dir")
    p.add_argument("out_dir")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def state_digest(state_dict) -> str:
    """SHA-256 over the tensors' raw bytes, in sorted key order."""
    hasher = hashlib.sha256()
    for k in sorted(state_dict):
        t = state_dict[k].detach().cpu().contiguous().reshape(-1)
        hasher.update(t.view(torch.uint8).numpy().tobytes())
    return hasher.hexdigest()


def main(argv=None) -> str:
    """Writes the release files; returns the weights' path."""
    args = parse_args(argv)
    from .runtime import resolve_device
    from .utils.checkpoint import MODEL_FILE, latest_step, step_dir

    resolve_device(args.device)
    ckpt_dir = os.path.abspath(args.ckpt_dir)
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    state = torch.load(os.path.join(step_dir(ckpt_dir, step), MODEL_FILE),
                       map_location="cpu", weights_only=True)
    digest = state_digest(state)[:8]
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(os.path.abspath(args.out_dir),
                       f"ver_params-{digest}.pth")
    torch.save(state, out)
    meta = os.path.join(ckpt_dir, "meta.json")
    if os.path.isfile(meta):
        shutil.copy(meta, out[:-len(".pth")] + ".meta.json")
    print(f"published {out} (step {step}, sha {digest})")
    return out


if __name__ == "__main__":
    main()
