"""The port stands alone: no module of vln_ver_tpu_torch, and not
chip_smoke.py, imports jax, flax or the JAX package; and the package
imports without h5py (a PyTorch-only host may have none).

An AST walk, not sys.modules: the interpreter here imports jax at start."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "vln_ver_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
# the modules of the VER generation product path that arrived with the
# sparse lift, the uploads and the image frontend
PRODUCT_PATH = ("models/vit.py", "convert/vit.py", "check_query_capacity.py",
                "extract_vit_features.py")
# the VLN agent's evaluation path; env.py and data.py are the port's own
# numpy copies, not imports of the JAX package's
AGENT = ("agent/__init__.py", "agent/env.py", "agent/data.py",
         "agent/memory.py", "agent/attention.py", "agent/text.py",
         "agent/ver.py", "agent/policy.py", "agent/rollout.py",
         "agent/replay.py", "convert/policy.py", "test_vln.py",
         # the agent's training: the trainers, pretraining and the
         # converters of pretrained weights
         "agent/pretrain.py", "agent/cli_setup.py", "agent/crossmodal.py",
         "agent/update.py", "train_vln.py", "pretrain_vln.py",
         "convert_text_encoder.py", "convert_crossmodal.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "vln_ver_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(REPO)))
def test_no_jax_import(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _checked():
    return {str(p.relative_to(REPO / "vln_ver_tpu_torch"))
            for p in FILES if p.is_relative_to(REPO / "vln_ver_tpu_torch")}


def test_product_path_modules_are_checked():
    assert set(PRODUCT_PATH) <= _checked()


def test_agent_modules_are_checked():
    assert set(AGENT) <= _checked()


def test_forbidden_names():
    assert _forbidden("vln_ver_tpu") and _forbidden("vln_ver_tpu.geometry")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert not _forbidden("vln_ver_tpu_torch")
    assert not _forbidden("vln_ver_tpu_torch.models")


def test_package_imports_without_h5py():
    code = ("import sys; sys.modules['h5py'] = None; "
            "import vln_ver_tpu_torch.get_occ, vln_ver_tpu_torch.ver_writer,"
            " vln_ver_tpu_torch.data, vln_ver_tpu_torch.convert,"
            " vln_ver_tpu_torch.test, vln_ver_tpu_torch.evaluation.runner,"
            " vln_ver_tpu_torch.train.cli, vln_ver_tpu_torch.losses,"
            " vln_ver_tpu_torch.matching, vln_ver_tpu_torch.utils.checkpoint,"
            " vln_ver_tpu_torch.utils.params, vln_ver_tpu_torch.models.vit,"
            " vln_ver_tpu_torch.convert.vit,"
            " vln_ver_tpu_torch.check_query_capacity,"
            " vln_ver_tpu_torch.extract_vit_features,"
            " vln_ver_tpu_torch.agent.rollout, vln_ver_tpu_torch.agent.data,"
            " vln_ver_tpu_torch.convert.policy, vln_ver_tpu_torch.test_vln,"
            " vln_ver_tpu_torch.train_vln, vln_ver_tpu_torch.pretrain_vln,"
            " vln_ver_tpu_torch.convert_text_encoder,"
            " vln_ver_tpu_torch.convert_crossmodal,"
            " vln_ver_tpu_torch.agent.cli_setup; "
            "from vln_ver_tpu_torch.data import synthetic_samples; "
            "synthetic_samples(1, 1, num_cams=1, feat_hw=2, feat_dim=4, "
            "occ_dims=(2, 4, 4)); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
