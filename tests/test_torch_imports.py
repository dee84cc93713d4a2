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
# the server and the multi-process modules
PARALLEL = ("serve.py", "parallel/__init__.py", "parallel/mesh.py",
            "parallel/multihost.py", "agent/parallel.py")
# the temporal VER model and the BEVFormer-2D family; nuscenes.py is the
# port's own numpy copy of the JAX reader
TEMPORAL = ("models/temporal.py", "models/bev2d.py", "convert/bev2d.py",
            "data/nuscenes.py")
# the headline measurement, the remaining utils and the tools' entry
# points
TOOLS = ("bench.py", "utils/bench.py", "benchmark.py", "bench_train.py",
         "check_determinism.py", "utils/tensorboard.py",
         "utils/profiling.py", "augment.py", "get_params.py",
         "print_config.py", "browse_dataset.py", "publish_model.py",
         "fire_drill.py")


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


def test_parallel_modules_are_checked():
    assert set(PARALLEL) <= _checked()


def test_temporal_modules_are_checked():
    assert set(TEMPORAL) <= _checked()


def test_tool_modules_are_checked():
    assert set(TOOLS) <= _checked()


def test_parallel_modules_import_without_jax_or_a_process_group():
    """The server and the multi-process modules import with jax and the
    JAX package made unimportable, and importing them brings up no
    process group (the CLIs do, from torchrun's environment)."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'vln_ver_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import torch.distributed as dist\n"
            "import vln_ver_tpu_torch.serve, vln_ver_tpu_torch.parallel,"
            " vln_ver_tpu_torch.parallel.mesh,"
            " vln_ver_tpu_torch.parallel.multihost,"
            " vln_ver_tpu_torch.agent.parallel\n"
            "assert not dist.is_initialized()\n"
            "print('ok')")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


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
            " vln_ver_tpu_torch.agent.cli_setup, vln_ver_tpu_torch.serve,"
            " vln_ver_tpu_torch.parallel, vln_ver_tpu_torch.agent.parallel,"
            " vln_ver_tpu_torch.models.temporal,"
            " vln_ver_tpu_torch.models.bev2d, vln_ver_tpu_torch.convert.bev2d,"
            " vln_ver_tpu_torch.data.nuscenes, vln_ver_tpu_torch.bench,"
            " vln_ver_tpu_torch.utils.bench, vln_ver_tpu_torch.benchmark,"
            " vln_ver_tpu_torch.bench_train,"
            " vln_ver_tpu_torch.check_determinism,"
            " vln_ver_tpu_torch.utils.tensorboard,"
            " vln_ver_tpu_torch.utils.profiling, vln_ver_tpu_torch.augment,"
            " vln_ver_tpu_torch.get_params, vln_ver_tpu_torch.print_config,"
            " vln_ver_tpu_torch.browse_dataset,"
            " vln_ver_tpu_torch.publish_model, vln_ver_tpu_torch.fire_drill; "
            "from vln_ver_tpu_torch.data import synthetic_samples; "
            "synthetic_samples(1, 1, num_cams=1, feat_hw=2, feat_dim=4, "
            "occ_dims=(2, 4, 4)); "
            "from vln_ver_tpu_torch.data import synthetic_nuscenes; "
            "synthetic_nuscenes(1, 2, 2, 2, 4); print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
