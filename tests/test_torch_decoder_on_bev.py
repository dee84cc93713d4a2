"""The port's ``decoder_on_bev`` against the JAX package, fp32 on the CPU:
the full forward with the voxel grid collapsed to a BEV grid by the
``mlp`` (``voxel2bev``) and by ``pool`` (the max over z), on weights
carried by JAX's own ``export_state_dict``; and ``python -m
vln_ver_tpu_torch.test --cfg-options
model.pts_bbox_head.transformer.decoder_on_bev=True`` printing what JAX's
tools/test.py prints on the same weights and data.
The decoder then samples a depth-1 grid in 2D, through
``ms_deform_attn_2d_fused`` (the plain version on the CPU).  Tolerances:
rtol 1e-4 with atol 2e-5 on ``bev_embed`` and 5e-5 on the head outputs.
The train step's gradients with ``decoder_on_bev`` are held in
tests/test_torch_temporal.py."""

import dataclasses
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder import JCFG, jax_params
from test_torch_head import _inputs
from test_torch_train import _port_cfg

from vln_ver_tpu.config import apply_cfg_options as jax_apply_cfg_options
from vln_ver_tpu.config import build_ver_config as jax_build_ver_config
from vln_ver_tpu.config import load_config as jax_load_config
from vln_ver_tpu.convert import export_state_dict
from vln_ver_tpu.models import VoxelFormer as JaxVoxelFormer
from vln_ver_tpu.train import TrainConfig as JaxTrainConfig
from vln_ver_tpu.train import create_train_state as jax_create_train_state
from vln_ver_tpu.utils.checkpoint import save_state as jax_save_state
from vln_ver_tpu_torch import test as test_cli
from vln_ver_tpu_torch.convert import state_dict_from_jax
from vln_ver_tpu_torch.models import VoxelFormer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")
OUTPUTS = ("bev_embed", "all_cls_scores", "all_bbox_preds",
           "occupancy_preds")


def _cfgs(kind):
    jcfg = dataclasses.replace(JCFG, decoder_on_bev=True,
                               voxel_2_bev_type=kind)
    return jcfg, _port_cfg(jcfg)


def _port_from_export(params, jcfg, tcfg):
    """The port's model loaded, strictly, from JAX's ``export_state_dict``
    (the reference-format dict, ``voxel2bev`` included)."""
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_state_dict(params, jcfg).items()}
    model = VoxelFormer(tcfg)
    model.load_state_dict(sd, strict=True)
    return model.eval(), sd


@pytest.mark.parametrize("kind", ["mlp", "pool"])
def test_decoder_on_bev_forward_matches_jax(kind):
    jcfg, tcfg = _cfgs(kind)
    params = jax_params(jcfg, seed=8)
    model, sd = _port_from_export(params, jcfg, tcfg)
    ours, unmapped = state_dict_from_jax(params, tcfg)
    assert not unmapped and ours.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(ours[k].numpy(), sd[k].numpy(), k)
    assert hasattr(model.pts_bbox_head.transformer, "voxel2bev") \
        == (kind == "mlp")
    f, w, s = _inputs(2, seed=9)
    ref = jax.jit(lambda p, *a: JaxVoxelFormer(jcfg).apply(
        {"params": p}, *a))(params, *map(jnp.asarray, (f, w, s)))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (f, w, s)))
    for k in OUTPUTS:
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(ref[k]), rtol=1e-4,
            atol=2e-5 if k == "bev_embed" else 5e-5, err_msg=k)


def test_cli_prints_jax_metrics(tmp_path, monkeypatch, capsys):
    """tools/test.py (JAX, an orbax checkpoint of the weights) and ``python
    -m vln_ver_tpu_torch.test`` (the port, the same weights exported to a
    reference-format .pth) on one synthetic split print the same lines."""
    opts = ["model.pts_bbox_head.transformer.decoder_on_bev=True"]
    jcfg = jax_build_ver_config(jax_apply_cfg_options(
        jax_load_config(CONFIG), opts))
    assert jcfg.decoder_on_bev
    params = jax_params(jcfg, seed=7)
    jax_save_state(str(tmp_path / "ckpt"), 1, jax_create_train_state(
        JaxVoxelFormer(jcfg), {"params": params}, JaxTrainConfig()))
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in export_state_dict(params, jcfg).items()},
               tmp_path / "model.pth")
    monkeypatch.chdir(tmp_path)
    common = ["--synthetic", "--limit", "3", "--cfg-options", *opts]
    monkeypatch.setattr(sys, "argv", ["tools/test.py", CONFIG, *common,
                                      "--checkpoint", "ckpt"])
    runpy.run_path(os.path.join(REPO, "tools", "test.py"),
                   run_name="__main__")
    jax_lines = [line for line in capsys.readouterr().out.splitlines()
                 if ":" in line and not line.startswith("restored")]
    metrics = test_cli.main([CONFIG, *common, "--device", "cpu",
                             "--checkpoint", "model.pth"])
    port_lines = [line for line in capsys.readouterr().out.splitlines()
                  if ":" in line]
    assert len(jax_lines) == 12 and port_lines == jax_lines
    assert metrics["iou"] > 0        # a non-trivial comparison
