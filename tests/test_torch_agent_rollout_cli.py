"""``tools/test_vln.py`` and ``python -m vln_ver_tpu_torch.test_vln``
print the same metrics on one JAX checkpoint and its conversion.  Kept
apart from tests/test_torch_agent_rollout.py, whose helpers it uses, so
that the test runners that hand out whole files can put its two JAX CLI
runs, the longest cases of the port's tests, on a worker of their own."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from test_torch_agent_rollout import REPO, _init_jax

from vln_ver_tpu.agent import PolicyConfig as JPolicyConfig
from vln_ver_tpu.agent import env as jenv
from vln_ver_tpu_torch.agent import policy as tpol
from vln_ver_tpu_torch.convert import policy_state_dict_from_jax
from vln_ver_tpu_torch.utils.checkpoint import save_model


def _synthetic_jax(work_dir, objects):
    """What tools/test_vln.py --synthetic builds, with perturbed weights."""
    dims = 64
    kw = dict(embed_dims=dims, num_heads=4, fusion_layers=2, text_layers=2,
              ffn_dim=2 * dims, vocab_size=128, max_text_len=16,
              max_nodes=16, bev_z=2, bev_h=4, bev_w=4, num_query_tokens=4)
    made = jenv.make_synthetic_vln(
        os.path.join(work_dir, "synvln"), num_scans=2, nodes_per_scan=9,
        num_episodes=16, bev_num=32, embed_dims=dims, max_text_len=16,
        with_objects=objects)
    env = jenv.R2REnv(*made[:3], max_nodes=16,
                      objects=made[3] if objects else None)
    cfg = JPolicyConfig(**kw)
    policy, params = _init_jax(cfg, env, objects, seed=0, scale=0.1)
    return env, cfg, policy, params, tpol.PolicyConfig(**kw)


def _cli(argv, cwd=REPO):
    out = subprocess.run([sys.executable] + argv, cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


@pytest.mark.parametrize("objects", [False, True], ids=["r2r", "reverie"])
def test_test_vln_cli_prints_jax_metrics(tmp_path, objects):
    """tools/test_vln.py on a JAX (orbax) checkpoint and ``python -m
    vln_ver_tpu_torch.test_vln --device cpu`` on the port's checkpoint
    converted from it print the same metrics line."""
    from vln_ver_tpu.utils import checkpoint as jckpt
    work = str(tmp_path / "work")
    _, _, _, params, tcfg = _synthetic_jax(work, objects)
    jdir = str(tmp_path / "jax_ckpt")
    jckpt.save_state(jdir, 3, params)
    extra = ["--objects", "synthetic"] if objects else []
    jax_lines = _cli([os.path.join(REPO, "tools", "test_vln.py"),
                      "--checkpoint", jdir, "--synthetic", "--work-dir",
                      work] + extra)
    want = json.loads(jax_lines[-1])
    assert want and all(np.isfinite(v) for v in want.values())

    restored = jckpt.restore_state(jdir, jckpt.latest_step(jdir), params)
    tp = tpol.VLNPolicy(tcfg, grounding=objects)
    tp.load_state_dict(policy_state_dict_from_jax(restored, tcfg),
                       strict=True)
    ckpt = str(tmp_path / "ckpt")
    save_model(ckpt, 3, tp)
    args = ["--checkpoint", ckpt, "--synthetic", "--device", "cpu",
            "--work-dir", work] + extra
    lines = _cli(["-m", "vln_ver_tpu_torch.test_vln"] + args)
    assert lines[0] == "restored policy step 3"
    assert json.loads(lines[-1]) == want
    from vln_ver_tpu_torch import test_vln
    assert test_vln.main(args + ["--batch", "8"]) == want
