"""The port's config, checkpoint and determinism tools against the JAX
tools, on the CPU at vocc_tiny.py: ``get_params``' total,
``print_config``'s output (dtypes by name), ``browse_dataset``'s sample
lines, ``check_determinism``'s fingerprint fold against ``lax.reduce``'s
XOR, and a ``publish_model`` round trip."""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_ver_tpu_torch import (browse_dataset, check_determinism, get_params,
                               print_config, publish_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")


def _jax_tool(name, argv, monkeypatch, capsys):
    """Run tools/<name>.py in this process; its standard output."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(os.path.join(REPO, "tools", f"{name}.py"),
                   run_name="__main__")
    return capsys.readouterr().out


def test_get_params_total_equals_jax(monkeypatch, capsys):
    from vln_ver_tpu.config import build_ver_config, load_config
    from vln_ver_tpu.models import VoxelFormer as JaxVoxelFormer

    jax_out = _jax_tool("get_params", [CONFIG], monkeypatch, capsys)
    got = get_params.main([CONFIG, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == jax_out.splitlines()[-1]   # TOTAL
    cfg = build_ver_config(load_config(CONFIG))
    x = (jnp.zeros((1, cfg.num_cams, cfg.feat_h, cfg.feat_w,
                    cfg.in_channels)),
         jnp.tile(jnp.eye(4), (1, cfg.num_cams, 1, 1)), jnp.zeros((1, 3)))
    shapes = jax.eval_shape(JaxVoxelFormer(cfg).init, jax.random.PRNGKey(0),
                            *x)
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    # the positional encoding, which flax builds only for a temporal
    # config, is a parameter of the port's model always
    pos = sum(v for k, v in got["groups"].items()
              if k.startswith("pts_bbox_head/positional_encoding"))
    assert got["total"] - pos == want
    assert sum(got["groups"].values()) == got["total"]


def test_print_config_matches_jax(monkeypatch, capsys):
    argv = [CONFIG, "--cfg-options", "model.pts_bbox_head.only_occ=True",
            "--steps-per-epoch", "7"]
    want = _jax_tool("print_config", argv, monkeypatch, capsys)
    print_config.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want.replace("<class 'jax.numpy.float32'>", "float32")
    assert "  dtype = float32" in got and "only_occ = True" in got


def test_browse_dataset_lines_match_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = [CONFIG, "--synthetic", "--limit", "3"]
    want = _jax_tool("browse_dataset", argv, monkeypatch, capsys)
    lines = browse_dataset.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    assert len(lines) == 3
    assert lines == want.strip().splitlines()[1:]


@pytest.mark.parametrize("shape,dtype", [
    ((3, 5, 7), torch.float32), ((1,), torch.float32),
    ((2, 900, 768), torch.bfloat16), ((4, 33), torch.float32)])
def test_fingerprint_equals_jax_xor_reduce(shape, dtype):
    x = torch.from_numpy(np.random.default_rng(len(shape)).standard_normal(
        shape).astype(np.float32)).to(dtype)
    bits = jax.lax.bitcast_convert_type(
        jnp.asarray(x.float().numpy()), jnp.int32).reshape(-1)
    want = int(jax.lax.reduce(bits, np.int32(0), jax.lax.bitwise_xor, (0,)))
    got = check_determinism.fingerprint(x)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want
    # one flipped bit anywhere flips it
    y = x.float().clone()
    y.view(-1).view(torch.int32)[-1] ^= 1
    assert int(check_determinism.fingerprint(y)) != want


def test_check_determinism_on_a_tiny_model(capsys):
    from test_torch_bench import TINY36
    res = check_determinism.run(check_determinism.parse_args(
        ["--batch", "1", "--runs", "2", "--device", "cpu"]), cfg=TINY36)
    assert res["bitwise_deterministic"] and res["differs"] == []
    assert len(res["prints"]) == 2 and len(res["prints"][0]) == 3


def test_publish_model_round_trip(tmp_path, capsys):
    from vln_ver_tpu_torch.config import build_ver_config, load_config
    from vln_ver_tpu_torch.convert import load_checkpoint
    from vln_ver_tpu_torch.models import build_model
    from vln_ver_tpu_torch.train import TrainConfig, create_train_state
    from vln_ver_tpu_torch.utils.checkpoint import save_state

    ver = build_ver_config(load_config(CONFIG))
    model = build_model(ver, "cpu", seed=3)
    state = create_train_state(model, TrainConfig())
    ckpt = tmp_path / "ckpt"
    save_state(str(ckpt), 2, state)
    save_state(str(ckpt), 5, state)
    (ckpt / "meta.json").write_text('{"config": "x", "CLASSES": ["a"]}')
    out = publish_model.main([str(ckpt), str(tmp_path / "rel"), "--device",
                              "cpu"])
    digest = publish_model.state_digest(model.state_dict())[:8]
    assert os.path.basename(out) == f"ver_params-{digest}.pth"
    assert "(step 5," in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "rel")) == [
        f"ver_params-{digest}.meta.json", f"ver_params-{digest}.pth"]
    saved = torch.load(out, weights_only=True)
    assert set(saved) == set(model.state_dict())   # no optimizer state
    fresh = build_model(ver, "cpu", seed=4)
    assert load_checkpoint(fresh, out) == []
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # the same weights publish under the same name
    assert publish_model.main([str(ckpt), str(tmp_path / "again"),
                               "--device", "cpu"]).endswith(
        f"ver_params-{digest}.pth")
    with pytest.raises(FileNotFoundError):
        publish_model.main([str(tmp_path / "none"), str(tmp_path / "x"),
                            "--device", "cpu"])
