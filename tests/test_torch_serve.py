"""The port's VER server (``python -m vln_ver_tpu_torch.serve``) against
the JAX tool (tools/serve_ver.py) on the CPU, tiny config
(configs/verformer/vocc_tiny.py), the same queue protocol and requests as
tests/test_serve.py:

* 3 feature requests and 1 malformed one at ``batch_max`` 2 with
  ``--occupancy``: the JAX server with its PRNGKey(0) weights, the port's
  with them converted (``convert.state_dict_from_jax``) and saved as its
  checkpoint.  Volumes within rtol 1e-4 / atol 2e-5 (the bev_embed bound
  of tests/test_convert_voxelformer.py), occupancy labels equal, an error
  file for the malformed request, 3 served, the inbox empty;
* an image and a feature request with ``--images`` (a 1-layer ViT, the
  JAX server's PRNGKey(1) weights as an HF state dict for both), the same
  tolerance;
* the orphan sweep: a request left in a dead server's claimed dir is swept
  back, served, and ``in/STOP`` ends the server; and the sweep's
  cross-host rules are the JAX tool's.
"""

import argparse
import importlib.util
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from vln_ver_tpu_torch import serve as tserve
from vln_ver_tpu_torch.config import build_ver_config, load_config
from vln_ver_tpu_torch.geometry import make_pinhole_world2pixel

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")
CFG = build_ver_config(load_config(CONFIG))
PATCH = 8


def _jax_serve():
    spec = importlib.util.spec_from_file_location(
        "serve_ver", os.path.join(REPO, "tools", "serve_ver.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(queue, **kw):
    base = dict(config=CONFIG, cfg_options=None, checkpoint=None,
                queue=queue, batch_max=2, poll_ms=10, occupancy=False,
                max_requests=None, images=False, vit_checkpoint=None,
                hf_prefix="", vit_patch_size=16, vit_layers=12,
                vit_heads=12)
    base.update(kw)
    return argparse.Namespace(**base)


def _request(seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((CFG.num_cams, CFG.feat_h, CFG.feat_w,
                                 CFG.in_channels)).astype(np.float32)
    w2p = np.stack([make_pinhole_world2pixel(90.0, (360 / CFG.num_cams) * i,
                                             (0, 0, 0))
                    for i in range(CFG.num_cams)]).astype(np.float32)
    return feats, w2p, np.zeros(3, np.float32)


def _write_requests(queue, reqs):
    inbox = os.path.join(queue, "in")
    os.makedirs(inbox, exist_ok=True)
    for rid, arrays in reqs.items():
        np.savez(os.path.join(inbox, f"{rid}.npz"), **arrays)


def _read(queue, rid):
    with np.load(os.path.join(queue, "out", f"{rid}.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX server's weights (PRNGKey(0) on its seed-0 dummy batch; a
    1-layer ViT of PRNGKey(1)), saved for the port."""
    import jax

    from vln_ver_tpu.config import build_ver_config as jbuild
    from vln_ver_tpu.config import load_config as jload
    from vln_ver_tpu.models import VoxelFormer
    from vln_ver_tpu.models.vit import vit_for_ver
    from vln_ver_tpu_torch.convert import state_dict_from_jax
    from vln_ver_tpu_torch.convert.vit import vit_state_dict_from_jax

    tmp = tmp_path_factory.mktemp("serve")
    jcfg = jbuild(jload(CONFIG))
    rng = np.random.default_rng(0)
    feats0 = rng.standard_normal((1, jcfg.num_cams, jcfg.feat_h,
                                  jcfg.feat_w, jcfg.in_channels)
                                 ).astype(np.float32)
    w2p0 = np.tile(np.eye(4, dtype=np.float32), (1, jcfg.num_cams, 1, 1))
    params = VoxelFormer(jcfg).init(jax.random.PRNGKey(0), feats0, w2p0,
                                    np.zeros((1, 3), np.float32))
    sd, unmapped = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), CFG)
    assert not unmapped
    pth = str(tmp / "port.pth")
    torch.save(sd, pth)
    img = CFG.feat_h * PATCH
    vit = vit_for_ver(jcfg, patch_size=PATCH, num_layers=1, num_heads=4)
    variables = vit.init(jax.random.PRNGKey(1),
                         np.zeros((1, img, img, 3), np.float32))
    vit_pth = str(tmp / "vit.pth")
    torch.save(vit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)), vit_pth)
    return pth, vit_pth


def test_feature_requests_match_the_jax_server(weights, tmp_path):
    reqs = {f"r{i}": dict(zip(("features", "world2pixel", "origin_shift"),
                              _request(i))) for i in range(3)}
    reqs["bad"] = dict(features=np.zeros((1, 2, 2, 3), np.float32),
                       world2pixel=np.zeros((1, 4, 4), np.float32),
                       origin_shift=np.zeros(3, np.float32))
    jq, tq = str(tmp_path / "jax"), str(tmp_path / "port")
    for q in (jq, tq):
        _write_requests(q, reqs)
        # the client's write is old: a malformed file is not a half-write
        old = time.time() - 10
        os.utime(os.path.join(q, "in", "bad.npz"), (old, old))
    assert _jax_serve().serve(_args(jq, occupancy=True,
                                    max_requests=3)) == 3
    times = []
    assert tserve.serve(_args(tq, occupancy=True, max_requests=3,
                              checkpoint=weights[0], device="cpu"),
                        times=times) == 3
    # claims of 2 in name order: (bad, r0), then (r1, r2)
    assert [(t["requests"], t["batches"]) for t in times] == [(1, 1), (2, 1)]
    assert all(t[k] >= 0 for t in times for k in
               ("claim", "load", "upload", "forward", "copy", "write"))
    for rid in ("r0", "r1", "r2"):
        want, got = _read(jq, rid), _read(tq, rid)
        assert sorted(got) == sorted(want) == ["occupancy", "volume"]
        assert got["volume"].shape == (CFG.embed_dims, CFG.bev_z, CFG.bev_h,
                                       CFG.bev_w)
        assert got["volume"].dtype == np.float32
        assert got["occupancy"].dtype == np.int32
        np.testing.assert_allclose(got["volume"], want["volume"], rtol=1e-4,
                                   atol=2e-5, err_msg=rid)
        np.testing.assert_array_equal(got["occupancy"], want["occupancy"])
    for q in (jq, tq):
        assert os.path.exists(os.path.join(q, "out", "bad.error.txt"))
        assert not os.listdir(os.path.join(q, "in"))


def test_image_requests_match_the_jax_server(weights, tmp_path):
    img = CFG.feat_h * PATCH
    images = np.random.default_rng(3).integers(
        0, 256, (CFG.num_cams, img, img, 3)).astype(np.uint8)
    feats, w2p, shift = _request(0)
    reqs = {"imgreq": dict(images=images, world2pixel=w2p,
                           origin_shift=shift),
            "featreq": dict(features=feats, world2pixel=w2p,
                            origin_shift=shift)}
    jq, tq = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(images=True, max_requests=2, vit_checkpoint=weights[1],
              vit_patch_size=PATCH, vit_layers=1, vit_heads=4)
    for q in (jq, tq):
        _write_requests(q, reqs)
    assert _jax_serve().serve(_args(jq, **kw)) == 2
    assert tserve.serve(_args(tq, checkpoint=weights[0], device="cpu",
                              **kw)) == 2
    for rid in reqs:
        np.testing.assert_allclose(_read(tq, rid)["volume"],
                                   _read(jq, rid)["volume"], rtol=1e-4,
                                   atol=2e-5, err_msg=rid)


def test_orphaned_claim_is_swept_back_and_served(weights, tmp_path):
    q = str(tmp_path / "q")
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    orphan = os.path.join(q, f".claimed.{tserve._claim_host()}-{dead.pid}")
    os.makedirs(orphan)
    os.makedirs(os.path.join(q, "in"))
    np.savez(os.path.join(orphan, "lost.npz"),
             **dict(zip(("features", "world2pixel", "origin_shift"),
                        _request(5))))

    def stop_when_served():
        out = os.path.join(q, "out", "lost.npz")
        deadline = time.time() + 60
        while not os.path.exists(out) and time.time() < deadline:
            time.sleep(0.02)
        open(os.path.join(q, "in", "STOP"), "w").close()

    t = threading.Thread(target=stop_when_served)
    t.start()
    served = tserve.serve(_args(q, checkpoint=weights[0], device="cpu"))
    t.join()
    assert served == 1
    assert _read(q, "lost")["volume"].shape[0] == CFG.embed_dims
    assert not os.path.exists(orphan)
    assert not os.listdir(os.path.join(q, "in"))


def test_sweep_follows_the_jax_tools_rules(tmp_path):
    """tests/test_serve.py's cross-host scenario on both sweeps."""
    jsv = _jax_serve()
    for name, sweep in (("jax", jsv._sweep_orphans),
                        ("port", tserve._sweep_orphans)):
        queue = str(tmp_path / name)
        inbox = os.path.join(queue, "in")
        os.makedirs(inbox)

        def make_claim(dirname, fname, age_s):
            d = os.path.join(queue, dirname)
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, fname)
            np.save(path, np.zeros(2, np.float32))
            old = time.time() - age_s
            os.utime(path, (old, old))

        host = tserve._claim_host()
        assert host == jsv._claim_host()
        make_claim(".claimed.otherhost-994321", "r1.npy", 1.0)
        make_claim(".claimed.otherhost-994321", "r2.npy", 9999.0)
        make_claim(f".claimed.{host}-994322", "r3.npy", 1.0)
        make_claim(f".claimed.{host}-{os.getpid()}", "r4.npy", 9999.0)
        sweep(queue, inbox, max_age_s=300.0)
        assert sorted(os.listdir(inbox)) == ["r2.npy", "r3.npy"], name
        assert os.path.exists(os.path.join(
            queue, ".claimed.otherhost-994321", "r1.npy"))


def test_cli_refuses_cuda_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tserve.main([CONFIG, "--queue", str(tmp_path / "q")])
