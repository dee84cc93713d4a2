"""Dry run of the port's day-one fire drill
(``python -m vln_ver_tpu_torch.fire_drill``) on vocc_tiny.py with synthetic
data on the CPU: every stage of tools/fire_drill.py passes through the
port's CLIs (about 30 s on 8 cores).  Alone in its file: its stages are
subprocesses, and ``--dist loadfile`` gives the file a worker."""

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "verformer", "vocc_tiny.py")
STAGES = ("contract", "capacity", "convert", "eval", "dump", "images",
          "mesh_dump", "vln")


def test_fire_drill_synthetic_on_the_cpu(tmp_path):
    # vocc_tiny.py with its data under tmp_path: the JAX drill's test
    # writes data/tiny of the repository at the same time
    data = tmp_path / "data"
    cfg = tmp_path / "vocc_tiny_here.py"
    cfg.write_text(
        f"_base_ = [{CONFIG!r}]\n"
        "data = dict(\n" + "".join(
            f"    {split}=dict(data_root={str(data)!r}, "
            f"ann_file={str(data / ann)!r}),\n"
            for split, ann in (("train", "mp3d_trainval.pkl"),
                               ("val", "mp3d_test.pkl"),
                               ("test", "mp3d_test.pkl"))) + ")\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "vln_ver_tpu_torch.fire_drill", str(cfg),
         "--synthetic", "--device", "cpu", "--limit", "2", "--vln-steps",
         "8", "--work-dir", str(tmp_path / "drill")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert "all stages green" in out, out[-4000:]
    for stage in STAGES:
        assert f"[fire_drill] {stage}: PASS" in out, (stage, out[-4000:])
    for name in ("ver.hdf5", "ver_from_images.hdf5", "ver_mesh.hdf5.shard0"):
        assert (tmp_path / "drill" / name).exists(), name
    # about 30 s alone on 8 cores; the bound leaves room for a loaded
    # machine without hiding a stage that hangs
    assert seconds < 300, f"the drill took {seconds:.1f}s"
