"""A tiny CPU run of each cell loads no module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``vln_ver_tpu`` (compared whole: the
port's ``vln_ver_tpu_torch`` begins with ``vln_ver_tpu``)."""

import json
import subprocess
import sys

import pytest

from . import tiny

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from verbench.tests import tiny
from verbench.bench import forbidden_modules
out = tiny.run({workload!r})
print(json.dumps({{"correct": out["correct"], "bad": forbidden_modules(),
                  "port": "vln_ver_tpu_torch" in sys.modules}}))
"""


@pytest.mark.parametrize("workload", ["ver36-full-b8", "vocc-train-b1",
                                      "ver36-dump-b8"])
def test_run_loads_no_jax(workload):
    code = SCRIPT.format(root=str(tiny.ROOT), workload=workload)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tiny.ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["port"] and out["bad"] == []


def test_forbidden_compares_whole_names(monkeypatch):
    from verbench import bench
    monkeypatch.setitem(sys.modules, "vln_ver_tpu_torch_fake", object())
    assert "vln_ver_tpu_torch_fake" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib.fake" in bench.forbidden_modules()
