"""``vln_ver_tpu_torch/utils/profiling.py`` against
``vln_ver_tpu/utils/profiling.py``: ``force_completion`` on the same
arrays, ``grad_report`` naming the same all-zero gradients (through the
converter's names), and the port's ``trace``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vln_ver_tpu.models import VoxelFormer as JaxVoxelFormer
from vln_ver_tpu.utils import profiling as jprof
from vln_ver_tpu_torch.convert import state_dict_from_jax
from vln_ver_tpu_torch.convert.voxelformer import _mapping
from vln_ver_tpu_torch.utils import profiling as tprof


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"b": [rng.standard_normal((3, 4)).astype(np.float32),
                  rng.integers(-5, 5, (7,)).astype(np.int32)],
            "a": {"y": rng.standard_normal((2, 2, 2)).astype(np.float32),
                  "x": np.float32(2.5)}}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


def test_force_completion_equals_jax():
    tree = _tree()
    want = jprof.force_completion(_to(tree, jnp.asarray))
    got = tprof.force_completion(_to(tree, lambda a: torch.as_tensor(a)))
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _jax_name(keystr: str) -> str:
    """"['params']['a']['b']" -> "a/b"."""
    parts = keystr.split("'")[1::2]
    return "/".join(parts[1:] if parts[0] == "params" else parts)


def test_grad_report_names_the_same_zero_gradients():
    from test_torch_model import JCFG, TCFG, _inputs

    feats, w2p, shift = _inputs(1)
    # the tree's structure and shapes: every value is drawn below
    params = jax.eval_shape(lambda: JaxVoxelFormer(JCFG).init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(w2p),
        jnp.asarray(shift)))["params"]
    rng = np.random.default_rng(3)
    # every gradient nonzero, then a few leaves zeroed: whole tensors,
    # a packed q/k/v attention's three kernels, and one of the three alone
    zero = {"pts_bbox_head/occ_proj/bias",
            "pts_bbox_head/transformer/cams_embeds",
            "pts_bbox_head/transformer/decoder/layer_1/norm2/scale",
            "pts_bbox_head/transformer/decoder/layer_0/self_attn/attn/query/"
            "kernel",
            "pts_bbox_head/transformer/decoder/layer_0/self_attn/attn/key/"
            "kernel",
            "pts_bbox_head/transformer/decoder/layer_0/self_attn/attn/value/"
            "kernel",
            "pts_bbox_head/transformer/decoder/layer_1/self_attn/attn/query/"
            "bias"}
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    names = ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in flat]
    assert zero <= set(names)
    leaves = [np.zeros(np.shape(x), np.float32) if n in zero
              else (rng.standard_normal(np.shape(x)) + 3.0).astype(np.float32)
              for n, (_, x) in zip(names, flat)]
    grads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), leaves)
    jax_zero = {_jax_name(k) for k in jprof.grad_report(
        {"params": grads}, limit=1000)}
    assert jax_zero == zero

    sd, _ = state_dict_from_jax(grads, TCFG)
    mapping = _mapping(TCFG)
    # a port tensor is zero where every JAX leaf it is packed from is; the
    # positional encoding, which flax builds only for a temporal config,
    # comes over as zeros
    want = {key for key, (paths, _) in mapping.items()
            if all(p in jax_zero for p in paths)}
    want |= {k for k in sd if ".positional_encoding." in k}
    got = tprof.grad_report({k: torch.as_tensor(v) for k, v in sd.items()},
                            limit=1000)
    assert set(got) == want
    assert ("pts_bbox_head.transformer.decoder.layers.0.attentions.0.attn."
            "in_proj_weight") in got
    assert not any("layers.1.attentions.0.attn.in_proj_bias" in k
                   for k in got)
    # the limit keeps the first names, in the mapping's order
    assert tprof.grad_report({k: torch.as_tensor(v) for k, v in sd.items()},
                             limit=2) == got[:2]


def test_grad_report_on_a_module_counts_absent_gradients():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    model[1](torch.ones(1, 4)).sum().backward()
    assert tprof.grad_report(model) == ["0.weight", "0.bias"]
    model[1].bias.grad.zero_()
    assert tprof.grad_report(model) == ["0.weight", "0.bias", "1.bias"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")):
        with tprof.span("test#matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any(e.get("name") == "test#matmul" for e in events)
    # the recorder's spans of the block beside it
    with open(tmp_path / "tr" / "spans.json") as f:
        rec = json.load(f)
    assert [s["name"] for s in rec["spans"]] == ["test#matmul"]


def test_grad_report_with_no_present_gradient():
    assert tprof.grad_report({"a": None, "b": None}) == ["a", "b"]
