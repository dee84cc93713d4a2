"""``parallel.pipeline`` over gloo processes against JAX's
``pipeline_apply``, fp32 on the CPU.

* JAX's toy layers (``tests/test_pipeline.py``: 4 layers of ``tanh(h @ w +
  b) * scale``) at stages 2 and 4 with 2 and 4 microbatches, and at
  (stage 2, data 2): outputs within rtol and atol 1e-6 (JAX's bound for
  its own pipeline), the gradients of ``sum(out ** 2)`` (every layer's, and
  ``x``'s summed over the ranks) within rtol and atol 1e-5: they reach 10,
  and torch and XLA sum a weight gradient's 48 row products in different
  orders (JAX's atol 1e-6 holds JAX against itself).
* 4 tiny ``VoxelEncoderLayer``\\ s (``tests/test_train_step.TINY``), JAX's
  weights carried across by the port's converter, at (stage 2,
  microbatches 2) and (stage 2, data 2): outputs within 2e-5, the
  gradients of every layer parameter, of the query and of the SCA's value
  within rtol 5e-4 / atol 5e-5 (tests/test_pipeline.py's bounds).
* the three ``ValueError``\\ s, with JAX's messages.

The JAX values are computed here and handed to the worker processes as
files; the workers import torch and the port only.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import launch, worker_main

torch.set_num_threads(1)

L, D_TOY, B_TOY, SCALE = 4, 16, 8, 1.1
# (name, stages, data, microbatches, kind); the world is stages x data
CASES = [("toy_s2_m2", 2, 1, 2, "toy"), ("toy_s2_m4", 2, 1, 4, "toy"),
         ("enc_s2_m2", 2, 1, 2, "encoder"),
         ("toy_s4_m2", 4, 1, 2, "toy"), ("toy_s4_m4", 4, 1, 4, "toy"),
         ("toy_s2_d2", 2, 2, 2, "toy"), ("enc_s2_d2", 2, 2, 2, "encoder")]
ENC_KEYS = ("query", "value", "ref_cam", "bev_mask")


# ---- the port's side (worker processes) -----------------------------------

class ToyLayer(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))
        self.b = torch.nn.Parameter(torch.from_numpy(b))


def toy_fn(layer, h, scale):
    return torch.tanh(h @ layer.w + layer.b) * scale


def _encoder_layers(cfg: dict, weights: str):
    from vln_ver_tpu_torch.models import VERConfig
    from vln_ver_tpu_torch.models.encoder import VoxelEncoderLayer
    cfg = VERConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in cfg.items()})
    layers = torch.nn.ModuleList([VoxelEncoderLayer(cfg) for _ in range(L)])
    layers.load_state_dict({k: torch.from_numpy(v) for k, v in
                            np.load(weights).items()}, strict=True)
    shapes = ((cfg.feat_h, cfg.feat_w),)

    def layer_fn(layer, h, value, ref_cam, bev_mask):
        return layer(h, value, ref_cam, bev_mask, shapes)
    return layers.eval(), layer_fn


def pipeline_worker(out: str, files: dict, cfg: dict, cases: list) -> None:
    from vln_ver_tpu_torch.parallel import multihost
    from vln_ver_tpu_torch.parallel.pipeline import make_pp_mesh, pipeline_apply
    rank = multihost.process_index()
    for name, stages, data, micro, kind in cases:
        mesh = make_pp_mesh(stages, data)
        z = np.load(files[kind])
        if kind == "toy":
            layers = [ToyLayer(z["w"][i], z["b"][i]) for i in range(L)]
            layer_fn, x = toy_fn, torch.from_numpy(z["x"])
            bargs, shared = (), (torch.tensor(SCALE),)
            params = [(f"{i}.{n}", p) for i, layer in enumerate(layers)
                      for n, p in layer.named_parameters()]
        else:
            layers, layer_fn = _encoder_layers(cfg, files["weights"])
            x, value, ref_cam, mask = (torch.from_numpy(z[k])
                                       for k in ENC_KEYS)
            value.requires_grad_(True)
            bargs, shared = (value, ref_cam, mask), ()
            params = list(layers.named_parameters())
        x.requires_grad_(True)
        y = pipeline_apply(mesh, layer_fn, layers, x, *bargs, shared=shared,
                           microbatches=micro)
        (y ** 2).sum().backward()
        # x reaches the layers on stage 0 alone
        res = {"out": y.detach().numpy(),
               "x_grad": (torch.zeros_like(x) if x.grad is None
                          else x.grad).numpy()}
        if kind == "encoder":
            res["value_grad"] = value.grad.numpy()
        res.update({f"grad/{n}": p.grad.numpy() for n, p in params
                    if p.grad is not None})
        np.savez(f"{out}.{name}.{rank}.npz", **res)


# ---- JAX's side and the comparisons ---------------------------------------

def _jax_toy(tmp):
    import jax
    import jax.numpy as jnp

    from vln_ver_tpu.parallel.pipeline import (make_pp_mesh, pipeline_apply,
                                               stack_layer_params)
    rng = np.random.default_rng(0)
    trees = [{"w": (rng.standard_normal((D_TOY, D_TOY)) / np.sqrt(D_TOY))
              .astype(np.float32),
              "b": (rng.standard_normal(D_TOY) * 0.1).astype(np.float32)}
             for _ in range(L)]
    stacked = stack_layer_params([jax.tree.map(jnp.asarray, t)
                                  for t in trees])
    x = rng.standard_normal((B_TOY, 6, D_TOY)).astype(np.float32)

    def layer(p, h, scale):
        return jnp.tanh(h @ p["w"] + p["b"]) * scale

    refs = {}
    for name, stages, data, micro, kind in CASES:
        if kind != "toy":
            continue
        mesh = make_pp_mesh(stages, data=data)

        @jax.jit
        def run(p, xx, mesh=mesh, micro=micro):
            out, vjp = jax.vjp(lambda p, xx: pipeline_apply(
                mesh, layer, p, xx, shared=(jnp.float32(SCALE),),
                microbatches=micro), p, xx)
            return (out,) + vjp(2 * out)    # the gradient of sum(out ** 2)
        out, gp, gx = run(stacked, jnp.asarray(x))
        refs[name] = {"out": np.asarray(out), "x_grad": np.asarray(gx),
                      **{f"grad/{i}.{k}": np.asarray(gp[k][i])
                         for i in range(L) for k in ("w", "b")}}
    path = str(tmp / "toy.npz")
    np.savez(path, w=np.stack([t["w"] for t in trees]),
             b=np.stack([t["b"] for t in trees]), x=x)
    return path, refs


def _jax_encoder(tmp):
    import jax
    import jax.numpy as jnp

    from tests.test_train_step import TINY, _toy_batch
    from vln_ver_tpu import geometry
    from vln_ver_tpu.models.encoder import VoxelEncoderLayer
    from vln_ver_tpu.parallel.pipeline import (make_pp_mesh, pipeline_apply,
                                               stack_layer_params)
    from vln_ver_tpu_torch.convert.voxelformer import KeyMap, _mapping
    from vln_ver_tpu_torch.models import VERConfig

    cfg = dataclasses.replace(TINY, encoder_layers=L)
    batch = _toy_batch(b=4, cfg=cfg)
    feats = jnp.asarray(batch["features"])
    b, n_cam = feats.shape[:2]
    value = feats.reshape(b, n_cam, -1, cfg.in_channels)
    ref3d = geometry.voxel_reference_points(cfg.bev_z, cfg.bev_h, cfg.bev_w)
    ref_cam, bev_mask = jax.vmap(
        lambda w2p, shift: geometry.project_reference_points(
            ref3d, w2p, shift, pc_range=cfg.pc_range))(
                jnp.asarray(batch["world2pixel"]),
                jnp.asarray(batch["origin_shift"]))
    ref_cam, bev_mask = ref_cam[:, :, :, None, :], bev_mask[:, :, :, None]
    shapes = ((cfg.feat_h, cfg.feat_w),)
    layer = VoxelEncoderLayer(cfg)
    rng = np.random.default_rng(3)
    query = jnp.asarray(rng.standard_normal(
        (b, cfg.bev_num, cfg.embed_dims)).astype(np.float32))
    # every leaf moved off its init, so that the sampling offsets and
    # attention weights are tested (as tests/test_torch_model.py does)
    init = jax.jit(lambda key: layer.init(
        key, query, value, ref_cam, bev_mask, shapes,
        deterministic=True)["params"])
    trees = [jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32)), init(jax.random.PRNGKey(10 + i)))
        for i in range(L)]
    stacked = stack_layer_params(trees)

    def layer_fn(p, h, value, ref_cam, bev_mask):
        return layer.apply({"params": p}, h, value, ref_cam, bev_mask,
                           shapes, deterministic=True)

    # JAX's layer trees carried to the port's names by its converter
    tcfg = VERConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(VERConfig)
                        if f.name != "dtype"})
    prefix = "pts_bbox_head.transformer.encoder.layers."
    keymap = KeyMap({k[len(prefix):]: v for k, v in _mapping(tcfg).items()
                     if k.startswith(prefix)})

    def to_port(tree_list):
        leaves = {}
        for i, tree in enumerate(tree_list):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                key = "/".join(p.key for p in path)
                leaves[f"pts_bbox_head/transformer/encoder/layer_{i}/"
                       f"{key}"] = np.asarray(leaf)
        sd, rest = keymap.convert(leaves)
        assert not rest, rest
        return {k: v.numpy() for k, v in sd.items()}

    inputs = {"query": np.asarray(query), "value": np.asarray(value),
              "ref_cam": np.asarray(ref_cam),
              "bev_mask": np.asarray(bev_mask)}
    refs = {}
    for name, stages, data, micro, kind in CASES:
        if kind != "encoder":
            continue
        mesh = make_pp_mesh(stages, data=data)

        @jax.jit
        def run(p, q, v, mesh=mesh, micro=micro):
            out, vjp = jax.vjp(lambda p, q, v: pipeline_apply(
                mesh, layer_fn, p, q, v, ref_cam, bev_mask,
                microbatches=micro), p, q, v)
            return (out,) + vjp(2 * out)
        out, gp, gq, gv = run(stacked, query, value)
        grads = to_port([jax.tree.map(lambda a, i=i: a[i], gp)
                         for i in range(L)])
        refs[name] = {"out": np.asarray(out), "x_grad": np.asarray(gq),
                      "value_grad": np.asarray(gv),
                      **{f"grad/{k}": v for k, v in grads.items()}}
    path, weights = str(tmp / "encoder.npz"), str(tmp / "weights.npz")
    np.savez(weights, **to_port(trees))
    np.savez(path, **inputs)
    cfg_json = {f.name: getattr(tcfg, f.name)
                for f in dataclasses.fields(tcfg) if f.name != "dtype"}
    return path, weights, cfg_json, refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    toy, toy_refs = _jax_toy(tmp)
    enc, weights, cfg, enc_refs = _jax_encoder(tmp)
    out = str(tmp / "res")
    files = {"toy": toy, "encoder": enc, "weights": weights}
    for world in (2, 4):
        launch(world, __file__, "pipeline_worker", timeout=150, out=out,
               files=files, cfg=cfg, cases=[c for c in CASES
                                   if c[1] * c[2] == world])
    return out, {**toy_refs, **enc_refs}


def _rows(b, micro, data, d):
    """The rows of a (b, ...) batch that data rank d holds."""
    mb = b // micro
    r = mb // data
    return np.concatenate([np.arange(k * mb + d * r, k * mb + (d + 1) * r)
                           for k in range(micro)])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pipeline_matches_jax(runs, case):
    out, refs = runs
    name, stages, data, micro, kind = case
    ref = refs[name]
    ranks = [dict(np.load(f"{out}.{name}.{r}.npz"))
             for r in range(stages * data)]
    tol = (dict(rtol=1e-6, atol=1e-6) if kind == "toy"
           else dict(rtol=2e-5, atol=2e-5))
    gtol = (dict(rtol=1e-5, atol=1e-5) if kind == "toy"
            else dict(rtol=5e-4, atol=5e-5))
    b = ref["out"].shape[0]
    for r, res in enumerate(ranks):
        rows = _rows(b, micro, data, r % data)
        np.testing.assert_allclose(res["out"], ref["out"][rows], **tol,
                                   err_msg=f"rank {r} out")
    # the input gradients, summed over the ranks, are the stack's
    for key in ("x_grad", "value_grad") if kind == "encoder" else ("x_grad",):
        got = sum(res[key] for res in ranks)
        np.testing.assert_allclose(got, ref[key], **gtol, err_msg=key)
    # each layer's gradient lives on its stage, summed over its data ranks
    per = L // stages
    for key in (k for k in ref if k.startswith("grad/")):
        layer = int(key.split("/")[1].split(".")[0])
        owners = [ranks[(layer // per) * data + d] for d in range(data)]
        assert all(key in res for res in owners), key
        got = sum(res[key] for res in owners)
        np.testing.assert_allclose(got, ref[key], **gtol, err_msg=key)
        others = [res for i, res in enumerate(ranks)
                  if i // data != layer // per]
        assert not any(key in res for res in others), key


def _mesh(stages, data=1):
    from vln_ver_tpu_torch.parallel.mesh import Mesh
    return Mesh((stages, data), 0, 0, axis_names=("stage", "data"),
                coords=(0, 0))


@pytest.mark.parametrize("stages,data,micro,batch,match", [
    (3, 1, 2, 4, "4 layers over 3 stages"),
    (2, 1, 3, 4, "batch 4 into 3 microbatches"),
    (2, 3, 2, 4, "microbatch rows 2 \\(batch 4 / 2 microbatches\\) must be "
                 "divisible by the mesh data axis size 3")],
    ids=["layers", "microbatches", "data"])
def test_pipeline_refusals(stages, data, micro, batch, match):
    from vln_ver_tpu_torch.parallel.pipeline import pipeline_apply
    layers = [ToyLayer(np.eye(4, dtype=np.float32),
                       np.zeros(4, np.float32)) for _ in range(L)]
    with pytest.raises(ValueError, match=match):
        pipeline_apply(_mesh(stages, data), toy_fn, layers,
                       torch.zeros(batch, 4), shared=(1.0,),
                       microbatches=micro)


def test_one_stage_without_a_process_group_is_the_stack():
    from vln_ver_tpu_torch.parallel.pipeline import (make_pp_mesh,
                                                     pipeline_apply,
                                                     sequential_apply)
    rng = np.random.default_rng(5)
    layers = [ToyLayer(rng.standard_normal((4, 4)).astype(np.float32),
                       rng.standard_normal(4).astype(np.float32))
              for _ in range(L)]
    x = torch.from_numpy(rng.standard_normal((6, 3, 4)).astype(np.float32))
    got = pipeline_apply(make_pp_mesh(1), toy_fn, layers, x, shared=(0.9,),
                         microbatches=3)
    torch.testing.assert_close(got, sequential_apply(toy_fn, layers, x,
                                                     shared=(0.9,)),
                               rtol=0, atol=0)


if __name__ == "__main__":
    worker_main(globals())
