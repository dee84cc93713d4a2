"""The port's VLN pretraining against the JAX package on the CPU:

* ``VLNPretrainModel``'s losses (sap, mlm, og; rtol 1e-4) and every
  gradient (rtol 1e-3, atol 1e-5) against ``jax.value_and_grad``, on
  weights carried by ``pretrain_state_dict_from_jax``, with JAX's masked
  tokens fed to both and dropout off;
* ``mask_tokens``'s statistics: 15 % selected, 80 / 10 / 10, pad and the
  special ids never selected;
* the ``policy.`` subtree is the finetuning policy's state dict, and the
  converter is strict both ways;
* ``build_vln_setup``'s synthetic branch builds JAX's config and
  environment;
* the CLI chain ``pretrain_vln`` -> ``train_vln --init-from-pretrain`` ->
  ``test_vln``, all ``--synthetic --device cpu``: the pretraining loss
  drops (as tests/test_vln_pretrain.py asserts for JAX) and the policy
  subtree is what finetuning starts from."""

import dataclasses
import functools
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from test_torch_agent_train import (KW, LOSS_RTOL, _cfgs, assert_grads_match,
                                    both_records, fill_params)

from vln_ver_tpu.agent.cli_setup import build_vln_setup as jbuild_vln_setup
from vln_ver_tpu.agent.pretrain import VLNPretrainModel as JPretrainModel
from vln_ver_tpu.agent.pretrain import mask_tokens as jmask_tokens
from vln_ver_tpu.agent.pretrain import stack_records as jstack
from vln_ver_tpu_torch import pretrain_vln, test_vln, train_vln
from vln_ver_tpu_torch.agent.cli_setup import build_vln_setup
from vln_ver_tpu_torch.agent.policy import VLNPolicy
from vln_ver_tpu_torch.agent.pretrain import (VLNPretrainModel,
                                              extract_policy_params,
                                              init_pretrain_params,
                                              mask_tokens, pretrain_loss,
                                              stack_records)
from vln_ver_tpu_torch.convert import pretrain_state_dict_from_jax
from vln_ver_tpu_torch.utils.checkpoint import model_file


def _jax_pretrain_params(jcfg, jbatch, masked, sel, objects):
    shapes = jax.eval_shape(
        functools.partial(JPretrainModel(jcfg).init, deterministic=True),
        jax.random.PRNGKey(0), jax.tree.map(lambda x: x[:1], jbatch),
        masked[:1], jbatch["instruction"][:1], sel[:1])
    assert ("ground_proj" in shapes["params"]["policy"]) == objects
    return fill_params(shapes, jcfg)


@pytest.mark.parametrize("arch,objects", [("preln", False), ("bert", True)],
                         ids=["preln-r2r", "bert-reverie"])
def test_pretrain_losses_and_grads_match_jax(tmp_path, arch, objects):
    _, jrecs, recs = both_records(tmp_path, objects)
    jcfg, tcfg = _cfgs(arch)
    jbatch, batch = jstack(jrecs[:12]), stack_records(recs[:12])
    masked, targets, sel = jmask_tokens(jax.random.PRNGKey(3),
                                        jbatch["instruction"],
                                        jcfg.vocab_size)
    assert int(sel.sum()) > 0
    params = _jax_pretrain_params(jcfg, jbatch, masked, sel, objects)
    jmodel = JPretrainModel(jcfg)

    def jloss(p):
        losses = jmodel.apply(p, jbatch, masked, targets, sel,
                              deterministic=True)
        return sum(losses.values()), losses
    (jtotal, jparts), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)

    model = VLNPretrainModel(tcfg, grounding=objects)
    model.load_state_dict(pretrain_state_dict_from_jax(params, tcfg),
                          strict=True)
    t = [torch.from_numpy(np.asarray(a)) for a in (masked, targets, sel)]
    parts = model.eval()(batch, *t)
    total = sum(parts.values())
    total.backward()
    assert sorted(parts) == sorted(jparts) == sorted(
        ["sap", "mlm"] + (["og"] if objects else []))
    for k, v in parts.items():
        np.testing.assert_allclose(float(v.detach()), float(jparts[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(jtotal),
                               rtol=LOSS_RTOL)
    assert_grads_match(model, pretrain_state_dict_from_jax(jgrads, tcfg),
                       f"pretrain {arch}")

    # dropout follows the mode: train() draws, eval() is the identity
    with torch.no_grad():
        torch.manual_seed(0)
        a = model.train()(batch, *t)["mlm"]
        b = model(batch, *t)["mlm"]
        c = model.eval()(batch, *t)["mlm"]
    assert float(a) != float(b) and float(c) == float(parts["mlm"])


def test_mask_tokens_statistics():
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(4, 100, (512, 48)).astype(
        np.int32))
    tokens[:, 40:] = 0                  # pad tail
    tokens[:, 0], tokens[:, 39] = 2, 3  # [CLS] / [SEP]-like specials
    gen = torch.Generator().manual_seed(0)
    masked, targets, sel = mask_tokens(gen, tokens, vocab_size=100,
                                       mask_id=1, special_ids=(2, 3))
    assert masked.dtype == tokens.dtype and torch.equal(targets, tokens)
    assert not sel[:, 40:].any() and not sel[:, [0, 39]].any()
    assert torch.equal(masked[~sel], tokens[~sel])
    rate = float(sel.sum()) / (512 * 38)
    assert abs(rate - 0.15) < 0.01, rate
    m, t = masked[sel], tokens[sel]
    n = len(m)
    as_mask = float((m == 1).sum()) / n
    unchanged = float((m == t).sum()) / n
    # a random id equal to the original counts as unchanged: 1 in 98
    assert abs(as_mask - 0.8) < 0.02, as_mask
    assert abs(unchanged - (0.1 + 0.1 / 98)) < 0.015, unchanged
    rand = m[(m != 1) & (m != t)]
    assert len(rand) and int(rand.min()) >= 2 and int(rand.max()) < 100
    # the same generator state, the same masks
    again = mask_tokens(torch.Generator().manual_seed(0), tokens, 100,
                        special_ids=(2, 3))
    assert torch.equal(again[0], masked) and torch.equal(again[2], sel)


def test_policy_subtree_and_strict_converter(tmp_path):
    _, jrecs, _ = both_records(tmp_path, False)
    jcfg, tcfg = _cfgs("preln")
    jbatch = jstack(jrecs[:2])
    masked, targets, sel = jmask_tokens(jax.random.PRNGKey(0),
                                        jbatch["instruction"],
                                        jcfg.vocab_size)
    params = _jax_pretrain_params(jcfg, jbatch, masked, sel, False)
    sd = pretrain_state_dict_from_jax(params, tcfg)
    model = init_pretrain_params(VLNPretrainModel(tcfg), seed=4)
    assert sd.keys() == model.state_dict().keys()
    head = {k for k in sd if not k.startswith("policy.")}
    assert {k.split(".")[0] for k in head} == {
        "mlm_cross", "mlm_ln", "mlm_dense", "mlm_ln2", "mlm_out"}
    assert model.mlm_out.weight.shape == (KW["vocab_size"], KW["embed_dims"])
    policy = VLNPolicy(tcfg)
    policy.load_state_dict(extract_policy_params(model.state_dict()),
                           strict=True)
    assert torch.equal(policy.score_head.weight,
                       model.policy.score_head.weight)
    again = init_pretrain_params(VLNPretrainModel(tcfg), seed=4)
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), again.state_dict().values()))

    extra = jax.tree.map(lambda a: a, params)
    extra["params"]["mlm_extra"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="mlm_extra"):
        pretrain_state_dict_from_jax(extra, tcfg)
    short = jax.tree.map(lambda a: a, params)
    del short["params"]["mlm_out"]["bias"]
    with pytest.raises(KeyError, match="mlm_out.bias"):
        pretrain_state_dict_from_jax(short, tcfg)


@pytest.mark.parametrize("objects", [None, "synthetic"])
def test_synthetic_setup_matches_jax(tmp_path, objects):
    args = SimpleNamespace(synthetic=True, work_dir=str(tmp_path),
                           embed_dims=None, objects=objects, data_dir=None,
                           connectivity=None, ver=None, benchmark="R2R",
                           bert_vocab=None)
    got, want = build_vln_setup(args), jbuild_vln_setup(args)
    a, b = dataclasses.asdict(got.cfg), dataclasses.asdict(want.cfg)
    a.pop("dtype"), b.pop("dtype")
    assert a == b
    assert len(got.episodes) == len(want.episodes)
    for a, b in zip(got.episodes, want.episodes):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_equal(a[k], b[k], err_msg=k)
    assert sorted(got.ver) == sorted(want.ver)
    for k in got.ver:
        np.testing.assert_array_equal(got.ver[k], want.ver[k])
    assert (got.mask_id, got.special_ids) == (want.mask_id, want.special_ids)
    assert (got.objects is None) == (objects is None)


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_chain_pretrain_train_test_vln(tmp_path):
    pre, vln = str(tmp_path / "pre"), str(tmp_path / "vln")
    common = ["--synthetic", "--device", "cpu", "--objects", "synthetic"]
    pretrain_vln.main(common + ["--steps", "24", "--batch", "8", "--lr",
                                "1e-3", "--log-interval", "1",
                                "--work-dir", pre])
    log = _log(os.path.join(pre, "pretrain_log.jsonl"))
    assert [m["step"] for m in log] == list(range(1, 25))
    assert all(np.isfinite(m[k]) for m in log for k in ("sap", "mlm", "og"))
    for k in ("sap", "mlm", "loss"):
        first = np.mean([m[k] for m in log[:4]])
        last = np.mean([m[k] for m in log[-4:]])
        assert last < first, (k, first, last)
    pre_sd = torch.load(model_file(os.path.join(pre, "ckpt")),
                        weights_only=True)
    assert any(k.startswith("mlm_out.") for k in pre_sd)

    # --steps 0: the saved policy is the pretrained subtree itself
    train_vln.main(common + ["--steps", "0", "--init-from-pretrain",
                             os.path.join(pre, "ckpt"), "--work-dir",
                             str(tmp_path / "zero")])
    zero = torch.load(model_file(str(tmp_path / "zero" / "ckpt")),
                      weights_only=True)
    want = extract_policy_params(pre_sd)
    assert zero.keys() == want.keys()
    assert all(torch.equal(zero[k], want[k]) for k in want)

    metrics = train_vln.main(common + [
        "--steps", "16", "--eval-interval", "8", "--eval-limit", "4",
        "--episode-batch", "4", "--init-from-pretrain",
        os.path.join(pre, "ckpt"), "--work-dir", vln])
    assert metrics["step"] == 16
    log = _log(os.path.join(vln, "vln_log.jsonl"))
    assert [m["step"] for m in log if "success" in m] == [8, 16]
    out = test_vln.main(["--checkpoint", os.path.join(vln, "ckpt"),
                         "--synthetic", "--objects", "synthetic", "--device",
                         "cpu", "--work-dir", vln, "--batch", "8"])
    assert all(np.isfinite(v) for v in out.values())
    assert 0.0 <= out["success"] <= 1.0 and 0.0 <= out["spl"] <= 1.0


@pytest.mark.parametrize("cli", [pretrain_vln, train_vln])
def test_trainer_clis_refuse_mesh_and_missing_cuda(tmp_path, cli):
    # a mesh the world (one process) cannot hold
    with pytest.raises(ValueError, match="needs 2 processes"):
        cli.main(["--synthetic", "--mesh", "2", "--device", "cpu",
                  "--work-dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["--synthetic", "--work-dir", str(tmp_path)])


def test_pretrain_loss_masks_with_the_generator(tmp_path):
    _, _, recs = both_records(tmp_path, False)
    _, tcfg = _cfgs("preln")
    model = init_pretrain_params(VLNPretrainModel(tcfg), seed=0).eval()
    batch = stack_records(recs[:8])
    with torch.no_grad():
        a, b, c = (pretrain_loss(model, batch,
                                 torch.Generator().manual_seed(s))
                   for s in (5, 5, 6))
    assert float(a[0]) == float(b[0]) != float(c[0])
    assert float(a[1]["sap"]) == float(c[1]["sap"])


def test_real_format_setup_with_bert_vocab_matches_jax(tmp_path):
    """The R2R-format branch with a WordPiece vocab: ``[MASK]`` is the mask
    id and ``[CLS]`` / ``[SEP]`` are never masked, as in JAX's setup; both
    trainers run on it."""
    h5py = pytest.importorskip("h5py")
    from test_torch_agent_env import _write_r2r
    root = str(tmp_path)
    _write_r2r(root)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                                "walk", "to", "the", "second", "room", "go",
                                "forward", "twice", "move", "ahead", "and",
                                "stop"]) + "\n")
    ver = str(tmp_path / "ver.hdf5")
    rng = np.random.default_rng(0)
    with h5py.File(ver, "w") as f:
        for i in range(4):
            f.create_dataset(f"scanA_vp{i}", data=rng.standard_normal(
                (16, 4, 15, 15)).astype(np.float32))
    flags = dict(data_dir=root, connectivity=os.path.join(root,
                                                          "connectivity"),
                 ver=ver, benchmark="REVERIE", bert_vocab=str(vocab))
    args = SimpleNamespace(synthetic=False, work_dir=root, embed_dims=16,
                           objects=None, **flags)
    got, want = build_vln_setup(args), jbuild_vln_setup(args)
    assert (got.mask_id, got.special_ids) == (want.mask_id,
                                              want.special_ids) == (4, (2, 3))
    a, b = dataclasses.asdict(got.cfg), dataclasses.asdict(want.cfg)
    a.pop("dtype"), b.pop("dtype")
    assert a == b and a["vocab_size"] == 17
    assert len(got.episodes) == len(want.episodes) == 3
    for x, y in zip(got.episodes, want.episodes):
        np.testing.assert_array_equal(x["instruction_tokens"],
                                      y["instruction_tokens"])

    argv = ["--data-dir", root, "--connectivity", flags["connectivity"],
            "--ver", ver, "--benchmark", "REVERIE", "--bert-vocab",
            str(vocab), "--embed-dims", "16", "--device", "cpu"]
    m = pretrain_vln.main(argv + ["--steps", "2", "--batch", "4",
                                  "--log-interval", "1", "--work-dir",
                                  str(tmp_path / "pre")])
    assert m["step"] == 2 and np.isfinite(m["mlm"])
    m = train_vln.main(argv + ["--steps", "4", "--update-batch", "2",
                               "--eval-limit", "1", "--work-dir",
                               str(tmp_path / "vln")])
    assert m["step"] == 4 and np.isfinite(m["spl"])
