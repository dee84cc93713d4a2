"""The port's converters of pretrained weights, on random-weight
``transformers`` modules (no download), against those modules and against
the JAX package's converters:

* ``agent.text.convert_hf_bert_params``: a ``BertModel`` onto
  ``TextEncoder(arch="bert")``, the token features within 2e-5 of HF's on
  real tokens (LayerNorm eps 1e-6 against BERT's 1e-12: the JAX test's
  bound) and within 1e-5 of the JAX encoder on JAX's converted tree;
* ``agent.crossmodal``: an ``LxmertXLayer``'s vision stream onto
  ``_FusionBlock(fusion_arch="bert")`` under each key alias, against HF
  (2e-5) and JAX (1e-5); DUET's two stacks detected;
* the ``convert_text_encoder`` and ``convert_crossmodal`` CLIs, their
  files through ``cli_setup.build_vln_setup`` and ``graft_pretrained``
  into a policy, and ``pretrain_vln`` / ``train_vln`` started from them.
"""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from vln_ver_tpu.agent.crossmodal import \
    convert_crossmodal_params as jconvert_crossmodal
from vln_ver_tpu.agent.policy import PolicyConfig as JPolicyConfig
from vln_ver_tpu.agent.policy import _FusionBlock as JFusionBlock
from vln_ver_tpu.agent.text import TextEncoder as JTextEncoder
from vln_ver_tpu.agent.text import convert_hf_bert_params as jconvert_bert
from vln_ver_tpu_torch import (convert_crossmodal, convert_text_encoder,
                               pretrain_vln, train_vln)
from vln_ver_tpu_torch.agent.cli_setup import (build_vln_setup,
                                               graft_pretrained)
from vln_ver_tpu_torch.agent.crossmodal import (convert_crossmodal_params,
                                                detect_x_layers)
from vln_ver_tpu_torch.agent.policy import (PolicyConfig, VLNPolicy,
                                            _FusionBlock, random_state_dict)
from vln_ver_tpu_torch.agent.text import TextEncoder, convert_hf_bert_params

HIDDEN, HEADS, INTER, LAYERS, VOCAB, MAX_POS = 32, 4, 64, 2, 120, 40


def _transformers():
    return pytest.importorskip("transformers")


def _tiny_bert(seed=0):
    tf = _transformers()
    cfg = tf.BertConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, intermediate_size=INTER,
        max_position_embeddings=MAX_POS, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(seed)
    return tf.BertModel(cfg, add_pooling_layer=False).eval()


def _xlayer(seed=0):
    tf = _transformers()
    from transformers.models.lxmert.modeling_lxmert import LxmertXLayer
    cfg = tf.LxmertConfig(hidden_size=HIDDEN, num_attention_heads=HEADS,
                          intermediate_size=INTER, hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    torch.manual_seed(seed)
    return LxmertXLayer(cfg).eval()


def _tokens(b=3, l=17, lengths=(17, 9, 5)):
    rng = np.random.default_rng(0)
    mask = np.arange(l)[None, :] < np.array(lengths)[:, None]
    return rng.integers(3, VOCAB, (b, l)) * mask, mask


def _bert_features(model, tokens, mask):
    with torch.no_grad():
        return model(input_ids=torch.tensor(tokens),
                     attention_mask=torch.tensor(mask.astype(np.int64))
                     ).last_hidden_state.numpy()


def _encoder(max_len=MAX_POS):
    return TextEncoder(vocab_size=VOCAB, embed_dims=HIDDEN,
                       num_layers=LAYERS, num_heads=HEADS, ffn_dim=INTER,
                       max_len=max_len, arch="bert")


@pytest.mark.parametrize("prefix", ["", "bert."])
def test_bert_converter_matches_hf_and_jax(prefix):
    model = _tiny_bert()
    sd = {prefix + k: v for k, v in model.state_dict().items()}
    enc = _encoder()
    enc.load_state_dict(convert_hf_bert_params(sd, LAYERS, HEADS,
                                               prefix=prefix), strict=True)
    tokens, mask = _tokens()
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(tokens), torch.from_numpy(mask))
    ref = _bert_features(model, tokens, mask)
    assert np.abs(got.numpy() - ref)[mask].max() < 2e-5

    jenc = JTextEncoder(vocab_size=VOCAB, embed_dims=HIDDEN,
                        num_layers=LAYERS, num_heads=HEADS, ffn_dim=INTER,
                        max_len=MAX_POS, arch="bert")
    want = jax.jit(jenc.apply)(jconvert_bert(sd, LAYERS, HEADS,
                                             prefix=prefix),
                               tokens, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(KeyError, match="embeddings"):
        convert_hf_bert_params(sd, LAYERS, HEADS, prefix="nope.")


def _visn_forward(layer, lang, lang_mask, visn):
    """The vision stream of an HF x-layer (the half the fusion blocks
    reproduce)."""
    ext = (1.0 - torch.tensor(lang_mask, dtype=torch.float32)
           [:, None, None, :]) * -10000.0
    with torch.no_grad():
        lang_att, visn_att = layer.cross_att(
            torch.tensor(lang), ext, torch.tensor(visn), None)
        lang_att, visn_att = layer.self_att(lang_att[0], ext,
                                            visn_att[0], None)
        return layer.output_fc(lang_att, visn_att)[1].numpy()


def _alias(sd, name):
    """The layer's HF keys renamed to DUET's (``crossattention.att``) or
    the ``crossattention.self`` alias."""
    if name == "hf":
        return dict(sd)
    return {k.replace("visual_attention.att.", f"crossattention.{name}.")
            .replace("visual_attention.output.", "crossattention.output."): v
            for k, v in sd.items()}


@pytest.mark.parametrize("alias", ["hf", "att", "self"])
def test_xlayer_converter_matches_hf_and_jax(alias):
    layer = _xlayer()
    sd = _alias({f"x_layers.0.{k}": v for k, v in
                 layer.state_dict().items()}, alias)
    cfg = PolicyConfig(embed_dims=HIDDEN, num_heads=HEADS, ffn_dim=INTER,
                       fusion_arch="bert")
    blk = _FusionBlock(cfg)
    blk.load_state_dict(convert_crossmodal_params(sd, 1, HEADS)["block_0"],
                        strict=True)
    rng = np.random.default_rng(0)
    lang = rng.standard_normal((2, 11, HIDDEN)).astype(np.float32)
    visn = rng.standard_normal((2, 7, HIDDEN)).astype(np.float32)
    lang_mask = np.arange(11)[None] < np.array([[11], [6]])
    with torch.no_grad():
        got = blk.eval()(torch.from_numpy(visn), torch.ones(2, 7, dtype=bool),
                         torch.from_numpy(lang), torch.from_numpy(lang_mask))
    ref = _visn_forward(layer, lang, lang_mask.astype(np.float32), visn)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)

    jcfg = JPolicyConfig(embed_dims=HIDDEN, num_heads=HEADS, ffn_dim=INTER,
                         fusion_arch="bert")
    want = jax.jit(JFusionBlock(jcfg).apply)(
        {"params": jconvert_crossmodal(sd, 1, HEADS)["block_0"]}, visn,
        np.ones((2, 7), bool), lang, lang_mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    del sd["x_layers.0.visn_inter.dense.bias"]
    with pytest.raises(KeyError, match="visn_inter"):
        convert_crossmodal_params(sd, 1, HEADS)


def _duet_state_dict():
    """Two stacks of two x-layers each, in DUET's naming."""
    sd = {}
    for stack, seeds in (("global_encoder.", (1, 2)),
                         ("local_encoder.", (2, 1))):
        for i, seed in enumerate(seeds):
            sd.update(_alias({f"{stack}x_layers.{i}.{k}": v for k, v in
                              _xlayer(seed).state_dict().items()}, "att"))
    return sd


def _setup_args(tmp_path, **kw):
    return SimpleNamespace(**dict(
        dict(synthetic=True, work_dir=str(tmp_path), embed_dims=None,
             objects=None, data_dir=None, connectivity=None, ver=None,
             benchmark="R2R", bert_vocab=None, text_init=None,
             crossmodal_init=None), **kw))


def test_converter_clis_into_the_policy_and_trainers(tmp_path):
    model = _tiny_bert()
    bert_src = tmp_path / "bert.pt"
    torch.save({"state_dict": {f"bert.{k}": v for k, v in
                               model.state_dict().items()}}, bert_src)
    bert_out = str(tmp_path / "bert_text.pt")
    meta = convert_text_encoder.main(["--src", str(bert_src), "--out",
                                      bert_out, "--heads", str(HEADS),
                                      "--max-len", "30"])
    assert meta == dict(num_layers=LAYERS, num_heads=HEADS, hidden=HIDDEN,
                        vocab_size=VOCAB, max_len=30, ffn_dim=INTER)

    duet = _duet_state_dict()
    assert detect_x_layers(duet) == {"global_encoder.": 2,
                                     "local_encoder.": 2}
    duet_src = tmp_path / "duet.pt"
    torch.save({"model": duet}, duet_src)
    x_out = str(tmp_path / "xmodal.pt")
    xmeta = convert_crossmodal.main(["--src", str(duet_src), "--out", x_out,
                                     "--heads", str(HEADS)])
    assert xmeta == dict(num_heads=HEADS, num_layers=2, hidden=HIDDEN,
                         ffn_dim=INTER)

    setup = build_vln_setup(_setup_args(tmp_path, text_init=bert_out,
                                        crossmodal_init=x_out))
    cfg = setup.cfg
    assert (cfg.text_arch, cfg.fusion_arch, cfg.embed_dims,
            cfg.max_text_len, cfg.fusion_layers, cfg.ffn_dim,
            cfg.text_ffn_dim, cfg.vocab_size) == (
        "bert", "bert", HIDDEN, 30, 2, INTER, INTER, VOCAB)
    policy = VLNPolicy(cfg)
    policy.load_state_dict(random_state_dict(policy, 0), strict=True)
    graft_pretrained(policy, cfg, setup.text_params, setup.xmodal)
    tokens, mask = _tokens(l=30, lengths=(30, 12, 4))
    with torch.no_grad():
        got = policy.eval().encode_text(torch.from_numpy(tokens),
                                        torch.from_numpy(mask))
    ref = _bert_features(model, tokens, mask)
    assert np.abs(got.numpy() - ref)[mask].max() < 2e-5
    want = convert_crossmodal_params(duet, 2, HEADS,
                                     prefix="local_encoder.")["block_1"]
    for k, v in want.items():
        assert torch.equal(policy.local_block_1.state_dict()[k], v), k

    # both trainers start from the converted files
    flags = ["--synthetic", "--device", "cpu", "--text-init", bert_out,
             "--crossmodal-init", x_out]
    m = pretrain_vln.main(flags + ["--steps", "2", "--batch", "4",
                                   "--log-interval", "1", "--work-dir",
                                   str(tmp_path / "pre")])
    assert m["step"] == 2 and np.isfinite(m["loss"])
    m = train_vln.main(flags + ["--steps", "8", "--eval-limit", "2",
                                "--work-dir", str(tmp_path / "vln")])
    assert m["step"] == 8
    assert os.path.isdir(tmp_path / "vln" / "ckpt" / "step_00000008")

    # the cross-modal width must be the policy's
    with pytest.raises(SystemExit, match="embed_dims"):
        build_vln_setup(_setup_args(tmp_path, embed_dims=64,
                                    crossmodal_init=x_out))
