"""The port's model-family registry, the PEG / per-token wiring and the
tokenizers on the CPU, against the JAX package.

- ``models/registry.py``: the families' fields, the model names, the
  presets, ``build_model`` (random init for every family; a JAX-written
  checkpoint directory; a local Hugging Face directory), and the branches
  that are not ported raising ``NotImplementedError`` with their ROADMAP
  item;
- ``apply_peg_wiring``: JAX's ``axis`` / ``n_groups`` / ``permute`` on
  every site, for per-token, per-embd and per-groups with and without
  permutation, for BERT and MobileBERT; fake-quant logits under per-embd
  and per-token calibrated in both packages from the same weights agree
  at 2 layers within rtol 2e-3 / atol 3e-3 (the recipes' engine bound);
- ``utils/data.py``: ``SyntheticTokenizer.encode_pair`` equals JAX's on
  a fixed list of texts and pairs, with truncation; ``load_tokenizer``'s
  branches;
- ``utils/native.py``: the port's WordPiece binding equals JAX's on a
  vocab.txt the test writes.
"""

import dataclasses
import functools
import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.models import mobilebert as JMB
from transformer_quantization_tpu.models import registry as JR
from transformer_quantization_tpu.quant.qconfig import QuantDefaults
from transformer_quantization_tpu.quant.qconfig import QuantMode as JMode
from transformer_quantization_tpu.quant.quantizers import QMethod
from transformer_quantization_tpu.quant.ranges import RangeMethod
from transformer_quantization_tpu.training.calibration import (
    prepare_quantized_model as jax_prepare,
)
from transformer_quantization_tpu.utils import checkpoint as JCK
from transformer_quantization_tpu.utils import data as JD
from transformer_quantization_tpu.utils import native as JN
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.models import mobilebert as TMB
from transformer_quantization_tpu_torch.models import registry as TR
from transformer_quantization_tpu_torch.training import calibration as TC
from transformer_quantization_tpu_torch.utils import data as TD
from transformer_quantization_tpu_torch.utils import native as TN

CFG = dict(vocab_size=256, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=64, num_labels=2)
ENGINE_RTOL, ENGINE_ATOL = 2e-3, 3e-3
PEG = {
    "per_token": dict(per_token=True),
    "per_embd": dict(per_embd=True),
    "per_groups": dict(per_groups=4),
    "per_groups_permute": dict(per_groups=4, permute=True),
    "per_embd_groups": dict(per_embd=True, per_groups=2),
    "none": {},
}


def _defaults():
    return QuantDefaults(method=QMethod.symmetric_uniform,
                         act_method=QMethod.asymmetric_uniform, n_bits=8,
                         weight_range_method=RangeMethod.current_minmax,
                         act_range_method=RangeMethod.current_minmax)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_family_fields_and_model_names_match_jax():
    assert ([f.name for f in dataclasses.fields(TR.ModelFamily)]
            == [f.name for f in dataclasses.fields(JR.ModelFamily)])
    assert TR.MODEL_NAME_TO_FAMILY == JR.MODEL_NAME_TO_FAMILY
    assert set(TR._FAMILIES) == set(JR._FAMILIES)


@pytest.mark.parametrize("name", ["bert", "mobilebert", "roberta",
                                  "distilbert", "albert", "squeezebert"])
def test_ported_family_matches_jax(name):
    t, j = TR.get_family(name), JR.get_family(name)
    assert t.name == j.name and t.head_key == j.head_key
    assert t.config_presets == j.config_presets
    assert t.tiny_preset == j.tiny_preset
    assert ([f.name for f in dataclasses.fields(t.config_cls)]
            == [f.name for f in dataclasses.fields(j.config_cls)])
    assert t.config_cls() == t.config_cls(
        **dataclasses.asdict(j.config_cls()))
    assert (t.shared_perm_groups is None) == (j.shared_perm_groups is None)
    assert t.build_engine is not None and t.engine_apply is not None
    assert t.apply_peg.__name__ == j.apply_peg.__name__
    assert t.apply_quant_dict.__name__ == j.apply_quant_dict.__name__
    if name in ("bert", "mobilebert"):
        assert t.apply_peg is (TB if name == "bert" else TMB).apply_peg_wiring
    for model_name, fam in TR.MODEL_NAME_TO_FAMILY.items():
        if fam == name:
            assert TR.get_family(model_name).name == name


@pytest.mark.parametrize("model", ["bert_large_uncased", "albert_large_v2"])
def test_large_preset_matches_jax_and_fits_the_kernels(model, monkeypatch):
    """The two large presets that ``chip_smoke.py`` phase 15 drives at
    their published widths and depth: the model name's family and the
    preset's config equal to the JAX registry's (H = 1024, 16 heads of
    64, I = 4096, 24 layers), and the shapes their engines give the
    kernels inside the wrappers' limits: K1 at K = 1024 and 4096 (the
    int8 and the packed int4 weight), K2 at (seq 128, head_dim 64), K3 at
    H = 1024 (the shape rules; the dtype and device checks need the
    card)."""
    from transformer_quantization_tpu_torch.ops.kernels import (
        engine_kernels as EK,
    )

    monkeypatch.setattr(EK, "_check", lambda *a, **k: None)
    monkeypatch.setattr(EK, "_same_device", lambda *a: None)

    assert TR.MODEL_NAME_TO_FAMILY[model] == JR.MODEL_NAME_TO_FAMILY[model]
    tfam, jfam = TR.get_family(model), JR.get_family(model)
    tcfg = tfam.config_cls(**tfam.config_presets[model])
    jcfg = jfam.config_cls(**jfam.config_presets[model])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    h, i = tcfg.hidden_size, tcfg.intermediate_size
    assert (h, tcfg.num_attention_heads, i, tcfg.num_hidden_layers) == (
        1024, 16, 4096, 24)
    scal = torch.zeros((1, 2))
    for n, k in ((3 * h, h), (h, h), (i, h), (h, i)):
        x8 = torch.zeros((8, k), dtype=torch.int8)
        vecs = torch.zeros((5, n))
        assert EK._check_matmul(x8, torch.zeros((n, k), dtype=torch.int8),
                                vecs, scal, "K1") == (8, n, k)
        assert EK._check_matmul(x8, torch.zeros((n, k // 2),
                                                dtype=torch.uint8),
                                vecs, scal, "K1 w4", w4=True) == (8, n, k)
    assert (128, h // tcfg.num_attention_heads) in EK.ATTN_SHAPES
    EK._h_fits(h, "K3")


@pytest.mark.parametrize("name", ["roberta", "distilbert", "albert",
                                  "squeezebert", "distilroberta_base",
                                  "albert_base_v2"])
def test_family_resolves_and_builds(name):
    """Each family of the slice resolves, and ``build_model(tiny=True)``
    gives JAX's config and a parameter tree of JAX's structure and
    shapes."""
    fam = TR.get_family(name)
    assert fam.name == JR.get_family(name).name
    jfam, jcfg, jp = JR.build_model(name, tiny=True)
    tfam, tcfg, tp = TR.build_model(name, tiny=True, device="cpu")
    assert tfam.name == jfam.name
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda a: tuple(a.shape), tp) == shapes
    head = tfam.init_head(tcfg, 1, "cpu")
    assert (jax.tree.map(lambda a: tuple(a.shape), head)
            == jax.tree.map(lambda a: tuple(a.shape),
                            jfam.init_head(jax.random.PRNGKey(1), jcfg)))


def test_unported_branches_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="item 5"):
        TR.get_family("mobilebert").adaround_specs({}, TMB.MobileBertConfig())
    with pytest.raises(KeyError):
        TR.get_family("gpt2")
    # a local Hugging Face directory loads (models/hf_loader.py; each
    # family, written by transformers' save_pretrained, is
    # tests/test_torch_hf_loader.py's): the files of one, written without
    # importing transformers (tests/test_torch_cli.py's writer)
    from safetensors.numpy import load_file
    from test_torch_cli import HF, write_hf_bert

    write_hf_bert(tmp_path)
    fam, cfg, params = TR.build_model("bert_base_uncased",
                                      model_path=str(tmp_path), device="cpu")
    assert fam.name == "bert" and cfg.hidden_size == HF["hidden_size"]
    sd = load_file(str(tmp_path / "model.safetensors"))
    np.testing.assert_array_equal(
        params["layers"][0]["ffn"]["inter"]["kernel"].numpy(),
        sd["bert.encoder.layer.0.intermediate.dense.weight"])


def test_build_model_random_init():
    fam, cfg, params = TR.build_model("bert_base_uncased", seed=3, tiny=True,
                                      num_labels=3, device="cpu",
                                      num_hidden_layers=1)
    assert fam.name == "bert"
    assert cfg == TB.BertConfig(**dict(fam.tiny_preset, num_labels=3,
                                       num_hidden_layers=1))
    want = TB.init_bert_params(cfg, seed=3, device="cpu")
    assert torch.equal(params["embeddings"]["word"],
                       want["embeddings"]["word"])
    assert len(params["layers"]) == 1
    assert params["classifier"]["kernel"].shape == (3, cfg.hidden_size)
    head = fam.init_head(cfg, 3, "cpu")
    assert head["kernel"].shape == (3, cfg.hidden_size)
    fam, cfg, _ = TR.build_model("bert_large_uncased", tiny=False,
                                 device="cpu", num_hidden_layers=0)
    assert (cfg.hidden_size, cfg.num_attention_heads) == (1024, 16)
    fam, cfg, params = TR.build_model("mobilebert_uncased", tiny=True,
                                      device="cpu")
    assert fam.name == "mobilebert"
    assert cfg == TMB.MobileBertConfig(**dict(fam.tiny_preset, num_labels=2))
    assert fam.init_head(cfg, 0, "cpu")["kernel"].shape == (
        2, cfg.hidden_size)


def test_build_model_from_a_jax_checkpoint(tmp_path):
    jcfg = JB.BertConfig(**CFG)
    jp = JB.init_bert_params(jax.random.PRNGKey(0), jcfg)
    JCK.save_checkpoint(str(tmp_path), params=jp, family="bert", cfg=jcfg)
    fam, cfg, params = TR.build_model("mobilebert_uncased",
                                      model_path=str(tmp_path), device="cpu")
    assert fam.name == "bert" and cfg == TB.BertConfig(**CFG)
    want = C.params_from_jax(_np(jp), device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)
    _, cfg3, _ = TR.build_model("bert", model_path=str(tmp_path),
                                num_labels=3, device="cpu")
    assert cfg3.num_labels == 3


def test_build_model_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        TR.build_model("bert", tiny=True)


# ---------------------------------------------------------------------------
# apply_peg_wiring
# ---------------------------------------------------------------------------


def _site_settings(qcfg):
    return [(n, c.axis, c.n_groups, c.permute) for n, c in qcfg.items()]


@pytest.mark.parametrize("peg", sorted(PEG))
@pytest.mark.parametrize("family", ["bert", "mobilebert"])
def test_peg_wiring_matches_jax(family, peg):
    kw = PEG[peg]
    if family == "bert":
        jq = JB.declare_bert_sites(_defaults(), JB.BertConfig(**CFG))
        tq = TB.declare_bert_sites(TC.w8a8_defaults(), TB.BertConfig(**CFG))
        jw, tw = JB.apply_peg_wiring, TB.apply_peg_wiring
    else:
        tiny = TR.get_family("mobilebert").tiny_preset
        jq = JMB.declare_mobilebert_sites(_defaults(),
                                          JMB.MobileBertConfig(**tiny))
        tq = TMB.declare_mobilebert_sites(TC.w8a8_defaults(),
                                          TMB.MobileBertConfig(**tiny))
        jw, tw = JMB.apply_peg_wiring, TMB.apply_peg_wiring
    assert _site_settings(tq) == _site_settings(jq)
    jq, tq = jw(jq, 2, **kw), tw(tq, 2, **kw)
    assert _site_settings(tq) == _site_settings(jq)
    if family == "bert" and kw:
        changed = {n for n, a, g, p in _site_settings(tq) if a is not None}
        assert "L1.ffn.ln.out" in changed
        assert ("pooler.dense.out" in changed) == bool(kw.get("per_embd"))


@pytest.fixture(scope="module", params=["per_embd", "per_token"])
def peg_logits(request):
    """JAX init (PRNGKey 0), the wiring, one-batch calibration and the
    fake-quant forward in both packages from the same weights and batch."""
    kw = PEG[request.param]
    jcfg, tcfg = JB.BertConfig(**CFG), TB.BertConfig(**CFG)
    jp = JB.init_bert_params(jax.random.PRNGKey(0), jcfg)
    tp = C.params_from_jax(_np(jp), device="cpu")
    batch = TC.calibration_batch(CFG["vocab_size"], 2, 16, 0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jq = JB.apply_peg_wiring(JB.declare_bert_sites(_defaults(), jcfg), 2,
                             **kw)
    tq = TB.apply_peg_wiring(TB.declare_bert_sites(TC.w8a8_defaults(), tcfg),
                             2, **kw)
    js, jmode = jax_prepare(functools.partial(JB.bert_apply, cfg=jcfg), jp,
                            jq, [jbatch],
                            weight_tensors=JB.bert_weight_site_tensors(jp))

    def apply_fn(p, b, **k):
        return TB.bert_apply(p, b, tcfg, **k)

    ts, tmode = TC.prepare_quantized_model(
        apply_fn, tp, tq, [batch],
        weight_tensors=TB.bert_weight_site_tensors(tp), device="cpu")
    jout, _ = JB.bert_apply(jp, jbatch, jcfg, jq, js, jmode)
    tout, _ = TB.bert_apply(tp, batch, tcfg, tq, ts, tmode, device="cpu")
    return request.param, np.asarray(jout["logits"]), tout["logits"], tq, js


def test_peg_wiring_fake_quant_logits_match_jax(peg_logits):
    name, want, got, tq, js = peg_logits
    axis = 2 if name == "per_embd" else 1
    assert tq["L0.attn.q.out"].axis == axis
    assert np.asarray(js["L0.attn.q.out"]["qp"].delta).size > 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=ENGINE_RTOL,
                               atol=ENGINE_ATOL)


def test_peg_wiring_leaves_the_flat_config_alone():
    tq = TB.declare_bert_sites(TC.w8a8_defaults(), TB.BertConfig(**CFG))
    assert TB.apply_peg_wiring(tq, 2) is tq
    assert TMB.apply_peg_wiring(tq, 2, per_embd=True) is tq


# ---------------------------------------------------------------------------
# Tokenizers
# ---------------------------------------------------------------------------

TEXTS = [
    ("the quick brown fox", None),
    ("the quick brown fox", "jumps over the lazy dog"),
    ("", None),
    ("", ""),
    ("Hello, World! unaffable", "quantization model"),
    ("  spaced   out\twords\n", "é ü 中文"),
    ("word " * 40, None),
    ("a b c d e f g h", "i j k l m n o p q r s t"),
]


@pytest.mark.parametrize("max_len", [4, 8, 16, 64])
@pytest.mark.parametrize("vocab", [30522, 256])
def test_synthetic_tokenizer_matches_jax(vocab, max_len):
    t, j = TD.SyntheticTokenizer(vocab), JD.SyntheticTokenizer(vocab)
    for a, b in TEXTS:
        assert t.encode_pair(a, b, max_len) == j.encode_pair(a, b, max_len)
    assert (TD.PAD_ID, TD.UNK_ID, TD.CLS_ID, TD.SEP_ID) == (
        JD.PAD_ID, JD.UNK_ID, JD.CLS_ID, JD.SEP_ID)


VOCAB = ["[PAD]", "[unused0]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the",
         "quick", "brown", "fox", "jump", "##s", "##ed", "##ing", "over",
         "lazy", "dog", "un", "##aff", "##able", ",", ".", "!", "?", "'",
         "hello", "world", "a", "an", "and", "é", "model", "quant",
         "##ization"]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocab")
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    return d


@pytest.fixture(scope="module")
def wordpiece(vocab_dir):
    if shutil.which("g++") is None:
        print("g++ is missing: the native tokenizer cannot be built")
        pytest.skip("g++ is missing: the native tokenizer cannot be built")
    path = str(vocab_dir / "vocab.txt")
    return TN.WordPieceTokenizer(path), JN.WordPieceTokenizer(path)


@pytest.mark.parametrize("max_len", [4, 8, 32])
def test_wordpiece_matches_jax(wordpiece, max_len):
    t, j = wordpiece
    assert t.vocab_size == j.vocab_size == len(VOCAB)
    texts = TEXTS + [("The Quick Brown Fox JUMPED over the lazy dogs!",
                      "unaffable quantization, hello world?")]
    for a, b in texts:
        assert t.encode_pair(a, b, max_len) == j.encode_pair(a, b, max_len)
    for got, want in zip(t.encode_batch(texts, max_len),
                         j.encode_batch(texts, max_len)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert TN.BUILD_DIR != JN.BUILD_DIR


def test_load_tokenizer_branches(wordpiece, vocab_dir, tmp_path, caplog):
    tok = TD.load_tokenizer(str(vocab_dir))
    assert isinstance(tok, TN.WordPieceTokenizer)
    assert tok.encode_pair("hello world", None, 6) == \
        wordpiece[1].encode_pair("hello world", None, 6)
    tok = TD.load_tokenizer(None, vocab_size=100)
    assert isinstance(tok, TD.SyntheticTokenizer) and tok.vocab_size == 100
    with caplog.at_level(logging.WARNING, logger="tq_torch"):
        tok = TD.load_tokenizer(str(tmp_path / "empty"), vocab_size=77)
    assert isinstance(tok, TD.SyntheticTokenizer) and tok.vocab_size == 77
    assert "SYNTHETIC" in caplog.text


def test_load_tokenizer_refuses_a_hf_tokenizer(vocab_dir, tmp_path):
    """A directory with a loadable HF tokenizer (no vocab.txt) loads through
    the HF tokenizer adapter (``local_files_only``), whose ids, type ids
    and masks equal JAX's ``HFTokenizerAdapter``'s on the same tokenizer."""
    transformers = pytest.importorskip("transformers")
    from transformer_quantization_tpu.utils import data as JD

    tok = transformers.BertTokenizerFast(str(vocab_dir / "vocab.txt"))
    tok.save_pretrained(str(tmp_path))
    (tmp_path / "vocab.txt").unlink()
    got = TD.load_tokenizer(str(tmp_path))
    want = JD.load_tokenizer(str(tmp_path))
    assert isinstance(got, TD.HFTokenizerAdapter)
    assert isinstance(want, JD.HFTokenizerAdapter)
    assert got.vocab_size == want.vocab_size == len(VOCAB)
    texts = TEXTS + [("The Quick Brown Fox JUMPED over the lazy dogs!",
                      "unaffable quantization, hello world?")]
    for max_len in (4, 8, 32):
        for a, b in texts + [(a, None) for a, _ in texts]:
            assert got.encode_pair(a, b, max_len) == want.encode_pair(
                a, b, max_len)