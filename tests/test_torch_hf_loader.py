"""The port's Hugging Face checkpoint loader on the CPU.

For each of the six families a random HF model from a tiny config (the
configs of tests/test_hf_loader.py) is written with ``save_pretrained``
into a directory, as ``model.safetensors`` and as ``pytorch_model.bin``.
The port's loader must give the JAX loader's config and parameters bit
for bit, and FP32 logits within rtol 2e-3 / atol 2e-4 of the HF model's
(tests/test_hf_loader.py's bound). The port reads safetensors with its
own reader, held against ``safetensors``' own.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from transformer_quantization_tpu.models import registry as JR
from transformer_quantization_tpu_torch.models import hf_loader as HL
from transformer_quantization_tpu_torch.models import registry as TR

transformers = pytest.importorskip("transformers")
safetensors_numpy = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")

torch.set_num_threads(2)

NUM_LABELS = 3
B, T = 2, 12
FAMILIES = ["bert", "roberta", "mobilebert", "distilbert", "albert",
            "squeezebert"]


def _hf_case(family):
    tr = transformers
    if family == "bert":
        cfg = tr.BertConfig(
            vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64, num_labels=NUM_LABELS)
        return cfg, tr.BertForSequenceClassification(cfg)
    if family == "roberta":
        cfg = tr.RobertaConfig(
            vocab_size=130, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=66, type_vocab_size=1, pad_token_id=1,
            num_labels=NUM_LABELS)
        return cfg, tr.RobertaForSequenceClassification(cfg)
    if family == "mobilebert":
        cfg = tr.MobileBertConfig(
            vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=48, embedding_size=16,
            intra_bottleneck_size=16, num_feedforward_networks=2,
            max_position_embeddings=64, num_labels=NUM_LABELS)
        return cfg, tr.MobileBertForSequenceClassification(cfg)
    if family == "distilbert":
        cfg = tr.DistilBertConfig(
            vocab_size=128, dim=32, n_layers=2, n_heads=2, hidden_dim=64,
            max_position_embeddings=64, num_labels=NUM_LABELS)
        return cfg, tr.DistilBertForSequenceClassification(cfg)
    if family == "albert":
        cfg = tr.AlbertConfig(
            vocab_size=128, embedding_size=16, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=64,
            num_labels=NUM_LABELS)
        return cfg, tr.AlbertForSequenceClassification(cfg)
    cfg = tr.SqueezeBertConfig(
        vocab_size=128, hidden_size=32, embedding_size=32,
        num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, q_groups=2, k_groups=2, v_groups=2,
        post_attention_groups=1, intermediate_groups=2, output_groups=2,
        num_labels=NUM_LABELS)
    return cfg, tr.SqueezeBertForSequenceClassification(cfg)


def _inputs(family):
    """ids >= 3; row 1 padded from position 8 with the pad id 1 (RoBERTa
    numbers positions from its pad id)."""
    rng = np.random.RandomState(3)
    ids = rng.randint(3, 120, (B, T))
    mask = np.ones((B, T), np.float32)
    mask[1, 8:] = 0.0
    ids[1, 8:] = 1
    batch = {"input_ids": ids.astype(np.int32), "attention_mask": mask}
    if family not in ("distilbert", "roberta"):
        batch["token_type_ids"] = np.zeros((B, T), np.int32)
    return batch


@pytest.fixture(scope="module", params=FAMILIES)
def saved(request, tmp_path_factory):
    """One random HF model of the family, written both ways, and its FP32
    logits on :func:`_inputs`."""
    family = request.param
    torch.manual_seed(0)
    hf_cfg, model = _hf_case(family)
    model.eval()
    dirs = {}
    for fmt, safe in (("safetensors", True), ("bin", False)):
        d = tmp_path_factory.mktemp(f"{family}_{fmt}")
        model.save_pretrained(str(d), safe_serialization=safe)
        dirs[fmt] = str(d)
    batch = _inputs(family)
    with torch.no_grad():
        ref = model(**{k: torch.from_numpy(v.astype(
            np.float32 if k == "attention_mask" else np.int64))
            for k, v in batch.items()}).logits.numpy()
    return family, dirs, batch, ref


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_loader_matches_jax_and_hf(saved, fmt):
    family, dirs, batch, ref = saved
    d = dirs[fmt]
    name = {"safetensors": "model.safetensors",
            "bin": "pytorch_model.bin"}[fmt]
    assert HL.os.path.exists(HL.os.path.join(d, name))
    tfam = TR.get_family(family)
    cfg, params = tfam.load_checkpoint(d, NUM_LABELS, "cpu")
    jcfg, jparams = JR.get_family(family).load_checkpoint(d, NUM_LABELS)
    assert type(cfg).__name__ == type(jcfg).__name__
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(
        jparams, is_leaf=lambda x: x is None)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(
        params, is_leaf=lambda x: x is None))
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        got = flat_t[path]
        if v is None:
            assert got is None, path
            continue
        assert got.dtype == torch.float32, path
        np.testing.assert_array_equal(got.numpy(), np.asarray(v),
                                      err_msg=str(path))
    out, _ = tfam.apply(params, batch, cfg, device="cpu")
    got = out["logits"].numpy()
    assert got.shape == ref.shape == (B, NUM_LABELS)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
    # the registry's build_model takes the same directory
    fam, cfg2, params2 = TR.build_model(family, model_path=d,
                                        num_labels=NUM_LABELS, device="cpu")
    assert fam.name == family and cfg2 == cfg


def test_safetensors_reader_matches_safetensors(saved):
    _, dirs, _, _ = saved
    path = HL.os.path.join(dirs["safetensors"], "model.safetensors")
    want = safetensors_numpy.load_file(path)
    got = HL.read_safetensors(path)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_safetensors_reader_dtypes(tmp_path):
    """Every dtype the reader takes, against ``safetensors.torch``'s own
    reader (bfloat16 widened to float32, exactly), scalars and empty
    tensors included."""
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn((3, 5), generator=g),
        "f64": torch.randn((4,), generator=g, dtype=torch.float64),
        "f16": torch.randn((2, 3), generator=g).to(torch.float16),
        "bf16": torch.randn((7, 2), generator=g).to(torch.bfloat16),
        "i64": torch.arange(-6, 6, dtype=torch.int64).reshape(3, 4),
        "i32": torch.arange(5, dtype=torch.int32),
        "i16": torch.arange(-3, 3, dtype=torch.int16),
        "i8": torch.arange(-128, 128, dtype=torch.int8),
        "u8": torch.arange(0, 256, dtype=torch.uint8).reshape(16, 16),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
    }
    path = str(tmp_path / "t.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    got = HL.read_safetensors(path)
    want = safetensors_torch.load_file(path)
    assert set(got) == set(want)
    for k, v in want.items():
        v = v.float() if v.dtype == torch.bfloat16 else v
        assert got[k].shape == tuple(v.shape), k
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_local_directories_only(tmp_path):
    assert HL.resolve_model_dir(str(tmp_path)) == str(tmp_path)
    with pytest.raises(FileNotFoundError):
        HL.resolve_model_dir("bert-base-uncased")
    with pytest.raises(NotImplementedError, match="huggingface_hub"):
        HL.resolve_model_dir("bert-base-uncased", allow_hub=True)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        HL.load_hf_state_dict(str(tmp_path))


def test_albert_with_groups_raises(tmp_path):
    cfg = transformers.AlbertConfig(num_hidden_groups=2)
    (tmp_path / "config.json").write_text(cfg.to_json_string())
    with pytest.raises(NotImplementedError, match="one group"):
        HL.load_albert(str(tmp_path), device="cpu")


def test_loader_needs_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal is not testable")
    hf_cfg, model = _hf_case("bert")
    model.save_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        HL.load_bert(str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        TR.build_model("bert", model_path=str(tmp_path))
