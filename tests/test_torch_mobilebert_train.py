"""Port parity for MobileBERT's training forward and its QAT against the
JAX package: ``mobilebert_apply(train=True)`` through ``training/qat.py``
(the ``qat-w4a8`` recipe's learned ranges) and the command line.

The model is the registry's tiny MobileBERT (2 layers, H = 64,
bottleneck 32, 4 heads of 8, I = 64, 3 stacked FFNs, relu, NoNorm,
shared key/query bottleneck), randomly initialized and calibrated by the
port (current-minmax 4-bit symmetric weights, 8-bit asymmetric
activations, one batch); the same weights and ranges are carried into
JAX, so both packages train one model. The data are synthetic RTE
examples through the hash tokenizer (seq 32, batch 4), made with numpy
from a seed.

- one learned-ranges (``qat-w4a8``) step on the float fake-quant forward
  and on the int8 QAT forward, both dropouts 0: the loss within rtol 1e-5
  of JAX's; every weight gradient and the packed range gradients (every
  site's ``delta`` and ``zero_float``) within rtol 1e-4 with an absolute
  floor of 1e-6 of the tensor's largest (the bounds of
  ``tests/test_torch_qat.py``); the key biases, whose gradient is zero up
  to rounding, below 1e-6 of the largest weight gradient on both sides;
  then the AdamW update: weights and ranges within rtol 1e-4 of optax's,
  with a floor of a hundredth of one Adam step. JAX runs jitted without
  XLA's backend optimizations (the parity contract's O0 rule, ROADMAP);
- ``remat`` with both dropouts at 0.1 (the port alone: JAX draws other
  random numbers): loss, gradients, the new quant state and the dropout
  generator's state bit-identical to the forward without it;
- ``train-quantized --recipe qat-w4a8 --max-steps 2`` on a written
  MobileBERT checkpoint directory (the port alone: the JAX CLI's eager
  calibration and its O0 train-step compile would cost more than this
  file's time budget): two finite losses on the int8 QAT forward, and the
  evaluation on the W4A8 engine, every matmul of its plan packed int4.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

import __graft_entry__ as G
from transformer_quantization_tpu.models import mobilebert as JM
from transformer_quantization_tpu.quant import quantizers as JQ
from transformer_quantization_tpu.training import qat as JQAT
from transformer_quantization_tpu.utils import data as JD
from transformer_quantization_tpu.utils import glue as JG
from transformer_quantization_tpu_torch import cli as TCLI
from transformer_quantization_tpu_torch.models import mobilebert as TM
from transformer_quantization_tpu_torch.models.registry import get_family
from transformer_quantization_tpu_torch.training import calibration as TC
from transformer_quantization_tpu_torch.training import qat as TQAT

torch.set_num_threads(2)

KW = dict(get_family("mobilebert").tiny_preset, num_labels=2,
          hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
SEQ, BATCH, LR = 32, 4, 5e-5
O0 = {"xla_backend_optimization_level": 0}


def _w4a8(defaults):
    return dataclasses.replace(defaults, n_bits=4, n_bits_act=8)


def to_jax(tp, ts):
    """The port's params and quant state as JAX's trees (the ranges'
    ``qp`` only)."""
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    js = {name: {"qp": JQ.QuantParams(
        delta=jnp.asarray(st["qp"].delta.numpy()),
        zero_float=jnp.asarray(st["qp"].zero_float.numpy()),
        signed=jnp.asarray(st["qp"].signed.numpy()))}
        for name, st in ts.items() if "qp" in st}
    return jp, js


@pytest.fixture(scope="module")
def model():
    tcfg, jcfg = TM.MobileBertConfig(**KW), JM.MobileBertConfig(**KW)
    tp, tq, ts = TC.calibrated_mobilebert(tcfg, batch_size=2, seq=SEQ,
                                          device="cpu",
                                          defaults=_w4a8(TC.w8a8_defaults()))
    jq = JM.declare_mobilebert_sites(_w4a8(G._w8a8_defaults()), jcfg)
    jp, js = to_jax(tp, ts)
    task = JG.TASKS["rte"]
    arrays = JD.encode_examples(
        JD.SyntheticTokenizer(KW["vocab_size"]), task,
        JG.synthetic_examples(task, "train", 2 * BATCH, seed=5), SEQ)
    batch = {k: v[:BATCH] for k, v in arrays.items()}
    return dict(tcfg=tcfg, jcfg=jcfg, tp=tp, tq=tq, ts=ts, jq=jq, js=js,
                jp=jp, batch=batch)


def _port_step(m, int8):
    """The port's learned-ranges step: ``(qat, loss, grads, unravel, new
    params, new learnable)``."""
    qat = TQAT.QATConfig(learn_ranges=True, learning_rate=LR,
                         int8_sites=(TQAT.int8_forward_sites(m["tq"], m["ts"])
                                     if int8 else None))
    apply_fn = functools.partial(TM.mobilebert_apply, cfg=m["tcfg"],
                                 device="cpu")
    learnable, rest = TQAT.split_learnable_ranges(m["tq"], m["ts"])
    loss, grads, _, unravel = TQAT.qat_value_and_grad(
        apply_fn, m["tq"], qat, m["tp"], learnable, rest, m["batch"], None)
    tx = TQAT.make_optimizer(qat, m["tp"])
    params, learnable, rest, opt = TQAT.init_qat_state(m["tq"], qat, m["tp"],
                                                       m["ts"], tx)
    step = TQAT.make_qat_train_step(apply_fn, m["tq"], qat, tx)
    new_p, new_l, _, _, _, _ = step(params, learnable, rest, opt,
                                    m["batch"], None)
    return qat, float(loss), grads, unravel, new_p, new_l


def _jax_step(m, sites):
    """JAX's value and gradient (jitted at O0) and the AdamW update of
    ``JQAT.make_optimizer``, in one program: ``(loss, grads, unravel, new
    tree, the forward's sequence output)``."""
    learnable, rest = JQAT.split_learnable_ranges(m["jq"], m["js"])
    flat, unravel = ravel_pytree(learnable)
    qat = JQAT.QATConfig(learn_ranges=True, learning_rate=LR)
    mode = JQAT.qat_mode(qat)
    batch = {k: jnp.asarray(v) for k, v in m["batch"].items()}

    def loss_fn(tr):
        qs = JQAT.merge_learnable_ranges(unravel(tr["ranges"]), rest)
        out, _ = JM.mobilebert_apply(tr["params"], batch, m["jcfg"],
                                     qcfg=m["jq"], qstate=qs, mode=mode,
                                     train=True,
                                     dropout_rng=jax.random.PRNGKey(0),
                                     int8_qat_sites=sites)
        return out["loss"], out["sequence_output"]

    tx = JQAT.make_optimizer(qat)

    def step(tree):
        (loss, seq_out), g = jax.value_and_grad(loss_fn, has_aux=True)(tree)
        updates, _ = tx.update(g, tx.init(tree), tree)
        return loss, g, optax.apply_updates(tree, updates), seq_out

    loss, g, new, seq_out = jax.jit(step, compiler_options=O0)(
        {"params": m["jp"], "ranges": flat})
    return float(loss), g, unravel, new, np.asarray(seq_out)


def _close(got, want, what, rtol=1e-4, floor=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=floor * float(np.abs(want).max()),
                               err_msg=what)


def _vanishing(path) -> bool:
    """The key biases: a shift of every key adds one constant to each
    query's scores, which the softmax ignores."""
    return path[-2:] == ("k", "bias")


def _flips(m, qat, jax_out) -> tuple:
    """(elements of the port's training forward's sequence output off
    JAX's ``jax_out``, the largest difference in levels of its site): the
    float32 matmuls of the float fake-quant forward sum in another order
    than XLA's, which moves an act site's level where a value sits within
    an ulp of a rounding edge."""
    with torch.no_grad():
        t = TM.mobilebert_apply(m["tp"], m["batch"], m["tcfg"], m["tq"],
                                m["ts"], TQAT.qat_mode(qat), train=True,
                                int8_qat_sites=qat.int8_sites, device="cpu")
    last = f"L{KW['num_hidden_layers'] - 1}.out.bn.norm.out"
    d = np.abs(t[0]["sequence_output"].numpy() - jax_out)
    return (int((d > 0).sum()),
            float(d.max()) / float(m["ts"][last]["qp"].delta))


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_one_qat_w4a8_step_matches_jax(model, int8):
    """The int8 QAT forward's products are exact, so the step is held at
    ``tests/test_torch_qat.py``'s bounds. The float fake-quant forward's
    float32 matmuls round their sums in another order than XLA's: a value
    within an ulp of a rounding edge takes the other level (the parity
    contract's one-level rule; measured: one element of the last layer's
    8192 outputs, one level), and the backward carries that level through
    the last layer's gradients. There the rule: the same loss (rtol
    1e-5), at most one level off on at most 1e-3 of the outputs, every
    gradient within 1e-1 of its tensor's largest (measured 5.3e-2), and
    the strict bounds wherever the outputs agree (``flips`` 0)."""
    m = model
    qat, loss, grads, unravel, new_p, new_l = _port_step(m, int8)
    jsites = JQAT.int8_forward_sites(m["jq"], m["js"]) if int8 else None
    assert (qat.int8_sites or None) == jsites
    if int8:   # the NoNorm bottlenecks' and stacked FFNs' matmuls too
        assert {"L0.bn.in.dense", "L1.bn.attn.dense", "L0.ffn2.dense",
                "L1.out.bn.dense", "classifier"} <= jsites
    jloss, jg, junravel, jnew, jout = _jax_step(m, jsites)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    flips, levels = _flips(m, qat, jout)
    assert flips <= 1e-3 * BATCH * SEQ * KW["hidden_size"]
    assert levels <= 1 + 1e-6
    if int8:
        assert flips == 0
    jleaves = jax.tree.leaves(jg["params"])
    paths = [p for p, _ in TQAT.tree_leaves(m["tp"])]
    assert len(jleaves) == len(grads) - 1
    gmax = max(float(np.abs(np.asarray(b)).max()) for b in jleaves)
    for path, a, b in zip(paths, grads, jleaves):
        if _vanishing(path):
            assert float(a.abs().max()) <= 1e-6 * gmax
            assert float(np.abs(np.asarray(b)).max()) <= 1e-6 * gmax
        elif flips:
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-1 * np.abs(b).max(), (
                "/".join(path))
        else:
            _close(a.numpy(), b, "/".join(path))
    if flips:
        return
    _close(grads[-1].numpy(), jg["ranges"], "ranges")
    tr, jr = unravel(grads[-1]), junravel(jg["ranges"])
    assert sorted(tr) == sorted(jr)
    # the NoNorm weight sites and the acts' zero points learn too
    assert tr["L0.bn.in.norm.w"]["delta"].abs().max() > 0
    assert any(tr[s]["zero_float"].abs().max() > 0 for s in tr
               if s.endswith(".out"))
    # the AdamW step: a hundredth of one Adam step as the floor (entries
    # whose gradient cancels to near zero)
    for (path, a), b in zip(TQAT.tree_leaves(new_p),
                            jax.tree.leaves(jnew["params"])):
        if not _vanishing(path):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-2 * LR,
                                       err_msg="/".join(path))
    flat_new, _ = TQAT.ravel_ranges(new_l)
    np.testing.assert_allclose(flat_new.numpy(), np.asarray(jnew["ranges"]),
                               rtol=1e-4, atol=1e-2 * LR)


def test_remat_is_bit_identical_with_dropout(model):
    """Both dropouts at 0.1: ``remat`` recomputes each layer in the
    backward from the layer's entry quant state and generator state, so
    the step's values equal the plain forward's bit for bit."""
    m = model
    cfg = dataclasses.replace(m["tcfg"], hidden_dropout_prob=0.1,
                              attention_probs_dropout_prob=0.1)
    learnable, rest = TQAT.split_learnable_ranges(m["tq"], m["ts"])
    out = {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(3)
        qat = TQAT.QATConfig(learn_ranges=True, remat=remat)
        loss, grads, qs, _ = TQAT.qat_value_and_grad(
            functools.partial(TM.mobilebert_apply, cfg=cfg, device="cpu"),
            m["tq"], qat, m["tp"], learnable, rest, m["batch"], gen)
        out[remat] = (loss, grads, qs, gen.get_state())
    (l0, g0, q0, s0), (l1, g1, q1, s1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert sorted(q0) == sorted(q1)
    for site in q0:
        a, b = q0[site].get("qp"), q1[site].get("qp")
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.delta, b.delta)
            assert torch.equal(a.zero_float, b.zero_float)
    assert torch.equal(s0, s1)
    # dropout drew from the generator: another seed gives another loss
    gen = torch.Generator().manual_seed(4)
    other, _, _, _ = TQAT.qat_value_and_grad(
        functools.partial(TM.mobilebert_apply, cfg=cfg, device="cpu"),
        m["tq"], TQAT.QATConfig(learn_ranges=True), m["tp"], learnable,
        rest, m["batch"], gen)
    assert not torch.equal(other, l0)


# Hugging Face's MobileBertForSequenceClassification names of the port's
# tree (the inverse of models/hf_loader.py's)
def _hf_state_dict(params, cfg) -> dict:
    sd = {}

    def lin(name, p):
        sd[name + ".weight"] = p["kernel"]
        sd[name + ".bias"] = p["bias"]

    def nonorm(name, p):
        sd[name + ".weight"] = p["weight"]
        sd[name + ".bias"] = p["bias"]

    e, m = params["embeddings"], "mobilebert.embeddings"
    sd[f"{m}.word_embeddings.weight"] = e["word"]
    sd[f"{m}.position_embeddings.weight"] = e["position"]
    sd[f"{m}.token_type_embeddings.weight"] = e["token_type"]
    lin(f"{m}.embedding_transformation", e["transform"])
    nonorm(f"{m}.LayerNorm", e["norm"])
    for i, layer in enumerate(params["layers"]):
        p = f"mobilebert.encoder.layer.{i}"
        for k, n in (("q", "query"), ("k", "key"), ("v", "value")):
            lin(f"{p}.attention.self.{n}", layer["attn"][k])
        lin(f"{p}.attention.output.dense", layer["attn_out"]["dense"])
        nonorm(f"{p}.attention.output.LayerNorm", layer["attn_out"]["norm"])
        lin(f"{p}.intermediate.dense", layer["inter"])
        lin(f"{p}.output.dense", layer["out"]["dense"])
        nonorm(f"{p}.output.LayerNorm", layer["out"]["norm"])
        bn = layer["bottleneck"]
        lin(f"{p}.bottleneck.input.dense", bn["input"]["dense"])
        nonorm(f"{p}.bottleneck.input.LayerNorm", bn["input"]["norm"])
        lin(f"{p}.bottleneck.attention.dense", bn["attention"]["dense"])
        nonorm(f"{p}.bottleneck.attention.LayerNorm",
               bn["attention"]["norm"])
        lin(f"{p}.output.bottleneck.dense", layer["out"]["bn_dense"])
        nonorm(f"{p}.output.bottleneck.LayerNorm", layer["out"]["bn_norm"])
        for j, f in enumerate(layer["ffn"]):
            lin(f"{p}.ffn.{j}.intermediate.dense", f["inter"])
            lin(f"{p}.ffn.{j}.output.dense", f["dense"])
            nonorm(f"{p}.ffn.{j}.output.LayerNorm", f["norm"])
    lin("classifier", params["classifier"])
    return {k: v.numpy().astype(np.float32) for k, v in sd.items()}


def write_hf_mobilebert(path, seed: int = 0) -> str:
    """A random ``MobileBertForSequenceClassification`` checkpoint
    directory at the tiny widths: ``config.json``, ``model.safetensors``
    (the port's random init from ``seed``, under Hugging Face's names)
    and a WordPiece ``vocab.txt`` over the synthetic examples' words."""
    from safetensors.numpy import save_file

    cfg = TM.MobileBertConfig(**KW)
    params = TM.init_mobilebert_params(cfg, seed=seed, device="cpu")
    os.makedirs(path, exist_ok=True)
    save_file(_hf_state_dict(params, cfg),
              os.path.join(path, "model.safetensors"))
    hf = {k: v for k, v in dataclasses.asdict(cfg).items()
          if k not in ("num_labels", "initializer_range")}
    hf.update(model_type="mobilebert",
              architectures=["MobileBertForSequenceClassification"],
              id2label={"0": "LABEL_0", "1": "LABEL_1"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words += [f"tok{i}" for i in range(cfg.vocab_size - len(words))]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(words) + "\n")
    return str(path)


def test_cli_trains_mobilebert_qat_w4a8(tmp_path):
    hf = write_hf_mobilebert(tmp_path / "hf")
    losses, sites, plans = [], [], []
    real_step, real_build = TQAT.make_qat_train_step, TM._build_plan

    def make(apply_fn, qcfg, qat, tx):
        sites.append(qat.int8_sites)
        step = real_step(apply_fn, qcfg, qat, tx)

        def run(*a):
            out = step(*a)
            losses.append(float(out[-1]))
            return out
        return run

    def build(*a, **k):
        out = real_build(*a, **k)
        plans.append(out[0])
        return out

    TQAT.make_qat_train_step, TM._build_plan = make, build
    try:
        final = TCLI.main([
            "train-quantized", "--recipe", "qat-w4a8", "--max-steps", "2",
            "--model-name", "mobilebert_uncased", "--model-path", hf,
            "--synthetic-data", "--task", "rte", "--max-seq-length",
            str(SEQ), "--num-train-samples", "32", "--num-val-samples",
            "16", "--weight-quant-method", "current_minmax", "--engine",
            "auto", "--device", "cpu", "--output-dir",
            str(tmp_path / "out")])
    finally:
        TQAT.make_qat_train_step, TM._build_plan = real_step, real_build
    assert len(losses) == 2 and np.all(np.isfinite(losses)), losses
    # the int8 QAT forward (the recipe's learned ranges: JAX's 'auto')
    assert len(sites) == 1 and {"L0.bn.in.dense", "L1.out.bn.dense",
                                "classifier"} <= sites[0]
    # evaluated on the W4A8 engine: every matmul of the plan packed int4
    assert plans and all(all(f) for p in plans for f in p.w4)
    assert os.path.exists(tmp_path / "out" / "final_score.txt")
    assert np.isfinite(float(final))
