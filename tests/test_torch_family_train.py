"""Port parity for the training forward and QAT of RoBERTa, DistilBERT,
ALBERT and SqueezeBERT against the JAX package, and each trained model's
W4A8 engine.

Each family is the registry's tiny preset (2 layers, H = 64, 4 heads of
16, I = 128; ALBERT's one shared layer applied twice on 16-wide
factorized embeddings; SqueezeBERT's q / k / v and FFN in 4 groups),
both dropouts 0, randomly initialized and calibrated by the port
(current-minmax 4-bit symmetric weights, 8-bit asymmetric activations,
one batch); the same weights and ranges are carried into JAX, so both
packages train one model. The data are synthetic RTE examples through
the hash tokenizer (seq 32, batch 4; RoBERTa's token types 0, as its
tokenizer gives them), made with numpy from a seed.

- one learned-ranges (``qat-w4a8``) step on the int8 QAT forward (the
  recipe's ``auto``): the int8 sites equal to JAX's ``int8_forward_sites``
  (ALBERT's ``shared.*`` names included); the loss within rtol 1e-5 of
  JAX's; every weight gradient and the packed range gradients within rtol
  1e-4 with an absolute floor of 1e-6 of the tensor's largest (the bounds
  of ``tests/test_torch_qat.py``); the key biases, whose gradient is zero
  up to rounding, below 1e-6 of the largest weight gradient on both
  sides; then the AdamW update within rtol 1e-4 of optax's, with a floor
  of a hundredth of one Adam step, where the gradient is at least 100
  times Adam's eps (below, the first step's ``g / (|g| + eps)`` turns the
  gradient's last bits into a share of a step). SqueezeBERT's grouped layers stay on
  the float fake-quant forward (as in JAX), whose float32 sums may take
  another act level at a rounding edge than XLA's: there the flip rule of
  ``tests/test_torch_mobilebert_train.py`` (at most one level on at most
  1e-3 of the outputs, gradients within 1e-1 of the tensor's largest; the
  strict bounds when no output flipped). RoBERTa's logits site range
  gradient sums the residuals of logits from its head's unquantized tanh,
  whose last bits torch and XLA compute differently: rtol 1e-3 there
  (``TANH_LOGITS``). JAX runs jitted without XLA's
  backend optimizations (the parity contract's O0 rule, ROADMAP), one
  program a family;
- ALBERT's shared layer: the shared weights' gradient equals the sum of
  the gradients of per-application copies (the port alone);
- ``remat`` with both dropouts at 0.1 (the port alone: JAX draws other
  random numbers): loss, gradients, the new quant state and the dropout
  generator's state bit-identical to the forward without it;
- the trained model (the port's step) packed int4 and planned by both
  packages: every plan leaf and the static fields equal, every matmul's
  ``w4`` flag set, and the port's engine on its plain versions within
  rtol 1e-3 / atol 2e-3 of JAX's engine on its XLA backend.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

import __graft_entry__ as G
from transformer_quantization_tpu.models import registry as JR
from transformer_quantization_tpu.quant import quantizers as JQ
from transformer_quantization_tpu.training import qat as JQAT
from transformer_quantization_tpu.utils import data as JD
from transformer_quantization_tpu.utils import glue as JG
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.models import registry as TR
from transformer_quantization_tpu_torch.training import calibration as TC
from transformer_quantization_tpu_torch.training import qat as TQAT

torch.set_num_threads(2)

MODELS = ["roberta_base", "distilbert_base_uncased", "albert_base_v2",
          "squeezebert_uncased"]
SEQ, BATCH, LR = 32, 4, 5e-5
RTOL, ATOL = 1e-3, 2e-3
O0 = {"xla_backend_optimization_level": 0}
# RoBERTa's logits come from a float product on the head's tanh, whose
# output is not quantized: torch's and XLA's tanh differ by an ulp on most
# inputs, and the logits site's range gradient, a sum of the logits'
# rounding residuals, carries those ulps (4.0e-4 relative measured)
TANH_LOGITS = {"roberta_base": "clf.out_proj.out"}
TANH_LOGITS_RTOL = 1e-3
ADAM_EPS = 1e-8   # optax.adamw's


def _w4a8(defaults):
    return dataclasses.replace(defaults, n_bits=4, n_bits_act=8)


def to_jax(tp, ts):
    """The port's params and quant state as JAX's trees (the ranges'
    ``qp`` only)."""
    jp = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tp)
    js = {name: {"qp": JQ.QuantParams(
        delta=jnp.asarray(st["qp"].delta.detach().numpy()),
        zero_float=jnp.asarray(st["qp"].zero_float.detach().numpy()),
        signed=jnp.asarray(st["qp"].signed.detach().numpy()))}
        for name, st in ts.items() if "qp" in st}
    return jp, js


def _last_site(name, cfg):
    return ("shared.ffn.ln.out" if name.startswith("albert")
            else f"L{cfg.num_hidden_layers - 1}.ffn.ln.out")


@functools.lru_cache(maxsize=None)
def _model(name):
    tfam, jfam = TR.get_family(name), JR.get_family(name)
    kw = dict(tfam.tiny_preset, num_labels=2, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
    tcfg, jcfg = tfam.config_cls(**kw), jfam.config_cls(**kw)
    tp = tfam.init_params(tcfg, 0, "cpu")
    tq = tfam.declare_sites(_w4a8(TC.w8a8_defaults()), tcfg)
    ts, _ = TC.prepare_quantized_model(
        functools.partial(tfam.apply, cfg=tcfg), tp, tq,
        [TC.calibration_batch(tcfg.vocab_size, 2, SEQ, 0)],
        weight_tensors=tfam.weight_site_tensors(tp), device="cpu")
    jq = jfam.declare_sites(_w4a8(G._w8a8_defaults()), jcfg)
    jp, js = to_jax(tp, ts)
    task = JG.TASKS["rte"]
    arrays = JD.encode_examples(
        JD.SyntheticTokenizer(kw["vocab_size"]), task,
        JG.synthetic_examples(task, "train", 2 * BATCH, seed=5), SEQ)
    batch = {k: v[:BATCH] for k, v in arrays.items()}
    if tcfg.type_vocab_size == 1:
        # RoBERTa's one-row token-type table: its tokenizer gives type 0
        batch["token_type_ids"] = np.zeros_like(batch["token_type_ids"])
    return dict(name=name, tfam=tfam, jfam=jfam, tcfg=tcfg, jcfg=jcfg,
                tp=tp, tq=tq, ts=ts, jq=jq, jp=jp, js=js, batch=batch)


def _port_step(m):
    """The port's learned-ranges step on the int8 QAT forward: ``(qat,
    loss, grads, unravel, new params, new quant state)``."""
    qat = TQAT.QATConfig(learn_ranges=True, learning_rate=LR,
                         int8_sites=TQAT.int8_forward_sites(m["tq"],
                                                            m["ts"]))
    apply_fn = functools.partial(m["tfam"].apply, cfg=m["tcfg"],
                                 device="cpu")
    learnable, rest = TQAT.split_learnable_ranges(m["tq"], m["ts"])
    loss, grads, _, unravel = TQAT.qat_value_and_grad(
        apply_fn, m["tq"], qat, m["tp"], learnable, rest, m["batch"], None)
    tx = TQAT.make_optimizer(qat, m["tp"])
    state = TQAT.init_qat_state(m["tq"], qat, m["tp"], m["ts"], tx)
    step = TQAT.make_qat_train_step(apply_fn, m["tq"], qat, tx)
    new_p, new_l, new_rest, _, _, _ = step(*state, m["batch"], None)
    return (qat, float(loss), grads, unravel, new_p,
            TQAT.merge_learnable_ranges(new_l, new_rest))


def _jax_step(m, sites):
    """JAX's value and gradient and the AdamW update of
    ``JQAT.make_optimizer`` in one program jitted at O0: ``(loss, grads,
    unravel, new tree, the forward's sequence output)``."""
    learnable, rest = JQAT.split_learnable_ranges(m["jq"], m["js"])
    flat, unravel = ravel_pytree(learnable)
    qat = JQAT.QATConfig(learn_ranges=True, learning_rate=LR)
    mode = JQAT.qat_mode(qat)
    batch = {k: jnp.asarray(v) for k, v in m["batch"].items()}

    def loss_fn(tr):
        qs = JQAT.merge_learnable_ranges(unravel(tr["ranges"]), rest)
        out, _ = m["jfam"].apply(tr["params"], batch, m["jcfg"],
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


@functools.lru_cache(maxsize=None)
def _steps(name):
    """Both packages' step on one family, shared by its cases."""
    m = _model(name)
    port = _port_step(m)
    jsites = JQAT.int8_forward_sites(m["jq"], m["js"])
    return port, jsites, _jax_step(m, jsites)


def _close(got, want, what, rtol=1e-4, floor=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=floor * float(np.abs(want).max()),
                               err_msg=what)


def _adam_close(got, want, grad, what):
    """The AdamW update against optax's (rtol 1e-4, a hundredth of one
    Adam step as the floor) where the gradient is at least 100 times
    Adam's eps: the first step ``lr g / (|g| + eps)`` moves by ``lr |dg|
    eps / (|g| + eps)^2``, which below that turns the gradient's last bits
    (held by the gradient comparison) into a share of a step."""
    keep = np.abs(np.asarray(grad)) >= 100 * ADAM_EPS
    np.testing.assert_allclose(np.asarray(got)[keep], np.asarray(want)[keep],
                               rtol=1e-4, atol=1e-2 * LR, err_msg=what)


def _vanishing(path) -> bool:
    """The key biases: a shift of every key adds one constant to each
    query's scores, which the softmax ignores."""
    return tuple(path[-2:]) == ("k", "bias")


def _flips(m, qat, jax_out) -> tuple:
    """(elements of the port's training forward's sequence output off
    JAX's ``jax_out``, the largest difference in levels of its site)."""
    with torch.no_grad():
        t = m["tfam"].apply(m["tp"], m["batch"], m["tcfg"], m["tq"],
                            m["ts"], TQAT.qat_mode(qat), train=True,
                            int8_qat_sites=qat.int8_sites, device="cpu")
    last = _last_site(m["name"], m["tcfg"])
    d = np.abs(t[0]["sequence_output"].numpy() - jax_out)
    return (int((d > 0).sum()),
            float(d.max()) / float(m["ts"][last]["qp"].delta))


@pytest.mark.parametrize("name", MODELS)
def test_one_qat_w4a8_step_matches_jax(name):
    m = _model(name)
    (qat, loss, grads, unravel, new_p, _), jsites, jax_out = _steps(name)
    jloss, jg, junravel, jnew, jout = jax_out
    assert qat.int8_sites == jsites
    # the int8 QAT forward reaches the encoder and the head
    real = {s for s in jsites if not s.startswith("L.")}
    if name.startswith("albert"):
        assert {"emb_proj", "shared.attn.q", "shared.ffn.dense",
                "classifier"} <= real
        assert not any(s.startswith("L") for s in jsites)
    else:
        assert {"L0.attn.q", "L1.ffn.dense", "L1.attn_out.dense"} <= real
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    flips, levels = _flips(m, qat, jout)
    n_out = BATCH * SEQ * m["tcfg"].hidden_size
    assert flips <= 1e-3 * n_out
    assert levels <= 1 + 1e-6
    if not name.startswith("squeezebert"):
        assert flips == 0   # every encoder matmul on exact int8 products
    jleaves = jax.tree.leaves(jg["params"])
    paths = [p for p, _ in TQAT.tree_leaves(m["tp"])]
    assert len(jleaves) == len(grads) - 1
    gmax = max(float(np.abs(np.asarray(b)).max()) for b in jleaves)
    for path, a, b in zip(paths, grads, jleaves):
        b = np.asarray(b)
        if _vanishing(path):
            assert float(a.abs().max()) <= 1e-6 * gmax
            assert float(np.abs(b).max()) <= 1e-6 * gmax
        elif flips:
            assert np.abs(a.numpy() - b).max() <= 1e-1 * np.abs(b).max(), (
                "/".join(path))
        else:
            _close(a.numpy(), b, "/".join(path))
    if flips:
        return
    tr, jr = unravel(grads[-1]), junravel(jg["ranges"])
    assert sorted(tr) == sorted(jr)
    floor = 1e-6 * float(np.abs(np.asarray(jg["ranges"])).max())
    for site in tr:
        for f in ("delta", "zero_float"):
            np.testing.assert_allclose(
                tr[site][f].numpy(), np.asarray(jr[site][f]),
                rtol=TANH_LOGITS_RTOL if site == TANH_LOGITS.get(name)
                else 1e-4, atol=floor, err_msg=f"{site} {f}")
    for (path, a), b, g in zip(TQAT.tree_leaves(new_p),
                               jax.tree.leaves(jnew["params"]), jleaves):
        _adam_close(a.numpy(), b, g, "/".join(path))
    flat_new, _ = ravel_pytree(jnew["ranges"])
    got, _ = TQAT.ravel_ranges(TQAT.split_learnable_ranges(
        m["tq"], _steps(name)[0][5])[0])
    _adam_close(got.numpy(), flat_new, jg["ranges"], "ranges")


def test_albert_shared_weight_gradient_sums_its_applications(monkeypatch):
    """One learned-ranges loss on ALBERT with each application of the
    shared layer given its own copy of the shared weights: the shared
    weights' gradient equals the sum of the copies' gradients, leaf for
    leaf, within float32 rounding of the sum."""
    m = _model("albert_base_v2")
    L = m["tcfg"].num_hidden_layers
    qat = TQAT.QATConfig(learn_ranges=True)
    learnable, rest = TQAT.split_learnable_ranges(m["tq"], m["ts"])
    apply_fn = functools.partial(m["tfam"].apply, cfg=m["tcfg"],
                                 device="cpu")
    _, grads, _, _ = TQAT.qat_value_and_grad(
        apply_fn, m["tq"], qat, m["tp"], learnable, rest, m["batch"], None)
    shared = {p: g for (p, _), g in zip(TQAT.tree_leaves(m["tp"]), grads)
              if p[0] == "shared"}

    copies = [TQAT.tree_unflatten(m["tp"]["shared"], [
        t.detach().clone().requires_grad_(True)
        for _, t in TQAT.tree_leaves(m["tp"]["shared"])]) for _ in range(L)]
    seen = []
    real_layer = TB._layer

    def layer(ctx, p, *a, **k):
        assert p is m["tp"]["shared"]
        seen.append(len(seen))
        return real_layer(ctx, copies[seen[-1]], *a, **k)

    monkeypatch.setattr(TB, "_layer", layer)
    flat, unravel = TQAT.ravel_ranges(learnable)
    out, _ = m["tfam"].apply(
        m["tp"], m["batch"], m["tcfg"], m["tq"],
        TQAT.merge_learnable_ranges(unravel(flat), rest),
        TQAT.qat_mode(qat), train=True, device="cpu")
    leaves = [[t for _, t in TQAT.tree_leaves(c)] for c in copies]
    per_copy = torch.autograd.grad(out["loss"], sum(leaves, []))
    assert seen == list(range(L))
    n = len(leaves[0])
    for j, (path, g) in enumerate(shared.items()):
        want = sum(per_copy[i * n + j] for i in range(L))
        scale = max(float(want.abs().max()), 1e-30)
        assert float((g - want).abs().max()) <= 1e-6 * scale, path
        # every application contributes
        assert all(float(per_copy[i * n + j].abs().max()) > 0
                   for i in range(L)) or _vanishing(path), path


@pytest.mark.parametrize("name", MODELS)
def test_remat_is_bit_identical_with_dropout(name):
    """Both dropouts at 0.1: ``remat`` recomputes each layer (each of
    ALBERT's applications) in the backward from its entry quant state and
    generator state, so the step's values equal the plain forward's bit
    for bit."""
    m = _model(name)
    cfg = dataclasses.replace(m["tcfg"], hidden_dropout_prob=0.1,
                              attention_probs_dropout_prob=0.1)
    learnable, rest = TQAT.split_learnable_ranges(m["tq"], m["ts"])
    apply_fn = functools.partial(m["tfam"].apply, cfg=cfg, device="cpu")
    out = {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(3)
        qat = TQAT.QATConfig(learn_ranges=True, remat=remat)
        loss, grads, qs, _ = TQAT.qat_value_and_grad(
            apply_fn, m["tq"], qat, m["tp"], learnable, rest, m["batch"],
            gen)
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
    other, _, _, _ = TQAT.qat_value_and_grad(
        apply_fn, m["tq"], TQAT.QATConfig(learn_ranges=True), m["tp"],
        learnable, rest, m["batch"], torch.Generator().manual_seed(4))
    assert not torch.equal(other, l0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", MODELS)
def test_trained_w4a8_engine_matches_jax(name):
    m = _model(name)
    (_, _, _, _, new_p, new_q), _, _ = _steps(name)
    tst, tplan, tint = m["tfam"].build_engine(new_p, m["tcfg"], m["tq"],
                                              new_q, use_int4=True,
                                              device="cpu")
    jp, js = to_jax(new_p, new_q)
    jst, jplan, jint = m["jfam"].build_engine(jp, m["jcfg"], m["jq"], js,
                                              use_int4=True)
    for f in ("n_layers", "n_heads", "ln_eps", "hidden_act", "fold",
              "res_quant", "attn_skip_max", "attn_bits", "w4", "flex", "io",
              "any_flex"):
        assert getattr(tst, f) == getattr(jst, f), f
    assert all(tst.int8_layer) and all(all(f) for f in tst.w4)
    flat_j = jax.tree_util.tree_leaves_with_path(_np(jplan))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tplan))
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        np.testing.assert_array_equal(flat_t[path].numpy(), v,
                                      err_msg=str(path))
    batch = {k: v for k, v in m["batch"].items() if k != "labels"}
    got = m["tfam"].engine_apply(new_p, batch, m["tcfg"], m["tq"], new_q,
                                 tst, tplan, tint, backend="plain",
                                 device="cpu")["logits"]

    @functools.partial(jax.jit, compiler_options=O0)
    def engine(p, b, st, plan, ip):
        return m["jfam"].engine_apply(p, b, m["jcfg"], m["jq"], st, jst,
                                      plan, ip, backend="xla")["logits"]

    want = engine(jp, {k: jnp.asarray(v) for k, v in batch.items()}, js,
                  jplan, jint)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
