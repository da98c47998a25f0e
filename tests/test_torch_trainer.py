"""The port's train loop and its data layer (``training/trainer.py``,
``training/optim.py``, ``utils/glue.py``, ``utils/data.py``,
``convert.py``'s QAT state) against the JAX package, and its own
guarantees: resume equal to an uninterrupted run, cadences in optimizer
steps under gradient accumulation, the best model restored, dropout
reproducible from its generator.

The model is the tiny BERT of tests/test_torch_qat.py (2 layers, H=64,
seq 32, batch 4), calibrated by the port with current-minmax W4A8 ranges;
data are synthetic RTE examples through the hash tokenizer.

Tolerances: everything here is exact (bit for bit), except the metrics'
floats against JAX's, equal to 1e-12.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transformer_quantization_tpu.training import qat as JQAT
from transformer_quantization_tpu.training import trainer as JT
from transformer_quantization_tpu.utils import checkpoint as JCK
from transformer_quantization_tpu.utils import data as JD
from transformer_quantization_tpu.utils import glue as JG
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.training import calibration as TC
from transformer_quantization_tpu_torch.training import qat as TQAT
from transformer_quantization_tpu_torch.training import trainer as TT
from transformer_quantization_tpu_torch.utils import checkpoint as TCK
from transformer_quantization_tpu_torch.utils import data as TD
from transformer_quantization_tpu_torch.utils import glue as TG

torch.set_num_threads(2)

KW = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=128,
          max_position_embeddings=64, num_labels=2)
SEQ = 32


def _setup(dropout=0.0, n_train=24, seed=0):
    cfg = TB.BertConfig(**KW, hidden_dropout_prob=dropout,
                        attention_probs_dropout_prob=dropout)
    params, qcfg, qstate = TC.calibrated_bert(
        cfg, batch_size=2, seq=SEQ, seed=seed, device="cpu",
        defaults=dataclasses.replace(TC.w8a8_defaults(), n_bits=4,
                                     n_bits_act=8))
    task = TG.TASKS["rte"]
    tok = TD.SyntheticTokenizer(cfg.vocab_size)
    train = TD.encode_examples(tok, task, TG.synthetic_examples(
        task, "train", n_train, seed=2), SEQ)
    val = TD.encode_examples(tok, task, TG.synthetic_examples(
        task, "validation", 10, seed=2), SEQ)
    apply_fn = functools.partial(TB.bert_apply, cfg=cfg, device="cpu")
    return cfg, params, qcfg, qstate, task, train, val, apply_fn


TCFG = dict(learning_rate=1e-4, num_epochs=2, batch_size=4,
            max_grad_norm=1.0, warmup_steps=2, log_every=1000, seed=11)


def _equal_states(a, b):
    pa, qa = a
    pb, qb = b
    for (path, x), (_, y) in zip(TQAT.tree_leaves(pa),
                                 TQAT.tree_leaves(pb)):
        assert torch.equal(x, y), path
    assert set(qa) == set(qb)
    for site in qa:
        for f in ("delta", "zero_float", "signed"):
            assert torch.equal(getattr(qa[site]["qp"], f),
                               getattr(qb[site]["qp"], f)), (site, f)


@pytest.mark.parametrize("accum", [1, 2])
def test_resume_equals_an_uninterrupted_run(tmp_path, accum):
    """Learned ranges, dropout 0.1 (the generator's state is part of the
    train state), the run cut after three optimizer steps and resumed to
    seven: bit for bit the uninterrupted seven, across an epoch boundary
    (six micro-batches an epoch)."""
    cfg, params, qcfg, qstate, task, train, _, apply_fn = _setup(0.1)
    qat = TQAT.QATConfig(learn_ranges=True)
    kw = dict(TCFG, grad_accum_steps=accum)
    full = TT.train(apply_fn, params, task, train,
                    TT.TrainConfig(**kw, max_steps=7), qcfg=qcfg,
                    qstate=qstate, qat_cfg=qat, log_fn=lambda *_: None)
    path = str(tmp_path / "state")
    TT.train(apply_fn, params, task, train,
             TT.TrainConfig(**kw, max_steps=3, save_every=3), qcfg=qcfg,
             qstate=qstate, qat_cfg=qat, log_fn=lambda *_: None,
             train_state_path=path)
    assert TT.has_train_state(path)
    log = []
    resumed = TT.train(apply_fn, params, task, train,
                       TT.TrainConfig(**kw, max_steps=7), qcfg=qcfg,
                       qstate=qstate, qat_cfg=qat, log_fn=log.append,
                       train_state_path=path, resume=True)
    assert any("resumed train state" in s and f"step {3 * accum}" in s
               for s in log)
    _equal_states(resumed, full)
    # resuming at max_steps takes no extra step
    again = TT.train(apply_fn, params, task, train,
                     TT.TrainConfig(**kw, max_steps=3), qcfg=qcfg,
                     qstate=qstate, qat_cfg=qat, log_fn=lambda *_: None,
                     train_state_path=path, resume=True)
    three = TT.train(apply_fn, params, task, train,
                     TT.TrainConfig(**kw, max_steps=3), qcfg=qcfg,
                     qstate=qstate, qat_cfg=qat, log_fn=lambda *_: None)
    _equal_states(again, three)


def test_cadences_count_optimizer_steps_under_accumulation(tmp_path):
    cfg, params, qcfg, qstate, task, train, val, apply_fn = _setup()
    saved, log = [], []
    path = str(tmp_path / "state")
    TT.train(apply_fn, params, task, train,
             TT.TrainConfig(**dict(TCFG, grad_accum_steps=2, max_steps=3,
                                   eval_every=1, save_every=1,
                                   eval_batch_size=4)),
             qcfg=qcfg, qstate=qstate,
             qat_cfg=TQAT.QATConfig(learn_ranges=True), eval_arrays=val,
             log_fn=log.append, train_state_path=path,
             save_fn=lambda p, q, step: saved.append(step))
    # micro-batches 2, 4, 6 close optimizer steps 1, 2, 3
    assert saved == [2, 4, 6]
    evals = [s for s in log if "eval:" in s]
    assert [s.split("]")[0] for s in evals] == ["[step 2", "[step 4",
                                                "[step 6"]
    with np.load(path + ".opt.npz") as z:
        assert int(z["__step__"]) == 6
        assert int(z["opt/count"]) == 3 and int(z["opt/gradient_step"]) == 3
        assert int(z["opt/mini_step"]) == 0


def test_the_best_model_is_restored():
    cfg, params, qcfg, qstate, task, train, val, apply_fn = _setup()
    snaps, log = {}, []

    def save_fn(p, q, step):
        snaps[step] = ({k: v for k, v in TQAT.tree_leaves(p)}, q)

    p_end, q_end = TT.train(
        apply_fn, params, task, train,
        TT.TrainConfig(**dict(TCFG, max_steps=6, eval_every=1, save_every=1,
                              eval_batch_size=4, load_best_model_at_end=True,
                              metric_for_best_model="accuracy",
                              greater_is_better=False)),
        qcfg=qcfg, qstate=qstate, qat_cfg=TQAT.QATConfig(learn_ranges=True),
        eval_arrays=val, log_fn=log.append, save_fn=save_fn)
    scores = [json.loads(s.split("eval: ")[1].replace("'", '"'))["accuracy"]
              for s in log if "eval:" in s]
    assert len(scores) == 6
    best = 1 + int(np.argmin(scores))  # the first of the lowest
    assert any("restoring best checkpoint" in s for s in log)
    leaves, q_best = snaps[best]
    for path, t in TQAT.tree_leaves(p_end):
        assert torch.equal(t, leaves[path]), path
    for site, st in q_best.items():
        assert torch.equal(q_end[site]["qp"].delta, st["qp"].delta), site


def test_ffn_weight_decay_reaches_ffn_kernels_only():
    """Zero gradients, constant lr: the update is the decoupled decay
    alone, ``-lr * wd * p``, on FFN kernels at ``weight_decay +
    ffn_weight_decay``; the same update as the JAX optimizer's."""
    cfg, params, *_ = _setup()
    tcfg = dict(learning_rate=0.5, lr_scheduler_type="constant",
                weight_decay=0.01, ffn_weight_decay=0.1, max_grad_norm=1.0)
    tx = TT.make_optimizer(TT.TrainConfig(**tcfg), 10, params)
    labels = dict(zip(TQAT.trainable_paths(params), tx.labels))
    ffn = {p for p, lab in labels.items() if lab == "ffn"}
    assert ffn == {("params", "layers", str(i), "ffn", k, "kernel")
                   for i in range(2) for k in ("inter", "dense")}
    leaves = [t for _, t in TQAT.tree_leaves(params)]
    flat = torch.ones((5,))
    new, _ = tx.update([torch.zeros_like(t) for t in leaves + [flat]],
                       tx.init(leaves + [flat]), leaves + [flat])
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jtx = JT.make_optimizer(JT.TrainConfig(**tcfg), 10)
    tree = {"params": jparams, "ranges": jnp.ones((5,))}
    upd, _ = jtx.update(jax.tree.map(jnp.zeros_like, tree), jtx.init(tree),
                        tree)
    jnew = optax.apply_updates(tree, upd)
    for got, want in zip(new, jax.tree.leaves(jnew)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dropout_steps_repeat_from_the_generator_seed():
    cfg, params, qcfg, qstate, task, train, _, apply_fn = _setup(0.1)
    qat = TQAT.QATConfig(learn_ranges=True)
    learnable, rest = TQAT.split_learnable_ranges(qcfg, qstate)
    batch = {k: v[:4] for k, v in train.items()}

    def loss(seed):
        gen = torch.Generator().manual_seed(seed)
        return TQAT.qat_value_and_grad(apply_fn, qcfg, qat, params,
                                       learnable, rest, batch, gen)[:2]

    (l1, g1), (l2, g2), (l3, _) = loss(5), loss(5), loss(6)
    assert torch.equal(l1, l2) and all(torch.equal(a, b)
                                       for a, b in zip(g1, g2))
    assert not torch.equal(l1, l3)
    # training dropout needs a generator
    with pytest.raises(ValueError, match="Generator"):
        TQAT.qat_value_and_grad(apply_fn, qcfg, qat, params, learnable,
                                rest, batch, None)


@pytest.mark.parametrize("field,value", [("compute_dtype", "bfloat16"),
                                         ("remat", True),
                                         ("scan_layers", True),
                                         ("pp_mesh", object())])
def test_unported_qat_options_raise(field, value):
    """Only the pipeline (``pp_mesh``, ROADMAP §1 item 9) is still refused;
    the other options build the step and reach the forward as the JAX
    step passes them (``compute_dtype`` as a torch dtype)."""
    cfg, params, qcfg, qstate, *_ = _setup()
    qat = TQAT.QATConfig(learn_ranges=True, **{field: value})
    tx = TQAT.make_optimizer(qat, params)
    if field == "pp_mesh":
        with pytest.raises(NotImplementedError,
                           match="pp_mesh.*not yet ported.*item 9"):
            TQAT.make_qat_train_step(None, qcfg, qat, tx)
        return
    assert callable(TQAT.make_qat_train_step(None, qcfg, qat, tx))
    want = torch.bfloat16 if field == "compute_dtype" else value
    assert TQAT.forward_options(qat) == {field: want}


def test_qat_optimizer_with_a_range_learning_rate_matches_jax():
    """``training/qat.py`` ``make_optimizer``: AdamW on the weights, Adam
    at ``range_learning_rate`` on the ranges; two updates on the same
    gradients equal to optax's."""
    rng = np.random.RandomState(0)
    params = {"a": {"kernel": rng.normal(size=(3, 4)).astype(np.float32)},
              "b": rng.normal(size=(5,)).astype(np.float32)}
    ranges = rng.uniform(0.1, 1, (6,)).astype(np.float32)
    grads = [{"params": jax.tree.map(
        lambda t: rng.normal(size=t.shape).astype(np.float32), params),
        "ranges": rng.normal(size=(6,)).astype(np.float32)}
        for _ in range(2)]
    qat = dict(learning_rate=1e-2, range_learning_rate=1e-3,
               weight_decay=0.05)
    jtx = JQAT.make_optimizer(JQAT.QATConfig(**qat))
    tree = {"params": params, "ranges": ranges}
    state = jtx.init(tree)
    for g in grads:
        upd, state = jtx.update(g, state, tree)
        tree = optax.apply_updates(tree, upd)
    tparams = jax.tree.map(torch.from_numpy, params)
    tx = TQAT.make_optimizer(TQAT.QATConfig(**qat), tparams)
    leaves = [t for _, t in TQAT.tree_leaves(tparams)] + [
        torch.from_numpy(ranges)]
    st = tx.init(leaves)
    for g in grads:
        gl = [torch.from_numpy(np.asarray(t)) for t in jax.tree.leaves(g)]
        leaves, st = tx.update(gl, st, leaves)
    for got, want in zip(leaves, jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_glue_and_batching_match_jax(tmp_path):
    for name in ("rte", "stsb", "cola", "mnli"):
        jt, tt = JG.TASKS[name], TG.TASKS[name]
        assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
        assert (TG.synthetic_examples(tt, "train", 12, seed=3)
                == JG.synthetic_examples(jt, "train", 12, seed=3))
    assert ([t.name for t in TG.resolve_tasks("all")]
            == [t.name for t in JG.resolve_tasks("all")])
    rng = np.random.RandomState(1)
    for name in ("rte", "mrpc", "cola", "stsb"):
        t = TG.TASKS[name]
        n = 37
        if t.num_labels == 1:
            logits = rng.uniform(0, 5, (n, 1)).astype(np.float32)
            labels = rng.uniform(0, 5, n).astype(np.float32)
            labels[:5] = labels[5]  # ties for the ranks
        else:
            logits = rng.normal(size=(n, 2)).astype(np.float32)
            labels = rng.randint(0, 2, n)
        got = TG.compute_metrics(t, logits, labels)
        want = JG.compute_metrics(JG.TASKS[name], logits, labels)
        assert got.keys() == want.keys()
        for k in got:
            assert abs(got[k] - want[k]) < 1e-12, (name, k)
    task = TG.TASKS["mrpc"]
    ex = TG.synthetic_examples(task, "train", 21, seed=4)
    tarr = TD.encode_examples(TD.SyntheticTokenizer(128), task, ex, 24)
    jarr = JD.encode_examples(JD.SyntheticTokenizer(128), JG.TASKS["mrpc"],
                              ex, 24)
    for k in jarr:
        np.testing.assert_array_equal(tarr[k], jarr[k])
        assert tarr[k].dtype == jarr[k].dtype
    for kw in (dict(shuffle=True, drop_last=True), dict(pad_final=True),
               dict(shuffle=True)):
        tb = list(TD.batch_iterator(tarr, 4, rng=np.random.RandomState(9),
                                    **kw))
        jb = list(JD.batch_iterator(jarr, 4, rng=np.random.RandomState(9),
                                    **kw))
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    b0 = {k: v[:5] for k, v in tarr.items()}
    for mult in (1, 8):
        tt = TD.trim_to_real_length(b0, mult)
        jt_ = JD.trim_to_real_length(b0, mult)
        for k in jt_:
            np.testing.assert_array_equal(tt[k], jt_[k])
    # local files: both packages read the same examples
    d = tmp_path / "rte"
    d.mkdir()
    rows = TG.synthetic_examples(TG.TASKS["rte"], "train", 6, seed=1)
    with open(d / "train.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    with open(d / "dev.tsv", "w") as f:
        f.write("sentence1\tsentence2\tlabel\n")
        for r in rows[:3]:
            f.write(f"{r['sentence1']}\t{r['sentence2']}\t{r['label']}\n")
    got = TG.load_task_data(TG.TASKS["rte"], data_dir=str(tmp_path))
    want = JG.load_task_data(JG.TASKS["rte"], data_dir=str(tmp_path))
    assert got == want and len(got["validation"]) == 3
    assert (TG.load_task_data(TG.TASKS["rte"], synthetic=True)
            == JG.load_task_data(JG.TASKS["rte"], synthetic=True))
    # the Hugging Face datasets branch, its load_dataset stubbed in both
    # packages (nothing is fetched), then without a cache: synthetic
    datasets = pytest.importorskip("datasets")
    calls = []

    def load_dataset(path, name):
        calls.append((path, name))
        split = {"sentence1": [r["sentence1"] for r in rows],
                 "sentence2": [r["sentence2"] for r in rows],
                 "label": [r["label"] for r in rows]}
        return {"train": datasets.Dataset.from_dict(split),
                "validation": datasets.Dataset.from_dict(split)}

    real = datasets.load_dataset
    datasets.load_dataset = load_dataset
    try:
        got = TG.load_task_data(TG.TASKS["rte"])
        want = JG.load_task_data(JG.TASKS["rte"])
    finally:
        datasets.load_dataset = real
    assert calls == [("glue", "rte")] * 2
    assert got == want and got["train"] == rows

    def no_cache(*a, **k):
        raise FileNotFoundError("no local datasets cache")

    datasets.load_dataset = no_cache
    try:
        got = TG.load_task_data(TG.TASKS["rte"], seed=3)
        want = JG.load_task_data(JG.TASKS["rte"], seed=3)
    finally:
        datasets.load_dataset = real
    assert got == want == TG.load_task_data(TG.TASKS["rte"], synthetic=True,
                                            seed=3)


def test_evaluate_matches_the_forward():
    cfg, params, qcfg, qstate, task, _, val, apply_fn = _setup()
    from transformer_quantization_tpu_torch.quant.qconfig import QuantMode

    m = TT.evaluate(apply_fn, params, qstate, task, val, qcfg=qcfg,
                    mode=QuantMode(), batch_size=4)
    out, _ = apply_fn(params, {k: v for k, v in val.items()
                               if k != "labels"}, qcfg=qcfg, qstate=qstate)
    want = TG.compute_metrics(task, out["logits"].numpy(), val["labels"])
    assert m == want


def test_jax_qat_state_carries_across(tmp_path):
    """A JAX learn-ranges split (``qp_signed`` in ``rest``) and a JAX train
    state file's weights and ranges -> the port, equal arrays; merged, the
    port's split of the same qstate."""
    import __graft_entry__ as G
    from transformer_quantization_tpu.models import bert as JB

    jcfg = JB.BertConfig(**KW)
    jp, jq, js = G._calibrated_bert(jcfg, batch_size=2, seq=16)
    learnable, rest = JQAT.split_learnable_ranges(jq, js)
    path = str(tmp_path / "jstate")
    tx = optax.adam(1e-3)
    JT.save_train_state(path, jp, learnable, rest,
                        tx.init({"params": jp}), jax.random.PRNGKey(0), 3)
    tp, tl, tr = C.train_state_from_jax(TCK.load_tree(path + ".model.npz"),
                                        device="cpu")
    for (path_, a), b in zip(TQAT.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert set(tl) == set(learnable) and set(tr) == set(rest)
    for site, st in learnable.items():
        for k in ("delta", "zero_float"):
            np.testing.assert_array_equal(tl[site][k].numpy(),
                                          np.asarray(st[k]))
        np.testing.assert_array_equal(tr[site]["qp_signed"].numpy(),
                                      np.asarray(rest[site]["qp_signed"]))
    merged = TQAT.merge_learnable_ranges(tl, tr)
    ts = C.qstate_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    tcfg = TB.BertConfig(**KW)
    tq = TB.declare_bert_sites(TC.w8a8_defaults(), tcfg)
    pl, prest = TQAT.split_learnable_ranges(tq, ts)
    assert set(pl) == set(tl)
    for site in merged:
        for f in ("delta", "zero_float", "signed"):
            assert torch.equal(getattr(merged[site]["qp"], f),
                               getattr(ts[site]["qp"], f)), site
    flat, unravel = TQAT.ravel_ranges(pl)
    jflat, _ = jax.flatten_util.ravel_pytree(learnable)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert jax.tree.structure(JCK.load_tree(path + ".model.npz")) is not None
