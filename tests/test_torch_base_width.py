"""Port parity at BERT-base width: H=768, 12 heads, I=3072, cut to 2 layers,
seq 32, 16 sequences, on the qstate the JAX package calibrates, for W8A8
and the paper's two recipes (``w8a8-mixed``: 16-bit x/h/y sites;
``w8a8-peg``: ``ngp6`` with the shared-h permutation).

At this width and batch a rare one-level payload flip (float32 sums in
another order) moves logits by more than the fixed rtol 1e-3 / atol 2e-3
of the narrower tests, in the JAX package's own routes as much as in the
port. The gates are therefore the JAX package's own route gaps on the
same batch:
- engine: max |port engine - JAX engine| <= max |JAX generic int - JAX
  engine| (the JAX engine on its XLA backend);
- simulation: max |port simulation - JAX simulation| <= max |JAX
  simulation - JAX generic int|;
- the last LayerNorm's payload (``sequence_output`` over the site's step,
  which a logit bound cannot see when logits are small): the port's
  engine differs from the JAX engine on no more elements, and by no more
  levels, than the JAX generic int path does.
``pytest -s`` prints every gap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.quant import manager as JM
from transformer_quantization_tpu.quant.qconfig import Phase as JPhase
from transformer_quantization_tpu.quant.qconfig import QuantMode as JMode
from transformer_quantization_tpu.training import calibration as JCAL
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.quant.qconfig import QuantMode
from transformer_quantization_tpu_torch.training import calibration as TC

torch.set_num_threads(2)

BASE = dict(vocab_size=512, hidden_size=768, num_hidden_layers=2,
            num_attention_heads=12, intermediate_size=3072,
            max_position_embeddings=64, num_labels=2)
SEQ, N_SEQ = 32, 16
RECIPES = {"w8a8": ({}, False), **TC.MINMAX_RECIPES}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_calibrated(cfg, params, qd, shared_h):
    """W8A8 defaults plus the recipe's quant_dict; weight ranges, the PEG
    pre-pass for permuted sites and one-batch calibration in one jit."""
    qcfg = JB.apply_bert_quant_dict(
        JB.declare_bert_sites(G._w8a8_defaults(), cfg), qd,
        cfg.num_hidden_layers)
    rng = np.random.RandomState(0)
    cal = {"input_ids": jnp.asarray(rng.randint(0, cfg.vocab_size, (2, SEQ)),
                                    jnp.int32),
           "attention_mask": jnp.ones((2, SEQ), jnp.float32),
           "token_type_ids": jnp.zeros((2, SEQ), jnp.int32)}
    shared = (JB.shared_permutation_groups(cfg.num_hidden_layers)
              if shared_h else None)

    def apply_fn(p, b, qcfg, qstate, mode):
        return JB.bert_apply(p, b, cfg, qcfg, qstate, mode)

    @jax.jit
    def calibrate(p, b):
        qs = JM.init_weight_qstate(qcfg, JB.bert_weight_site_tensors(p))
        if any(c.permute for _, c in qcfg.items()):
            qs = JCAL.record_permutation_ranges(apply_fn, p, qcfg, qs, [b],
                                                shared_groups=shared)
        qs = apply_fn(p, b, qcfg, qs, JMode(act_phase=JPhase.estimate))[1]
        return qs, JB.build_bert_int_params(p, qcfg, qs)

    qstate, int_params = calibrate(params, cal)
    return qcfg, qstate, int_params


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_base_width_stays_within_jax_route_gaps(recipe):
    qd, shared_h = RECIPES[recipe]
    jcfg, tcfg = JB.BertConfig(**BASE), TB.BertConfig(**BASE)
    jp = jax.jit(lambda k: JB.init_bert_params(k, jcfg))(
        jax.random.PRNGKey(0))
    jq, js, jint = _jax_calibrated(jcfg, jp, qd, shared_h)
    jst, jplan, _ = JB.build_bert_engine(jp, jcfg, jq, js, int_params=jint)
    rng = np.random.RandomState(1)
    batch = {
        "input_ids": rng.randint(0, BASE["vocab_size"], (N_SEQ, SEQ)).astype(
            np.int32),
        "attention_mask": (np.arange(SEQ)[None, :]
                           < rng.randint(SEQ // 2, SEQ + 1, (N_SEQ, 1))
                           ).astype(np.float32),
        "token_type_ids": np.zeros((N_SEQ, SEQ), np.int32),
    }
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jax_routes(p, b, s, plan, ip):
        sim = JB.bert_apply(p, b, jcfg, jq, s, JMode())[0]
        gen = JB.bert_apply(p, b, jcfg, jq, s, JMode(), int_params=ip)[0]
        eng = JB.bert_engine_apply(p, b, jcfg, jq, s, jst, plan, ip,
                                   backend="xla")
        return {r: {k: o[k] for k in ("logits", "sequence_output")}
                for r, o in (("sim", sim), ("gen", gen), ("eng", eng))}

    want = _np(jax_routes(jp, jb, js, jplan, jint))
    tp = C.params_from_jax(_np(jp), device="cpu")
    ts = C.qstate_from_jax(_np(js), device="cpu")
    _, tq, _ = TC.calibrated_bert(tcfg, batch_size=2, seq=SEQ, seed=0,
                                  device="cpu", params=tp, quant_dict=qd,
                                  shared_h=shared_h)
    tst, tplan, tint = TB.build_bert_engine(tp, tcfg, tq, ts, device="cpu")
    with torch.no_grad():
        eng = TB.bert_engine_apply(tp, batch, tcfg, tq, ts, tst, tplan, tint,
                                   device="cpu")
        sim = TB.bert_apply(tp, batch, tcfg, tq, ts, QuantMode(),
                            device="cpu")[0]

    def gap(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    j = {r: want[r]["logits"] for r in want}
    eng_gap, eng_bound = gap(eng["logits"], j["eng"]), gap(j["gen"], j["eng"])
    sim_gap, sim_bound = gap(sim["logits"], j["sim"]), gap(j["sim"], j["gen"])
    # the last LayerNorm's payload in grid levels
    site = f"L{BASE['num_hidden_layers'] - 1}.ffn.ln.out"
    step = float(np.asarray(js[site]["qp"].delta))

    def levels(a, b):
        d = np.rint(np.abs(np.asarray(a) - np.asarray(b)) / step)
        return int(d.max()), int((d > 0).sum())

    ln_port = levels(eng["sequence_output"], want["eng"]["sequence_output"])
    ln_jax = levels(want["gen"]["sequence_output"],
                    want["eng"]["sequence_output"])
    print(f"{recipe} at H=768, 2 layers, seq {SEQ}, {N_SEQ} sequences, "
          f"logit scale {float(np.abs(j['eng']).max()):.4e}: engine gap "
          f"{eng_gap:.4e} (JAX generic vs engine {eng_bound:.4e}); "
          f"simulation gap {sim_gap:.4e} (JAX simulation vs generic "
          f"{sim_bound:.4e}); last LN payload, (max levels, elements off) "
          f"port engine vs JAX engine {ln_port}, JAX generic vs JAX engine "
          f"{ln_jax} of {want['eng']['sequence_output'].size}")
    assert np.isfinite(eng["logits"].numpy()).all()
    assert eng["logits"].shape == j["eng"].shape
    assert eng_gap <= eng_bound
    assert sim_gap <= sim_bound
    assert ln_port[0] <= ln_jax[0] and ln_port[1] <= ln_jax[1]
