"""The port's training commands against the JAX CLI's, end to end on the
local Hugging Face checkpoint of ``tests/test_torch_cli.py``
(``--synthetic-data --task rte --max-seq-length 32``, the port on
``--device cpu``):

- ``train-quantized --recipe qat-w4a8`` (learned ranges, W4A8, both
  dropouts 0 through the recipe and the flags, the int8 QAT forward on by
  ``auto``) from one calibrated checkpoint (``--quant-model-path``, the
  recipe's calibration written by the port's ``validate-quantized``;
  ``tests/test_torch_cli.py`` holds the CLIs' calibrations against each
  other): JAX for three steps; the port for two with ``--save-every 1
  --save-total-limit 1``, then ``--resume --max-steps 3`` from its train
  state, which takes the third step alone;
- ``train-baseline --max-steps 2`` at dropout 0;
- ``train-quantized --recipe qat-w4a8 --max-steps 2`` on the tiny ALBERT
  and RoBERTa (``--tiny-model``, the port alone): the int8 QAT forward on
  the family's sites and the evaluation on the W4A8 engine.

Each CLI runs each configuration once, in a module fixture; JAX's train
step is jitted without XLA's backend optimizations, as
``tests/test_torch_qat.py`` runs it (the bound there is for that program).

Tolerances: every step's loss within rtol 1e-5 of JAX's (the loss bound
of ``tests/test_torch_qat.py``); the final scores equal; pruning leaves
only the newest step checkpoint; the resumed run takes exactly the steps
after the saved one.
"""

import functools
import os

import jax
import numpy as np
import pytest

from test_torch_cli import COMMON, QUANT, run_cli, write_hf_bert
from transformer_quantization_tpu import cli as JCLI
from transformer_quantization_tpu.training import qat as JQAT
from transformer_quantization_tpu_torch import cli as TCLI
from transformer_quantization_tpu_torch.training import qat as TQAT

LOSS_RTOL = 1e-5
O0 = {"xla_backend_optimization_level": 0}
QAT = ["train-quantized", "--recipe", "qat-w4a8", "--hidden-dropout", "0",
       "--attn-dropout", "0", "--log-every", "1"] + QUANT
BASE = ["train-baseline", "--hidden-dropout", "0", "--attn-dropout", "0",
        "--batch-size", "8", "--max-steps", "2"]


def _recording(module, losses):
    """Wrap ``module.make_qat_train_step`` so each step's loss is appended
    to ``losses``; returns the real function."""
    real = module.make_qat_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def run(*args):
            out = step(*args)
            losses.append(float(np.asarray(out[-1])))
            return out
        return run
    module.make_qat_train_step = make
    return real


def _run(module, qat_module, argv, jit_o0=False):
    losses = []
    real = _recording(qat_module, losses)
    real_jit = jax.jit
    if jit_o0:
        jax.jit = functools.partial(real_jit, compiler_options=O0)
    try:
        final, _ = run_cli(module, argv)
    finally:
        qat_module.make_qat_train_step = real
        jax.jit = real_jit
    return final, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_train")
    hf = write_hf_bert(root / "hf")
    model = COMMON + ["--model-path", hf]
    port = ["--device", "cpu"]
    out = {}
    # the recipe's calibration by the port's CLI, saved as a checkpoint
    # that both packages' QAT starts from (--quant-model-path)
    run_cli(TCLI, ["validate-quantized", "--recipe", "qat-w4a8"] + QUANT
            + model + port + ["--output-dir", str(root / "cal")])
    qat = QAT + model + ["--quant-model-path",
                         str(root / "cal" / "checkpoint_rte")]
    out["jax", "qat"] = _run(JCLI, JQAT, qat + [
        "--max-steps", "3", "--output-dir", str(root / "jq")], jit_o0=True)
    out["jax", "base"] = _run(JCLI, JQAT, BASE + model + [
        "--output-dir", str(root / "jb")], jit_o0=True)
    td = root / "tq"
    save = ["--save-every", "1", "--save-total-limit", "1",
            "--output-dir", str(td)]
    out["torch", "qat"] = _run(TCLI, TQAT, qat + port + save + [
        "--max-steps", "2"])
    out["saved"] = sorted(os.listdir(td))
    out["torch", "resume"] = _run(TCLI, TQAT, qat + port + save + [
        "--max-steps", "3", "--resume"])
    out["resaved"] = sorted(os.listdir(td))
    out["torch", "base"] = _run(TCLI, TQAT, BASE + model + port + [
        "--output-dir", str(root / "tb")])
    return out


def test_qat_steps_match_jax(runs):
    """The port's two steps and its resumed third against JAX's three."""
    _, jl = runs["jax", "qat"]
    _, tl = runs["torch", "qat"]
    _, rl = runs["torch", "resume"]
    assert len(jl) == 3 and len(tl) == 2 and len(rl) == 1
    np.testing.assert_allclose(tl + rl, jl, rtol=LOSS_RTOL)


def test_qat_resume_scores_as_jax(runs):
    """The resumed run's final score (three steps, the third after a
    restore) equals JAX's uninterrupted run's."""
    assert runs["torch", "resume"][0] == runs["jax", "qat"][0]


def test_save_total_limit_prunes_step_checkpoints(runs):
    """``--save-every 1 --save-total-limit 1``: only the newest step
    checkpoint is left, beside the final checkpoint and the train state,
    also after the resumed run (which prunes the first run's)."""
    steps = [d for d in runs["saved"] if "_step" in d]
    assert steps == ["checkpoint_rte_step2"]
    assert "checkpoint_rte" in runs["saved"]
    assert any(d.startswith("train_state_rte") for d in runs["saved"])
    assert [d for d in runs["resaved"] if "_step" in d] == [
        "checkpoint_rte_step3"]


def test_baseline_steps_match_jax(runs):
    (jf, jl), (tf, tl) = runs["jax", "base"], runs["torch", "base"]
    assert len(jl) == len(tl) == 2
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tf == jf


@pytest.mark.parametrize("model,module,sites", [
    ("albert_base_v2", "albert", {"emb_proj", "shared.attn.q",
                                  "shared.ffn.dense", "classifier"}),
    ("roberta_base", "roberta", {"L0.attn.q", "L1.ffn.dense",
                                 "clf.dense"})])
def test_cli_trains_family_qat_w4a8(tmp_path, model, module, sites):
    """``train-quantized --recipe qat-w4a8 --max-steps 2`` on a tiny
    family beyond BERT (the port alone; ``tests/test_torch_family_train.py``
    holds the families' QAT step against JAX's): two finite losses on the
    int8 QAT forward, whose sites are the family's (ALBERT's shared
    layer's), and the evaluation on the W4A8 engine, every matmul of its
    plan packed int4. RoBERTa's one-row token-type table takes the
    synthetic pair encoder's examples (their types set to 0)."""
    import importlib

    fam_mod = importlib.import_module(
        f"transformer_quantization_tpu_torch.models.{module}")
    build_name = f"build_{module}_engine"
    losses, seen, plans = [], [], []
    real_step, real_build = (TQAT.make_qat_train_step,
                             getattr(fam_mod, build_name))

    def make(apply_fn, qcfg, qat, tx):
        seen.append(qat.int8_sites)
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

    TQAT.make_qat_train_step = make
    setattr(fam_mod, build_name, build)
    try:
        final = TCLI.main(["train-quantized", "--recipe", "qat-w4a8",
                           "--max-steps", "2", "--hidden-dropout", "0",
                           "--attn-dropout", "0", "--model-name", model,
                           "--tiny-model", "--engine", "auto", "--device",
                           "cpu", "--output-dir", str(tmp_path)]
                          + COMMON + QUANT)
    finally:
        TQAT.make_qat_train_step = real_step
        setattr(fam_mod, build_name, real_build)
    assert len(losses) == 2 and np.all(np.isfinite(losses)), losses
    assert len(seen) == 1 and sites <= seen[0]
    assert plans and all(all(f) for p in plans for f in p.w4)
    assert os.path.exists(tmp_path / "final_score.txt")
    assert np.isfinite(float(final))
