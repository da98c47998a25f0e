"""The port's command line (``transformer_quantization_tpu_torch/cli.py``)
against the JAX CLI: the parsers, the recipes, and the validate commands
run end to end on one local Hugging Face checkpoint directory that the
test writes (2 layers, H = 64; ``config.json`` and ``model.safetensors``
under Hugging Face's BERT names, weights drawn with numpy from a seed), so
both CLIs load the same weights and head.

Each CLI run happens once, in a module fixture (``--synthetic-data --task
rte --max-seq-length 32``, the port on ``--device cpu``):
``validate-baseline``; ``validate-quantized --recipe w8a8 --engine off``
(simulation); the same checkpoint with the JAX ``--engine xla`` against
the port's ``--engine auto`` (the plain versions on the CPU); and
``--recipe w8a8-peg`` (simulation). The port's quantized runs calibrate
(current-minmax weight ranges in place of the recipes' MSE searches) and
save their checkpoints, which the JAX runs evaluate through
``--quant-model-path``: both CLIs then score the same ranges, and
``tests/test_torch_calibration.py`` holds the recipes' calibrations
against the JAX CLI's presets (the JAX CLI's eager calibration is most
of a run's time).

Tolerances: the metrics in ``eval_results_rte.txt`` and ``final_score.txt``
equal JAX's; the logits behind them within rtol 1e-3 / atol 2e-3 (the
engine bounds of ``tests/test_engine.py``). ``config.out`` has JAX's keys
plus ``device``; the parsers differ only in ``--device`` and in
``--engine``'s choices.
"""

import json
import os

import numpy as np
import pytest

from transformer_quantization_tpu import cli as JCLI
from transformer_quantization_tpu.training import trainer as JT
from transformer_quantization_tpu_torch import cli as TCLI
from transformer_quantization_tpu_torch.ops import engine as TENG
from transformer_quantization_tpu_torch.training import trainer as TT

RTOL, ATOL = 1e-3, 2e-3
HF = dict(vocab_size=512, hidden_size=48, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=96,
          max_position_embeddings=64, type_vocab_size=2)
COMMON = ["--synthetic-data", "--task", "rte", "--max-seq-length", "32",
          "--num-train-samples", "32", "--num-val-samples", "64",
          "--eval-batch-size", "64"]
# current-minmax weight ranges in place of the recipes' MSE searches:
# tests/test_torch_calibration.py holds those against JAX's, preset by
# preset; here the CLI's wiring is what is tested
QUANT = ["--weight-quant-method", "current_minmax"]
COMMANDS = ("train-baseline", "train-quantized", "validate-baseline",
            "validate-quantized")


def write_hf_bert(path, seed: int = 0, num_labels: int = 2) -> str:
    """A random ``BertForSequenceClassification`` checkpoint directory, the
    files ``save_pretrained`` writes without importing ``transformers``:
    ``config.json`` and ``model.safetensors`` with Hugging Face's names,
    normal(0, 0.02) kernels and tables, small random biases and LayerNorm
    affines, from ``np.random.RandomState(seed)``; and ``vocab.txt``."""
    from safetensors.numpy import save_file

    rng = np.random.RandomState(seed)
    H, I = HF["hidden_size"], HF["intermediate_size"]
    sd = {}

    def lin(name, n_out, n_in):
        sd[name + ".weight"] = rng.normal(0, 0.02, (n_out, n_in))
        sd[name + ".bias"] = rng.normal(0, 0.02, (n_out,))

    def ln(name):
        sd[name + ".weight"] = 1.0 + rng.normal(0, 0.05, (H,))
        sd[name + ".bias"] = rng.normal(0, 0.02, (H,))

    e = "bert.embeddings"
    for key, n in (("word", HF["vocab_size"]),
                   ("position", HF["max_position_embeddings"]),
                   ("token_type", HF["type_vocab_size"])):
        sd[f"{e}.{key}_embeddings.weight"] = rng.normal(0, 0.02, (n, H))
    ln(f"{e}.LayerNorm")
    for i in range(HF["num_hidden_layers"]):
        p = f"bert.encoder.layer.{i}"
        for k in ("query", "key", "value"):
            lin(f"{p}.attention.self.{k}", H, H)
        lin(f"{p}.attention.output.dense", H, H)
        ln(f"{p}.attention.output.LayerNorm")
        lin(f"{p}.intermediate.dense", I, H)
        lin(f"{p}.output.dense", H, I)
        ln(f"{p}.output.LayerNorm")
    lin("bert.pooler.dense", H, H)
    lin("classifier", num_labels, H)
    os.makedirs(path, exist_ok=True)
    save_file({k: v.astype(np.float32) for k, v in sd.items()},
              os.path.join(path, "model.safetensors"))
    cfg = dict(HF, model_type="bert",
               architectures=["BertForSequenceClassification"],
               hidden_act="gelu", layer_norm_eps=1e-12,
               hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
               id2label={str(i): f"LABEL_{i}" for i in range(num_labels)})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    # a WordPiece vocabulary over the synthetic examples' words
    # (``tok<i>``), read by both packages' native tokenizer
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words += [f"tok{i}" for i in range(HF["vocab_size"] - len(words))]
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(words) + "\n")
    return str(path)


def run_cli(module, argv, logits_of=None):
    """``module.main(argv)``; with ``logits_of`` (a trainer module), the
    logits every evaluation scored, recorded by wrapping its
    ``compute_metrics``."""
    seen = []
    real = logits_of.compute_metrics if logits_of is not None else None
    if logits_of is not None:
        def record(task, logits, labels):
            seen.append(np.asarray(logits))
            return real(task, logits, labels)
        logits_of.compute_metrics = record
    try:
        final = module.main(argv)
    finally:
        if logits_of is not None:
            logits_of.compute_metrics = real
    return final, seen


def read_results(out_dir) -> dict:
    with open(os.path.join(out_dir, "eval_results_rte.txt")) as f:
        metrics = dict(line.strip().split(" = ") for line in f)
    with open(os.path.join(out_dir, "final_score.txt")) as f:
        final = f.read().strip()
    with open(os.path.join(out_dir, "config.out")) as f:
        config = json.load(f)
    return dict(metrics=metrics, final=final, config=config)


# name -> (JAX argv, port argv); "{ckpt}" is the checkpoint the port's
# run of the named configuration saved (``--quant-model-path``)
W8A8 = ["validate-quantized", "--recipe", "w8a8"] + QUANT
PEG = ["validate-quantized", "--recipe", "w8a8-peg"] + QUANT
RUNS = {
    "baseline": (["validate-baseline"], ["validate-baseline"]),
    "w8a8": (W8A8 + ["--engine", "off", "--quant-model-path", "{ckpt}"],
             W8A8 + ["--engine", "off"]),
    "w8a8-engine": (W8A8 + ["--engine", "xla", "--quant-model-path",
                            "{ckpt}"],
                    W8A8 + ["--engine", "auto", "--quant-model-path",
                            "{ckpt}"]),
    "w8a8-peg": (PEG + ["--quant-model-path", "{ckpt}"], PEG),
}
CKPT_OF = {"w8a8": "w8a8", "w8a8-engine": "w8a8", "w8a8-peg": "w8a8-peg"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of :data:`RUNS`, the port's first (they write the
    checkpoints the JAX runs load)."""
    root = tmp_path_factory.mktemp("cli")
    hf = write_hf_bert(root / "hf")
    out = {}
    for pkg, module, trainer, extra in (
            ("torch", TCLI, TT, ["--device", "cpu"]), ("jax", JCLI, JT, [])):
        for name, argvs in RUNS.items():
            argv = argvs[0] if pkg == "jax" else argvs[1]
            d = str(root / f"{pkg}-{name}")
            ckpt = str(root / f"torch-{CKPT_OF.get(name, name)}" /
                       "checkpoint_rte")
            argv = [a.replace("{ckpt}", ckpt) for a in argv]
            calls, restore = _count(TENG, "encoder_engine")
            try:
                final, logits = run_cli(module, argv + COMMON + [
                    "--model-path", hf, "--output-dir", d] + extra, trainer)
            finally:
                restore()
            out[pkg, name] = dict(read_results(d), final_value=final,
                                  logits=logits, engine_calls=calls[0])
    return out


def _count(module, name):
    """Count the calls of ``module.name``; returns (count, restore)."""
    real, n = getattr(module, name), [0]

    def counted(*a, **k):
        n[0] += 1
        return real(*a, **k)
    setattr(module, name, counted)
    return n, lambda: setattr(module, name, real)


def _dests(parser, command):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {a.dest: (a.default, tuple(a.choices) if a.choices else None,
                     tuple(a.option_strings))
            for a in sub.choices[command]._actions if a.dest != "help"}


@pytest.mark.parametrize("command", COMMANDS)
def test_parser_surface_matches_jax(command):
    """Every dest, default, choice list and option string of JAX's
    parser; the port adds ``--device`` and changes ``--engine``'s
    choices, and nothing else."""
    j = _dests(JCLI.build_parser(), command)
    t = _dests(TCLI.build_parser(), command)
    assert set(t) - set(j) == {"device"}
    assert set(j) <= set(t)
    assert t["device"] == ("cuda", ("cuda", "cpu"), ("--device",))
    for dest, want in j.items():
        if dest == "engine":
            assert want[1] == ("off", "auto", "pallas", "xla")
            assert t[dest] == ("off", ("off", "auto", "kernels", "plain"),
                               want[2])
            continue
        assert t[dest] == want, dest
    parsed = vars(TCLI.build_parser().parse_args([command]))
    assert parsed["device"] == "cuda"


@pytest.mark.parametrize("recipe", ["w8a8", "w8a8-mixed", "w8a8-mixed-stsb",
                                    "w8a8-peg", "w4-adaround", "qat-w4a8"])
def test_apply_recipe_matches_jax(recipe):
    """``apply_recipe`` leaves the same ``vars(args)`` as JAX's for every
    recipe (on a train and a validate command; the STS-B variant of the
    mixed recipe through ``--task stsb``), an explicit flag winning; the
    port's ``RECIPES`` are read from its preset tables."""
    name = "w8a8-mixed" if recipe == "w8a8-mixed-stsb" else recipe
    task = ["--task", "stsb"] if recipe == "w8a8-mixed-stsb" else []
    for command in ("train-quantized", "validate-quantized"):
        for extra in ([], ["--n-bits", "6"]):
            argv = [command, "--recipe", name] + task + extra
            ja = JCLI.build_parser().parse_args(argv)
            ta = TCLI.build_parser().parse_args(argv)
            JCLI.apply_recipe(ja)
            TCLI.apply_recipe(ta)
            want = vars(ja)
            got = {k: v for k, v in vars(ta).items() if k != "device"}
            assert got == want, (argv, {k: (got[k], want[k]) for k in want
                                        if got[k] != want[k]})


@pytest.mark.parametrize("name", list(RUNS))
def test_validate_matches_jax(runs, name):
    """Equal metrics and final score; the evaluated logits within rtol
    1e-3 / atol 2e-3; ``config.out`` with JAX's keys plus ``device``."""
    j, t = runs["jax", name], runs["torch", name]
    assert t["metrics"] == j["metrics"]
    assert t["final"] == j["final"]
    assert t["final_value"] == j["final_value"]
    assert len(t["logits"]) == len(j["logits"]) == 1
    assert t["logits"][0].shape == j["logits"][0].shape
    np.testing.assert_allclose(t["logits"][0], j["logits"][0], rtol=RTOL,
                               atol=ATOL)
    assert set(t["config"]) == set(j["config"]) | {"device"}
    assert t["config"]["device"] == "cpu"


def test_engine_auto_runs_the_engine(runs):
    """``--engine auto`` on the CPU ran the engine (its plain versions) for
    each evaluated batch, from the checkpoint the simulation run saved."""
    assert runs["torch", "w8a8-engine"]["engine_calls"] == 1
    assert runs["torch", "w8a8"]["engine_calls"] == 0
    assert runs["torch", "w8a8-engine"]["config"]["engine"] == "auto"


def test_cli_refuses_what_is_not_ported(tmp_path):
    """A card that is absent, the pipeline (item 9) and the export (item
    6) raise before any work."""
    import torch

    base = ["validate-quantized", "--tiny-model"] + COMMON
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TCLI.main(base)
    with pytest.raises(NotImplementedError, match="item 9"):
        TCLI.main(base + ["--device", "cpu", "--pp-stages", "2"])
    with pytest.raises(NotImplementedError, match="item 6"):
        TCLI.main(base + ["--device", "cpu", "--export-dir",
                          str(tmp_path)])
