"""Tokenizers.

Counterpart of the tokenizer half of ``transformer_quantization_tpu/
utils/data.py``: the special token ids, the deterministic word-hash
tokenizer that stands in offline, and :func:`load_tokenizer` (the native
WordPiece over a local ``vocab.txt``, else a local HF tokenizer, else the
stand-in), and the GLUE encoding and batching (:func:`encode_examples`,
:func:`trim_to_real_length`, :func:`batch_iterator`, whose
``np.random.RandomState`` shuffle gives the JAX package's batch order),
and :class:`HFTokenizerAdapter` over a local Hugging Face tokenizer
(loaded with ``local_files_only=True``: nothing is fetched).
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from transformer_quantization_tpu_torch.utils.glue import GlueTask

PAD_ID, UNK_ID, CLS_ID, SEP_ID = 0, 1, 2, 3


class SyntheticTokenizer:
    """Deterministic word-hash tokenizer for offline runs."""

    def __init__(self, vocab_size: int = 30522):
        self.vocab_size = vocab_size

    def _word_id(self, w: str) -> int:
        h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
        return 4 + h % (self.vocab_size - 4)

    def encode_pair(self, a: str, b: Optional[str], max_len: int):
        """(ids, type ids, mask) lists of ``max_len``: [CLS] a [SEP] (b
        [SEP]) over whitespace words, truncated and padded."""
        ids = [CLS_ID] + [self._word_id(w) for w in a.split()] + [SEP_ID]
        types = [0] * len(ids)
        if b is not None:
            bids = [self._word_id(w) for w in b.split()] + [SEP_ID]
            ids += bids
            types += [1] * len(bids)
        ids, types = ids[:max_len], types[:max_len]
        mask = [1] * len(ids)
        pad = max_len - len(ids)
        return (ids + [PAD_ID] * pad, types + [0] * pad, mask + [0] * pad)


def load_tokenizer(model_path: Optional[str], vocab_size: int = 30522):
    """Native WordPiece over a local vocab.txt when present, else a local
    HF tokenizer, else the synthetic stand-in (with a warning when
    ``model_path`` was given: real text through it scores near chance)."""
    if model_path:
        vocab = os.path.join(model_path, "vocab.txt")
        if os.path.exists(vocab):
            try:
                from transformer_quantization_tpu_torch.utils.native import (
                    WordPieceTokenizer,
                )

                return WordPieceTokenizer(vocab)
            except (RuntimeError, OSError):
                pass
        try:
            from transformers import AutoTokenizer

            return HFTokenizerAdapter(AutoTokenizer.from_pretrained(
                model_path, local_files_only=True))
        except Exception as e:  # any loader failure takes the stand-in
            logging.getLogger("tq_torch").warning(
                "no tokenizer loadable from %s (%s: %s) — falling back to "
                "the SYNTHETIC tokenizer; real-text evaluation scores will "
                "be meaningless", model_path, type(e).__name__, e)
    return SyntheticTokenizer(vocab_size)


class HFTokenizerAdapter:
    """A Hugging Face tokenizer behind :class:`SyntheticTokenizer`'s
    ``encode_pair``: truncated and padded to ``max_len``, token type ids
    zero where the tokenizer returns none."""

    def __init__(self, tok):
        self.tok = tok
        self.vocab_size = tok.vocab_size

    def encode_pair(self, a: str, b: Optional[str], max_len: int):
        enc = self.tok(a, b, truncation=True, max_length=max_len,
                       padding="max_length")
        types = enc.get("token_type_ids", [0] * max_len)
        return enc["input_ids"], types, enc["attention_mask"]


def encode_examples(tokenizer, task: GlueTask, examples: List[Dict],
                    max_len: int = 128) -> Dict[str, np.ndarray]:
    """Tokenize a split into fixed-shape arrays (+labels)."""
    ids, types, masks, labels = [], [], [], []
    k = task.sentence_keys
    for ex in examples:
        a = ex[k[0]]
        b = ex[k[1]] if len(k) > 1 else None
        i, t, m = tokenizer.encode_pair(a, b, max_len)
        ids.append(i)
        types.append(t)
        masks.append(m)
        labels.append(ex["label"])
    label_dtype = np.float32 if task.num_labels == 1 else np.int32
    return {
        "input_ids": np.asarray(ids, np.int32),
        "token_type_ids": np.asarray(types, np.int32),
        "attention_mask": np.asarray(masks, np.float32),
        "labels": np.asarray(labels, label_dtype),
    }


def trim_to_real_length(batch: Dict[str, np.ndarray],
                        multiple: int = 1) -> Dict[str, np.ndarray]:
    """Trim (B, T) arrays to the batch's longest real sequence.

    The reference's ``--est-ranges-no-pad`` tokenizes calibration batches
    with dynamic padding so PAD tokens never enter range estimation
    (transformer_click_options.py:405-410, main.py:504-510). Calibration
    here is eager, so per-batch shapes are fine; ``multiple`` optionally
    rounds the length up (e.g. to 8) to bound the shape count.
    """
    mask = batch.get("attention_mask")
    if mask is None:
        return batch
    t = int(np.max(np.sum(np.asarray(mask) > 0, axis=1)))
    t = max(1, -(-t // multiple) * multiple)
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = v[:, :t] if v.ndim == 2 and v.shape[1] == mask.shape[1] else v
    return out


def batch_iterator(arrays: Dict[str, np.ndarray], batch_size: int,
                   shuffle: bool = False, rng: Optional[np.random.RandomState]
                   = None, drop_last: bool = False,
                   pad_final: bool = False) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-size batches. ``pad_final`` repeats rows to fill the last batch
    and adds an ``example_mask`` so metrics can ignore the padding — keeps
    every step on one compiled shape."""
    n = len(arrays["input_ids"])
    idx = np.arange(n)
    if shuffle:
        (rng or np.random).shuffle(idx)
    for start in range(0, n, batch_size):
        take = idx[start:start + batch_size]
        if len(take) < batch_size:
            if drop_last:
                return
            if pad_final:
                pad = np.zeros(batch_size - len(take), np.int64)
                full = np.concatenate([take, pad])
                batch = {k: v[full] for k, v in arrays.items()}
                em = np.zeros(batch_size, np.float32)
                em[: len(take)] = 1.0
                batch["example_mask"] = em
                yield batch
                return
        batch = {k: v[take] for k, v in arrays.items()}
        batch["example_mask"] = np.ones(len(take), np.float32)
        yield batch
