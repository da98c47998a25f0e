"""Tokenizers.

Counterpart of the tokenizer half of ``transformer_quantization_tpu/
utils/data.py``: the special token ids, the deterministic word-hash
tokenizer that stands in offline, and :func:`load_tokenizer` (the native
WordPiece over a local ``vocab.txt``, else a local HF tokenizer, else the
stand-in). The HF tokenizer adapter and the GLUE encoding and batching
(``encode_examples``, ``batch_iterator``, ``trim_to_real_length``) are
not yet ported (ROADMAP §1 item 8).
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

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

            AutoTokenizer.from_pretrained(model_path, local_files_only=True)
        except Exception as e:  # any loader failure takes the stand-in
            logging.getLogger("tq_torch").warning(
                "no tokenizer loadable from %s (%s: %s) — falling back to "
                "the SYNTHETIC tokenizer; real-text evaluation scores will "
                "be meaningless", model_path, type(e).__name__, e)
        else:
            raise NotImplementedError(
                f"{model_path} holds a HF tokenizer; the HF tokenizer "
                "adapter is not yet ported (ROADMAP §1 item 8)")
    return SyntheticTokenizer(vocab_size)
