"""Native (C++) component loader.

Counterpart of ``transformer_quantization_tpu/utils/native.py``: the port's
own ctypes binding of the repo's ``native/wordpiece.cpp`` (BERT basic
tokenization + greedy longest-match WordPiece behind a plain C ABI), read
where it stands and built on first use with ``g++`` into the port's build
directory (``utils/_native_build/``), keyed by the source's hash.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_native_build")


def _build(src_name: str, lib_name: str) -> Optional[str]:
    """Path of the shared library built from ``native/<src_name>``, built
    if absent; None when the source or ``g++`` is missing or the build
    fails. The library is written under a temporary name and renamed, so
    concurrent builders never load a half-written file."""
    src = os.path.join(NATIVE_DIR, src_name)
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{lib_name}.{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired):
        os.unlink(tmp)
        return None
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _wordpiece_lib():
    """The loaded library (built once a process), or None."""
    path = _build("wordpiece.cpp", "libwordpiece")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.wp_load.restype = ctypes.c_void_p
    lib.wp_load.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.wp_free.restype = None
    lib.wp_free.argtypes = [ctypes.c_void_p]
    lib.wp_vocab_size.restype = ctypes.c_int
    lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
    lib.wp_encode_pair.restype = ctypes.c_int
    lib.wp_encode_pair.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        i32p, i32p, i32p]
    lib.wp_encode_batch.restype = ctypes.c_int
    lib.wp_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        i32p, i32p, i32p]
    return lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class WordPieceTokenizer:
    """Native WordPiece tokenizer over a BERT ``vocab.txt``: the
    ``encode_pair`` contract of ``utils/data.py`` and the serving engine's
    tokenizer slot."""

    def __init__(self, vocab_path: str, lowercase: bool = True):
        lib = _wordpiece_lib()
        if lib is None:
            raise RuntimeError("native wordpiece library unavailable "
                               "(g++ build failed?)")
        self._lib = lib
        self._h = lib.wp_load(vocab_path.encode(), int(lowercase))
        if not self._h:
            raise FileNotFoundError(vocab_path)
        self.vocab_size = lib.wp_vocab_size(self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.wp_free(h)
            self._h = None

    def encode_pair(self, a: str, b: Optional[str], max_len: int):
        """(ids, type ids, mask) lists of ``max_len``: [CLS] a [SEP] (b
        [SEP]), truncated to ``max_len`` and padded."""
        ids = np.zeros(max_len, np.int32)
        types = np.zeros(max_len, np.int32)
        mask = np.zeros(max_len, np.int32)
        self._lib.wp_encode_pair(
            self._h, a.encode(), b.encode() if b else None, max_len,
            _i32p(ids), _i32p(types), _i32p(mask))
        return ids.tolist(), types.tolist(), mask.tolist()

    def encode_batch(self, pairs, max_len: int):
        """Batch-encode [(a, b|None), ...] in one native call -> (ids,
        type ids, mask) int32 arrays of shape (n, max_len)."""
        n = len(pairs)
        packed = "\x1e".join(
            a + ("\x1f" + b if b else "") for a, b in pairs).encode()
        ids = np.zeros((n, max_len), np.int32)
        types = np.zeros((n, max_len), np.int32)
        mask = np.zeros((n, max_len), np.int32)
        self._lib.wp_encode_batch(self._h, packed, n, max_len, _i32p(ids),
                                  _i32p(types), _i32p(mask))
        return ids, types, mask
