"""Native byte-level BPE tokenizer (RoBERTa/GPT-2 file format).

The reference pulls RobertaTokenizerFast from the HuggingFace hub at model
load (src/caco/load_model.py:25) — a network dependency in the inference
hot path.  This is a self-contained implementation of the same standard
algorithm (byte-to-unicode remap, regex pre-tokenization, ranked merges)
that loads the user's local `vocab.json` + `merges.txt` — the files shipped
with every roberta-base download — so the framework runs fully offline.

`load_tokenizer` prefers a local HF snapshot/transformers cache when one
exists and otherwise builds this native tokenizer from files; behavior
matches RobertaTokenizerFast for the CACO usage surface: encode with
<s>/</s> specials, pad-to-max, truncation, batch_decode(skip_special_tokens).

A copy of cacophony_tpu/data/tokenizer.py, so that the port runs where JAX
is absent (importing anything under cacophony_tpu imports jax);
tests/test_torch_engine.py holds the two equal.
"""

from __future__ import annotations

import functools
import json
import os
import re
from typing import Dict, List, Sequence

import numpy as np

# GPT-2/RoBERTa pre-tokenization pattern (public, standard).  The `regex`
# module gives the exact \p{L}/\p{N} classes; the stdlib-`re` fallback
# approximates them ([^\W\d_] admits No/Nl characters like '²' as letters —
# a known, tiny divergence) and must list '_' in the punctuation class
# because \w contains it while \p{L}/\p{N} do not.
try:
    import regex as _regex

    _PRETOKEN_RE = _regex.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
        r"|\s+(?!\S)|\s+"
    )
except ImportError:  # pragma: no cover
    _PRETOKEN_RE = re.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+",
        re.UNICODE,
    )


@functools.lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte → printable-unicode map (the standard GPT-2 table)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    chars = printable[:]
    n = 0
    for b in range(256):
        if b not in printable:
            printable.append(b)
            chars.append(256 + n)
            n += 1
    return dict(zip(printable, (chr(c) for c in chars)))


class ByteLevelBPETokenizer:
    """Encode/decode with RoBERTa conventions.

    Special ids (reference roberta_text_model.py:59-61): bos=<s>=0,
    pad=<pad>=1, eos=</s>=2, unk=<unk>=3.
    """

    def __init__(self, vocab: Dict[str, int], merges: Sequence[tuple],
                 bos_token: str = "<s>", eos_token: str = "</s>",
                 pad_token: str = "<pad>", unk_token: str = "<unk>"):
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_map = _bytes_to_unicode()
        self.inv_byte_map = {v: k for k, v in self.byte_map.items()}
        self.bos_token_id = self.vocab[bos_token]
        self.eos_token_id = self.vocab[eos_token]
        self.pad_token_id = self.vocab[pad_token]
        self.unk_token_id = self.vocab.get(unk_token, 3)
        self.special_ids = {self.bos_token_id, self.eos_token_id, self.pad_token_id}
        self.vocab_size = len(self.vocab)
        self._bpe_cache: Dict[str, List[str]] = {}

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str) -> "ByteLevelBPETokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def from_dir(cls, path: str) -> "ByteLevelBPETokenizer":
        return cls.from_files(os.path.join(path, "vocab.json"),
                              os.path.join(path, "merges.txt"))

    # ----------------------------------------------------------- BPE core

    def _bpe(self, token: str) -> List[str]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        parts = list(token)
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 30))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._bpe_cache[token] = parts
        return parts

    def encode_text(self, text: str) -> List[int]:
        """Raw BPE ids, no specials."""
        out: List[int] = []
        for piece in _PRETOKEN_RE.findall(text):
            mapped = "".join(self.byte_map[b] for b in piece.encode("utf-8"))
            for sub in self._bpe(mapped):
                out.append(self.vocab.get(sub, self.unk_token_id))
        return out

    def decode_ids(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self.special_ids:
                continue
            toks.append(self.inv_vocab.get(i, ""))
        text = "".join(toks)
        data = bytes(self.inv_byte_map.get(c, ord(" ")) for c in text)
        return data.decode("utf-8", errors="replace")

    # ----------------------------------------- HF-compatible call surface

    def __call__(self, texts, padding: str = "max_length", truncation: bool = True,
                 max_length: int = 100, return_tensors: str = "np"):
        if isinstance(texts, str):
            texts = [texts]
        rows, masks = [], []
        for t in texts:
            ids = [self.bos_token_id] + self.encode_text(t) + [self.eos_token_id]
            if truncation and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_token_id]
            mask = [1] * len(ids)
            if padding == "max_length" and len(ids) < max_length:
                pad = max_length - len(ids)
                ids = ids + [self.pad_token_id] * pad
                mask = mask + [0] * pad
            rows.append(ids)
            masks.append(mask)
        if padding != "max_length":
            longest = max(len(r) for r in rows)
            rows = [r + [self.pad_token_id] * (longest - len(r)) for r in rows]
            masks = [m + [0] * (longest - len(m)) for m in masks]
        return {
            "input_ids": np.asarray(rows, np.int32),
            "attention_mask": np.asarray(masks, np.int32),
        }

    def batch_decode(self, ids_batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode_ids(np.asarray(row).tolist(), skip_special_tokens)
                for row in ids_batch]


def load_tokenizer(path_or_name: str = "roberta-base"):
    """Best-effort tokenizer resolution:

    1. a directory with vocab.json/merges.txt → native tokenizer
    2. transformers local cache (offline)
    3. transformers hub download (when the network is available)
    """
    if os.path.isdir(path_or_name) and os.path.exists(
        os.path.join(path_or_name, "vocab.json")
    ):
        return ByteLevelBPETokenizer.from_dir(path_or_name)
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(path_or_name)
    except Exception as e:
        raise FileNotFoundError(
            f"cannot resolve tokenizer {path_or_name!r}: no local vocab.json/"
            f"merges.txt directory and transformers failed ({e}). Pass a "
            "directory containing roberta-base's vocab.json + merges.txt."
        ) from e
