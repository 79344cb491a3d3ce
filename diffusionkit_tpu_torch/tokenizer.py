"""CLIP byte-pair-encoding tokenizer (host numpy).

A copy of the CLIP half of ``diffusionkit_tpu/tokenizer.py``; the T5 wrapper
waits for the FLUX / T5 slice. ``synthetic_clip_vocab`` builds the 49408-entry
character-level vocabulary that stands in for the real one when no tokenizer
files are on the machine.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import regex

from .utils import get_logger

logger = get_logger(__name__)

_CLIP_PATTERN = regex.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    regex.IGNORECASE,
)

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"


class CLIPTokenizer:
    """CLIP byte-pair-encoding tokenizer.

    Word-level BPE with ``</w>`` end-of-word markers; text is lowercased and
    whitespace-collapsed before the regex split.
    """

    def __init__(
        self,
        bpe_ranks: Dict[Tuple[str, str], int],
        vocab: Dict[str, int],
        pad_with_eos: bool = False,
        max_length: int = 77,
    ):
        self.bpe_ranks = bpe_ranks
        self.vocab = vocab
        self.pad_with_eos = pad_with_eos
        self.max_length = max_length
        self._cache: Dict[str, List[str]] = {BOS: [BOS], EOS: [EOS]}

    @classmethod
    def from_files(
        cls,
        vocab_path: Union[str, Path],
        merges_path: Union[str, Path],
        pad_with_eos: bool = False,
    ) -> "CLIPTokenizer":
        with open(vocab_path) as f:
            vocab = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # First line of merges.txt is a version header.
        merges = [
            tuple(line.split()) for line in lines[1:] if len(line.split()) == 2
        ]
        ranks = {pair: i for i, pair in enumerate(merges)}
        return cls(ranks, vocab, pad_with_eos=pad_with_eos)

    @property
    def bos_token(self) -> int:
        return self.vocab[BOS]

    @property
    def eos_token(self) -> int:
        return self.vocab[EOS]

    @property
    def pad_token(self) -> int:
        return self.eos_token if self.pad_with_eos else 0

    def bpe(self, word: str) -> List[str]:
        """Merge the characters of one word by ascending merge rank."""
        if word in self._cache:
            return self._cache[word]
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pairs = set(zip(parts, parts[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[word] = parts
        return parts

    def tokenize(
        self,
        text: Union[str, List[str]],
        prepend_bos: bool = True,
        append_eos: bool = True,
    ) -> List:
        """Tokenize one string -> List[int], or a list of strings -> a list
        of per-string token lists."""
        if isinstance(text, list):
            return [self.tokenize(t, prepend_bos, append_eos) for t in text]
        clean = regex.sub(r"\s+", " ", text.lower())
        words = regex.findall(_CLIP_PATTERN, clean)
        pieces = [p for w in words for p in self.bpe(w)]
        ids = [self.vocab[p] for p in pieces]
        budget = self.max_length - int(prepend_bos) - int(append_eos)
        if len(ids) > budget:
            logger.warning(
                "Token length %d exceeds %d; truncating.", len(ids), self.max_length
            )
            ids = ids[:budget]
        if prepend_bos:
            ids = [self.bos_token] + ids
        if append_eos:
            ids = ids + [self.eos_token]
        return ids


def synthetic_clip_vocab(size: int = 49408) -> Dict[str, int]:
    """Character-level vocabulary of the real CLIP vocabulary's size.

    Printable ASCII and space, each also in its ``</w>`` form, then BOS and
    EOS, then filler entries up to ``size``. With no merges every word
    tokenizes to its characters, so prompts give real token ids over the
    full embedding table.
    """
    vocab: Dict[str, int] = {}
    chars = [chr(c) for c in range(33, 127)] + [" "]
    for c in chars:
        vocab[c] = len(vocab)
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    vocab[BOS] = len(vocab)
    vocab[EOS] = len(vocab)
    i = 0
    while len(vocab) < size:
        vocab[f"<fill{i}>"] = len(vocab)
        i += 1
    return vocab


def tokenize_batch(
    tokenizer,
    text: str,
    negative_text: Optional[str] = None,
    pad_to_max_length: bool = True,
) -> np.ndarray:
    """Build the (1 or 2, L) int32 token batch: row 0 positive, row 1 negative.

    Row order matters for CFG: the denoiser splits batch halves as
    (text, negative). Padding token is 0 unless the tokenizer pads with EOS.
    """
    pad = tokenizer.pad_token
    rows = [list(tokenizer.tokenize(text))]
    if pad_to_max_length:
        rows[0].extend([pad] * (tokenizer.max_length - len(rows[0])))
    if negative_text is not None:
        rows.append(list(tokenizer.tokenize(negative_text)))
    width = max(len(r) for r in rows)
    rows = [r + [pad] * (width - len(r)) for r in rows]
    return np.asarray(rows, dtype=np.int32)
