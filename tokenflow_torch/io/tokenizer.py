"""CLIP BPE tokenizer — self-contained re-implementation.

The port's own copy of ``tokenflow_tpu/io/tokenizer.py`` (same classes,
same ids), so the port imports nothing of the JAX package.

The reference uses ``transformers.CLIPTokenizer`` loaded from the checkpoint
(preprocess.py:53, run_tokenflow_pnp.py:51); this environment has no hub
access, so the byte-level BPE is implemented here directly against the
checkpoint's ``vocab.json`` + ``merges.txt`` (openai/CLIP tokenizer
semantics: lowercase, whitespace cleanup, byte encoder, ``</w>``
end-of-word, bos/eos wrapping, pad-to-77 with eos... CLIP pads with the
eos token for SD-2.x checkpoints and 0/eos depending on config; SD uses
max_length padding with the pad token = eos ("!")-independent; see
``pad_token_id`` below).

A deterministic :class:`HashTokenizer` fallback exists for weightless
smoke tests.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re


@functools.lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    """OpenAI CLIP byte<->unicode table (reversible byte-level encoding)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


import regex  # full unicode-category support, as in openai/CLIP

_PAT = regex.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    regex.IGNORECASE,
)


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """Byte-level BPE with CLIP conventions; API: __call__(text) -> ids
    padded to model_max_length (=77), matching what the reference feeds the
    text encoder (preprocess.py:151-160)."""

    model_max_length = 77

    def __init__(self, vocab_path: str, merges_path: str):
        with open(vocab_path) as f:
            self.encoder: dict[str, int] = json.load(f)
        if merges_path.endswith(".gz"):
            with gzip.open(merges_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
        else:
            with open(merges_path, encoding="utf-8") as f:
                merges = f.read().split("\n")
        # first line is a version header; drop empties
        merges = [m for m in merges[1:] if m and not m.startswith("#")]
        self.bpe_ranks = {
            tuple(m.split()): i for i, m in enumerate(merges)
        }
        self.byte_encoder = _bytes_to_unicode()
        self.cache: dict[str, str] = {}
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        # SD checkpoints pad with eos (tokenizer config pad "<|endoftext|>")
        self.pad_token_id = self.eos_token_id

    @classmethod
    def from_pretrained(cls, tokenizer_dir: str, config_pad: bool = False) -> "CLIPTokenizer":
        """The tokenizer of a checkpoint directory. ``config_pad``: pad with
        the ``pad_token`` its ``special_tokens_map.json`` names (SD-XL's
        ``tokenizer_2`` pads with "!"), else with eos."""
        tok = cls(
            os.path.join(tokenizer_dir, "vocab.json"),
            os.path.join(tokenizer_dir, "merges.txt"),
        )
        special = os.path.join(tokenizer_dir, "special_tokens_map.json")
        if config_pad and os.path.exists(special):
            with open(special) as f:
                pad = json.load(f).get("pad_token")
            if isinstance(pad, dict):
                pad = pad.get("content")
            if pad is not None:
                tok.pad_token_id = tok.encoder[pad]
        return tok

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        """Token ids WITHOUT special tokens."""
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: list[int] = []
        for token in regex.findall(_PAT, text):
            token = "".join(
                self.byte_encoder[b] for b in token.encode("utf-8")
            )
            ids.extend(
                self.encoder[t] for t in self._bpe(token).split(" ")
            )
        return ids

    def __call__(self, text: str, max_length: int | None = None) -> list[int]:
        """bos + tokens + eos, truncated and padded to max_length."""
        n = max_length or self.model_max_length
        ids = [self.bos_token_id] + self.encode(text)[: n - 2] + [
            self.eos_token_id
        ]
        ids += [self.pad_token_id] * (n - len(ids))
        return ids


class HashTokenizer:
    """Deterministic stand-in tokenizer for weightless smoke tests (hashes
    words into a small id range). NOT CLIP-compatible."""

    model_max_length = 77

    def __init__(self, vocab_size: int = 1000):
        self.vocab_size = vocab_size
        self.bos_token_id = 0
        self.eos_token_id = 1
        self.pad_token_id = 1

    def __call__(self, text: str, max_length: int | None = None) -> list[int]:
        n = max_length or self.model_max_length
        words = _whitespace_clean(text).lower().split(" ")
        ids = [
            2 + (hash(w) % (self.vocab_size - 2)) for w in words if w
        ][: n - 2]
        ids = [self.bos_token_id] + ids + [self.eos_token_id]
        ids += [self.pad_token_id] * (n - len(ids))
        return ids
