"""CLIP byte-pair-encoding tokenizer (port of gagan_tpu/clip/tokenizer.py).

The BPE vocab ``bpe_simple_vocab_16e6.txt.gz`` is read from the path in
``GAGAN_CLIP_BPE``, as the JAX package reads it.  Without one the tokenizer
falls back to bytes: CLIP's vocab puts the 256 byte tokens and their 256
word-final ``</w>`` forms at ids 0..511 and ``<|startoftext|>`` /
``<|endoftext|>`` at 49406 / 49407, so encoding with no merges still gives
valid CLIP ids, in longer, unmerged sequences (``is_byte_fallback``, and a
warning on stderr).

Words are split with the stdlib ``re`` pattern of the JAX module's ASCII
branch and text is cleaned without ``ftfy``, so the port needs neither
``regex`` nor ``ftfy``; on English prompts the split equals that of CLIP's
``regex`` pattern (``\\p{L}`` / ``\\p{N}`` classes).
"""

from __future__ import annotations

import gzip
import html
import os
import re
import sys
from functools import lru_cache
from typing import List, Union

import numpy as np

# CLIP's word pattern with ASCII letter and digit classes.
WORD_PATTERN = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
                r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+")


@lru_cache()
def bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: str = None):
        bpe_path = bpe_path or os.environ.get("GAGAN_CLIP_BPE", "")
        self.is_byte_fallback = not (bpe_path and os.path.isfile(bpe_path))
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if self.is_byte_fallback:
            print("[gagan_tpu_torch.clip] WARNING: no BPE vocab "
                  "(set GAGAN_CLIP_BPE to bpe_simple_vocab_16e6.txt.gz); "
                  "using the byte-level fallback tokenizer: token ids are "
                  "valid CLIP ids but sequences are unmerged, embeddings "
                  "differ from real-CLIP tokenization", file=sys.stderr)
            merges = []
        else:
            with gzip.open(bpe_path) as f:
                merges = f.read().decode("utf-8").split("\n")
            merges = [tuple(m.split()) for m in merges[1: 49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(merge) for merge in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = dict(zip(vocab, range(len(vocab))))
        if self.is_byte_fallback:
            # The special tokens at their real-CLIP ids (512 byte tokens +
            # 48894 merges), so a converted text tower indexes the right rows.
            self.encoder["<|startoftext|>"] = 49406
            self.encoder["<|endoftext|>"] = 49407
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.pat = re.compile(WORD_PATTERN, re.IGNORECASE)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e10))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        word = " ".join(word)
        self.cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        bpe_tokens = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t]
                              for t in self.bpe(token).split(" "))
        return bpe_tokens


def tokenize(texts: Union[str, List[str]], tokenizer: SimpleTokenizer,
             context_length: int = 77) -> np.ndarray:
    """clip.tokenize: [N, context_length] int32 token ids, truncated with
    the end token kept."""
    if isinstance(texts, str):
        texts = [texts]
    sot = tokenizer.encoder["<|startoftext|>"]
    eot = tokenizer.encoder["<|endoftext|>"]
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [sot] + tokenizer.encode(text) + [eot]
        if len(tokens) > context_length:
            tokens = tokens[:context_length - 1] + [eot]
        result[i, : len(tokens)] = tokens
    return result
