"""The port's CLIP tokenizer (gagan_tpu_torch.clip.tokenizer: stdlib ``re``,
no ``ftfy``) against the JAX package's, which uses ``regex`` where it is
installed: the byte fallback, a BPE vocab, and the word split."""

import gzip

import numpy as np
import pytest
import regex

from gagan_tpu.clip import tokenizer as jtok
from gagan_tpu.utils.text_templates import imagenet_templates
from gagan_tpu_torch.clip import tokenizer as ttok

# CLIP's own word pattern, with Unicode letter / number classes.
CLIP_PATTERN = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
                r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+")

PROMPTS = ([t.format(c) for t in imagenet_templates for c in ("Photo", "Anime")]
           + ["Golden Car", "Real Person", "It's a 3-D   photo!", "&amp;x"])


def test_template_ids_match_jax_byte_fallback(monkeypatch):
    monkeypatch.delenv("GAGAN_CLIP_BPE", raising=False)
    t, j = ttok.SimpleTokenizer(), jtok.SimpleTokenizer()
    assert t.is_byte_fallback and j.is_byte_fallback
    got, want = ttok.tokenize(PROMPTS, t), jtok.tokenize(PROMPTS, j)
    assert got.dtype == np.int32 and got.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got, want)
    # Byte ids (0..511) between the pinned start / end ids.
    assert t.encoder["<|startoftext|>"] == 49406
    assert t.encoder["<|endoftext|>"] == 49407
    row = got[0][got[0] > 0]
    assert row[0] == 49406 and row[-1] == 49407 and row[1:-1].max() < 512
    assert t.encode("a b") == [t.encoder["a</w>"], t.encoder["b</w>"]]


def test_truncation_keeps_the_end_token():
    t = ttok.SimpleTokenizer()
    long = "word " * 100
    got = ttok.tokenize(long, t, context_length=16)
    np.testing.assert_array_equal(got, jtok.tokenize(long, jtok.SimpleTokenizer(),
                                                     context_length=16))
    assert got[0, -1] == 49407


@pytest.fixture()
def bpe_file(tmp_path):
    """A small merges file in the format of bpe_simple_vocab_16e6.txt.gz."""
    merges = ["#version: 0.2", "p h", "o t", "ph ot", "o</w>", "pho to</w>",
              "a n", "an i", "ani m", "e</w>", "m e</w>", "t h", "th e</w>",
              "o f</w>", "a </w>"]
    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges) + "\n")
    return str(path)


def test_bpe_path_matches_jax(bpe_file, monkeypatch):
    monkeypatch.setenv("GAGAN_CLIP_BPE", bpe_file)
    t, j = ttok.SimpleTokenizer(), jtok.SimpleTokenizer()
    assert not t.is_byte_fallback
    assert t.encoder == j.encoder and t.bpe_ranks == j.bpe_ranks
    for text in PROMPTS[:20] + ["photo of the anime", "animated photos"]:
        assert t.encode(text) == j.encode(text), text
    # The merges apply: "photo" is one token.
    assert len(t.encode("photo")) < len(t.encode("pxoto"))
    np.testing.assert_array_equal(ttok.tokenize(PROMPTS, t),
                                  jtok.tokenize(PROMPTS, j))


def test_re_pattern_splits_like_regex():
    pat = regex.compile(CLIP_PATTERN, regex.IGNORECASE)
    t = ttok.SimpleTokenizer()
    for text in PROMPTS:
        text = ttok.whitespace_clean(ttok.basic_clean(text)).lower()
        assert t.pat.findall(text) == pat.findall(text), text
