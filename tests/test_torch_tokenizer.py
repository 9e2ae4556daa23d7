"""The port's tokenizer against the JAX package's: the same ids and the same
detokenized text for every vocabulary type (SPM, byte-level BPE under each
tested ``pre`` kind, WPM, UGM, RWKV), on vocabularies built here.

The port's pre-tokenizer runs on ``re`` with classes built from
``unicodedata``; the JAX one on the ``regex`` package, whose Unicode tables
are newer. They differ only on code points that Python's ``unicodedata``
leaves unassigned (category Cn; ROADMAP §3), so the generated text excludes
category Cn (and the surrogates, Cs)."""
import importlib.util
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from fixtures import byte_vocab, ugm_vocab
from ik_llama_cpp_tpu.runtime import tokenizer as JT
from ik_llama_cpp_tpu_torch.runtime import tokenizer as TT

ROOT = Path(__file__).resolve().parent.parent

CORPUS = [
    "Hello world",
    "  leading spaces and trailing  ",
    "The quick brown fox jumps over the lazy dog.",
    "I'm sure they'll say we'd've DONE it; it's THEIR call, isn't it?",
    "múltiple ñ languages: café, naïve, Ångström, straße, Œuvre",
    "中文字符测试，日本語のテキスト、한국어 텍스트",
    "emoji 😀🎉👍🏽 and symbols ∑∫√π ≠ ≤ € £ ¥",
    "digits 1234567890 3.14159 1,000,000 007 2024-10-18",
    "mixed\twhitespace\n\nnew  lines\r\n\tand nbsp　ideographic",
    "code: def f(x): return x**2 + 1  # comment\n    if a != b: pass",
    "   \n\n   ",
    "a\x1cb\x1dc\x1ed\x1fe",
    "<|endoftext|> special <s> markers </s> inline",
    "",
]


def _pair(model, tokens, scores=None, types=None, merges=None, **kw):
    """The same vocabulary as a JAX and as a port Tokenizer."""
    def make(mod):
        return mod.Tokenizer(
            model=model, tokens=list(tokens),
            scores=None if scores is None else np.asarray(scores, np.float32),
            token_types=None if types is None else np.asarray(types, np.int32),
            merges=None if merges is None else list(merges), **kw)
    return make(JT), make(TT)


def _same(j, t, texts=CORPUS, **enc):
    for text in texts:
        a, b = j.encode(text, **enc), t.encode(text, **enc)
        assert a == b, (text, a, b)
        assert j.decode(a) == t.decode(b), text
        assert j.decode_bytes(a) == t.decode_bytes(b), text


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_spm_byte_vocab():
    tokens, scores, types = byte_vocab()
    j, t = _pair("llama", tokens, scores, types, bos_id=1, eos_id=2, unk_id=0)
    _same(j, t)
    _same(j, t, parse_special=False, add_bos=False)


def test_spm_chip_smoke_vocab_round_trips():
    """The synthetic vocabulary of chip_smoke.py's dense file (here at 3,000
    pieces): the JAX ids, and text that decodes back to itself."""
    cs = _chip_smoke()
    tokens, scores, types = cs.spm_vocab(3000)
    assert len(tokens) == len(set(tokens)) == 3000
    j, t = _pair("llama", tokens, scores, types, bos_id=1, eos_id=2, unk_id=0)
    texts = CORPUS + [cs.smoke_text(np.random.default_rng(s), 60) for s in range(3)]
    _same(j, t, texts)
    for text in texts[-3:]:
        ids = t.encode(text)
        assert ids[0] == 1 and t.decode(ids[1:]) == " " + text
        assert len(ids) < 2 * len(text.split())       # pieces merge


def _train_bpe(texts, n_merges):
    """Byte-level BPE merges learned greedily from ``texts`` (split on
    spaces): the base 256 byte symbols, then the most frequent pair, each
    round. Returns (tokens, merges)."""
    enc = JT._BYTE_ENC
    words = Counter("".join(enc[b] for b in w.encode("utf-8"))
                    for text in texts for w in text.split(" ") if w)
    seqs = {w: list(w) for w in words}
    tokens = [enc[b] for b in range(256)]
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, n in words.items():
            s = seqs[w]
            for a, b in zip(s, s[1:]):
                pairs[(a, b)] += n
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append(f"{a} {b}")
        tokens.append(a + b)
        for w in seqs:
            s, out, i = seqs[w], [], 0
            while i < len(s):
                if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            seqs[w] = out
    return tokens, merges


@pytest.fixture(scope="module")
def bpe_vocab():
    tokens, merges = _train_bpe(CORPUS * 3 + [" ".join(CORPUS)], 300)
    specials = ["<|endoftext|>", "<s>", "</s>"]
    types = [1] * len(tokens) + [3] * len(specials)
    return tokens + specials, types, merges


@pytest.mark.parametrize("pre", ["gpt2", "llama3", "qwen2", "falcon", "deepseek-llm"])
def test_bpe(bpe_vocab, pre):
    tokens, types, merges = bpe_vocab
    j, t = _pair("gpt2", tokens, None, types, merges, pre=pre, add_bos=False,
                 bos_id=len(tokens) - 2, eos_id=len(tokens) - 3)
    _same(j, t)
    _same(j, t, parse_special=False)


def test_wpm():
    words = ["hello", "world", "the", "quick", "brown", "fox", "is", "a", "test",
             "un", "##able", "caf", "e", "naive"]
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
    tokens += ["▁" + w for w in words] + ["ing", "ed", "s", "er"]
    tokens += ["▁" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789.,!?'-:;"]
    tokens += list("abcdefghijklmnopqrstuvwxyz0123456789")
    types = [3, 2, 3, 3] + [1] * (len(tokens) - 4)
    j, t = _pair("bert", tokens, None, types, unk_id=1, bos_id=2, eos_id=3,
                 add_bos=True, add_eos=True)
    _same(j, t)


def test_ugm():
    tokens, scores, types = ugm_vocab()
    j, t = _pair("t5", tokens, scores, types, unk_id=2, eos_id=1, add_bos=False,
                 add_eos=True, add_space_prefix=True)
    _same(j, t)


def test_rwkv():
    toks = ["\\x00", "a", "b", "ab", "abc", "\\n", "hel", "hello", " ",
            "\\x41\\x42", "\\t", "wor", "world", "\\xe4\\xb8\\xad", "\\xf0\\x9f"]
    j, t = _pair("rwkv", toks, add_bos=False)
    _same(j, t)


def test_tokenizer_from_gguf_metadata():
    tokens, scores, types = byte_vocab()
    md = {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
          "tokenizer.ggml.scores": np.asarray(scores, np.float32),
          "tokenizer.ggml.token_type": np.asarray(types, np.int32),
          "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
          "tokenizer.chat_template": "{{ messages }}"}
    j, t = JT.tokenizer_from_gguf(md), TT.tokenizer_from_gguf(md)
    for f in ("model", "bos_id", "eos_id", "unk_id", "add_bos", "add_eos",
              "add_space_prefix", "pre", "chat_template"):
        assert getattr(j, f) == getattr(t, f), f
    _same(j, t)


def test_white_space_is_the_unicode_property():
    """The port's \\s is the White_Space set: U+001C-U+001F are not in it,
    as in the JAX package's pre-tokenizer, though ``re``'s \\s takes them."""
    import re
    pat = re.compile(TT._to_re(r"\s"))
    for cp in range(0x110000):
        assert bool(pat.fullmatch(chr(cp))) == (chr(cp) in JT_WS), hex(cp)


JT_WS = {chr(c) for c in (0x9, 0xA, 0xB, 0xC, 0xD, 0x20, 0x85, 0xA0, 0x1680,
                          *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F,
                          0x205F, 0x3000)}


@settings(max_examples=300, deadline=None, database=None)
@given(kind=st.sampled_from(sorted(TT._PRE_EXPRS)),
       text=st.text(st.characters(exclude_categories=("Cs", "Cn")), max_size=40))
def test_pretokenizer_matches_jax(kind, text):
    assert TT._Pretok(kind)(text) == JT._Pretok(kind)(text)


@pytest.mark.parametrize("kind", sorted(TT._PRE_EXPRS))
def test_pretokenizer_corpus(kind):
    for text in CORPUS:
        assert TT._Pretok(kind)(text) == JT._Pretok(kind)(text), text
