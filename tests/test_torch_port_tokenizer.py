"""The port's tokenizer and native data components on the CPU, against the
JAX package: ``train_bpe`` and the tokenizer CLI (the same ``bpe.json``),
the native C++ BPE encoder (``distributed_pipeline_tpu_torch/native``, the
port's own copy and build) against the JAX ``BPEVocab``'s Python path, the
native jsonl index against the non-blank lines, ``JsonlSeq2SeqDataset``
with and without ``DPT_NATIVE=0``, and the fallback when no compiler
builds the library."""

import json
import os
import random
import string
import sys
import warnings

import numpy as np
import pytest

from distributed_pipeline_tpu.data import tokenizer as jtok
from distributed_pipeline_tpu.data.dataset import \
    JsonlSeq2SeqDataset as JaxJsonlDataset
from distributed_pipeline_tpu_torch import native
from distributed_pipeline_tpu_torch.data import tokenizer as ptok
from distributed_pipeline_tpu_torch.data.dataset import JsonlSeq2SeqDataset

WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
         "pack", "my", "box", "with", "five", "dozen", "liquor", "jugs",
         "boxes", "were", "packed", "jumped"]


def _corpus(seed: int, n: int, oov: bool = False):
    """Seeded texts: corpus words, and with ``oov`` also random
    lower-case, accented and CJK words the vocabulary never saw."""
    rng = random.Random(seed)
    alphabet = string.ascii_lowercase + "éßü日本語"
    out = []
    for _ in range(n):
        words = [rng.choice(WORDS) for _ in range(rng.randrange(0, 12))]
        if oov:
            words += ["".join(rng.choice(alphabet)
                              for _ in range(rng.randrange(1, 8)))
                      for _ in range(rng.randrange(0, 3))]
            rng.shuffle(words)
        out.append(" ".join(words))
    return out


def _jax_python_ids(vocab, text):
    """The JAX ``BPEVocab``'s Python path, whatever its native state."""
    out = []
    for word in text.split():
        out.extend(vocab._id(s) for s in vocab._bpe_word(word))
    return out


@pytest.mark.parametrize("vocab_size,n", [(48, 40), (96, 60), (512, 200)],
                         ids=["budget", "mid", "freq-stop"])
def test_train_bpe_artifact_equals_jax(vocab_size, n):
    """The same merges and vocabulary on the same texts: a small budget
    reached, and a large one stopped by ``freq < 2``."""
    texts = _corpus(1, n, oov=True)
    got = ptok.train_bpe(texts, vocab_size)
    assert got == jtok.train_bpe(texts, vocab_size)
    assert json.dumps(got) == json.dumps(jtok.train_bpe(texts, vocab_size))
    if vocab_size == 512:
        assert len(got["vocab"]) < vocab_size - ptok.N_RESERVED


def test_train_bpe_refuses_a_vocab_inside_the_reserved_ids():
    for mod in (ptok, jtok):
        with pytest.raises(ValueError, match="reserved"):
            mod.train_bpe(["a b"], vocab_size=4)


def _write_corpus(path, rows, blanks=True):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
            if blanks:
                f.write("  \t\n")


def test_tokenizer_cli_writes_the_jax_bpe_json(tmp_path, monkeypatch,
                                               capsys):
    """``python -m distributed_pipeline_tpu_torch.data.tokenizer`` and the
    JAX CLI write the same ``bpe.json`` and print the same counts; the
    port's dataset then picks the artifact up."""
    texts = _corpus(2, 80, oov=True)
    rows = [{"src": s, "trg": t} for s, t in zip(texts, reversed(texts))]
    rows[3] = {"src": "only src", "tgt": "a tgt key"}
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
        _write_corpus(tmp_path / name / "train.jsonl", rows)
    got = ptok.main(["--data_dir", str(tmp_path / "port"),
                     "--vocab_size", "128"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    monkeypatch.setattr(sys, "argv", ["tokenizer", "--data_dir",
                                      str(tmp_path / "jax"),
                                      "--vocab_size", "128"])
    jtok.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (got["merges"], got["symbols"]) == (ref["merges"],
                                                ref["symbols"]) != (0, 0)
    assert (tmp_path / "port" / "bpe.json").read_text() == \
        (tmp_path / "jax" / "bpe.json").read_text()
    ds = JsonlSeq2SeqDataset(str(tmp_path / "port"), "train", seq_len=32,
                             vocab_size=128)
    assert ds.vocab._bpe is not None


def test_native_library_builds_from_the_ports_sources():
    """This machine has a C++ compiler: the port's own library builds into
    ``native/_build/``, named by its sources' hash, and loads."""
    lib = native.load_library()
    assert lib is not None
    path = native.build_library()
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(native.__file__), "_build")
    assert os.path.basename(path).startswith("libdpt_native_")


def test_native_ids_equal_the_jax_python_path():
    """The port's native encoder gives the JAX ``BPEVocab`` Python path's
    ids over seeded random text with OOV, accented and CJK words, repeated
    calls, a text larger than the id buffer, and Unicode whitespace."""
    art = jtok.train_bpe(_corpus(3, 60), vocab_size=96)
    port = ptok.BPEVocab(art, vocab_size=96)
    ref = jtok.BPEVocab(art, vocab_size=96)
    assert port._native is not None
    texts = _corpus(4, 300, oov=True) + [
        "", "   ", "a b c", "étude", "zzz qqq zzz",
        " ".join(["the quick brown fox"] * 2000)]
    for text in texts:
        assert port.encode(text) == _jax_python_ids(ref, text), repr(text)
    assert port.encode("zzz qqq zzz") == port.encode("zzz qqq zzz")


def test_python_path_equals_jax_without_native(monkeypatch):
    monkeypatch.setenv("DPT_NATIVE", "0")
    assert native.load_library() is None
    art = ptok.train_bpe(_corpus(5, 60), vocab_size=96)
    port = ptok.BPEVocab(art, vocab_size=96)
    ref = jtok.BPEVocab(art, vocab_size=96)
    assert port._native is None
    for text in _corpus(6, 100, oov=True):
        assert port.encode(text) == _jax_python_ids(ref, text)


def test_no_compiler_falls_back_with_one_warning(tmp_path, monkeypatch):
    """With no compiler the library is None after one warning, and the
    encoder serves the same ids in Python."""
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    art = ptok.train_bpe(_corpus(7, 60), vocab_size=96)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        vocab = ptok.BPEVocab(art, vocab_size=96)
        again = ptok.BPEVocab(art, vocab_size=96)
    assert len([w for w in caught if "native" in str(w.message)]) == 1
    assert vocab._native is None and again._native is None
    ref = jtok.BPEVocab(art, vocab_size=96)
    for text in _corpus(8, 50, oov=True):
        assert vocab.encode(text) == _jax_python_ids(ref, text)


def test_native_jsonl_index_lines_are_the_non_blank_lines(tmp_path):
    """Universal newlines, whitespace-only lines skipped, Unicode lines
    intact, a line longer than the buffer; an empty file has no lines."""
    rng = random.Random(9)
    lines = [json.dumps({"src": " ".join(rng.choice(WORDS)
                                         for _ in range(rng.randrange(30))),
                         "trg": "日本 über"}, ensure_ascii=False)
             for _ in range(50)]
    lines.append(json.dumps({"src": "x" * 10_000}))
    path = tmp_path / "c.jsonl"
    with open(path, "w", newline="") as f:
        for i, ln in enumerate(lines):
            f.write(ln + ("\r\n" if i % 3 == 0 else "\n"))
            if i % 4 == 0:
                f.write(" \t\r\n\n")
    with open(path) as f:
        want = [ln.rstrip("\n") for ln in f if ln.strip()]
    index = native.NativeJsonlIndex(str(path))
    assert len(index) == len(want) == len(lines)
    assert [index.line(i) for i in range(len(index))] == want
    with pytest.raises(IndexError):
        index.line(len(want))
    (tmp_path / "empty.jsonl").write_text("")
    assert len(native.NativeJsonlIndex(str(tmp_path / "empty.jsonl"))) == 0


def test_jsonl_dataset_items_equal_with_and_without_native(tmp_path,
                                                            monkeypatch):
    """Items on the native index and encoder, on the Python paths
    (``DPT_NATIVE=0``) and from the JAX dataset are equal, blank lines
    skipped on every path."""
    texts = _corpus(10, 30, oov=True)
    rows = [{"src": s, "trg": t} for s, t in zip(texts, texts[1:])]
    _write_corpus(tmp_path / "train.jsonl", rows)
    (tmp_path / "bpe.json").write_text(json.dumps(
        ptok.train_bpe(texts, vocab_size=128)))
    fast = JsonlSeq2SeqDataset(str(tmp_path), "train", seq_len=32,
                               vocab_size=128)
    assert fast._index is not None and fast.vocab._bpe._native is not None
    ref = JaxJsonlDataset(str(tmp_path), "train", seq_len=32,
                          vocab_size=128)
    monkeypatch.setenv("DPT_NATIVE", "0")
    slow = JsonlSeq2SeqDataset(str(tmp_path), "train", seq_len=32,
                               vocab_size=128)
    assert slow._index is None and slow.vocab._bpe._native is None
    assert len(fast) == len(slow) == len(ref) == len(rows)
    for i in range(len(rows)):
        for k in ("input_ids", "input_mask", "pad_mask"):
            np.testing.assert_array_equal(fast[i][k], slow[i][k])
            np.testing.assert_array_equal(fast[i][k], ref[i][k])
