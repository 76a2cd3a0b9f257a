"""The port's corpus layer against the JAX package's, on the same inputs.

Stopwords, the Porter stemmer, the preprocessing pipeline (native C++ and
pure Python), ``load_corpus`` in both label modes and the seeded
``split_data`` must give exactly what the JAX package gives: the vocabulary,
the labelmap and every count tensor depend on them.  Also checks that the
synthetic-corpus CSV writer of ``chip_smoke.py`` produces words that the
pipeline leaves unchanged.
"""

import re
import shutil

import numpy as np
import pytest

import chip_smoke
from lda_thesis_tpu.data import corpus as jax_corpus
from lda_thesis_tpu.data import porter as jax_porter
from lda_thesis_tpu.data import textproc as jax_textproc
from lda_thesis_tpu.data.stopwords import STOPWORDS as JAX_STOPWORDS
from lda_thesis_tpu_torch.data import corpus, native, porter, textproc
from lda_thesis_tpu_torch.data.stopwords import STOPWORDS
from lda_thesis_tpu_torch.data.synthetic import jel_corpus, planted_corpus
from test_corpus import CSV
from test_native_textproc import EDGE_DOCS
from test_porter import VECTORS

SUFFIXES = ["ational", "tional", "enci", "anci", "izer", "abli", "alli", "entli",
            "eli", "ousli", "ization", "ation", "ator", "alism", "iveness",
            "fulness", "ousness", "aliti", "iviti", "biliti", "logi", "icate",
            "ative", "alize", "iciti", "ical", "ful", "ness", "al", "ance", "ence",
            "er", "ic", "able", "ible", "ant", "ement", "ment", "ent", "ion", "ou",
            "ism", "ate", "iti", "ous", "ive", "ize", "e", "ll", "ed", "ing", "s",
            "ies", "sses", "y", "eed", "at", "bl", "iz", ""]


def _words(n: int, seed: int):
    """Random stems of 1-8 letters with the suffixes the stemmer handles."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, rng.integers(1, 9))) + SUFFIXES[rng.integers(len(SUFFIXES))]
            for _ in range(n)]


def test_stopwords_equal_jax():
    assert STOPWORDS == JAX_STOPWORDS


def test_porter_vectors():
    stem = porter.PorterStemmer().stem
    bad = [(w, stem(w), want) for w, want in VECTORS
           if not stem(w) == jax_porter.stem(w) == want]
    assert not bad, f"(word, got, want): {bad}"


def test_porter_matches_jax_on_random_words():
    words = _words(3000, 0)
    assert [porter.stem(w) for w in words] == [jax_porter.stem(w) for w in words]
    assert porter.stem_text("Taxation POLICIES") == jax_porter.stem_text("Taxation POLICIES")


@pytest.mark.parametrize("i", range(len(EDGE_DOCS)))
def test_preprocess_string_matches_jax(i):
    doc = EDGE_DOCS[i]
    assert textproc.preprocess_string(doc) == jax_textproc.preprocess_string(doc)


def test_preprocess_documents_matches_jax():
    docs = EDGE_DOCS + [" ".join(_words(40, s)) for s in range(20)]
    assert textproc.preprocess_documents(docs) == jax_textproc.preprocess_documents(docs)


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent: no native build")
def test_native_matches_python():
    docs = EDGE_DOCS + [" ".join(_words(60, s)).upper() for s in range(20)]
    assert native.native_available()
    assert native.pipeline().startswith("native")
    got = native.preprocess_documents_native(docs, STOPWORDS)
    assert got == [textproc.preprocess_string(d) for d in docs]


def test_no_native_falls_back_to_python(monkeypatch):
    monkeypatch.setenv("LDA_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.preprocess_documents_native(EDGE_DOCS, STOPWORDS) is None
    assert native.pipeline() == "pure Python (LDA_NO_NATIVE is set)"
    assert textproc.preprocess_documents(EDGE_DOCS) == [
        jax_textproc.preprocess_string(d) for d in EDGE_DOCS]


@pytest.fixture
def csv_file(tmp_path):
    p = tmp_path / "corpus.csv"
    p.write_text(CSV)
    return str(p)


@pytest.mark.parametrize("d,mode", [(2, "truncate"), (3, "prefix"), (1, "truncate"),
                                    (3, "truncate"), (2, "prefix")])
def test_load_corpus_matches_jax(csv_file, d, mode):
    got = corpus.load_corpus(csv_file, d=d, mode=mode)
    want = jax_corpus.load_corpus(csv_file, d=d, mode=mode)
    assert (got.docs, got.labs, got.labelset) == (want.docs, want.labs, want.labelset)
    assert corpus.partition_label("E52", d) == jax_corpus.partition_label("E52", d)


def test_load_corpus_rejects_unknown_mode(csv_file):
    with pytest.raises(ValueError, match="unknown label mode"):
        corpus.load_corpus(csv_file, mode="bogus")


@pytest.mark.parametrize("seed", [0, 7, 123, None])
def test_split_data_matches_jax(seed):
    c = corpus.RawCorpus(docs=[[f"w{i}"] for i in range(57)],
                         labs=[[f"L{i % 5}"] for i in range(57)],
                         labelset=[f"L{i}" for i in range(5)])
    np.random.seed(11)  # the unseeded split draws from numpy's global stream
    got = corpus.split_data(c, seed=seed)
    np.random.seed(11)
    want = jax_corpus.split_data(jax_corpus.RawCorpus(c.docs, c.labs, c.labelset), seed=seed)
    for g, w in zip(got, want):
        assert (g.docs, g.labs, g.labelset) == (w.docs, w.labs, w.labelset)
    assert len(got[0]) == 51 and len(got[1]) == 6


def test_csv_words_survive_preprocessing():
    words = [chip_smoke.csv_word(v) for v in range(8969)]
    assert len(set(words)) == len(words)
    text = " ".join(words)
    assert textproc.preprocess_string(text) == words
    assert jax_textproc.preprocess_string(text) == words
    assert textproc.preprocess_documents([text]) == [words]


def test_csv_labels_are_jel_shaped():
    codes = [chip_smoke.csv_label(f"L{n:03d}") for n in range(391)]
    assert len(set(codes)) == 391
    assert all(len(c) == 3 and re.fullmatch(r"[A-Z]\d{2}", c) for c in codes)
    assert chip_smoke.csv_label("B23") == "B23"


@pytest.mark.parametrize("kind", ["planted", "jel"])
def test_csv_writer_round_trip(tmp_path, kind):
    small = dict(n_train=40, n_test=8, V=150, mean_types=10, max_types=25)
    if kind == "planted":
        c = planted_corpus(2, n_labels=12, max_labels=3, words_per_label=8, **small)
        mode, labs = "truncate", c.train_labs + c.test_labs
        want_labs = [[chip_smoke.csv_label(x) for x in lab] for lab in labs]
    else:
        c = jel_corpus(2, n_l2=30, n_l3=45, words_per_code=5, **small)
        mode, want_labs = "prefix", None
    path = str(tmp_path / "c.csv")
    chip_smoke.write_corpus_csv(path, c)
    got = corpus.load_corpus(path, d=3, mode=mode)
    docs = c.train_docs + c.test_docs
    assert got.docs == [[chip_smoke.csv_word(int(w[1:])) for w in doc] for doc in docs]
    if want_labs is None:
        # every leaf's ancestors are rebuilt, in the order load_corpus gives
        want_labs = [list(dict.fromkeys(p for x in lab if len(x) == 3
                                        for p in corpus.partition_label(x, 3)))
                     for lab in c.train_labs + c.test_labs]
        assert [sorted(x) for x in got.labs] == [sorted(x) for x in c.train_labs + c.test_labs]
    assert got.labs == want_labs
    want = jax_corpus.load_corpus(path, d=3, mode=mode)
    assert (got.docs, got.labs, got.labelset) == (want.docs, want.labs, want.labelset)
