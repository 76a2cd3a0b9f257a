"""The port's LocalLDA text path against the JAX package's.

``lda_thesis_tpu_torch/data/lemmatizer.py`` and the LocalLDA functions of
``data/textproc.py`` are copies; LocalLDA's vocabulary depends on them, so
they must give the JAX package's tokens word for word: over the fixtures of
``tests/test_lemmatizer.py`` and a few hundred inflections generated from
stems, and over sentence splitting and ``prep_docs`` of mixed text.
"""

import itertools

import numpy as np
import pytest

from lda_thesis_tpu.data import lemmatizer as jlem
from lda_thesis_tpu.data import textproc as jtext
from lda_thesis_tpu_torch.data import lemmatizer as tlem
from lda_thesis_tpu_torch.data import textproc as ttext
from test_lemmatizer import NOUN_FIXTURE, VERB_FIXTURE

STEMS = ["look", "make", "hop", "hope", "stud", "appl", "watch", "pass", "agree",
         "echo", "model", "create", "increase", "run", "stop", "see", "focus",
         "estimate", "observe", "box", "class", "economy", "crisis", "analys",
         "matri", "wif", "tax", "trade", "price", "bond", "yield", "plan", "ship",
         "travel", "refer", "occur", "die", "tie", "lie", "free", "flee", "go"]
SUFFIXES = ["", "s", "es", "ies", "ed", "d", "ing", "ling", "ning", "ping",
            "ied", "ves", "ses", "xes", "ches", "ment"]


def _generated():
    return sorted({s + x for s, x in itertools.product(STEMS, SUFFIXES)})


def test_generated_list_is_large():
    assert len(_generated()) >= 400


@pytest.mark.parametrize("pos", ["v", "n"])
def test_lemmatize_equals_jax(pos):
    words = sorted(set(VERB_FIXTURE) | set(NOUN_FIXTURE)) + _generated()
    got = [tlem.lemmatize(w, pos) for w in words]
    want = [jlem.lemmatize(w, pos) for w in words]
    assert got == want
    fixture = VERB_FIXTURE if pos == "v" else NOUN_FIXTURE
    assert {w: tlem.lemmatize(w, pos) for w in fixture} == fixture


def test_class_interface_and_refusal():
    assert tlem.WordNetStyleLemmatizer().lemmatize("running") == "run"
    with pytest.raises(NotImplementedError):
        tlem.lemmatize("happy", pos="a")


TEXT = [
    "The models were estimated using observed data. Prices rose, bonds fell!",
    "Is trade-based growth hopping? Studies applied 3 methods - watching taxes.",
    "A B C", "", "Crises, analyses and matrices; women's wives' boxes...",
]


def test_split_sentences_equals_jax():
    for doc in TEXT:
        assert ttext.split_sentences(doc) == jtext.split_sentences(doc)


@pytest.mark.parametrize("kw", [{}, {"stem": True}, {"lemma": False}],
                         ids=["lemma", "stem", "raw"])
def test_prep_docs_equals_jax(kw):
    sentences = [s for d in TEXT for s in ttext.split_sentences(d)]
    assert ttext.prep_docs(sentences, **kw) == jtext.prep_docs(sentences, **kw)
    assert ttext.prep_doc(TEXT[0], **kw) == jtext.prep_doc(TEXT[0], **kw)


def test_prep_docs_on_a_planted_corpus_equals_jax():
    """Whole synthetic abstracts, as the LocalLDA CLI reads them."""
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus

    c = planted_corpus(5, n_train=30, n_test=0, V=200, n_labels=5, max_labels=2,
                       mean_types=10, max_types=20, words_per_label=10)
    rng = np.random.default_rng(0)
    docs = [" ".join(d) + rng.choice([".", "!", ", and", " - so"]) for d in c.train_docs]
    assert ttext.prep_docs(docs) == jtext.prep_docs(docs)
