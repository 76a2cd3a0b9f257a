"""Text preprocessing (host side, pure Python).

Copy of the gensim-compatible pipeline of ``lda_thesis_tpu/data/textproc.py``
(lowercase, strip tags/punctuation/whitespace/numerics, remove stopwords,
drop words shorter than 3 chars, Porter-stem), the path of Labeled LDA and
CascadeLDA (reference LabeledLDA.py:45, CascadeLDA.py:48).  Token for token
the same as the JAX package's, since the vocabulary depends on it.

LocalLDA's hand-rolled path (reference LocalLDA.py:133-156) is here too:
:func:`prep_doc` / :func:`prep_docs` (lowercase, strip non-word chars,
stopword + length > 2 filter, then the vendored lemmatiser or the Porter
stemmer) and :func:`split_sentences` (``! . ? , -``).
"""

from __future__ import annotations

import re
import string
from typing import Iterable, List, Sequence

from .porter import PorterStemmer
from .stopwords import STOPWORDS

__all__ = [
    "strip_tags",
    "strip_punctuation",
    "strip_numeric",
    "strip_multiple_whitespaces",
    "remove_stopwords",
    "strip_short",
    "stem_text",
    "preprocess_string",
    "preprocess_documents",
    "prep_doc",
    "split_sentences",
    "prep_docs",
]

_RE_TAGS = re.compile(r"<([^>]+)>")
_RE_PUNCT = re.compile(r"([%s])+" % re.escape(string.punctuation))
_RE_NUMERIC = re.compile(r"[0-9]+")
_RE_WHITESPACE = re.compile(r"(\s)+")
_RE_NONWORD = re.compile(r"[^\w\s]")
# LocalLDA sentence splitting (reference LocalLDA.py:154-156). The reference
# pattern '!|\.|\?|,|-|' has a trailing empty alternative which would split
# between every character; the intended separators are kept here.
_RE_SENTENCE = re.compile(r"[!.?,-]")

_STEMMER = PorterStemmer()


def strip_tags(s: str) -> str:
    return _RE_TAGS.sub(" ", s)


def strip_punctuation(s: str) -> str:
    return _RE_PUNCT.sub(" ", s)


def strip_numeric(s: str) -> str:
    return _RE_NUMERIC.sub("", s)


def strip_multiple_whitespaces(s: str) -> str:
    return _RE_WHITESPACE.sub(" ", s)


def remove_stopwords(s: str, stopwords: frozenset = STOPWORDS) -> str:
    return " ".join(w for w in s.split() if w not in stopwords)


def strip_short(s: str, minsize: int = 3) -> str:
    return " ".join(w for w in s.split() if len(w) >= minsize)


def stem_text(s: str) -> str:
    return " ".join(_STEMMER.stem(w) for w in s.lower().split())


def preprocess_string(s: str, stopwords: frozenset = STOPWORDS) -> List[str]:
    """gensim-compatible default filter chain -> list of stemmed tokens."""
    s = s.lower()
    s = strip_tags(s)
    s = strip_punctuation(s)
    s = strip_multiple_whitespaces(s)
    s = strip_numeric(s)
    s = remove_stopwords(s, stopwords)
    s = strip_short(s)
    s = stem_text(s)
    return s.split()


def preprocess_documents(
    docs: Iterable[str], stopwords: frozenset = STOPWORDS
) -> List[List[str]]:
    """Batch preprocessing: the native C++ pipeline (``runtime/textproc.cpp``,
    :mod:`.native`) where it builds and loads, token for token the same as
    :func:`preprocess_string`; otherwise, or with ``LDA_NO_NATIVE=1``, the
    pure-Python one.  :func:`.native.pipeline` says which runs."""
    docs = list(docs)
    from .native import preprocess_documents_native

    out = preprocess_documents_native(docs, stopwords)
    if out is not None:
        return out
    return [preprocess_string(d, stopwords) for d in docs]


# --------------------------------------------------------------------------
# LocalLDA path (reference LocalLDA.py:133-156)
# --------------------------------------------------------------------------

def prep_doc(
    doc: str,
    stem: bool = False,
    lemma: bool = True,
    stopwords: frozenset = STOPWORDS,
) -> List[str]:
    """LocalLDA per-document preprocessing (reference LocalLDA.py:137-151).

    ``stem=True`` Porter-stems; otherwise ``lemma=True`` (the reference
    default) lemmatises each token with the vendored WordNet-style
    lemmatiser (data/lemmatizer.py); ``stem=False, lemma=False`` leaves
    tokens raw.
    """
    doc = doc.lower()
    doc = _RE_NONWORD.sub("", doc)
    words = [w for w in doc.split() if w not in stopwords and len(w) > 2]
    if stem:
        return [_STEMMER.stem(w) for w in words]
    if lemma:
        from .lemmatizer import lemmatize

        return [lemmatize(w) for w in words]
    return words


def split_sentences(doc: str) -> List[str]:
    """Split a document into sentence-level pseudo-documents."""
    return _RE_SENTENCE.split(doc)


def prep_docs(
    docs: Sequence[str],
    stem: bool = False,
    lemma: bool = True,
    stopwords: frozenset = STOPWORDS,
) -> List[List[str]]:
    return [prep_doc(d, stem=stem, lemma=lemma, stopwords=stopwords) for d in docs]
