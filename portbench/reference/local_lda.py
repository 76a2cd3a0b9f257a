"""Plain reference of LocalLDA's timed path (the thesis's ``LocalLDA.py``):
collapsed-Gibbs LDA over K free topics, each sentence a document, trained
by the merge-block sampler with its thinned saves.

Plain PyTorch, float32 with TF32 off; it imports nothing of the program.
LocalLDA's sampler is Labeled LDA's with every topic admissible at every
position, so the draw, the delta commit and the saves are those of
``reference/labeled_lda.py`` over K identity slots, all valid (slot a is
topic a).  It follows the program from a state the program reached (its
counts and its generator's state at a call's start) and draws the same
uniforms in the same order: one ``(M, U, D)`` block per merge block.
Before it is used, everything the program derived from the corpus is
checked against the corpus text itself (:func:`check_layout`): the
documents and their words, the vocabulary, the one bucket, the identity
slots and the padded topic axis.

Departures from ``LocalLDA.py``, the program's as well, so followed here:

* one draw per word type of a document, its f tokens moving together
  (``LocalLDA.py`` draws per token);
* the topic-word table is frozen for each merge block of M sweeps (the
  CLI's M = 1: one sweep) while the document's counts stay live, and one
  commit moves each type's tokens from its block-start to its block-end
  topic;
* the start draws one topic per type (the JAX package's init, not
  ``LocalLDA.py``'s per token); the reference starts from a recorded state,
  so it follows no init, and checks only that the start's counts are its
  z's;
* sentences split at ``! . ? , -`` (the JAX package's rule); the
  benchmark's text has no punctuation, so each abstract is one document,
  as the punctuation-stripped abstracts CSV gives;
* the slots are padded to a multiple of 8 (pad slots invalid) and the topic
  axis to a multiple of 128 (columns past K never drawn, zero in φ̂).
"""

from __future__ import annotations

import re
from collections import Counter
from typing import List, Sequence

import numpy as np
import torch

from portbench.reference.labeled_lda import Bucket, State, merge_block_size, recount

__all__ = ["Bucket", "State", "merge_block_size", "recount", "documents", "slots",
           "topic_axis", "check_layout", "plain_float32"]

SENTENCE_END = re.compile(r"[!.?,\-]")
SLOT_MULTIPLE = 8  # the slot axis's padding
TOPIC_MULTIPLE = 128  # the topic axis's padding


def documents(texts: Sequence[str]) -> List[List[str]]:
    """The documents of a corpus's texts: each text's sentences, each
    sentence's whitespace-separated words, and of those only the sentences
    with more than one distinct word (``LocalLDA.py:28``).  The benchmark's
    words are lowercase, longer than two letters, no stopword, and left as
    they are by lemmatising, so preprocessing keeps them whole."""
    out = []
    for text in texts:
        for sentence in SENTENCE_END.split(text):
            words = sentence.split()
            if len(set(words)) > 1:
                out.append(words)
    return out


def slots(K: int) -> int:
    """A document's slots: K rounded up to a multiple of 8."""
    return -(-K // SLOT_MULTIPLE) * SLOT_MULTIPLE


def topic_axis(K: int) -> int:
    """The topic axis Kp: K rounded up to a multiple of 128."""
    return -(-K // TOPIC_MULTIPLE) * TOPIC_MULTIPLE


def check_layout(buckets: Sequence[Bucket], words: Sequence[str], docs: Sequence[Sequence[str]],
                 K: int, Kp: int) -> None:
    """Raise ``ValueError`` unless the program's layout is the corpus's:
    one bucket that holds every document once with exactly its words'
    counts (``words[v]`` names id v), a vocabulary of exactly the corpus's
    words, identity slots (slot a is topic a and valid for a < K; pad slots
    invalid) and a topic axis of ``topic_axis(K)`` columns."""
    if len(buckets) != 1:
        raise ValueError(f"{len(buckets)} buckets, not LocalLDA's one")
    if sorted(words) != sorted({w for d in docs for w in d}):
        raise ValueError(f"a vocabulary of {len(words)} words unlike the corpus's "
                         f"{len({w for d in docs for w in d})}")
    if Kp != topic_axis(K):
        raise ValueError(f"a topic axis of {Kp} columns, not {topic_axis(K)} for K = {K}")
    b = buckets[0]
    A = slots(K)
    want_ids = np.where(np.arange(A) < K, np.arange(A), 0)
    want_valid = (np.arange(A) < K).astype(b.lab_valid.dtype)
    if b.lab_ids.shape != (len(docs), A) or (b.lab_ids != want_ids).any() \
            or (b.lab_valid != want_valid).any():
        raise ValueError(f"slots {b.lab_ids.shape} unlike the {A} identity slots of K = {K}")
    seen = np.zeros(len(docs), bool)
    for r, d in enumerate(b.doc_idx):
        if seen[d]:
            raise ValueError(f"document {d} is in the bucket twice")
        seen[d] = True
        live = b.tok_f[r] > 0
        got = Counter({words[v]: int(f) for v, f in zip(b.tok_v[r][live], b.tok_f[r][live])})
        if live.sum() != len(got) or got != Counter(docs[d]):
            raise ValueError(f"document {d}'s word counts differ from the corpus")
    if not seen.all():
        raise ValueError(f"{int((~seen).sum())} documents are in no bucket")


def plain_float32() -> None:
    """Keep the reference's float32 arithmetic plain: TF32 off for matrix
    products and cuDNN, before any draw is followed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
