"""Porter stemmer (Porter, 1980) — self-contained host-side implementation.

Copy of ``lda_thesis_tpu/data/porter.py``; the two must stem every word
alike, since the vocabulary depends on it.

The reference pipeline stems with gensim's Porter stemmer
(``gensim.parsing.preprocessing.preprocess_documents``, reference
LabeledLDA.py:45, CascadeLDA.py:48, HSLDA.py:78).  This framework has no gensim
dependency, so the algorithm is implemented here from the original paper
(M. Porter, "An algorithm for suffix stripping", Program 14(3), 1980), including
the two --DEPARTURE-- points of the author's ANSI-C release that gensim's port
also follows:

* step 2 maps ``abli -> able`` (paper: ``bli -> ble``)
* step 2 adds ``(m>0) logi -> log``

Words of length <= 2 are returned unchanged (same guard as the C release).
"""

from __future__ import annotations

__all__ = ["PorterStemmer", "stem", "stem_text"]


def _is_consonant(word: str, i: int) -> bool:
    ch = word[i]
    if ch in "aeiou":
        return False
    if ch == "y":
        return i == 0 or not _is_consonant(word, i - 1)
    return True


class PorterStemmer:
    """Stateless Porter stemmer; ``stem(word)`` expects a lowercase word."""

    # ------------------------------------------------------------------ utils

    @staticmethod
    def _measure(stem: str) -> int:
        """m in the [C](VC){m}[V] decomposition of ``stem``."""
        m = 0
        prev_vowel = False
        for i in range(len(stem)):
            cons = _is_consonant(stem, i)
            if cons and prev_vowel:
                m += 1
            prev_vowel = not cons
        return m

    @staticmethod
    def _has_vowel(stem: str) -> bool:
        return any(not _is_consonant(stem, i) for i in range(len(stem)))

    @staticmethod
    def _ends_double_consonant(stem: str) -> bool:
        return (
            len(stem) >= 2
            and stem[-1] == stem[-2]
            and _is_consonant(stem, len(stem) - 1)
        )

    @staticmethod
    def _ends_cvc(stem: str) -> bool:
        """*o — stem ends cvc where the final c is not w, x or y."""
        if len(stem) < 3:
            return False
        if not _is_consonant(stem, len(stem) - 3):
            return False
        if _is_consonant(stem, len(stem) - 2):
            return False
        if not _is_consonant(stem, len(stem) - 1):
            return False
        return stem[-1] not in "wxy"

    # ------------------------------------------------------------------ steps

    def _step1a(self, w: str) -> str:
        if w.endswith("sses"):
            return w[:-2]
        if w.endswith("ies"):
            return w[:-2]
        if w.endswith("ss"):
            return w
        if w.endswith("s"):
            return w[:-1]
        return w

    def _step1b(self, w: str) -> str:
        if w.endswith("eed"):
            if self._measure(w[:-3]) > 0:
                return w[:-1]
            return w
        fired = False
        if w.endswith("ed") and self._has_vowel(w[:-2]):
            w = w[:-2]
            fired = True
        elif w.endswith("ing") and self._has_vowel(w[:-3]):
            w = w[:-3]
            fired = True
        if fired:
            if w.endswith(("at", "bl", "iz")):
                return w + "e"
            if self._ends_double_consonant(w) and w[-1] not in "lsz":
                return w[:-1]
            if self._measure(w) == 1 and self._ends_cvc(w):
                return w + "e"
        return w

    def _step1c(self, w: str) -> str:
        if w.endswith("y") and self._has_vowel(w[:-1]):
            return w[:-1] + "i"
        return w

    _STEP2 = (
        ("ational", "ate"),
        ("tional", "tion"),
        ("enci", "ence"),
        ("anci", "ance"),
        ("izer", "ize"),
        ("abli", "able"),  # DEPARTURE (paper: bli -> ble)
        ("alli", "al"),
        ("entli", "ent"),
        ("eli", "e"),
        ("ousli", "ous"),
        ("ization", "ize"),
        ("ation", "ate"),
        ("ator", "ate"),
        ("alism", "al"),
        ("iveness", "ive"),
        ("fulness", "ful"),
        ("ousness", "ous"),
        ("aliti", "al"),
        ("iviti", "ive"),
        ("biliti", "ble"),
        ("logi", "log"),  # DEPARTURE (added in the C release)
    )

    _STEP3 = (
        ("icate", "ic"),
        ("ative", ""),
        ("alize", "al"),
        ("iciti", "ic"),
        ("ical", "ic"),
        ("ful", ""),
        ("ness", ""),
    )

    _STEP4 = (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    )

    def _map_suffix(self, w: str, rules, min_m: int) -> str:
        for suf, rep in rules:
            if w.endswith(suf):
                stem = w[: len(w) - len(suf)]
                if self._measure(stem) > min_m:
                    return stem + rep
                return w
        return w

    def _step2(self, w: str) -> str:
        return self._map_suffix(w, self._STEP2, 0)

    def _step3(self, w: str) -> str:
        return self._map_suffix(w, self._STEP3, 0)

    def _step4(self, w: str) -> str:
        for suf in self._STEP4:
            if w.endswith(suf):
                stem = w[: len(w) - len(suf)]
                if self._measure(stem) > 1:
                    if suf == "ion" and (not stem or stem[-1] not in "st"):
                        return w
                    return stem
                return w
        return w

    def _step5a(self, w: str) -> str:
        if w.endswith("e"):
            stem = w[:-1]
            m = self._measure(stem)
            if m > 1 or (m == 1 and not self._ends_cvc(stem)):
                return stem
        return w

    def _step5b(self, w: str) -> str:
        if (
            w.endswith("ll")
            and self._measure(w) > 1
        ):
            return w[:-1]
        return w

    # ------------------------------------------------------------------ API

    def stem(self, word: str) -> str:
        if len(word) <= 2:
            return word
        w = word
        w = self._step1a(w)
        w = self._step1b(w)
        w = self._step1c(w)
        w = self._step2(w)
        w = self._step3(w)
        w = self._step4(w)
        w = self._step5a(w)
        w = self._step5b(w)
        return w


_STEMMER = PorterStemmer()


def stem(word: str) -> str:
    """Stem a single lowercase word."""
    return _STEMMER.stem(word)


def stem_text(text: str) -> str:
    """Lowercase ``text`` and stem each whitespace-separated token."""
    return " ".join(_STEMMER.stem(w) for w in text.lower().split())
