"""Vendored WordNet-style lemmatiser (morphy rules, self-contained).

Copy of ``lda_thesis_tpu/data/lemmatizer.py``; the two must lemmatise every
word alike, since LocalLDA's vocabulary depends on it
(tests/test_torch_lemmatizer.py holds them to each other).

The reference's LocalLDA lemmatises every token with
``WordNetLemmatizer().lemmatize(word, pos='v')`` (LocalLDA.py:148) — the
WordNet *morphy* algorithm for **verbs**: exception-list lookup first, then
suffix detachment rules filtered by the WordNet lemma index.

This environment has no WordNet corpus (nltk's data is an optional
download), so this module vendors the same machinery self-contained:

* the morphy verb detachment rules (same table as WordNet's ``verb.sub``):
  s→'', ies→y, es→e, es→'', ed→e, ed→'', ing→e, ing→'',
* an irregular-verbs table drawn from WordNet's ``verb.exc`` (the frequent
  English forms),
* in place of the lemma-index membership check, standard English
  orthography heuristics to choose among rule outputs: undouble a final
  doubled consonant (hopping→hop), restore a silent 'e' after a
  consonant–single-vowel–consonant stem (making→make), keep -ss/-us words
  intact.

Documented deviation: morphy consults the real lemma index, so rare words
whose stem orthography breaks the heuristics can differ from nltk+WordNet;
the fixture test (tests/test_lemmatizer.py) pins behaviour on the common
vocabulary the LocalLDA pipeline actually sees.  The noun path (``pos='n'``)
is also provided for completeness.
"""

from __future__ import annotations

__all__ = ["lemmatize", "WordNetStyleLemmatizer"]

_VOWELS = set("aeiou")

# --- irregular verbs (WordNet verb.exc subset: frequent forms) -------------
_VERB_EXC = {
    "was": "be", "were": "be", "been": "be", "is": "be", "are": "be",
    "am": "be", "has": "have", "had": "have", "having": "have",
    "does": "do", "did": "do", "done": "do", "doing": "do",
    "went": "go", "gone": "go", "goes": "go", "going": "go",
    "said": "say", "says": "say", "made": "make", "ran": "run",
    "running": "run", "run": "run", "came": "come", "coming": "come",
    "took": "take", "taken": "take", "got": "get", "gotten": "get",
    "getting": "get", "gave": "give", "given": "give", "giving": "give",
    "found": "find", "thought": "think", "told": "tell", "became": "become",
    "showed": "show", "shown": "show", "left": "leave", "felt": "feel",
    "put": "put", "putting": "put", "brought": "bring", "began": "begin",
    "begun": "begin", "beginning": "begin", "kept": "keep", "held": "hold",
    "wrote": "write", "written": "write", "writing": "write",
    "stood": "stand", "heard": "hear", "let": "let", "letting": "let",
    "meant": "mean", "set": "set", "setting": "set", "met": "meet",
    "paid": "pay", "sat": "sit", "sitting": "sit", "spoke": "speak",
    "spoken": "speak", "lay": "lie", "led": "lead", "grew": "grow",
    "grown": "grow", "lost": "lose", "fell": "fall", "fallen": "fall",
    "sent": "send", "built": "build", "understood": "understand",
    "drew": "draw", "drawn": "draw", "broke": "break", "broken": "break",
    "spent": "spend", "cut": "cut", "cutting": "cut", "rose": "rise",
    "risen": "rise", "drove": "drive", "driven": "drive",
    "bought": "buy", "wore": "wear", "worn": "wear", "chose": "choose",
    "chosen": "choose", "sought": "seek", "threw": "throw",
    "thrown": "throw", "caught": "catch", "dealt": "deal", "won": "win",
    "winning": "win", "forgot": "forget", "forgotten": "forget",
    "lain": "lie", "lying": "lie", "laid": "lay", "sold": "sell",
    "flew": "fly", "flown": "fly", "hit": "hit", "hitting": "hit",
    "swam": "swim", "swum": "swim", "swimming": "swim",
    "knew": "know", "known": "know", "saw": "see", "seen": "see",
    "slept": "sleep", "taught": "teach", "arose": "arise",
    "arisen": "arise", "underlay": "underlie", "underlying": "underlie",
    "being": "be",
    # frequent stems whose silent-e restoration the orthography heuristics
    # cannot decide (the real morphy resolves these via the lemma index)
    "creating": "create", "created": "create",
    "increasing": "increase", "increased": "increase",
    "decreasing": "decrease", "decreased": "decrease",
    "releasing": "release", "released": "release",
    "pleasing": "please", "pleased": "please",
    "requiring": "require", "required": "require",
    "combining": "combine", "combined": "combine",
    "examining": "examine", "examined": "examine",
    "determining": "determine", "determined": "determine",
}

# --- irregular nouns (WordNet noun.exc subset) ------------------------------
_NOUN_EXC = {
    "children": "child", "feet": "foot", "geese": "goose", "lice": "louse",
    "men": "man", "mice": "mouse", "teeth": "tooth", "women": "woman",
    "oxen": "ox", "criteria": "criterion", "phenomena": "phenomenon",
    "data": "datum", "analyses": "analysis", "axes": "axis",
    "bases": "basis", "crises": "crisis", "hypotheses": "hypothesis",
    "theses": "thesis", "matrices": "matrix", "indices": "index",
    "appendices": "appendix", "vertices": "vertex", "media": "medium",
    "curricula": "curriculum", "strata": "stratum", "alumni": "alumnus",
    "stimuli": "stimulus", "nuclei": "nucleus", "radii": "radius",
    "foci": "focus", "fungi": "fungus", "corpora": "corpus",
    "genera": "genus", "series": "series", "species": "species",
    "wives": "wife", "lives": "life", "knives": "knife", "leaves": "leaf",
    "halves": "half", "shelves": "shelf", "selves": "self",
    "wolves": "wolf", "calves": "calf", "loaves": "loaf", "thieves": "thief",
}


def _undouble(base: str) -> str:
    """hopping -> hop: undo consonant doubling before -ing/-ed."""
    if (
        len(base) >= 3
        and base[-1] == base[-2]
        and base[-1] not in _VOWELS
        and base[-1] not in "lsz"  # tell/press/buzz keep the double letter
    ):
        return base[:-1]
    return base


def _vowel_groups(s: str) -> int:
    n, prev = 0, False
    for ch in s:
        cur = ch in _VOWELS or ch == "y"
        if cur and not prev:
            n += 1
        prev = cur
    return n


# unstressed final syllables that do NOT take a silent e in polysyllables
# (model, limit, open, offer, reckon, develop, market, focus, ...)
_NO_E_ENDINGS = ("it", "el", "en", "er", "on", "om", "ol", "et", "op",
                 "an", "al", "us", "ow", "ic")


def _maybe_e(base: str) -> str:
    """Restore the silent e dropped before -ed/-ing where English
    orthography implies one (mak -> make, estimat -> estimate,
    observ -> observe) — the real morphy decides via the WordNet index;
    these rules are pinned by tests/test_lemmatizer.py."""
    if len(base) < 2:
        return base
    # words never end in bare v/z/u -> the stem must have had an e
    if base[-1] in "vzu":
        return base + "e"
    cvc = (
        base[-1] not in _VOWELS
        and base[-1] not in "wxy"
        and base[-2] in _VOWELS
        and (len(base) == 2 or base[-3] not in _VOWELS)
    )
    if not cvc:
        return base
    if _vowel_groups(base) <= 1:
        return base + "e"  # monosyllables: mak -> make, not -> note, us -> use
    if base.endswith(_NO_E_ENDINGS):
        return base  # model, limit, open, develop, market, focus
    return base + "e"  # estimat -> estimate, provid -> provide, combin -> combine


def _verb_lemma(word: str) -> str:
    exc = _VERB_EXC.get(word)
    if exc is not None:
        return exc
    if word.endswith("ies") and len(word) > 4:
        return word[:-3] + "y"  # studies -> study
    if word.endswith(("ches", "shes", "sses", "xes", "zes", "oes")) and len(word) > 4:
        return word[:-2]  # watches -> watch, goes handled by exc anyway
    if word.endswith("s") and not word.endswith(("ss", "us", "is")):
        return word[:-1]  # takes -> take
    if word.endswith("ied") and len(word) > 4:
        return word[:-3] + "y"  # studied -> study
    if word.endswith("ed") and len(word) > 3:
        base = word[:-2]
        un = _undouble(base)
        if un != base:
            return un  # stopped -> stop
        if base.endswith("e"):
            return base + "e"  # agreed -> agree, freed -> free
        if base[-1] in _VOWELS and base[-1] != "u":
            return base  # echoed -> echo
        return _maybe_e(base)  # noted -> note, observed -> observe, asked -> ask
    if word.endswith("ing") and len(word) > 4:
        base = word[:-3]
        un = _undouble(base)
        if un != base:
            return un  # hopping -> hop
        return _maybe_e(base)  # making -> make, looking -> look
    return word


def _noun_lemma(word: str) -> str:
    exc = _NOUN_EXC.get(word)
    if exc is not None:
        return exc
    if word.endswith("ies") and len(word) > 4:
        return word[:-3] + "y"
    if word.endswith(("ches", "shes", "sses")):
        return word[:-2]
    if word.endswith(("xes", "zes", "ses")):
        return word[:-2]
    if word.endswith("men") and len(word) > 3:
        return word[:-3] + "man"
    if word.endswith("s") and not word.endswith(("ss", "us", "is")):
        return word[:-1]
    return word


def lemmatize(word: str, pos: str = "v") -> str:
    """Lemma of ``word``.  Default pos='v' mirrors the reference's call
    (LocalLDA.py:148: ``lm.lemmatize(word, pos='v')``)."""
    if pos == "v":
        exc = _VERB_EXC.get(word)
        if exc is not None:
            return exc
        return _verb_lemma(word) if len(word) > 2 else word
    if pos == "n":
        exc = _NOUN_EXC.get(word)
        if exc is not None:
            return exc
        return _noun_lemma(word) if len(word) > 2 else word
    raise NotImplementedError(f"pos={pos!r}: only 'v' and 'n' are implemented")


class WordNetStyleLemmatizer:
    """Drop-in for ``nltk.stem.WordNetLemmatizer`` (verb + noun paths)."""

    def lemmatize(self, word: str, pos: str = "v") -> str:
        return lemmatize(word, pos)
