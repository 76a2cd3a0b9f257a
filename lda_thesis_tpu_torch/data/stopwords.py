"""English stopword set for corpus preprocessing.

Copy of ``lda_thesis_tpu/data/stopwords.py``: gensim's ``STOPWORDS`` (the
Stone/Denis/Kwantes 2010 list), which the reference removes inside
``preprocess_documents`` (reference LabeledLDA.py:45).  The JAX package
builds it from scikit-learn's ``ENGLISH_STOP_WORDS`` plus gensim's
additions; this copy spells out all 337 words, so the set does not
depend on scikit-learn being installed.
"""

from __future__ import annotations

__all__ = ["STOPWORDS"]

STOPWORDS: frozenset = frozenset(
    """
    a about above across after afterwards again against all almost alone
    along already also although always am among amongst amoungst amount an
    and another any anyhow anyone anything anyway anywhere are around as at
    back be became because become becomes becoming been before beforehand
    behind being below beside besides between beyond bill both bottom but
    by call can cannot cant co con could couldnt cry de describe detail
    didn do doesn doing don done down due during each eg eight either
    eleven else elsewhere empty enough etc even ever every everyone
    everything everywhere except few fifteen fifty fill find fire first
    five for former formerly forty found four from front full further get
    give go had has hasnt have he hence her here hereafter hereby herein
    hereupon hers herself him himself his how however hundred i ie if in
    inc indeed interest into is it its itself just keep kg km last latter
    latterly least less ll ltd made make many may me meanwhile might mill
    mine more moreover most mostly move much must my myself name namely
    neither never nevertheless next nine no nobody none noone nor not
    nothing now nowhere of off often on once one only onto or other others
    otherwise our ours ourselves out over own part per perhaps please put
    quite rather re really regarding same say says see seem seemed seeming
    seems serious several she should show side since sincere six sixty so
    some somehow someone something sometime sometimes somewhere still such
    system take ten than that the their them themselves then thence there
    thereafter thereby therefore therein thereupon these they thick thin
    third this those though three through throughout thru thus to together
    too top toward towards twelve twenty two un under unless until up upon
    us used using various ve very via was we well were what whatever when
    whence whenever where whereafter whereas whereby wherein whereupon
    wherever whether which while whither who whoever whole whom whose why
    will with within without would yet you your yours yourself yourselves
    """.split()
)
