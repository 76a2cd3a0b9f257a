"""What the program records of itself in a traced block: its spans and
its counters.

The port names every span it records ``lda/<name>``
(``lda_thesis_tpu_torch/utils/tracing.annotate``: a replay runner's call
``<layer>`` and its phase ``<layer>.eager`` / ``.capture`` / ``.replay``, a
prediction request's steps ``predict.prepare``, ``foldin.init``,
``foldin.sweeps``, ``predict.scores``, ``predict.rank``).  They are user
annotations on the host, so the traced block's ``Trace`` keeps them among
its host events, by name.  Its counters (``tracing.counts()``) count each
runner call's phase.  A checkout whose program records neither gives its
readers nothing to read: they return ``None``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from portbench.trace import _merge

PREFIX = "lda/"


def spans(trace) -> Dict[str, List[Tuple[int, int]]]:
    """Each program span's instances ``(start, end)`` in ns, by its name
    without ``lda/``."""
    out: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for name, start, end in trace.host:
        if name.startswith(PREFIX):
            out[name[len(PREFIX):]].append((start, end))
    return dict(out)


def idle_in(trace, names: Iterable[str]) -> Optional[float]:
    """Seconds in which the device ran nothing while one of the spans
    ``names`` was open: the union of their instances, clipped to the traced
    window, less the device's busy union (``trace.busy``).  ``None`` where
    none of them ran."""
    found = spans(trace)
    inst = [iv for n in names for iv in found.get(n, [])]
    if not inst:
        return None
    clipped = ((max(s, trace.start), min(e, trace.end)) for s, e in inst)
    union = _merge([(s, e) for s, e in clipped if e > s])
    covered = sum(e - s for s, e in union)
    busy, i = 0, 0
    for s, e in union:  # both lists sorted and disjoint
        while i < len(trace.busy) and trace.busy[i][1] <= s:
            i += 1
        j = i
        while j < len(trace.busy) and trace.busy[j][0] < e:
            busy += min(e, trace.busy[j][1]) - max(s, trace.busy[j][0])
            j += 1
    return (covered - busy) / 1e9


def idle_ms_per_call(trace, names: Iterable[str]) -> Optional[float]:
    """:func:`idle_in` per traced call, in ms."""
    idle = idle_in(trace, names) if trace.traced_calls else None
    return None if idle is None else 1e3 * idle / trace.traced_calls


def counts() -> Optional[Dict[str, int]]:
    """The program's counters now, or ``None`` where it keeps none."""
    from lda_thesis_tpu_torch.utils import tracing

    read = getattr(tracing, "counts", None)
    return None if read is None else read()
