"""What a traced block of whole calls shows: the device's busy time, the
device time of each span, and where the device sat idle.

The traced block runs under ``torch.profiler`` with CPU and CUDA activity.
The harness names each call ``portbench/call`` and each program layer it
wraps ``portbench/<span>`` (the spans that the cell's metric readers
name).  A device record (kernel, copy or fill) is tied to the host call that launched it by the profiler's
correlation id: the kernels of a replayed CUDA graph carry the id of its
``cudaGraphLaunch``.  A record belongs to a span where its launch lies in
the span.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

PREFIX = "portbench/"
TOP = 10  # entries of each breakdown list


def _merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """The records of one traced block, with what the metric readers need
    besides: ``work`` (the cell's counted work, from its model adapter),
    ``calls`` and ``wall_s`` (the window's calls and their host-clock
    seconds, without the profiler) and ``traced_calls``."""

    def __init__(self, events, work: dict, calls: int, wall_s: float):
        from torch.autograd import DeviceType

        self.work, self.calls, self.wall_s = work, calls, wall_s
        self.device: List[Tuple[str, int, int, int]] = []  # (name, start, end, correlation)
        self.host: List[Tuple[str, int, int]] = []  # (name, start, end)
        launch: Dict[int, int] = {}
        self.span_times: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        for e in events:
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    self.device.append((name, start, end, e.correlation_id()))
                continue
            if e.is_user_annotation() and name.startswith(PREFIX):
                self.span_times[name[len(PREFIX):]].append((start, end))
                continue
            self.host.append((name, start, end))
            if name.startswith("cuda") and e.correlation_id():
                launch[e.correlation_id()] = start
        self.launch = launch
        calls_t = sorted(self.span_times.get("call", []))
        self.traced_calls = len(calls_t)
        self.start = calls_t[0][0] if calls_t else 0
        self.end = calls_t[-1][1] if calls_t else 0
        self.busy = _merge([(s, e) for _, s, e, _ in self.device])

    @property
    def window_s(self) -> float:
        """Seconds from the first traced call's start to the last one's end."""
        return (self.end - self.start) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds in which some device record ran, within the window."""
        return sum(max(0, min(e, self.end) - max(s, self.start)) for s, e in self.busy) / 1e9

    def span_device_s(self, span: str) -> List[float]:
        """Device seconds of each instance of ``span``: the sum of the
        durations of the records launched inside it.  Empty where the span
        never ran or no record could be tied to its launch."""
        inst = sorted(self.span_times.get(span, []))
        if not inst:
            return []
        starts = [s for s, _ in inst]
        out = [0.0] * len(inst)
        tied = 0
        for _, s, e, corr in self.device:
            t = self.launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= inst[i][1]:
                out[i] += (e - s) / 1e9
                tied += 1
        return out if tied else []

    def records(self, kernel: str) -> List[float]:
        """Durations (s) of the device records whose name holds ``kernel``."""
        return [(e - s) / 1e9 for name, s, e, _ in self.device if kernel in name]

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the window summed by what the host was doing: the innermost
        host event open at the gap's middle."""
        by_op: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.device:
            by_op[name[:120]] += (e - s) / 1e9
        gaps, last = [], self.start
        for s, e in self.busy:
            if s > last:
                gaps.append((last, min(s, self.end)))
            last = max(last, e)
        if last < self.end:
            gaps.append((last, self.end))
        host = sorted(self.host, key=lambda h: h[1])
        host_starts = [h[1] for h in host]
        by_host: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            if e <= s:
                continue
            mid = (s + e) // 2
            i = bisect.bisect_right(host_starts, mid)
            label = "no host event"
            for j in range(i - 1, max(-1, i - 400), -1):
                name, hs, he = host[j]
                if he >= mid:
                    label = name[:120]
                    break
            by_host[label] += (e - s) / 1e9
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
