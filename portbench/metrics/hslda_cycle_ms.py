"""Device time of one HSLDA cycle (ms): the records launched inside each
call of ``models/hslda.CycleStep`` (its noise and the replayed cycle
graph: the z-sweep, z̄, η, a and m, then β's Gamma draw), averaged over
the cycles of the traced block."""

# the program callable this reader needs wrapped in a profiler scope
SPANS = {"hslda_cycle": "lda_thesis_tpu_torch.models.hslda:CycleStep.__call__"}


def read(trace):
    per = trace.span_device_s("hslda_cycle")
    return 1e3 * sum(per) / len(per) if per else None
