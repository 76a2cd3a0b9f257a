"""Device time of one save (ms): the records launched inside each call of
``ops/gibbs.SaveStep`` (the replayed save graph: the current estimates and
the thinned means), averaged over the calls of the traced block."""

# the program callable this reader needs wrapped in a profiler scope
SPANS = {"save_step": "lda_thesis_tpu_torch.ops.gibbs:SaveStep.__call__"}


def read(trace):
    per = trace.span_device_s("save_step")
    return 1e3 * sum(per) / len(per) if per else None
