"""Device time of one fold-in sweep (ms): the records launched inside each
call of ``ops/gibbs.FoldinSweep`` (its uniforms and the sweep: eager at a
request's first sweep, captured at its second, replayed after), averaged
over the sweeps of the traced block."""

# the program callable this reader needs wrapped in a profiler scope
SPANS = {"foldin_sweep": "lda_thesis_tpu_torch.ops.gibbs:FoldinSweep.__call__"}


def read(trace):
    per = trace.span_device_s("foldin_sweep")
    return 1e3 * sum(per) / len(per) if per else None
