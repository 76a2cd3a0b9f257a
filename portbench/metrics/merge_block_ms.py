"""Device time of one merge block (ms): the records launched inside each
call of ``ops/gibbs_fused.FusedBlocks`` (its uniforms and the replayed
block graph: the gather, the slot pick, kernel 1 and the delta scatter),
averaged over the calls of the traced block."""

# the program callable this reader needs wrapped in a profiler scope
SPANS = {"merge_block": "lda_thesis_tpu_torch.ops.gibbs_fused:FusedBlocks.__call__"}


def read(trace):
    per = trace.span_device_s("merge_block")
    return 1e3 * sum(per) / len(per) if per else None
