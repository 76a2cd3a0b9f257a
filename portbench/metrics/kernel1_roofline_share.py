"""Kernel 1's share of its roofline (%): the least time its launches could
take on the card (``work.kernel1_launch_bound_s`` of each bucket's launch
shape, at the published peaks) over the device time of its records
(``fused_block*``) in the traced block.  Every merge block launches it
once per bucket; where the records do not add up to that (the profiler
lost some), nothing is read."""

# the program callable this reader needs wrapped in a profiler scope
SPANS = {"merge_block": "lda_thesis_tpu_torch.ops.gibbs_fused:FusedBlocks.__call__"}


def read(trace):
    blocks = len(trace.span_times.get("merge_block", []))
    times = trace.records("fused_block")
    per_block = trace.work.get("launches_per_block")
    if not blocks or not times or per_block is None or len(times) != blocks * per_block:
        return None
    return 100.0 * blocks * trace.work["kernel1_bound_s_per_block"] / sum(times)
