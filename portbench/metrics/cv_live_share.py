"""Share of the topic-word table entries that the merge blocks read which
belong to live positions on valid slots (%): the program's counters
``merge_block.live_table_entries`` over ``merge_block.table_entries``
over the traced block.  The rest is the padding of short documents
(positions with f = 0) and pad slots, which the gather fetches all the
same.  Nothing where the program counts no table entries.

The counters are read as ``foldin_captures_per_request`` reads its own:
when the harness loads this module (``AT_LOAD``), right before the traced
block, and in ``read``."""

from portbench import program

AT_LOAD = program.counts()


def read(trace):
    now = program.counts()
    if AT_LOAD is None or now is None:
        return None
    block = {k: now.get(k, 0) - AT_LOAD.get(k, 0)
             for k in ("merge_block.table_entries", "merge_block.live_table_entries")}
    if block["merge_block.table_entries"] <= 0:
        return None
    return 100.0 * block["merge_block.live_table_entries"] / block["merge_block.table_entries"]
