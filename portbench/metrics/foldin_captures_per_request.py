"""Fold-in graphs captured per prediction request: the program's counter
``foldin_sweep.capture`` over the traced block, divided by its requests.
0 where the fold-in sweeps ran and none was captured (the CPU runs them
eagerly); nothing where the program counts no fold-in sweep.

The counters are read twice: when the harness loads this module
(``AT_LOAD``) and in ``read``.  The difference is the traced block's only
because ``run.run_cell`` loads a cell's readers right after the window and
right before ``traced_block``.  A harness that loaded them earlier would
count the window's captures too; ``test_portbench_program.py``'s
``test_captures_per_request_counts_the_traced_block_alone`` runs
``run_cell`` and fails then.  Once ``Trace`` keeps the block's counters
itself, this reader should read them there."""

from portbench import program

AT_LOAD = program.counts()


def read(trace):
    now = program.counts()
    if AT_LOAD is None or now is None or not trace.traced_calls:
        return None
    block = {k: n - AT_LOAD.get(k, 0) for k, n in now.items()}
    if not any(n for k, n in block.items() if k.startswith("foldin_sweep.")):
        return None
    return block.get("foldin_sweep.capture", 0) / trace.traced_calls
