"""The training step's share of the card's float32 peak (%): the model's
counted operations of the window's calls (``work.llda_sweep_ops`` and its
saves, from the corpus's shapes) over the window's host-clock seconds and
the published 67 TFLOP/s."""

from portbench import peaks


def read(trace):
    ops = trace.work.get("ops_per_call")
    if not ops or not trace.calls:
        return None
    return 100.0 * ops * trace.calls / trace.wall_s / peaks.FP32_FLOP_PER_S
