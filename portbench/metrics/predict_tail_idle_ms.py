"""Device idle time of a prediction request's tail (ms): the device idle
while the program takes the scores to the host (``predict.scores``) and
ranks each document's labels (``predict.rank``), per traced request."""

from portbench import program


def read(trace):
    return program.idle_ms_per_call(trace, ("predict.scores", "predict.rank"))
