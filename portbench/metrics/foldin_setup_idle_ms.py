"""Device idle time of a prediction request's set-up (ms): the device
idle while the program prepares the request (``predict.prepare``: encoding
and the copies to the card), draws the fold-in's start (``foldin.init``)
or runs a fold-in sweep eagerly or captures its graph
(``foldin_sweep.eager``, ``foldin_sweep.capture``), per traced request."""

from portbench import program


def read(trace):
    return program.idle_ms_per_call(trace, ("predict.prepare", "foldin.init",
                                            "foldin_sweep.eager", "foldin_sweep.capture"))
