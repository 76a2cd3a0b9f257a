"""The benchmark of the port, ``lda_thesis_tpu_torch``, on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  The harness is driven by files found by name: ``configs/`` (each
configuration as it is run), ``traffic/`` (each mix's call and its
parameters), ``limits/`` (the limits of each cell's check), ``metrics/``
(one reader per per-layer metric, naming the program layers a traced run
wraps for it), ``models/`` (one adapter per model kind) and ``faults/``
(the faults planted under each model kind's calls, for the tests).  The yardstick
stays here, where changes to the program cannot move it: the corpus
generators (``corpus.py``), the counted operations and bytes (``work.py``),
the card's published peaks (``peaks.py``) and the plain references
(``reference/``) that decide ``correct``.  The harness imports neither JAX
nor the JAX package.
"""
