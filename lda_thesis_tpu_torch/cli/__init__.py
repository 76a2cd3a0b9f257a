"""Command-line drivers with reference-parity flags (counterparts of
``lda_thesis_tpu/cli/``), run on ``cuda`` unless ``--device cpu``."""
