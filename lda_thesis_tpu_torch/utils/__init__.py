"""Auxiliary subsystems of the port: configuration, checkpoint/resume, the
elastic training loop, and tracing/progress reporting (counterparts of
``lda_thesis_tpu/utils/``; the JAX package's persistent XLA compile cache has
none: the port's kernels build once into ``lda_thesis_tpu_torch/_build/``)."""
