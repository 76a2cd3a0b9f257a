"""PyTorch/CUDA port of lda_thesis_tpu (Labeled LDA on an NVIDIA H100).

Mirrors the JAX package's layout (``data/``, ``ops/``, ``models/``,
``eval/``) and imports nothing of it.  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper runs its
plain PyTorch version.
"""
