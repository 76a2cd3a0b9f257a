"""Gibbs sampling ops and the hand-written CUDA kernel they launch."""
