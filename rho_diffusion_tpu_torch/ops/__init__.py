"""Tensor ops of the port: embeddings, activations, normalisation,
convolution, attention, and the hand-written kernels under ``kernels``."""
