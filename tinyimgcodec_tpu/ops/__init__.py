"""Device (JAX/XLA) compute ops for the codec pipeline."""
