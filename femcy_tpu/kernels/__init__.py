"""Hand-written GPU kernels (Pallas through Triton), each kept because it
beat XLA's compilation of the plain version end to end (PERF.md)."""
