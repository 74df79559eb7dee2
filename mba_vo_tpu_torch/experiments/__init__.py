"""Measurement harnesses of the port (each needs a CUDA device)."""
