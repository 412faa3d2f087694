"""Kernels and plain tensor ops of the port (edge codec, clamp, attention)."""
