"""Dither telemetry (sparsity, bit-width, step size)."""
