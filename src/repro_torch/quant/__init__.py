"""Quantization helpers (the bitmap half of the NSD wire format)."""
