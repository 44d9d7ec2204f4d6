"""Core: NSD quantization and the dithered dense/conv ops."""
