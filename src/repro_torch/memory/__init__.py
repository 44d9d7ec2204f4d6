"""Residual memory: which codec (or remat) each dithered layer's saved
activation gets."""
