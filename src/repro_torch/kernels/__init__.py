"""Hand-written CUDA kernels of the dithered backward, their plain
versions, and the ops that chain them."""
