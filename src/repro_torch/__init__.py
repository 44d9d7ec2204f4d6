"""PyTorch/CUDA port of the dithered-backprop system, beside the JAX
reference package ``repro``.

The layout mirrors ``repro`` (``core``, ``kernels``, ``quant``, ``models``,
...) so each module's counterpart is found at the same relative path. The
port imports ``torch`` and never ``jax`` or ``repro``. Its entry points run
on CUDA unless the caller passes ``device="cpu"``.
"""
