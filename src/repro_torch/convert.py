"""Parameter conversion between the JAX reference and the port.

Classifiers (:func:`params_from_jax`): the reference keeps conv weights
HWIO (NHWC convolutions); the port keeps them OIHW. Every other parameter
(biases, BatchNorm scale and shift, dense weights (in, out)) has the same
layout in both. Names are kept as they are (``c{i}_w``, ``bn{i}_g``,
``fc{i}_w``, ...).

LMs (:func:`lm_params_from_jax`): the reference's ``init_lm`` tree is
nested, ``{"embed": {"table"}, "layers": {...}, "head": {"ln_f"}}``, its
blocks stacked along a leading (n_layers, ...) axis for the scan; the port's
``LM`` has one block per layer, ``layers.{i}.attn.wq`` and so on. Dense
weights keep the (in, out) layout, so no array is transposed. The names
are the reference's keys joined by dots, so every tree of the dense, MoE,
VLM, SSM and hybrid families maps by name alone: the q/k/v biases
(``attn.bq``, ``.bk``, ``.bv``), the untied ``head.lm_head``, relu2's MLP
without ``w_gate``, the MoE block's ``moe.router``, ``moe.w_gate`` /
``w_up`` / ``w_down`` (E, d, f) and shared experts ``moe.ws_*``, the VLM's
``head.vit_proj1`` / ``vit_proj2``, the stacked layers' nested ``mixer``
(the Mamba-2 mixer, its conv weight (d_conv, conv_dim) as the reference
lays it out), ``attn`` and ``mlp`` subtrees, and the hybrid's
``head.meta_tokens``. The encoder-decoder's two stacks, ``enc`` and
``dec`` (``enc.{i}.attn.wq``, ``dec.{i}.xattn.wk``, ``dec.{i}.lnx_s``, ...),
split and re-stack as ``layers`` does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

STACKS = ("layers", "enc", "dec")  # the reference's scanned block stacks


def params_from_jax(tree: Dict[str, np.ndarray], *,
                    device: Optional[torch.device] = None
                    ) -> Dict[str, torch.Tensor]:
    """Reference parameters (as numpy) -> the port's tensors (4-D conv
    weights HWIO -> OIHW)."""
    out = {}
    for name, a in tree.items():
        a = np.asarray(a)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return out


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax` (OIHW -> HWIO)."""
    out = {}
    for name, t in params.items():
        a = t.detach().cpu().numpy()
        out[name] = np.ascontiguousarray(a.transpose(2, 3, 1, 0)
                                         if a.ndim == 4 else a)
    return out


def _flatten(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def lm_params_from_jax(tree: Dict, *, device: Optional[torch.device] = None
                       ) -> Dict[str, torch.Tensor]:
    """The reference's ``init_lm`` tree (numpy leaves, stacked layers) ->
    the port's ``LM`` state dict (``net.load_state_dict(...)``)."""
    def tensor(a):
        if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: exact through f32
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    out = {}
    for name, a in _flatten(tree):
        a = np.asarray(a)
        stack, rest = name.split(".", 1)
        if stack in STACKS:
            for i in range(a.shape[0]):
                out[f"{stack}.{i}.{rest}"] = tensor(a[i])
        else:
            out[name] = tensor(a)
    return out


def lm_params_to_jax(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`lm_params_from_jax`: the port's named
    parameters -> the reference's nested tree, blocks stacked (bf16 as f32
    arrays, which hold it exactly)."""
    per_layer: Dict[Tuple[str, str], Dict[int, np.ndarray]] = {}
    tree: Dict = {}

    def put(path: str, a: np.ndarray):
        node = tree
        *keys, leaf = path.split(".")
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = a

    for name, t in params.items():
        a = t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
            else t.detach().cpu().numpy()
        stack, rest = name.split(".", 1)
        if stack in STACKS:
            i, rest = rest.split(".", 1)
            per_layer.setdefault((stack, rest), {})[int(i)] = a
        else:
            put(name, a)
    for (stack, rest), by_layer in per_layer.items():
        put(f"{stack}.{rest}",
            np.stack([by_layer[i] for i in range(len(by_layer))]))
    return tree
