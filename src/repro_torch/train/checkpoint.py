"""Checkpoints: an integrity manifest, an async write, keep-k rotation.

Counterpart of ``repro.train.checkpoint``, with its on-disk layout exactly,
so either package restores what the other wrote (one directory a step):

    <dir>/step_00000100/
        manifest.json       {step, leaves: [{name, shape, dtype, crc}, ...]}
        shard_00000.npz     every leaf, by its path name
                            (``repro_torch.utils.pytree.flatten_with_names``)
        _COMMITTED          written last; restores ignore a directory
                            without it

The write is crash-consistent: the data goes into ``step_...tmp``, the
marker last, then a rename, then the rotation that keeps the newest
``keep``. npz holds no bf16 or f16, so those leaves are widened to f32,
which is exact, and cast back to the template's dtype on restore; the crc
is zlib's crc32 of the stored array's bytes.

A save copies every leaf to the host (``ckpt_gather``, the loop's blocking
part), waits for the write before it if one is still in flight
(``ckpt_drain``: one write at a time), and hands the host arrays to a
writer thread (``async_write``) or writes them itself. The writer records
``ckpt_write`` with ``serialize``, ``commit`` and ``rotate`` inside; the
loop's ``wait`` records ``ckpt_wait``. Span stacks are thread-local, so the
writer's spans never nest under the loop's.

A restore checks each leaf's crc and shape against the manifest and
template, and puts it on the template leaf's device in its dtype, leaf by
leaf from the npz (one leaf on the host at a time). ``inplace=True`` copies
each tensor into the template's own tensor instead of a new one, so
restoring a model's state needs no second copy of it on the device.

The reference's ``restore(shardings=...)`` reshards onto a mesh under its
sharding rules; the port's node mesh (``repro_torch.launch.mesh``) carries
no sharding rules yet (they come with ROADMAP.md section 1, item 9), so it
refuses the argument.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.trace import span
from repro_torch.utils import get_logger
from repro_torch.utils.pytree import flatten_with_names, map_leaves

log = get_logger("repro_torch.checkpoint")

_MARKER = "_COMMITTED"
_SHARD = "shard_00000.npz"  # one host: the reference's process index 0
MESH_TODO = ("restore(shardings=...) reshards onto a mesh, which the port "
             "does not have yet (ROADMAP.md section 1, item 7.2)")


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def list_steps(base: str) -> List[int]:
    """The committed steps under ``base``, in order."""
    if not os.path.isdir(base):
        return []
    out = []
    for d in os.listdir(base):
        if d.startswith("step_") and os.path.exists(
                os.path.join(base, d, _MARKER)):
            out.append(int(d.split("_")[1]))
    return sorted(out)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).data) & 0xFFFFFFFF


def _to_host(leaf: Any) -> np.ndarray:
    """A leaf as the array the npz stores: bf16 and f16 widened to f32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.to(torch.float32)
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype == np.float16:
        arr = arr.astype(np.float32)
    return arr


def _like(arr: np.ndarray, ref: Any, inplace: bool) -> Any:
    """``arr`` as a leaf like ``ref``: its type, dtype and device."""
    if isinstance(ref, torch.Tensor):
        t = torch.from_numpy(np.require(arr, requirements="C"))  # 0-d kept
        if inplace:
            with torch.no_grad():
                ref.copy_(t)
            return ref
        return t.to(device=ref.device, dtype=ref.dtype)
    if isinstance(ref, np.ndarray):
        return arr.astype(ref.dtype)
    if isinstance(ref, np.generic):
        return ref.dtype.type(arr.item())
    return type(ref)(arr.item())  # a Python int or float


class CheckpointManager:
    def __init__(self, base_dir: str, *, keep: int = 3,
                 async_write: bool = True):
        self.base = base_dir
        self.keep = keep
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(base_dir, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any) -> None:
        """Write ``tree`` as step ``step``; returns once the leaves are on
        the host (and any earlier write has finished)."""
        with span("ckpt_gather"):
            host_flat = [(name, _to_host(leaf))
                         for name, leaf in flatten_with_names(tree)]
        if self._pending is not None:
            with span("ckpt_drain"):
                self._join()
        if self.async_write:
            t = threading.Thread(target=self._write, args=(step, host_flat),
                                 daemon=True)
            t.start()
            self._pending = t
        else:
            self._write(step, host_flat)
            self._raise()

    def wait(self) -> None:
        """Block until the write in flight (if any) is committed."""
        if self._pending is not None:
            with span("ckpt_wait"):
                self._join()

    def _join(self) -> None:
        self._pending.join()
        self._pending = None
        self._raise()

    def _raise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _write(self, step: int, host_flat: List[Tuple[str, np.ndarray]]):
        try:
            with span("ckpt_write"):
                self._write_spanned(step, host_flat)
        except Exception as e:  # raised again by the loop's next join
            self._error = e

    def _write_spanned(self, step: int,
                       host_flat: List[Tuple[str, np.ndarray]]):
        d = _step_dir(self.base, step)
        tmp = d + ".tmp"
        with span("serialize"):
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, _SHARD), **dict(host_flat))
            manifest = {
                "step": step,
                "leaves": [{"name": n, "shape": list(a.shape),
                            "dtype": str(a.dtype), "crc": _crc(a)}
                           for n, a in host_flat],
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
        with span("commit"):
            with open(os.path.join(tmp, _MARKER), "w") as f:
                f.write("ok")
            shutil.rmtree(d, ignore_errors=True)
            os.rename(tmp, d)
        log.info("saved checkpoint step=%d (%d leaves)", step, len(host_flat))
        with span("rotate"):
            self._rotate()

    def _rotate(self):
        steps = list_steps(self.base)
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(_step_dir(self.base, s), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = list_steps(self.base)
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Any = None, *, inplace: bool = False) -> Any:
        """Restore into the structure of ``tree_like`` (the latest committed
        step unless ``step`` is given): each leaf in its template's type,
        dtype and device. A name the checkpoint lacks raises ``KeyError``,
        a crc mismatch ``IOError``, a shape mismatch ``ValueError``."""
        if shardings is not None:
            raise NotImplementedError(MESH_TODO)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoints under {self.base}")
        d = _step_dir(self.base, step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        crc_by_name: Dict[str, int] = {leaf["name"]: leaf["crc"]
                                       for leaf in manifest["leaves"]}
        shards = [np.load(os.path.join(d, fn)) for fn in sorted(os.listdir(d))
                  if fn.startswith("shard_") and fn.endswith(".npz")]
        try:
            where = {k: z for z in shards for k in z.files}
            missing = [name for name, _ in flatten_with_names(tree_like)
                       if name not in where]
            if missing:
                raise KeyError(f"checkpoint missing leaf {missing[0]}")

            def load(name: str, ref: Any) -> Any:
                arr = where[name][name]
                if _crc(arr) != crc_by_name.get(name):
                    raise IOError(f"checksum mismatch for {name}")
                if tuple(arr.shape) != tuple(np.shape(ref)):
                    raise ValueError(f"shape mismatch for {name}: ckpt "
                                     f"{arr.shape} vs {tuple(np.shape(ref))}")
                return _like(arr, ref, inplace)

            return map_leaves(load, tree_like)
        finally:
            for z in shards:
                z.close()
