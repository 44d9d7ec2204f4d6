"""Paged KV cache: fixed-size pages from a shared pool, codec-encoded.

Counterpart of ``repro.serve.kvcache``. Each attention layer owns a pool of
``n_pages`` physical pages, each holding ``page`` token positions of K and
V. A slot's logical pages map to physical ids through a page table
(:class:`PageTable`, shared across layers: every layer sees the same token
positions); the host-side free list is ``repro_torch.serve.scheduler``'s
``PagePool``.

Pages are *sealed* through the quant engine (``repro_torch.quant``): while
a slot writes positions into its current page, the raw values sit in a
per-slot ``tail`` buffer; the micro-step that fills the page's last
position encodes the tail in f32 (fp32 passthrough, bf16, int8 affine per
row, or the NSD wire format) and stores it in the pool. Reads gather every
slot's pages, decode them and overlay the raw tail, so the newest
(unsealed) positions are always exact.

What differs from the reference, and why:

* The layers share one page table (:class:`PageTable`), which works out
  once a micro-step, on the host, what the positions imply (the tail slot
  written, the pages that seal, the view's page ids and mask) for every
  layer.
* Only the rows that seal encode. The reference encodes all B tails on
  every micro-step and drops the rows that do not seal, which keeps its
  step SPMD-uniform; each page's draw depends only on its own key, so the
  pages it keeps are the ones encoded here. Which rows seal is decided on
  the host, from the positions the caller passes as ``t_host``.
* The pool and the tails are written in place (a pool is not copied a
  step); ``update_and_view`` returns the cache itself as the new cache.
* The pool of an ``nsd`` mode is a ``PackedNSD`` whose fields carry a
  leading page axis, and a read decodes all B x max_pages pages of a layer
  with one launch of the paged wire expand
  (``kernels.levels.levels_expand_pages``), K and V apart: two launches a
  layer a micro-step. Sealed pages stay encoded; nothing keeps their
  decoded copies.
* Modes are ``fp32``, ``bf16``, ``int8`` and ``nsd`` (``nsd@S`` too). The
  reference also takes any other registered codec spec; the port refuses
  those.

Keys: the layer key is ``fold_in(0x9A6E, layer)``, a page's key
``fold_in(layer key, pid)``, and its encode draws from ``fold_in(page key,
RESID_SALT)`` (the reference's ``resid_key``), the splitmix64 ``fold_in``
of ``repro_torch.core.policy``. K and V of a page share the draw, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import quant as codec
from repro_torch.core.policy import fold_in
from repro_torch.kernels import levels as levels_k
from repro_torch.quant.codecs import RESID_SALT

KV_MODES = ("fp32", "bf16", "int8", "nsd")
BASE_KEY = 0x9A6E  # the reference's PRNGKey(0x9A6E) of the engine's pages


def layer_key(layer: int) -> int:
    return fold_in(BASE_KEY, layer)


def page_stored_nbytes(mode: str, page: int, n_kv: int, hd: int) -> int:
    """Static capacity bytes of one encoded K+V page (fp32 accounting)."""
    return 2 * codec.stored_nbytes(mode, (page, n_kv, hd), torch.float32)


def page_dense_nbytes(page: int, n_kv: int, hd: int) -> int:
    """Dense fp32 counterfactual bytes of one K+V page."""
    return 2 * codec.dense_nbytes((page, n_kv, hd), torch.float32)


def pages_for(n_tokens: int, page: int) -> int:
    """Logical pages covering ``n_tokens`` positions."""
    return -(-int(n_tokens) // page)


def _fields(enc):
    """The tensor fields of an encoding (the tensor itself for fp32)."""
    if isinstance(enc, torch.Tensor):
        return {None: enc}
    return {f.name: getattr(enc, f.name) for f in dataclasses.fields(enc)
            if isinstance(getattr(enc, f.name), torch.Tensor)}


def _stack(enc, n: int):
    """``n`` copies of an encoding, each tensor field with a leading page
    axis."""
    new = {k: v.expand((n,) + tuple(v.shape)).clone()
           for k, v in _fields(enc).items()}
    return new[None] if None in new else dataclasses.replace(enc, **new)


def _store(pool, pid: int, enc) -> None:
    """pool[pid] = enc, field by field, in place."""
    for name, dst in _fields(pool).items():
        dst[pid].copy_(_fields(enc)[name])


def _decode_pages(codec_name: str, pool, ids: torch.Tensor, shape):
    """The f32 pages ``ids`` (M,) of a pool, (M,) + shape: the codec's
    decode, written over a batch of pages."""
    if codec_name == "fp32":
        return pool[ids]
    if codec_name == "bf16":
        return pool.data[ids].to(torch.float32)
    if codec_name == "int8":
        x2 = (pool.q[ids].to(torch.float32) + 128.0) * pool.scale[ids] \
            + pool.lo[ids]
        return x2.reshape((-1,) + tuple(shape))
    # nsd: one paged expand launch, then k * Delta as in wire.unpack_nsd
    k = levels_k.levels_expand_pages(pool.levels, pool.bitmap, ids)
    vals = (k.to(torch.float32) * pool.deltas[ids][..., None]).reshape(
        ids.shape[0], -1)
    return vals[:, :math.prod(shape)].reshape((-1,) + tuple(shape))


@dataclasses.dataclass(frozen=True)
class _StepPlan:
    """What one micro-step's positions t imply for every layer's cache."""

    hit: torch.Tensor  # (B, page, 1, 1): the tail slot each active row writes
    here: torch.Tensor  # (B, P, 1, 1, 1): the logical page the tail overlays
    ids: torch.Tensor  # (B * P,) physical pages of the view, unmapped -> 0
    k_pos: torch.Tensor  # (B, P * page)
    valid: torch.Tensor  # (B, P * page): written, not ahead of t, active
    seals: tuple  # ((slot, pid), ...) rows whose write fills a mapped page


class PageTable:
    """The (B, max_pages) physical ids of every slot's logical pages, -1 for
    unmapped, kept on the host; one table serves every layer of a model
    (each layer sees the same token positions), and so does the plan it
    derives from a micro-step's positions: worked out on the host and
    copied to the device in two uploads, without a stream sync."""

    def __init__(self, batch: int, max_pages: int, device):
        self.device = torch.device("cpu" if device is None else device)
        self.host = np.full((batch, max_pages), -1, np.int64)
        self._plan = (None, None, None)
        self._k_pos = {}  # page -> (B, P * page) key positions

    def set(self, table) -> None:
        """Install a table (host array or tensor)."""
        host = np.asarray(table.cpu() if isinstance(table, torch.Tensor)
                          else table, np.int64)
        if not np.array_equal(host, self.host):
            self.host = host.copy()
            self._plan = (None, None, None)

    def plan(self, t: torch.Tensor, t_host, page: int,
             n_pages: int) -> _StepPlan:
        """The step plan of positions t (B,) (``t_host``: the same on the
        host; read from t, a device sync, when absent), made once for the
        step's t and reused by every layer (the same tensor, not written in
        place since)."""
        if self._plan[0] == (id(t), t._version):
            return self._plan[1]
        B, P = self.host.shape
        t_h = np.asarray(t.cpu() if t_host is None else t_host, np.int64)
        active = t_h >= 0
        cur = np.clip(np.where(active, t_h // page, 0), 0, P - 1)
        if page not in self._k_pos:
            self._k_pos[page] = torch.arange(
                P * page, device=self.device).expand(B, P * page)
        k_pos = np.arange(P * page)
        masks = np.concatenate([  # hit, here, valid
            (np.arange(page) == np.where(active, t_h % page, -1)[:, None]),
            np.arange(P) == cur[:, None],
            (k_pos <= t_h[:, None]) & active[:, None]], axis=1)
        ids = np.clip(self.host, 0, max(n_pages - 1, 0)).reshape(-1)
        up = (torch.from_numpy(masks.astype(np.uint8)).to(
            self.device, non_blocking=True).view(torch.bool))
        # the write that fills a mapped page seals it
        mapped = self.host[np.arange(B), cur]
        seal = active & (t_h % page == page - 1) & (mapped >= 0)
        plan = _StepPlan(
            hit=up[:, :page, None, None],
            here=up[:, page:page + P, None, None, None],
            ids=torch.from_numpy(ids).to(self.device, non_blocking=True),
            k_pos=self._k_pos[page], valid=up[:, page + P:],
            seals=tuple((int(b), int(mapped[b])) for b in np.flatnonzero(seal)))
        self._plan = ((id(t), t._version), plan, t)  # t kept: its id stays
        return plan


class PagedKV:
    """One attention layer's paged K/V state.

    ``pool_k``/``pool_v``: the encoded page stores, for fp32 a
    (n_pages, page, KV, hd) tensor, otherwise the codec's container with a
    leading n_pages axis on every tensor field. ``tail_k``/``tail_v``:
    (B, page, KV, hd) raw current-page buffers. ``table``: the
    :class:`PageTable`, which the layers of a model share.
    """

    def __init__(self, pool_k, pool_v, tail_k, tail_v, table: PageTable,
                 key: int, mode: str, page: int, n_pages: int):
        self.pool_k, self.pool_v = pool_k, pool_v
        self.tail_k, self.tail_v = tail_k, tail_v
        self.table = table
        self.key, self.mode, self.page, self.n_pages = key, mode, page, n_pages
        self.codec = codec.parse_spec(mode).codec

    @property
    def max_pages(self) -> int:
        return self.table.host.shape[1]

    @property
    def view_len(self) -> int:
        return self.max_pages * self.page

    def with_table(self, table) -> "PagedKV":
        """Install the (B, max_pages) page table (host array or tensor)."""
        self.table.set(table)
        return self

    def page_noise(self, pid: int, shape):
        """The encode noise of physical page ``pid``: its stream key (a
        test feeds a unit draw of ``shape`` here instead)."""
        return fold_in(fold_in(self.key, pid), RESID_SALT)

    def _seal(self, rows) -> None:
        """Encode the full tails of ``rows`` ((slot, pid), ...) into the
        pool: per row and per K and V, one NSD and one compact launch in
        the nsd mode."""
        shape = tuple(self.tail_k.shape[1:])
        for b, pid in rows:
            noise = self.page_noise(pid, shape)
            for tail, pool in ((self.tail_k, self.pool_k),
                               (self.tail_v, self.pool_v)):
                _store(pool, pid, codec.encode(
                    self.mode, tail[b].to(torch.float32), noise))

    def update_and_view(self, k: torch.Tensor, v: torch.Tensor,
                        t: torch.Tensor, *, t_host=None):
        """Write one token a slot, seal the pages that fill, return the
        view.

        k/v: (B, 1, KV, hd) new projections; t: (B,) absolute positions on
        the device, t < 0 for inactive slots; ``t_host``: the same on the
        host (read from t, a device sync, when absent). Returns (K, V,
        k_pos, valid, self), K/V (B, max_pages*page, KV, hd) f32 and valid
        masking both unused view positions and inactive slots. An inactive
        row writes nothing.
        """
        plan = self.table.plan(t, t_host, self.page, self.n_pages)
        for tail, new in ((self.tail_k, k), (self.tail_v, v)):
            torch.where(plan.hit, new.to(tail.dtype), tail, out=tail)
        self._seal(plan.seals)

        # view: every slot's pages decoded, the raw tail over its current page
        shape = tuple(self.tail_k.shape[1:])
        B, P = plan.here.shape[:2]
        views = []
        for tail, pool in ((self.tail_k, self.pool_k),
                           (self.tail_v, self.pool_v)):
            full = _decode_pages(self.codec, pool, plan.ids, shape).reshape(
                (B, P) + shape)
            full = torch.where(plan.here, tail[:, None].to(full.dtype), full)
            views.append(full.reshape((B, P * self.page) + shape[1:]))
        return views[0], views[1], plan.k_pos, plan.valid, self


def init_paged(mode: str, batch: int, max_len: int, n_pages: int, page: int,
               n_kv: int, hd: int, dtype: torch.dtype, key: int, *,
               device: Optional[torch.device] = None,
               table: Optional[PageTable] = None) -> PagedKV:
    """A zero-initialised paged cache for one layer: every pool page the
    encoding of a zero page, the tails zero and the table unmapped (a new
    one, or ``table``, which the model's other layers share).

    ``max_len`` bounds the logical pages per slot; ``n_pages`` is the
    shared physical pool (oversubscription is the scheduler's job).
    """
    try:
        name = codec.parse_spec(mode).codec
    except ValueError:
        name = None
    if name not in KV_MODES:
        raise ValueError(f"kv mode {mode!r}: one of {KV_MODES} (nsd@S for "
                         f"another dither scale)")
    if page < 1 or n_pages < 1:
        raise ValueError("page and n_pages must be >= 1")
    zero = torch.zeros((page, n_kv, hd), dtype=torch.float32, device=device)
    enc = codec.encode(mode, zero, key)  # Delta = 0: every k is 0
    tail = torch.zeros((batch, page, n_kv, hd), dtype=dtype, device=device)
    if table is None:
        table = PageTable(batch, pages_for(max_len, page), device)
    return PagedKV(_stack(enc, n_pages), _stack(enc, n_pages), tail,
                   tail.clone(), table, key, mode, page, n_pages)
