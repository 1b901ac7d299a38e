"""Head-granular paged KV cache (paper §6, "KV cache management").

vLLM pages cache at (sequence, block) granularity; Hetis splits further on
the head dimension so different head groups of ONE request can live on
different devices.  A block here is (kv-head-group, page of tokens), and
the block table maps (request, group, page_index) -> (device, local slot).

The pools are **sharded per logical device**: each device partition owns
its own ``(kpool, vpool)`` pair of torch tensors with shape
``(L, slots+1, page, dh)`` and device-LOCAL slot ids.  The cluster's
device classes are simulated: every partition's pools live on the one
torch ``device`` the cache was built for.  Migrating a head group is a
batched index copy between pools.  Layout is layer-major so one layer is
the contiguous view ``kpool[idx]``.

Every pool carries one ``sink`` slot (local index ``total``) padding
bucketed batches: rows past the true batch size write their garbage token
K/V there, and padded block-table entries point at it; the kernel's length
mask guarantees it is never read into a real output.

The **anchor** device (the engine's first primary) additionally reserves a
``stage_slots``-page STAGING region beyond its sink.  The paged kernel
reads exactly one pool pair, so a batch row whose pages live on another
device is served by gathering those remote pages into the staging region
inside the same step (and writing dirty staged pages back after) —
:class:`PoolStepPlan` builds the anchor-space block tables plus the
gather/writeback lane arrays for one step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.common import DTYPES
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class DevicePartition:
    device_id: int
    slots: List[int]                    # free LOCAL slot indices
    total: int

    @property
    def free(self) -> int:
        return len(self.slots)

    @property
    def used(self) -> int:
        return self.total - len(self.slots)


@dataclasses.dataclass
class MigrationResult:
    """Outcome of one ``migrate_group`` call.

    ``complete`` is False when the destination partition could not hold the
    whole chain — in that case NOTHING moved (all-or-nothing, so one head
    group's pages are never split across devices mid-request) and the
    caller must not record a migration that never happened.  Iterable as
    ``(moved, nbytes)`` for call sites that only meter bytes.
    """

    rid: int
    group: int
    dst_device: int
    requested: int                      # pages that needed to move
    moved: int
    nbytes: float
    complete: bool
    by_src: Dict[int, int]              # pages moved per source device

    def __iter__(self):
        return iter((self.moved, self.nbytes))


class PagedHeadCache:
    """Per-device physical pools + head-granular block tables."""

    def __init__(self, cfg: ModelConfig, device_slots: Dict[int, int],
                 page_size: int = 16, dtype=None,
                 anchor: Optional[int] = None, stage_slots: int = 0,
                 device="cuda"):
        assert cfg.attn_type == "gqa", \
            "paged head cache implemented for GQA; MLA/ssm use dense path"
        self.cfg = cfg
        self.page = page_size
        self.dtype = self.pool_dtype(cfg, dtype)
        self.device = torch.device(device)
        L, dh = cfg.n_layers, cfg.head_dim
        self.anchor = next(iter(device_slots)) if anchor is None else anchor
        assert self.anchor in device_slots, \
            f"anchor device {self.anchor} has no pool partition"
        self.stage = int(stage_slots)
        self.kpools: Dict[int, torch.Tensor] = {}
        self.vpools: Dict[int, torch.Tensor] = {}
        self.partitions: Dict[int, DevicePartition] = {}
        for dev, n in device_slots.items():
            # +1: per-pool sink slot for padded batch rows (never read
            # through a length mask, may be scribbled on by bucketed
            # steps); the anchor also reserves the staging region
            extra = 1 + (self.stage if dev == self.anchor else 0)
            shape = (L, n + extra, page_size, dh)
            self.kpools[dev] = torch.zeros(shape, dtype=self.dtype,
                                           device=self.device)
            self.vpools[dev] = torch.zeros(shape, dtype=self.dtype,
                                           device=self.device)
            self.partitions[dev] = DevicePartition(dev, list(range(n)), n)
        # anchor-space sink: the index every kernel-facing table pads with
        self.sink = self.partitions[self.anchor].total
        # (rid, group) -> list of (device, local slot)
        self.tables: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        # (rid, group) -> tokens stored
        self.lengths: Dict[Tuple[int, int], int] = {}

    # -- helpers -------------------------------------------------------------
    @classmethod
    def pool_dtype(cls, cfg: ModelConfig, dtype=None) -> torch.dtype:
        """Physical pool dtype — the single source of truth for byte
        accounting.  An explicit ``dtype`` (torch dtype or name) wins;
        otherwise the config's ``kv_dtype`` (``kv_cache_dtype`` falling
        back to the activation dtype) decides."""
        if dtype is None:
            dtype = cfg.kv_dtype
        return DTYPES[dtype] if isinstance(dtype, str) else dtype

    def sink_of(self, device_id: int) -> int:
        """Local sink slot index of one device's pool."""
        return self.partitions[device_id].total

    def bytes_per_slot(self) -> int:
        return int(2 * self.cfg.n_layers * self.page * self.cfg.head_dim
                   * self.dtype.itemsize)

    def free_bytes(self, device_id: int) -> int:
        """Real free bytes of one device partition — what the dispatcher's
        Eq 6 capacity constraint reads (per-partition, not aggregate)."""
        return self.partitions[device_id].free * self.bytes_per_slot()

    def pools(self) -> Tuple[Dict[int, torch.Tensor], Dict[int, torch.Tensor]]:
        """The per-device pool dicts, as passed to the model step."""
        return dict(self.kpools), dict(self.vpools)

    def install_pools(self, kpools: Dict[int, torch.Tensor],
                      vpools: Dict[int, torch.Tensor]) -> None:
        """Adopt the pool dicts returned by a model step (the same tensors,
        updated in place)."""
        self.kpools = dict(kpools)
        self.vpools = dict(vpools)

    def step_plan(self) -> "PoolStepPlan":
        """Fresh anchor-space remap for one model step."""
        return PoolStepPlan(self)

    # -- allocation ------------------------------------------------------------
    def ensure_capacity(self, rid: int, group: int, device_id: int,
                        n_tokens: int) -> bool:
        """Grow the (rid, group) chain on ``device_id`` to hold n_tokens."""
        key = (rid, group)
        chain = self.tables.setdefault(key, [])
        need_pages = -(-n_tokens // self.page)
        part = self.partitions[device_id]
        while len(chain) < need_pages:
            if not part.slots:
                return False
            chain.append((device_id, part.slots.pop()))
        self.lengths[key] = max(self.lengths.get(key, 0), n_tokens)
        return True

    def append_token(self, rid: int, group: int, device_id: int,
                     layer_kv: Optional[Tuple[np.ndarray, np.ndarray]] = None
                     ) -> bool:
        """Reserve room for one more token (and optionally store its K/V
        (L, dh) vectors)."""
        key = (rid, group)
        n = self.lengths.get(key, 0)
        if not self.ensure_capacity(rid, group, device_id, n + 1):
            return False
        if layer_kv is not None:
            self.store_token(rid, group, n, layer_kv[0], layer_kv[1])
        self.lengths[key] = n + 1
        return True

    def store_token(self, rid: int, group: int, pos: int, k, v) -> None:
        """k, v: (L, dh) (host arrays or tensors) for this group at
        position ``pos``, stored in the pool dtype."""
        dev, slot = self.tables[(rid, group)][pos // self.page]
        off = pos % self.page
        self.kpools[dev][:, slot, off] = torch.as_tensor(k).to(
            device=self.device, dtype=self.dtype)
        self.vpools[dev][:, slot, off] = torch.as_tensor(v).to(
            device=self.device, dtype=self.dtype)

    def store_prompt(self, rid: int, group: int, k: torch.Tensor,
                     v: torch.Tensor) -> None:
        """k, v: (L, ctx, dh) — bulk store after prefill; one scatter per
        device the chain touches (a single-device chain stays ONE
        scatter)."""
        ctx = k.shape[1]
        devs, slots, offs = self._scatter_indices(rid, group, ctx)
        k = torch.as_tensor(k).to(device=self.device, dtype=self.dtype)
        v = torch.as_tensor(v).to(device=self.device, dtype=self.dtype)
        for dev, sl, of, t in self._device_lanes(devs, slots, offs):
            self.kpools[dev][:, sl, of] = k[:, t]
            self.vpools[dev][:, sl, of] = v[:, t]

    def store_prompt_request(self, rid: int, k: torch.Tensor,
                             v: torch.Tensor) -> None:
        """Bulk store a whole request's prompt K/V for ALL head groups.
        k, v: (L, ctx, Hkv, dh) — the layout ``transformer.prefill``
        emits, on the device (no host round-trip)."""
        for g in range(self.cfg.n_kv_heads):
            self.store_prompt(rid, g, k[:, :, g], v[:, :, g])

    def _scatter_indices(self, rid: int, group: int, ctx: int
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(device, local slot, page offset) per token position for one
        group chain."""
        chain = self.tables[(rid, group)]
        t = np.arange(ctx)
        chain_devs = np.asarray([d for d, _ in chain], np.int32)
        chain_slots = np.asarray([s for _, s in chain], np.int32)
        page_idx = t // self.page
        return (chain_devs[page_idx], chain_slots[page_idx],
                (t % self.page).astype(np.int32))

    def _device_lanes(self, devs: np.ndarray, slots: np.ndarray,
                      offs: np.ndarray):
        """Per device of a chain's ``_scatter_indices``: (device, local
        slots, page offsets, token positions), the last three as index
        tensors on the pools' device."""
        for dev in np.unique(devs):
            m = devs == dev
            yield (int(dev),) + tuple(
                torch.from_numpy(a).to(self.device).long()
                for a in (slots[m], offs[m], np.flatnonzero(m)))

    def gather_dense(self, rid: int, max_len: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Reassemble (L, max_len, Hkv, dh) dense K/V from pages as fp32
        host arrays — the host-side reference path the paged fast path
        replaces.  The pages are gathered and widened to fp32 on the device
        (numpy has no bf16), then copied to the host."""
        cfg = self.cfg
        L, dh = cfg.n_layers, cfg.head_dim
        K = torch.zeros((L, max_len, cfg.n_kv_heads, dh), dtype=self.dtype,
                        device=self.device)
        V = torch.zeros_like(K)
        for g in range(cfg.n_kv_heads):
            n = min(self.lengths.get((rid, g), 0), max_len)
            if n <= 0:
                continue
            devs, slots, offs = self._scatter_indices(rid, g, n)
            for dev, sl, of, t in self._device_lanes(devs, slots, offs):
                K[:, t, g] = self.kpools[dev][:, sl, of]
                V[:, t, g] = self.vpools[dev][:, sl, of]
        return K.float().cpu().numpy(), V.float().cpu().numpy()

    # -- release / migration --------------------------------------------------------
    def release(self, rid: int) -> int:
        """Free all pages of a request; returns slots released."""
        released = 0
        for key in [k for k in self.tables if k[0] == rid]:
            for dev, slot in self.tables[key]:
                self.partitions[dev].slots.append(slot)
                released += 1
            del self.tables[key]
            self.lengths.pop(key, None)
        return released

    def migrate_group(self, rid: int, group: int, dst_device: int
                      ) -> MigrationResult:
        """Move one head group's pages to another device partition by
        BATCHED CROSS-POOL COPY (one gather/scatter pair per source
        device) — the physical device-to-device transfer the Hauler
        schedules into compute-overlap windows.

        All-or-nothing: if the destination partition cannot hold the whole
        chain, nothing moves and the result reports ``complete=False`` so
        callers never book a migration that did not happen."""
        key = (rid, group)
        chain = self.tables.get(key, [])
        dst = self.partitions[dst_device]
        pending = [(i, dev, slot) for i, (dev, slot) in enumerate(chain)
                   if dev != dst_device]
        if not pending:
            return MigrationResult(rid, group, dst_device, 0, 0, 0.0,
                                   True, {})
        if dst.free < len(pending):
            return MigrationResult(rid, group, dst_device, len(pending),
                                   0, 0.0, False, {})
        by_src: Dict[int, int] = {}
        for src_dev in sorted({dev for _, dev, _ in pending}):
            lanes = [(i, slot) for i, dev, slot in pending
                     if dev == src_dev]
            src = torch.tensor([s for _, s in lanes], dtype=torch.long,
                               device=self.device)
            new_slots = [dst.slots.pop() for _ in lanes]
            dst_idx = torch.tensor(new_slots, dtype=torch.long,
                                   device=self.device)
            self.kpools[dst_device][:, dst_idx] = \
                self.kpools[src_dev][:, src]
            self.vpools[dst_device][:, dst_idx] = \
                self.vpools[src_dev][:, src]
            for (i, slot), ns in zip(lanes, new_slots):
                chain[i] = (dst_device, ns)
                self.partitions[src_dev].slots.append(slot)
            by_src[src_dev] = len(lanes)
        moved = len(pending)
        return MigrationResult(rid, group, dst_device, moved, moved,
                               float(moved * self.bytes_per_slot()),
                               True, by_src)

    # -- invariants ----------------------------------------------------------------------
    def check_invariants(self) -> None:
        """Per-partition bookkeeping invariants: no slot double-booked
        within a pool, no pool's sink/staging region ever allocated, and
        every partition's used + free == total."""
        used: Dict[int, set] = {dev: set() for dev in self.partitions}
        for key, chain in self.tables.items():
            for dev, slot in chain:
                part = self.partitions[dev]
                assert 0 <= slot < part.total, \
                    f"device {dev} slot {slot} outside the allocatable " \
                    f"range (sink/staging slot handed out)"
                assert slot not in used[dev], \
                    f"device {dev} slot {slot} double-booked"
                used[dev].add(slot)
        for dev, part in self.partitions.items():
            for s in part.slots:
                assert s not in used[dev], \
                    f"device {dev} slot {s} both free and used"
            assert len(used[dev]) + part.free == part.total, \
                f"device {dev} leaked slots"


class PoolStepPlan:
    """Anchor-space remap of the sharded pools for ONE model call.

    The paged kernels read exactly one pool pair, so every block-table /
    scatter index handed to a kernel is an index into the ANCHOR pool.
    Anchor-local pages map to themselves; each distinct remote page is
    assigned a staging slot (beyond the anchor's sink) and recorded as a
    gather lane ``(device, src_slot, staging_idx)``; remote pages that are
    WRITTEN during the step additionally record a writeback lane
    ``(device, staging_idx, dst_slot)``.  The step copies gather lanes in
    before the forward pass and writeback lanes out after, inside the
    same model call.  Lane counts are pow2-bucketed by
    the engine (``exchange_arrays``) so compile counts stay bounded.
    """

    def __init__(self, kv: PagedHeadCache):
        self.kv = kv
        self.anchor = kv.anchor
        self._base = kv.partitions[kv.anchor].total + 1  # first staging idx
        self._map: Dict[Tuple[int, int], int] = {}
        self._g: List[Tuple[int, int, int]] = []   # (dev, src_slot, stage)
        self._w: List[Tuple[int, int, int]] = []   # (dev, stage, dst_slot)
        self._wseen: set = set()

    # -- lane bookkeeping ---------------------------------------------------
    def anchor_index(self, dev: int, slot: int, write: bool = False) -> int:
        """Anchor-pool index backing (dev, slot) this step; remote pages
        get a staging slot + gather lane (and a writeback lane if
        ``write``)."""
        if dev == self.anchor:
            return slot
        lane_key = (dev, slot)
        idx = self._map.get(lane_key)
        if idx is None:
            if len(self._map) >= self.kv.stage:
                raise RuntimeError(
                    f"staging region exhausted ({self.kv.stage} slots): "
                    f"a step referenced more remote pages than "
                    f"max_batch * n_kv_heads * pages_per_seq")
            idx = self._base + len(self._map)
            self._map[lane_key] = idx
            self._g.append((dev, slot, idx))
        if write and lane_key not in self._wseen:
            self._wseen.add(lane_key)
            self._w.append((dev, idx, slot))
        return idx

    @property
    def gather_count(self) -> int:
        return len(self._g)

    @property
    def writeback_count(self) -> int:
        return len(self._w)

    def d2d_bytes(self) -> float:
        """Device-to-device bytes this step's exchange moves (staging
        gathers + dirty-page writebacks)."""
        return float((len(self._g) + len(self._w))
                     * self.kv.bytes_per_slot())

    # -- kernel-facing index arrays -----------------------------------------
    def block_table_matrix(self, rid: int, max_pages: int,
                           n_tokens: Optional[int] = None) -> np.ndarray:
        """(Hkv, max_pages) int32 anchor-space table for one request,
        sink-padded (and truncated) to ``max_pages``.  Only pages holding
        tokens below ``n_tokens`` are staged from remote devices (the
        kernel's length mask never reads beyond them); anchor-local pages
        keep their full chain."""
        kv = self.kv
        Hkv = kv.cfg.n_kv_heads
        out = np.full((Hkv, max_pages), kv.sink, np.int32)
        for g in range(Hkv):
            chain = kv.tables.get((rid, g), [])
            n = kv.lengths.get((rid, g), 0) if n_tokens is None else n_tokens
            need = -(-n // kv.page)
            for p in range(min(len(chain), max_pages)):
                dev, slot = chain[p]
                if p < need:
                    out[g, p] = self.anchor_index(dev, slot)
                elif dev == self.anchor:
                    out[g, p] = slot
        return out

    def scatter_indices(self, rid: int, start: int, n: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(Hkv, n) anchor-space write slots + (n,) page offsets covering
        token positions [start, start + n) of EVERY head group.  Remote
        write pages are staged AND marked for writeback."""
        kv = self.kv
        Hkv = kv.cfg.n_kv_heads
        t = np.arange(start, start + n)
        page_idx = t // kv.page
        p0, p1 = int(page_idx[0]), int(page_idx[-1])
        slots = np.zeros((Hkv, n), np.int32)
        for g in range(Hkv):
            chain = kv.tables[(rid, g)]
            amap = np.asarray(
                [self.anchor_index(dev, slot, write=True)
                 for dev, slot in chain[p0:p1 + 1]], np.int32)
            slots[g] = amap[page_idx - p0]
        return slots, (t % kv.page).astype(np.int32)

    def mixed_scatter_indices(self, rows: Sequence[Tuple[int, int, int]],
                              C: int) -> Tuple[np.ndarray, np.ndarray]:
        """Write indices for a MIXED row batch (the fused prefill+decode
        step): ``rows`` is a list of ``(rid, start, n)`` spans — a decode
        row is the degenerate ``n == 1`` span at ``start == ctx - 1``.
        Returns ``(B, Hkv, C)`` anchor-space slot ids and ``(B, C)`` page
        offsets, sink-padded past each row's ``n``."""
        kv = self.kv
        Hkv = kv.cfg.n_kv_heads
        B = len(rows)
        wslots = np.full((B, Hkv, C), kv.sink, np.int32)
        woffs = np.zeros((B, C), np.int32)
        for i, (rid, start, n) in enumerate(rows):
            slots, offs = self.scatter_indices(rid, start, n)
            wslots[i, :, :n] = slots
            woffs[i, :n] = offs
        return wslots, woffs

    def exchange_arrays(self, n: int) -> Tuple[np.ndarray, ...]:
        """``(g_dev, g_src, g_dst, w_dev, w_src, w_dst)`` int32 lane
        arrays padded to ``n`` lanes (the engine's pow2 bucket).  Padded
        lanes carry device -1 — matching no pool, the exchange
        degrades them to harmless sink-to-sink copies."""
        kv = self.kv
        assert len(self._g) <= n and len(self._w) <= n, \
            (len(self._g), len(self._w), n)
        g_dev = np.full((n,), -1, np.int32)
        g_src = np.zeros((n,), np.int32)
        g_dst = np.full((n,), kv.sink, np.int32)
        for i, (d, s, t) in enumerate(self._g):
            g_dev[i], g_src[i], g_dst[i] = d, s, t
        w_dev = np.full((n,), -1, np.int32)
        w_src = np.full((n,), kv.sink, np.int32)
        w_dst = np.zeros((n,), np.int32)
        for i, (d, s, t) in enumerate(self._w):
            w_dev[i], w_src[i], w_dst[i] = d, s, t
        return g_dev, g_src, g_dst, w_dev, w_src, w_dst
