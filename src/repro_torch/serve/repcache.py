"""Cross-query representation cache (DESIGN.md §10.3).

The scan engine materializes the shared RGB pyramid per chunk per query
and the serving path re-pools every request batch from the raw base
images — in an interactive session (the paper's ONGOING scenario) the
same hot rows are pooled again and again. ``RepresentationCache`` is an
LRU over ``(row, resolution) -> pooled RGB level row`` with a byte
budget, shared across queries AND requests: one object can back a
``ScanEngine`` (per-chunk pyramid hook) and an ``AsyncCascadeService``
(per-flush batch assembly) simultaneously, so an offline scan warms the
online path and vice versa.

Entries live on one device in one slab per resolution: an
``(n, r, r, 3)`` f32 tensor that the cache owns, grown by doubling, one
slot per entry. The device is the first consumer's corpus device
(``bind_corpus``), else the first level put's. A chunk's or a flush's
freshly pooled levels go in with one indexed copy per level, and a
lookup comes out as one gathered block per level: no level crosses to
the host, and no entry is a view into the block it came from. Every slab
access runs on the device's default stream, so the scan's and every
serving lane's accesses are ordered; a caller on another stream is
ordered against them on entry and exit (``_DefaultStream``).

Exactness: an entry is the deterministic progressive box-filter pooling
of the row's base image (core/transforms.materialize_pyramid), so a
cache hit equals recomputation in the dyadic-pixel regime every corpus
in this repo uses — reuse changes bytes moved, never labels. Entries are
stored pre-color-transform (RGB), the same shared level every color
representation projects from, so concepts with different color reps
share entries.

Accounting is all-or-none per lookup: ``lookup_rows`` returns stacked
blocks only when EVERY (row, level) entry is present — the batch then
skips pooling entirely — and counts hits/misses at entry granularity.
Keys are plain ``(row, resolution)``; the scan engine publishes exactly
the non-base ingest levels of the plan it executes.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch


def corpus_token(images) -> tuple:
    """Cheap deterministic corpus fingerprint: shape plus a strided
    sample checksum. The same pixel data in a different buffer (engines
    copy on construction) maps to the same token; two different corpora
    virtually never collide. A tensor on a card sends only the strided
    sample to the host; the sum is numpy's f32 sum of it, widened to
    f64 — the token numpy gives for the same pixels."""
    step = max(1, len(images) // 17)
    if torch.is_tensor(images):
        sample = images[::step].detach().to("cpu", torch.float32).numpy()
    else:
        sample = np.asarray(images)[::step]
    return tuple(images.shape) + (float(np.float64(sample.sum())),)


class _DefaultStream:
    """Slab accesses on ``device``'s default stream. For a caller on
    another stream: on entry the default stream waits for the caller's,
    on exit the caller's waits for the default one, and ``keep(t)`` marks
    a tensor used on both, so its memory is not reused before both are
    done with it. Nothing happens off a card or on the default stream."""

    def __init__(self, device):
        self.caller = None
        if device is not None and device.type == "cuda":
            cur = torch.cuda.current_stream(device)
            default = torch.cuda.default_stream(device)
            if cur != default:
                self.caller, self.default = cur, default

    def __enter__(self):
        if self.caller is not None:
            self.default.wait_stream(self.caller)
            self._ctx = torch.cuda.stream(self.default)
            self._ctx.__enter__()
        return self

    def keep(self, t: torch.Tensor) -> torch.Tensor:
        if self.caller is not None:
            t.record_stream(self.default)
            t.record_stream(self.caller)
        return t

    def __exit__(self, *exc):
        if self.caller is not None:
            self._ctx.__exit__(*exc)
            self.caller.wait_stream(self.default)


class RepresentationCache:
    """Byte-budgeted LRU of pooled pyramid level rows keyed by
    ``(row, resolution)``. Levels are copied into the cache's slabs on
    insert (a cached level must not pin the flush-sized block it was
    sliced from) and gathered into fresh blocks on lookup.

    Keys carry no corpus identity, so every consumer binds its corpus
    fingerprint on attach (``bind_corpus``): sharing one cache between
    a scan engine and a service over the SAME corpus is the designed
    use; attaching a second, different corpus raises instead of
    silently serving another corpus's pixels (whose labels would then
    be committed as virtual columns permanently)."""

    def __init__(self, budget_bytes: int = 64 << 20):
        if budget_bytes <= 0:
            raise ValueError("budget_bytes must be positive")
        self.budget_bytes = int(budget_bytes)
        self.nbytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserts = 0
        self._od: OrderedDict[tuple, int] = OrderedDict()   # key -> slot
        self._slabs: dict[int, torch.Tensor] = {}    # resolution -> slab
        self._free: dict[int, list[int]] = {}        # resolution -> slots
        self.device: torch.device | None = None     # None: not fixed yet
        self._corpus: tuple | None = None

    def bind_corpus(self, token: tuple, device=None) -> None:
        """First binder wins; a different corpus raises ValueError. The
        first ``device`` given (the binder's corpus device) becomes the
        entries' device."""
        if self._corpus is None:
            self._corpus = token
        elif self._corpus != token:
            raise ValueError(
                "RepresentationCache is already bound to a different "
                "corpus — its (row, resolution) keys would collide; "
                "use one cache per corpus")
        if device is not None and self.device is None:
            self._place(torch.device(device))

    def _place(self, device: torch.device) -> None:
        self.device = device
        self._slabs = {r: s.to(device) for r, s in self._slabs.items()}

    def __len__(self) -> int:
        return len(self._od)

    def __contains__(self, key: tuple) -> bool:
        return key in self._od

    # -------------------------------------------------------------- slots --
    def _entries(self, block) -> torch.Tensor:
        """``block`` (an array or a tensor) as f32 on the cache's device,
        which the first block fixes when no consumer has."""
        t = torch.as_tensor(block)
        if self.device is None:
            self._place(t.device)
        return t.to(self.device, torch.float32)

    def _reserve(self, resolution: int, shape: tuple, n: int) -> list:
        """The resolution's free slots, at least ``n`` of them (its slab
        grown by doubling)."""
        slab = self._slabs.get(resolution)
        if slab is None:
            slab = torch.empty((0, *shape), dtype=torch.float32,
                               device=self.device or "cpu")
            self._free[resolution] = []
        free = self._free[resolution]
        if len(free) < n:
            old = len(slab)
            size = max(16, 2 * old, old + n - len(free))
            grown = torch.empty((size, *shape), dtype=torch.float32,
                                device=slab.device)
            grown[:old] = slab
            self._slabs[resolution] = grown
            free.extend(range(size - 1, old - 1, -1))
        return free

    def _insert(self, key: tuple, nbytes: int, free: list) -> int:
        """The reference's ``put`` bookkeeping for one entry of ``nbytes``
        (at most the budget), its slot taken from ``free``."""
        old = self._od.pop(key, None)
        if old is not None:
            free.append(old)
            self.nbytes -= nbytes
        slot = free.pop()
        self._od[key] = slot
        self.nbytes += nbytes
        self.inserts += 1
        while self.nbytes > self.budget_bytes:
            (_, r), victim = self._od.popitem(last=False)
            self._free[r].append(victim)
            self.nbytes -= 4 * math.prod(self._slabs[r].shape[1:])
            self.evictions += 1
        return slot

    def _index(self, slots) -> torch.Tensor:
        """int64 slot indices on the cache's device (from pinned memory
        on a card, so the copy does not wait for the stream)."""
        t = torch.from_numpy(np.asarray(slots, np.int64))
        if self.device is None or self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _hit(self, key: tuple) -> int:
        self._od.move_to_end(key)
        self.hits += 1
        return self._od[key]

    # ------------------------------------------------------ single entry --
    def get(self, row: int, resolution: int):
        """A copy of the level row (a tensor on the cache's device), or
        None. A hit refreshes LRU recency."""
        key = (int(row), int(resolution))
        if key not in self._od:
            self.misses += 1
            return None
        slot = self._hit(key)
        with _DefaultStream(self.device) as ds:
            return ds.keep(self._slabs[key[1]][slot].clone())

    def put(self, row: int, resolution: int, level) -> None:
        level = self._entries(level)
        self.put_rows([row], resolution, level[None])

    # ------------------------------------------------------- batch entry --
    def lookup_rows(self, ids, resolutions) -> dict | None:
        """All-or-none batch lookup: ``{resolution: (len(ids), r, r, 3)}``
        blocks on the cache's device when every (row, level) entry is
        cached, else None. Counters move at (row, level) granularity, and
        a failed lookup serves NOTHING — every probed entry of a failed
        batch counts as a miss, so ``hit_rate`` is exactly the fraction of
        entry lookups actually served from cache."""
        ids = np.asarray(ids, np.int64)
        resolutions = [int(r) for r in resolutions]
        if any((int(i), r) not in self._od
               for r in resolutions for i in ids):
            self.misses += len(ids) * len(resolutions)
            return None
        out = {}
        with _DefaultStream(self.device) as ds:
            for r in resolutions:
                slots = [self._hit((int(i), r)) for i in ids]
                out[r] = ds.keep(
                    self._slabs[r].index_select(0, self._index(slots))
                    if slots else torch.empty((0, r, r, 3),
                                              device=self.device))
        return out

    def put_rows(self, ids, resolution: int, block) -> None:
        """Insert one pooled level for a batch of rows; ``block`` is
        ``(len(ids), r, r, 3)``, an array or a tensor (each row copied
        into the resolution's slab, one indexed copy for the batch)."""
        ids = np.asarray(ids, np.int64)
        block = self._entries(block)
        r, shape = int(resolution), tuple(block.shape[1:])
        slab = self._slabs.get(r)
        if slab is not None and tuple(slab.shape[1:]) != shape:
            raise ValueError(f"levels of shape {shape} at resolution {r}, "
                             f"whose entries are {tuple(slab.shape[1:])}")
        nbytes = 4 * math.prod(shape)
        if nbytes > self.budget_bytes:
            return                       # would evict everything for one row
        with _DefaultStream(self.device) as ds:
            ds.keep(block)
            free = self._reserve(r, shape, len(ids))
            rows = ids.tolist()
            last = {}                      # slot -> the block row it holds
            for i, row in enumerate(rows):
                last[self._insert((row, r), nbytes, free)] = i
            # a slot freed again within the batch (evicted) holds nothing
            held = [(s, i) for s, i in last.items()
                    if self._od.get((rows[i], r)) == s]
            if held:
                slots, pos = zip(*held)
                self._slabs[r].index_copy_(
                    0, self._index(slots),
                    block.index_select(0, self._index(pos)))

    # ------------------------------------------------------- persistence --
    def items(self):
        """``((row, resolution), level)`` in LRU order (oldest first), each
        level a host numpy copy."""
        with _DefaultStream(self.device):
            host = {r: s.cpu().numpy() for r, s in self._slabs.items()}
        for key, slot in self._od.items():
            yield key, np.array(host[key[1]][slot])

    def save(self, path) -> None:
        """Persist the cache as an npz: entries in LRU order (oldest
        first, so a budget-trimmed load evicts the same victims the
        live cache would), plus the bound corpus token. Entries are
        deterministic poolings of the corpus, so a reload serves
        identical levels."""
        token = () if self._corpus is None else self._corpus
        data = {"budget_bytes": np.int64(self.budget_bytes),
                "token": np.asarray(token, np.float64),
                "keys": np.asarray(list(self._od), np.int64)}
        for i, (_, arr) in enumerate(self.items()):
            data[f"ent_{i}"] = arr
        np.savez(path, **data)

    @classmethod
    def load(cls, path, token: tuple | None = None
             ) -> "RepresentationCache":
        """Inverse of ``save``; reuses the ``bind_corpus`` contract:
        pass the attaching corpus's token and a snapshot saved for a
        different corpus refuses to load (its (row, resolution) keys
        would serve another corpus's pixels). ``token=None`` skips the
        check and re-binds lazily on first attach. The entries are on
        the host until a consumer binds its device."""
        with np.load(path, allow_pickle=False) as z:
            cache = cls(int(z["budget_bytes"]))
            saved = tuple(float(v) for v in z["token"])
            if saved:
                cache._corpus = saved
                if token is not None:
                    cache.bind_corpus(tuple(token))
            for i, (row, res) in enumerate(z["keys"]):
                arr = z[f"ent_{i}"]
                slot = cache._reserve(int(res), arr.shape, 1).pop()
                cache._slabs[int(res)][slot] = torch.from_numpy(arr)
                cache._od[(int(row), int(res))] = slot
                cache.nbytes += arr.nbytes
        return cache

    # ------------------------------------------------------------- stats --
    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "entries": len(self._od),
            "bytes": int(self.nbytes),
            "budget_bytes": self.budget_bytes,
            "hits": int(self.hits),
            "misses": int(self.misses),
            "hit_rate": round(self.hit_rate, 4),
            "inserts": int(self.inserts),
            "evictions": int(self.evictions),
        }
