"""Two-stage place retrieval.

Equivalent of ``search_ringkey`` + ``search_sc`` (search_place.h:25-85):
ringkey k-nearest-neighbors with an insertion lag of LOOP_MARGIN frames (so
recent frames never match), then the Scan Context signature difference over
the candidates. The FLANN KD-tree becomes a brute-force distance over the
ringkey database — exact where the KD-tree is approximate. Below
``DEVICE_MIN`` entries the search is a numpy broadcast (20-dim keys over a
few thousand frames cost microseconds and a device dispatch and pull
would dominate); past it the database lives in a power-of-2-capacity
device buffer and the search is one jitted distance + top_k program, so
retrieval stays O(ms) out to 100k+ keyframes (SURVEY.md §7)."""

from __future__ import annotations

from collections import deque
from functools import partial
from typing import List, Optional, Tuple

import numpy as np

DEVICE_MIN = 4096


def _device_knn_impl(buf, n, rk, k):
    import jax.numpy as jnp
    import jax

    d2 = jnp.sum((buf - rk[None, :]) ** 2, axis=1)
    d2 = jnp.where(jnp.arange(buf.shape[0]) < n, d2, jnp.inf)
    neg, idx = jax.lax.top_k(-d2, k)
    return -neg, idx


_device_knn = None


class RingkeyDatabase:
    def __init__(self, knn: int = 3, loop_margin: int = 100,
                 ringkey_thres: float = 0.1):
        self.knn = knn
        self.loop_margin = loop_margin
        self.thres = ringkey_thres
        self.db: List[np.ndarray] = []
        self.pending = deque()        # insertion lag queue
        self._buf = None              # device mirror [cap, D] (large DBs)

    def _search(self, ringkey: np.ndarray):
        """(d2, index) pairs of the k nearest database keys."""
        n = len(self.db)
        if n <= DEVICE_MIN:
            mat = np.stack(self.db)
            d2 = ((mat - ringkey[None, :]) ** 2).sum(axis=1)
            order = np.argsort(d2)[: self.knn]
            return [(float(d2[i]), int(i)) for i in order]
        global _device_knn
        import jax
        import jax.numpy as jnp
        if _device_knn is None:
            _device_knn = jax.jit(_device_knn_impl, static_argnums=(3,))
        cap = self._buf.shape[0] if self._buf is not None else 0
        if cap < n:
            cap = 1 << int(np.ceil(np.log2(max(n, DEVICE_MIN))))
            pad = np.zeros((cap, len(ringkey)), np.float32)
            pad[:n] = np.stack(self.db).astype(np.float32)
            self._buf = jnp.asarray(pad)
        d2s, idxs = jax.device_get(_device_knn(
            self._buf, np.int32(n), jnp.asarray(ringkey, jnp.float32),
            self.knn))
        return [(float(d), int(i)) for d, i in zip(d2s, idxs)]

    def search_and_insert(self, ringkey: np.ndarray) -> List[int]:
        """Returns candidate indices (into the order of insertion calls,
        0-based), then enqueues `ringkey` with the LOOP_MARGIN lag."""
        candidates: List[int] = []
        if len(self.db) > self.knn:
            for d2, i in self._search(ringkey):
                # reference quirk preserved: index 0 is rejected by the
                # `idces[0][i] > 0` check (search_place.h:37)
                if d2 < self.thres and i > 0:
                    candidates.append(int(i))
        # lag queue (search_place.h:42-56)
        self.pending.append(ringkey.copy())
        if len(self.pending) > self.loop_margin:
            self.db.append(self.pending.popleft())
            n = len(self.db)
            if self._buf is not None and n <= self._buf.shape[0]:
                self._buf = self._buf.at[n - 1].set(
                    np.asarray(self.db[-1], np.float32))
        return candidates


def search_signatures(
    signature: np.ndarray,
    all_signatures: List[np.ndarray],
    candidates: List[int],
    num_sectors: int,
) -> Tuple[int, float]:
    """search_sc (search_place.h:59-85): best candidate by signature
    difference."""
    from .scancontext import signature_difference

    best_idx = candidates[0]
    best_diff = 1.1
    for c in candidates:
        diff = signature_difference(signature, all_signatures[c], num_sectors)
        if diff < best_diff:
            best_idx, best_diff = c, diff
    return best_idx, best_diff
