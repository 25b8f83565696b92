"""Consistent-hash stream placement (a copy of ``evam_tpu/fleet/placer.py``).

A stream's submit() traffic must hit the SAME per-device shard every
frame: trackers, decoder state and the motion gate all key off stream
identity, and a stream that wanders between devices pays a cold bucket
ladder on each. A modulo over live shards would reshuffle almost
every stream when one device degrades; the classic consistent-hash ring
(512 vnodes per shard by default — enough ring density that per-shard
arc share stays within a few percent) moves only the dead shard's
streams —
exactly the drain-and-rebalance contract `FleetEngine` counts on
``evam_fleet_rebalance_total``.

Determinism is part of the contract: placement derives only from the
shard labels and the stream key (sha1, no process seed), so a restart
— or a second process serving the same fleet — places every stream
identically.
"""

from __future__ import annotations

import bisect
import hashlib
import threading


def _point(key: str) -> int:
    return int(hashlib.sha1(key.encode()).hexdigest()[:16], 16)


class ConsistentHashPlacer:
    """Hash ring over shard labels; ``place`` skips downed shards."""

    def __init__(self, shards: list[str], vnodes: int = 512):
        if not shards:
            raise ValueError("placer needs at least one shard")
        self._vnodes = vnodes
        self._down: set[str] = set()
        ring: list[tuple[int, str]] = []
        for s in shards:
            for v in range(vnodes):
                ring.append((_point(f"{s}:{v}"), s))
        ring.sort()
        self._ring = ring
        self._points = [p for p, _ in ring]
        self._lock = threading.Lock()

    # ------------------------------------------------------------- API

    def place(self, key: str) -> str:
        """First live shard clockwise of the key's ring point."""
        with self._lock:
            live = {s for _, s in self._ring} - self._down
            if not live:
                raise RuntimeError("no live shards on the placement ring")
            i = bisect.bisect_right(self._points, _point(key))
            n = len(self._ring)
            for step in range(n):
                s = self._ring[(i + step) % n][1]
                if s not in self._down:
                    return s
        raise RuntimeError("unreachable: live ring walk found no shard")

    def add(self, shard: str) -> None:
        """Grow the ring by one shard (fleet scale-up). A label the
        ring has seen before (a scale-down's slot coming back) is
        simply marked live again — its vnodes never left, so the
        streams it used to own come home deterministically. A genuinely
        new label inserts its vnodes; only the streams whose arcs the
        new points split move, the consistent-hash contract."""
        with self._lock:
            self._down.discard(shard)
            if any(s == shard for _, s in self._ring):
                return
            for v in range(self._vnodes):
                bisect.insort(self._ring, (_point(f"{shard}:{v}"), shard))
            self._points = [p for p, _ in self._ring]

    def mark_down(self, shard: str) -> None:
        with self._lock:
            self._down.add(shard)

    def mark_up(self, shard: str) -> None:
        with self._lock:
            self._down.discard(shard)

    def live(self) -> set[str]:
        with self._lock:
            return {s for _, s in self._ring} - self._down
