"""Redis telemetry mirror: share per-service stats across replicas.

PyTorch-port copy of ``mcpx/telemetry/mirror.py``. Each control-plane
replica periodically **exports** its local EWMA snapshot under a
per-replica key and **imports** every other replica's snapshot as peer
data, so replicas planning against the same registry see each other's
observed latency, error rate and cost within one sync interval.

Peer snapshots are held apart from local observations
(``TelemetryStore.set_peer``) and blended call-weighted at read time, so
re-importing a peer's snapshot never double-counts it.

The Redis client is injected, or built lazily from a URL through the
optional ``redis`` package (``utils/redis_client.py``): nothing connects at
import, and tests drive the whole protocol against ``FakeAsyncRedis``.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Optional

from mcpx_torch.telemetry.stats import ServiceStats, TelemetryStore


class RedisTelemetryMirror:
    def __init__(
        self,
        store: TelemetryStore,
        url: str = "",
        *,
        key_prefix: str = "mcpx:telemetry:",
        replica_id: str = "",
        ttl_s: float = 60.0,
        client=None,
    ) -> None:
        self.store = store
        self.replica_id = replica_id or uuid.uuid4().hex[:12]
        self._url = url
        self._prefix = key_prefix
        self._ttl_s = ttl_s
        self._client = client

    def _redis(self):
        if self._client is None:
            from mcpx_torch.utils.redis_client import lazy_redis_client

            self._client = lazy_redis_client(self._url, "telemetry.redis_url")
        return self._client

    # ------------------------------------------------------------------ api
    async def export(self) -> None:
        """Write this replica's LOCAL observations (peers excluded — they
        re-export their own) under ``<prefix><replica_id>``."""
        snap = {
            name: s.to_dict() for name, s in self.store.local_snapshot().items()
        }
        payload = json.dumps({"at": time.time(), "stats": snap})
        r = self._redis()
        await r.set(self._prefix + self.replica_id, payload, ex=int(self._ttl_s) or None)

    async def merge(self) -> int:
        """Read every other replica's snapshot into the store's peer view;
        returns the number of peers seen. Stale peers (unrefreshed past the
        TTL) are dropped from the peer view."""
        r = self._redis()
        peers = 0
        seen: set[str] = set()
        async for key in r.scan_iter(match=self._prefix + "*"):
            k = key.decode() if isinstance(key, bytes) else key
            rid = k[len(self._prefix):]
            if rid == self.replica_id:
                continue
            raw = await r.get(k)
            if not raw:
                continue
            try:
                obj = json.loads(raw)
                stats = {
                    name: ServiceStats(
                        service=name,
                        ewma_latency_ms=float(d.get("ewma_latency_ms", 0.0)),
                        ewma_error_rate=float(d.get("ewma_error_rate", 0.0)),
                        ewma_cost=float(d.get("ewma_cost", 0.0)),
                        calls=int(d.get("calls", 0)),
                        errors=int(d.get("errors", 0)),
                    )
                    for name, d in (obj.get("stats") or {}).items()
                }
            except (ValueError, TypeError, AttributeError):
                continue  # malformed peer payload; skip
            if time.time() - float(obj.get("at", 0)) > self._ttl_s:
                continue
            self.store.set_peer(rid, stats)
            seen.add(rid)
            peers += 1
        self.store.prune_peers(keep=seen)
        return peers

    async def sync(self) -> int:
        await self.export()
        return await self.merge()

    async def aclose(self) -> None:
        c, self._client = self._client, None
        if c is not None:
            close = getattr(c, "aclose", None) or getattr(c, "close", None)
            if close is not None:
                res = close()
                if hasattr(res, "__await__"):
                    await res


class FakeAsyncRedis:
    """Minimal in-memory async Redis (get/set/delete/incr/scan_iter) for
    tests and single-process demos — the same surface RedisRegistry and the
    telemetry mirror use, with no external server."""

    def __init__(self) -> None:
        self._data: dict[str, bytes] = {}

    async def get(self, key: str) -> Optional[bytes]:
        return self._data.get(key)

    async def set(self, key: str, value, ex: Optional[int] = None) -> None:
        self._data[key] = value.encode() if isinstance(value, str) else bytes(value)

    async def delete(self, *keys: str) -> int:
        n = 0
        for k in keys:
            n += self._data.pop(k, None) is not None
        return n

    async def incr(self, key: str) -> int:
        v = int(self._data.get(key, b"0")) + 1
        self._data[key] = str(v).encode()
        return v

    async def scan_iter(self, match: str = "*"):
        import fnmatch

        for k in list(self._data):
            if fnmatch.fnmatch(k, match):
                yield k.encode()
