"""Redis-persisted plan cache — the cross-replica / cross-restart tier.

The in-process LRU in ``ControlPlane`` dies with the process and is private
to one replica; this optional second tier shares validated plans between
replicas and across restarts (SURVEY.md §5 checkpoint/resume: "optionally
Redis-persisted plan cache keyed by (intent, registry-version) — a large
plans/sec lever"). Keys embed the registry version, so a registry change
invalidates every stale entry implicitly; values are the canonical wire
envelope (``Plan.to_wire``), which round-trips origin/explanation intact.

PyTorch-port copy of ``mcpx/server/plan_cache.py``. The ``redis`` import is
deferred to the first use and a ``client`` can be injected (any object with
async ``get(key)`` and ``set(key, value, ex=)``; the tests inject a
dict-backed one), so the control plane imports on machines without redis.
"""

from __future__ import annotations

import hashlib
import json
import logging
from typing import Optional

from mcpx_torch.core.dag import Plan

log = logging.getLogger("mcpx_torch.plan_cache")


class RedisPlanCache:
    def __init__(
        self,
        url: str = "",
        *,
        key_prefix: str = "mcpx:plancache:",
        ttl_s: float = 600.0,
        client=None,
    ) -> None:
        self._url = url
        self._prefix = key_prefix
        self._ttl_s = ttl_s
        self._client = client

    def _redis(self):
        if self._client is None:
            try:
                import redis.asyncio as aioredis
            except ImportError as e:
                raise RuntimeError(
                    "planner.plan_cache_redis_url requires the 'redis' package, "
                    "which is not installed"
                ) from e
            # Tight socket timeouts: a stalled Redis degrades the cache
            # (get/put log and carry on) instead of hanging the plan path.
            self._client = aioredis.from_url(
                self._url, socket_timeout=1.0, socket_connect_timeout=1.0
            )
        return self._client

    def _key(self, intent: str, version: int) -> str:
        digest = hashlib.sha1(intent.encode("utf-8")).hexdigest()
        return f"{self._prefix}{version}:{digest}"

    async def get(self, intent: str, version: int) -> Optional[Plan]:
        """Cached plan for (intent, registry version), or None. Corrupt or
        stale-schema entries are treated as misses, never raised."""
        try:
            raw = await self._redis().get(self._key(intent, version))
        except Exception:  # noqa: BLE001 - cache is an optimisation
            log.warning("plan-cache read failed; treating as miss", exc_info=True)
            return None
        if not raw:
            return None
        try:
            return Plan.from_wire(json.loads(raw))
        except Exception:  # ANY malformed entry is a miss:
            # valid-JSON-wrong-shape (e.g. {"nodes": 5}, a different build's
            # schema) raises TypeError and friends, not just
            # PlanValidationError — none of them may fail the plan request.
            return None

    async def put(self, intent: str, version: int, plan: Plan) -> None:
        # Sub-second TTLs round UP to 1s rather than truncating to "no
        # expiry" (int(0.5) == 0 would mean entries live forever and every
        # registry bump orphans a version's worth of keys).
        ttl = max(1, int(round(self._ttl_s))) if self._ttl_s > 0 else None
        try:
            await self._redis().set(
                self._key(intent, version), plan.to_json(), ex=ttl
            )
        except Exception:  # noqa: BLE001 - cache is an optimisation
            log.warning("plan-cache write failed; continuing", exc_info=True)
