"""Redis registry backend, with the reference's key layout.

The PyTorch port's copy of ``mcpx/registry/redis_backend.py``. Records live
at ``<prefix><name>`` as JSON values (prefix ``mcp:service:``) and the
version counter at ``<prefix>:__version__``, so a registry written by
either package reads as-is in the other. The client comes from
``utils.redis_client.lazy_redis_client`` at the first operation (``redis``
is optional, and the GPU machine has none); ``_client`` is injectable.
"""

from __future__ import annotations

import json
from typing import Optional

from mcpx_torch.core.errors import RegistryError
from mcpx_torch.registry.base import RegistryBackend, ServiceRecord


class RedisRegistry(RegistryBackend):
    def __init__(self, url: str, prefix: str = "mcp:service:") -> None:
        self._url = url
        self._prefix = prefix
        self._client = None
        self._version_key = f"{prefix.rstrip(':')}:__version__"

    def _redis(self):
        if self._client is None:
            from mcpx_torch.utils.redis_client import lazy_redis_client

            try:
                # Correctness path (not an optional cache): generous bound —
                # fail a registry op loudly after 5s rather than hanging
                # forever on a stalled Redis.
                self._client = lazy_redis_client(
                    self._url, "registry.backend=redis", timeout_s=5.0
                )
            except RuntimeError as e:
                raise RegistryError(str(e)) from e
        return self._client

    async def get(self, name: str) -> Optional[ServiceRecord]:
        raw = await self._redis().get(self._prefix + name)
        return ServiceRecord.from_dict(json.loads(raw)) if raw else None

    async def put(self, record: ServiceRecord) -> None:
        r = self._redis()
        await r.set(self._prefix + record.name, json.dumps(record.to_dict()))
        await r.incr(self._version_key)

    async def delete(self, name: str) -> bool:
        r = self._redis()
        n = await r.delete(self._prefix + name)
        if n:
            await r.incr(self._version_key)
        return bool(n)

    async def list_services(self) -> list[ServiceRecord]:
        r = self._redis()
        records: list[ServiceRecord] = []
        async for key in r.scan_iter(match=self._prefix + "*"):
            k = key.decode() if isinstance(key, bytes) else key
            if k == self._version_key:
                continue
            raw = await r.get(k)
            if raw:
                records.append(ServiceRecord.from_dict(json.loads(raw)))
        return sorted(records, key=lambda rec: rec.name)

    async def version(self) -> int:
        v = await self._redis().get(self._version_key)
        return int(v or 0)
