"""In-memory registry backend — the default, and the test workhorse."""

from __future__ import annotations

import asyncio
from typing import Optional

from mcpx_torch.registry.base import RegistryBackend, ServiceRecord


class InMemoryRegistry(RegistryBackend):
    def __init__(self) -> None:
        self._records: dict[str, ServiceRecord] = {}
        self._version = 0
        self._lock = asyncio.Lock()

    async def get(self, name: str) -> Optional[ServiceRecord]:
        return self._records.get(name)

    async def put(self, record: ServiceRecord) -> None:
        async with self._lock:
            self._records[record.name] = record
            self._version += 1

    async def delete(self, name: str) -> bool:
        async with self._lock:
            existed = self._records.pop(name, None) is not None
            if existed:
                self._version += 1
            return existed

    async def list_services(self) -> list[ServiceRecord]:
        return sorted(self._records.values(), key=lambda r: r.name)

    async def version(self) -> int:
        return self._version
