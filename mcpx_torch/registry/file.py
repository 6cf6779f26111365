"""JSON-file registry backend: a list of service records on disk.

The PyTorch port's copy of ``mcpx/registry/file.py``. It serves the files
``gen-registry`` writes (benchmarks, reproducible demos) and loads lazily
on first access: no I/O at import.
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Optional

from mcpx_torch.core.errors import RegistryError
from mcpx_torch.registry.base import RegistryBackend, ServiceRecord
from mcpx_torch.registry.memory import InMemoryRegistry


class FileRegistry(RegistryBackend):
    def __init__(self, path: str) -> None:
        self._path = path
        self._mem = InMemoryRegistry()
        self._loaded = False
        # One lock for both load and flush: file I/O is serialised, and the
        # lazy first load is exactly-once even under concurrent first reads.
        self._io_lock = asyncio.Lock()

    async def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        # The read runs off the event loop, and the lock (re-checked inside)
        # stops two concurrent first accesses from both loading: duplicate
        # puts would bump the registry version once per racer.
        async with self._io_lock:
            if self._loaded:
                return
            if not os.path.exists(self._path):
                raise RegistryError(f"registry file not found: {self._path}")

            def read():
                with open(self._path) as f:
                    return json.load(f)

            try:
                data = await asyncio.to_thread(read)
            except (OSError, json.JSONDecodeError) as e:
                raise RegistryError(
                    f"cannot read registry file {self._path}: {e}"
                ) from e
            if not isinstance(data, list):
                raise RegistryError(f"registry file {self._path} must hold a JSON list")
            for obj in data:
                await self._mem.put(ServiceRecord.from_dict(obj))
            self._loaded = True

    async def get(self, name: str) -> Optional[ServiceRecord]:
        await self._ensure_loaded()
        return await self._mem.get(name)

    async def put(self, record: ServiceRecord) -> None:
        await self._ensure_loaded()
        await self._mem.put(record)
        await self._flush()

    async def delete(self, name: str) -> bool:
        await self._ensure_loaded()
        existed = await self._mem.delete(name)
        if existed:
            await self._flush()
        return existed

    async def list_services(self) -> list[ServiceRecord]:
        await self._ensure_loaded()
        return await self._mem.list_services()

    async def version(self) -> int:
        await self._ensure_loaded()
        return await self._mem.version()

    async def _flush(self) -> None:
        # Serialised: concurrent put/delete must not interleave temp-file
        # writes (atomic replace from a unique temp name, one at a time).
        async with self._io_lock:
            records = [r.to_dict() for r in await self._mem.list_services()]

            def write() -> None:
                tmp = f"{self._path}.{os.getpid()}.{id(self)}.tmp"
                with open(tmp, "w") as f:
                    json.dump(records, f, indent=2)
                os.replace(tmp, self._path)

            # Off the event loop: a large write must not stall requests.
            await asyncio.to_thread(write)
