"""Service registry: record schema and backend interface.

The reference's registry is read-only Redis ``SCAN`` over ``mcp:service:*``
keys (reference ``control_plane.py:30-35``) with out-of-band registration
(``README.md:86``) and the record schema ``{name, endpoint, input_schema,
output_schema, cost_profile, fallback}`` (``README.md:86-95``). Here the
record is a typed dataclass (superset of that schema), backends implement a
small async interface with full CRUD (the reference has no write API at all),
and every mutation bumps a monotonic ``version`` so downstream consumers (the
HBM retrieval index, the plan cache) can detect staleness cheaply instead of
re-scanning (reference bug B9: O(N) scan per plan, ``control_plane.py:33-34``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Protocol, runtime_checkable

from mcpx_torch.core.errors import RegistryError


@dataclass
class ServiceRecord:
    """One registered microservice (reference ``README.md:86-95`` superset)."""

    name: str
    endpoint: str
    description: str = ""
    input_schema: dict[str, str] = field(default_factory=dict)  # param -> type/desc
    output_schema: dict[str, str] = field(default_factory=dict)  # key -> type/desc
    cost_profile: dict[str, float] = field(default_factory=dict)  # latency_ms, cost
    fallbacks: list[str] = field(default_factory=list)  # ordered fallback endpoints
    tags: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.name:
            raise RegistryError("service record requires a name")
        if not self.endpoint:
            raise RegistryError(f"service '{self.name}' requires an endpoint")

    @classmethod
    def from_dict(cls, obj: Mapping[str, Any]) -> "ServiceRecord":
        if not isinstance(obj, Mapping):
            raise RegistryError(f"service record must be an object, got {type(obj).__name__}")
        fb = obj.get("fallbacks", obj.get("fallback", []))
        if isinstance(fb, str):
            fb = [fb] if fb else []
        try:
            return cls(
                name=str(obj.get("name", "")),
                endpoint=str(obj.get("endpoint", "")),
                description=str(obj.get("description", "") or ""),
                input_schema=dict(obj.get("input_schema", {}) or {}),
                output_schema=dict(obj.get("output_schema", {}) or {}),
                cost_profile={
                    k: float(v) for k, v in (obj.get("cost_profile", {}) or {}).items()
                },
                fallbacks=list(fb or []),
                tags=list(obj.get("tags", []) or []),
            )
        except (TypeError, ValueError) as e:
            raise RegistryError(
                f"malformed service record {obj.get('name', '?')!r}: {e}"
            ) from e

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "endpoint": self.endpoint,
            "description": self.description,
            "input_schema": dict(self.input_schema),
            "output_schema": dict(self.output_schema),
            "cost_profile": dict(self.cost_profile),
            "fallbacks": list(self.fallbacks),
            "tags": list(self.tags),
        }

    def schema_text(self) -> str:
        """Flat text rendering used by the embedder and planner prompts."""
        ins = ", ".join(f"{k}:{v}" for k, v in sorted(self.input_schema.items()))
        outs = ", ".join(f"{k}:{v}" for k, v in sorted(self.output_schema.items()))
        return f"{self.name} | {self.description} | in({ins}) out({outs}) | {' '.join(self.tags)}"

    def topic_text(self) -> str:
        """WHAT the service is about (name, tags, description) — excludes
        schema keys, which are interface plumbing shared across unrelated
        services and drown topical words in document-frequency statistics
        (retrieval's coverage-greedy shortlist indexes this, not
        ``schema_text``)."""
        return f"{self.name} | {self.description} | {' '.join(self.tags)}"


@runtime_checkable
class RegistryBackend(Protocol):
    """Async CRUD + versioning over service records."""

    async def get(self, name: str) -> Optional[ServiceRecord]: ...

    async def put(self, record: ServiceRecord) -> None: ...

    async def delete(self, name: str) -> bool: ...

    async def list_services(self) -> list[ServiceRecord]: ...

    async def version(self) -> int: ...


async def stable_snapshot(registry: RegistryBackend) -> "tuple[int, list[ServiceRecord]]":
    """(version, services) observed ATOMICALLY: re-reads until the version is
    unchanged across the list call, so callers keying caches by version (the
    planner's grammar cache, the plan cache) never attach one version's
    content to another's key under concurrent registry mutation."""
    v = await registry.version()
    for _ in range(8):
        records = await registry.list_services()
        v2 = await registry.version()
        if v2 == v:
            return v, records
        v = v2
    # Registry churning faster than we can read it: newest observation wins
    # (a later request will re-snapshot).
    return v2, records
