from mcpx_torch.registry.base import RegistryBackend, ServiceRecord
from mcpx_torch.registry.memory import InMemoryRegistry

__all__ = ["RegistryBackend", "ServiceRecord", "InMemoryRegistry", "make_registry"]


def make_registry(cfg) -> RegistryBackend:
    """The configured registry backend. The port has the in-memory backend;
    the file and Redis backends are not ported yet."""
    if cfg.backend == "memory":
        return InMemoryRegistry()
    raise ValueError(f"registry backend {cfg.backend!r} is not ported to mcpx_torch yet")
