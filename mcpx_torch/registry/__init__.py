from mcpx_torch.registry.base import RegistryBackend, ServiceRecord
from mcpx_torch.registry.memory import InMemoryRegistry
from mcpx_torch.registry.file import FileRegistry

__all__ = ["RegistryBackend", "ServiceRecord", "InMemoryRegistry", "FileRegistry", "make_registry"]


def make_registry(cfg) -> RegistryBackend:
    """Construct the configured registry backend (lazy: no I/O until used)."""
    if cfg.backend == "memory":
        return InMemoryRegistry()
    if cfg.backend == "file":
        return FileRegistry(cfg.file_path)
    if cfg.backend == "redis":
        from mcpx_torch.registry.redis_backend import RedisRegistry

        return RedisRegistry(cfg.redis_url, prefix=cfg.prefix)
    raise ValueError(f"unknown registry backend {cfg.backend!r}")
