"""The file and Redis registry backends of the port against the reference's,
on the CPU: the same operations on both packages' backends give the same
records, versions and files; ``RedisRegistry`` runs over the in-memory
``FakeAsyncRedis`` each package ships (``redis`` is optional), and ``make_registry`` dispatches as the reference's does."""

import asyncio
import json
from types import SimpleNamespace

import pytest

from mcpx.core.config import RegistryConfig as JRegistryConfig
from mcpx.core.errors import RegistryError as JRegistryError
from mcpx.registry import FileRegistry as JFileRegistry, make_registry as jmake_registry
from mcpx.registry.base import ServiceRecord as JRecord
from mcpx.registry.redis_backend import RedisRegistry as JRedisRegistry
from mcpx.telemetry.mirror import FakeAsyncRedis as JFakeRedis
from mcpx.utils.synth import synth_registry as jsynth
from mcpx_torch.core.config import RegistryConfig
from mcpx_torch.core.errors import RegistryError
from mcpx_torch.registry import FileRegistry, make_registry
from mcpx_torch.registry.base import ServiceRecord
from mcpx_torch.registry.redis_backend import RedisRegistry
from mcpx_torch.telemetry.mirror import FakeAsyncRedis

PKGS = {
    "reference": SimpleNamespace(
        file=JFileRegistry, redis=JRedisRegistry, fake=JFakeRedis, record=JRecord, error=JRegistryError,
        make=jmake_registry, config=JRegistryConfig,
    ),
    "port": SimpleNamespace(
        file=FileRegistry, redis=RedisRegistry, fake=FakeAsyncRedis, record=ServiceRecord, error=RegistryError,
        make=make_registry, config=RegistryConfig,
    ),
}


def _records(pkg, n: int = 6):
    return [pkg.record.from_dict(r.to_dict()) for r in jsynth(n, seed=3)]


async def _crud(pkg, reg) -> list:
    """One script of operations; what each step reads back."""
    recs = _records(pkg)
    seen = [await reg.version(), [r.name for r in await reg.list_services()]]
    for rec in recs[:4]:
        await reg.put(rec)
    seen += [await reg.version(), [r.to_dict() for r in await reg.list_services()]]
    seen += [await reg.delete(recs[1].name), await reg.delete("ghost"), await reg.version()]
    got = await reg.get(recs[2].name)
    seen += [got.to_dict() if got else None, await reg.get(recs[1].name)]
    await reg.put(recs[4])
    seen += [await reg.version(), [r.name for r in await reg.list_services()]]
    return seen


@pytest.mark.parametrize("backend", ["file", "redis"])
def test_backend_operations_match_reference(tmp_path, backend):
    outs, files = {}, {}
    for name, pkg in PKGS.items():
        if backend == "file":
            path = tmp_path / f"{name}.json"
            path.write_text("[]")
            reg = pkg.file(str(path))
        else:
            reg = pkg.redis("redis://unused", prefix="mcp:service:")
            reg._client = pkg.fake()
        outs[name] = asyncio.run(_crud(pkg, reg))
        files[name] = path.read_text() if backend == "file" else sorted(reg._client._data.items())
    assert outs["port"] == outs["reference"]
    assert files["port"] == files["reference"]


def test_file_registry_round_trip_across_packages(tmp_path):
    """A file either package writes serves in the other: the records of
    ``gen-registry``'s format, a put flushed and read by a fresh instance."""
    path = tmp_path / "reg.json"
    path.write_text(json.dumps([r.to_dict() for r in jsynth(5, seed=7)]))

    async def run():
        reg = FileRegistry(str(path))
        assert [r.name for r in await reg.list_services()] == sorted(r.name for r in jsynth(5, seed=7))
        await reg.put(ServiceRecord(name="zz-extra", endpoint="local://zz", description="extra"))
        ref = JFileRegistry(str(path))
        names = [r.name for r in await ref.list_services()]
        assert names[-1] == "zz-extra" and len(names) == 6
        await ref.delete("zz-extra")
        again = FileRegistry(str(path))
        return [r.to_dict() for r in await again.list_services()], await again.version()

    records, version = asyncio.run(run())
    assert len(records) == 5 and version == 5


@pytest.mark.parametrize("package", list(PKGS))
def test_file_registry_missing_or_malformed_file(tmp_path, package):
    pkg = PKGS[package]

    async def run(path):
        with pytest.raises(pkg.error) as e:
            await pkg.file(path).list_services()
        return str(e.value).replace(str(tmp_path), "")

    missing = asyncio.run(run(str(tmp_path / "nope.json")))
    assert "not found" in missing
    (tmp_path / "obj.json").write_text('{"name": "a"}')
    (tmp_path / "bad.json").write_text("[{")
    assert "must hold a JSON list" in asyncio.run(run(str(tmp_path / "obj.json")))
    assert "cannot read" in asyncio.run(run(str(tmp_path / "bad.json")))


def test_redis_registry_reads_the_reference_key_layout():
    """A registry the reference wrote to Redis reads as-is in the port, and
    the client is built lazily: without the ``redis`` package the first
    operation raises ``RegistryError`` naming the option, in both."""

    async def run():
        ref = JRedisRegistry("redis://unused")
        ref._client = fake = FakeAsyncRedis()
        for rec in jsynth(4, seed=1):
            await ref.put(rec)
        port = RedisRegistry("redis://unused")
        port._client = fake
        return [r.to_dict() for r in await port.list_services()], await port.version()

    records, version = asyncio.run(run())
    assert [r["name"] for r in records] == sorted(r.name for r in jsynth(4, seed=1)) and version == 4
    for pkg in PKGS.values():
        with pytest.raises(pkg.error, match="registry.backend=redis"):
            asyncio.run(pkg.redis("redis://unused").version())


@pytest.mark.parametrize("backend", ["memory", "file", "redis", "etcd"])
def test_make_registry_dispatch_matches_reference(tmp_path, backend):
    kinds = {}
    for name, pkg in PKGS.items():
        cfg = pkg.config(backend=backend, file_path=str(tmp_path / "r.json"), redis_url="redis://unused")
        try:
            reg = pkg.make(cfg)
        except ValueError as e:
            kinds[name] = ("ValueError", str(e))
            continue
        kinds[name] = (type(reg).__name__, getattr(reg, "_path", None), getattr(reg, "_prefix", None))
    assert kinds["port"] == kinds["reference"]
    if backend == "etcd":
        assert kinds["port"][0] == "ValueError"
