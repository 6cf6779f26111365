"""The port's device mesh and sharding layout (``mcpx_torch/parallel/mesh.py``)
against the reference's (``mcpx/parallel/mesh.py``): the reference runs on the
conftest's 8 virtual CPU devices, the port on a virtual CPU mesh of eight
``cpu`` coordinates. Axes and too-big meshes, every spec tree of the test, 2b
and 7b presets (``param_pspecs``, ``kv_cache_pspecs``, ``quant_pspecs``) as
tuples, ``indices_map`` against ``NamedSharding.devices_indices_map`` for every
leaf coordinate by coordinate, ``batch_axes`` and ``make_hybrid_mesh``; and
the placement: whole tensors on a virtual mesh, blocks over distinct devices
(``meta`` stands in for a second device)."""

import math

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from mcpx.core.errors import ConfigError as JConfigError
from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.models.gemma.quant import quant_pspecs as jquant_pspecs
from mcpx.parallel import mesh as jmesh
from mcpx_torch.core.errors import ConfigError, EngineError
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.model import param_shapes
from mcpx_torch.models.gemma.params import load_or_init
from mcpx_torch.models.gemma.quant import _CONTRACT_AXES, quant_pspecs
from mcpx_torch.parallel import mesh as tmesh

CPU8 = [torch.device("cpu")] * 8
PRESETS = ("test", "2b", "7b")
MESHES = {
    "2x4": (dict(data=2, model=4), None),
    "1x8": (dict(data=1, model=8), None),
    "8x1": (dict(data=8, model=1), None),
    "hybrid2x2x2": (None, dict(dcn_data=2, data=2, model=2)),
}


def _meshes(name):
    flat, hybrid = MESHES[name]
    if flat is not None:
        return jmesh.make_mesh(**flat), tmesh.make_mesh(**flat, devices=CPU8)
    return jmesh.make_hybrid_mesh(**hybrid), tmesh.make_hybrid_mesh(**hybrid, devices=CPU8)


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    assert isinstance(tree, P)
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _shapes(cfg, quantized: bool):
    """Leaf path -> shape of the parameter tree (quantized: int8 codes and
    keepdims scales), from the shapes alone."""
    out = {}
    for name, shape in param_shapes(cfg).items():
        path = name if name in ("embed", "final_norm") else f"layers/{name}"
        if quantized and name in _CONTRACT_AXES:
            out[f"{path}/int8"] = shape
            out[f"{path}/scale"] = tuple(1 if i in _CONTRACT_AXES[name] else d for i, d in enumerate(shape))
        else:
            out[path] = shape
    return out


def test_mesh_axes_and_too_big_meshes():
    assert tmesh.make_mesh(data=2, model=4, devices=CPU8).shape == {"data": 2, "model": 4}
    seq = tmesh.make_mesh(data=1, seq=4, model=2, devices=CPU8)
    assert list(seq.shape.items()) == list(jmesh.make_mesh(data=1, seq=4, model=2).shape.items())
    assert tmesh.make_mesh(seq=1, devices=CPU8).axis_names == ("data", "model")
    with pytest.raises(ConfigError, match="needs 16 devices"):
        tmesh.make_mesh(data=4, model=4, devices=CPU8)
    with pytest.raises(JConfigError, match="needs 16 devices"):
        jmesh.make_mesh(data=4, model=4)
    with pytest.raises(ConfigError, match="hybrid mesh 2x2x4 needs 16 devices"):
        tmesh.make_hybrid_mesh(2, 2, 4, devices=CPU8)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("preset", PRESETS)
def test_spec_trees_equal_the_reference(preset, mesh_name):
    jm, tm_ = _meshes(mesh_name)
    jcfg, cfg = JGemmaConfig.named(preset), GemmaConfig.named(preset)
    assert tmesh.param_pspecs(cfg, tm_) == _tuples(jmesh.param_pspecs(jcfg, jm))
    assert quant_pspecs(cfg, tm_) == _tuples(jquant_pspecs(jcfg, jm))
    if "data" in tm_.shape:
        for batch in (1, 4, 6, 8):
            assert tmesh.kv_cache_pspecs(cfg, tm_, batch) == _tuples(jmesh.kv_cache_pspecs(jcfg, jm, batch))
            assert tmesh.data_pspec(tm_, batch) == _tuples(jmesh.data_pspec(jm, batch))
    assert tmesh.replicated(tm_) == _tuples(jmesh.replicated(jm)) == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("preset", PRESETS)
def test_indices_map_equals_jax_for_every_leaf(preset, mesh_name):
    """Coordinate by coordinate, each leaf's slices are the ones JAX's
    ``NamedSharding`` gives the device at that coordinate."""
    jm, tm_ = _meshes(mesh_name)
    jcfg, cfg = JGemmaConfig.named(preset), GemmaConfig.named(preset)
    cases = [(_shapes(cfg, False), _leaves(tmesh.param_pspecs(cfg, tm_)), _leaves(jmesh.param_pspecs(jcfg, jm))),
             (_shapes(cfg, True), _leaves(quant_pspecs(cfg, tm_)), _leaves(jquant_pspecs(jcfg, jm)))]
    if "data" in tm_.shape:
        kv = (cfg.n_layers, 8, 64, cfg.n_kv_heads, cfg.head_dim)
        cases.append(({"k": kv, "v": kv}, tmesh.kv_cache_pspecs(cfg, tm_, 8), jmesh.kv_cache_pspecs(jcfg, jm, 8)))
    for shapes, specs, jspecs in cases:
        assert set(shapes) == set(specs) == set(jspecs)
        for path, shape in shapes.items():
            got = tmesh.indices_map(shape, specs[path], tm_)
            want = NamedSharding(jm, jspecs[path]).devices_indices_map(shape)
            assert len(got) == len(want) == math.prod(jm.devices.shape)
            for coord in np.ndindex(*jm.devices.shape):
                assert got[coord] == tuple(want[jm.devices[coord]]), (path, coord)


def test_indices_map_splits_several_axes_major_first_and_refuses_a_remainder():
    hybrid = tmesh.make_hybrid_mesh(2, 2, 2, devices=CPU8)
    jm = jmesh.make_hybrid_mesh(2, 2, 2)
    spec = (("dcn_data", "data"), None)
    got = tmesh.indices_map((8, 3), spec, hybrid)
    want = NamedSharding(jm, P(("dcn_data", "data"), None)).devices_indices_map((8, 3))
    for coord in np.ndindex(2, 2, 2):
        assert got[coord] == tuple(want[jm.devices[coord]])
    assert got[(1, 0, 1)] == (slice(4, 6), slice(None))
    with pytest.raises(ConfigError, match="does not divide"):
        tmesh.indices_map((6, 3), spec, hybrid)


def test_batch_axes_and_hybrid_mesh():
    hybrid = tmesh.make_hybrid_mesh(dcn_data=2, data=2, model=2, devices=CPU8)
    assert hybrid.shape == dict(jmesh.make_hybrid_mesh(dcn_data=2, data=2, model=2).shape)
    assert list(hybrid.shape) == ["dcn_data", "data", "model"]
    for t, j in (
        (hybrid, jmesh.make_hybrid_mesh(dcn_data=2, data=2, model=2)),
        (tmesh.make_hybrid_mesh(dcn_data=2, data=1, model=4, devices=CPU8),
         jmesh.make_hybrid_mesh(dcn_data=2, data=1, model=4)),
        (tmesh.make_mesh(data=4, model=2, devices=CPU8), jmesh.make_mesh(data=4, model=2)),
        (tmesh.make_mesh(data=1, model=8, devices=CPU8), jmesh.make_mesh(data=1, model=8)),
    ):
        assert tmesh.batch_axes(t) == jmesh.batch_axes(j)
    assert tmesh.batch_axes(hybrid) == ("dcn_data", "data")


def test_shard_pytree_keeps_weights_whole_on_a_virtual_mesh():
    """Every leaf of a virtual mesh is the tensor itself (no copy, never a
    duplicate), int8 leaves too. ``load_or_init(mesh=)`` holds the same
    values, the leaves split over ``model`` laid out shard-major
    (``params.shard_major``): put back in their dimension, equal."""
    cfg = GemmaConfig(vocab_size=384, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
                      dtype="float32")
    params, _ = load_or_init(cfg, seed=3, device="cpu")
    mesh = tmesh.make_mesh(data=2, model=4, devices=CPU8)
    placed = tmesh.shard_pytree(params, tmesh.param_pspecs(cfg, mesh), mesh)
    flat, got = _leaves(params), _leaves(placed)
    assert set(flat) == set(got) and all(got[k] is flat[k] for k in flat)
    meshed, _ = load_or_init(cfg, seed=3, mesh=mesh, quantize="int8", device="cpu")
    plain, _ = load_or_init(cfg, seed=3, quantize="int8", device="cpu")
    layout = tmesh.ServeLayout(mesh, cfg)
    assert set(layout.sharded) == {"embed", "wq", "wo", "w_gate", "w_up", "w_down"}  # K 2 does not divide 4
    for k, v in _leaves(plain).items():
        parts = k.split("/")
        part = parts[-1] if parts[-1] in ("int8", "scale") else ""
        name = parts[-2] if part else parts[-1]
        dim = layout.sharded.get(name)
        got_k = _leaves(meshed)[k]
        if dim is not None and (part == "int8" or dim not in _CONTRACT_AXES[name]):
            lead = 0 if name == "embed" else 1
            got_k = got_k.movedim(lead, dim).flatten(dim, dim + 1)
        assert torch.equal(got_k, v), k


def test_shard_pytree_places_blocks_over_distinct_devices():
    """``meta`` as a second device: each device holds the box of its
    coordinates' slices (rows split over ``model``, replicated over
    ``data``)."""
    mesh = tmesh.make_mesh(data=2, model=2, devices=["cpu", "meta", "cpu", "meta"])
    x = torch.arange(24.0).reshape(8, 3)
    placed = tmesh.shard_pytree({"w": x, "b": x[0]}, {"w": ("model", None), "b": (None,)}, mesh)
    w = placed["w"]
    assert isinstance(w, tmesh.Sharded) and w.shape == (8, 3)
    (cpu_box, cpu_part), (meta_box, meta_part) = w.blocks[torch.device("cpu")], w.blocks[torch.device("meta")]
    assert cpu_box == (slice(0, 4), slice(None)) and torch.equal(cpu_part, x[:4])
    assert meta_box == (slice(4, 8), slice(None)) and meta_part.device.type == "meta" and meta_part.shape == (4, 3)
    assert set(placed["b"].blocks) == {torch.device("cpu"), torch.device("meta")}


def test_weights_on_another_device_are_refused():
    cfg = GemmaConfig(vocab_size=384, d_model=64, n_layers=1, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                      dtype="float32")
    for devices, named in ((["cpu", "meta"], "device meta holds no data"),
                           ([torch.device("cuda", 1)] * 2, "device cuda:1 is not visible")):
        with pytest.raises(EngineError, match=named):
            load_or_init(cfg, seed=0, device="cpu", mesh=tmesh.make_mesh(model=2, devices=devices))


def test_make_mesh_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EngineError, match="CUDA is not available"):
        tmesh.make_mesh()
    with pytest.raises(EngineError, match="CUDA is not available"):
        tmesh.make_hybrid_mesh(1)
