"""Device mesh and sharding layout: the PyTorch port of ``mcpx/parallel/mesh.py``.

The reference drives a named ``jax.sharding.Mesh`` from one process and lets
GSPMD insert the collectives. The port keeps that single-controller design:
a ``Mesh`` is a named grid of ``torch.device``s driven by one process, a
partition spec is a plain tuple (per dimension ``None``, one axis name, or a
tuple of axis names), and ``indices_map`` says which slice of an array each
mesh coordinate holds (``NamedSharding(mesh, spec).devices_indices_map``).

A device may appear at several coordinates: a *virtual mesh* (the
counterpart of ``--xla_force_host_platform_device_count``), on which the
ring's algebra runs in full on one card or on the CPU. Axis layout as in the
reference:

  - ``model`` (TP): attention heads, the MLP hidden dim and the vocab are
    sharded where they divide; MQA keeps KV replicated on ``model``;
  - ``data`` (DP): the batch splits across replicas, and KV caches shard on
    batch over ``data`` and on KV heads over ``model`` where they divide;
  - ``seq``: sequence parallelism (``ring_attention``); ``dcn_data``: the
    outer data axis of a hybrid mesh.

Divisibility-aware: an axis that does not divide its dimension replicates it.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from mcpx_torch.core.errors import ConfigError, EngineError
from mcpx_torch.device import resolve_device
from mcpx_torch.models.gemma.config import GemmaConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"  # sequence/context parallelism (ring attention)
DCN_DATA_AXIS = "dcn_data"  # cross-slice data parallelism (hybrid mesh)

Spec = tuple  # per dimension: None, an axis name, or a tuple of axis names


def canonical(device: "torch.device | str") -> torch.device:
    """``device`` with a CUDA index made explicit, so ``cuda`` and ``cuda:0``
    compare equal (and ``cpu:0`` as ``cpu``, the host's first device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    if dev.type == "cpu" and dev.index == 0:
        return torch.device("cpu")
    return dev


class Mesh:
    """A named grid of devices. ``devices`` is an object ``np.ndarray`` of
    ``torch.device`` whose dimensions are the axes in ``axis_names`` order;
    ``shape`` maps each axis name to its size, in that order."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]) -> None:
        if devices.ndim != len(axis_names):
            raise ConfigError(f"mesh of {devices.ndim} dimensions named {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def distinct_devices(self) -> list[torch.device]:
        """The mesh's devices without repeats, in coordinate order."""
        out: list[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.distinct_devices()})"


def _grid(devices: list, shape: tuple[int, ...]) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        grid[i] = canonical(d)
    return grid.reshape(shape)


def _devices(devices: Optional[Sequence]) -> list:
    """``devices`` as a list; ``None`` is every visible CUDA device (raises
    without CUDA, as every entry point of the port does)."""
    if devices is not None:
        return list(devices)
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(data: int = 1, model: int = 1, seq: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """Named device mesh ``(data, model)``, or ``(data, seq, model)`` when
    ``seq > 1`` (the seq axis sits between the two, as the reference's)."""
    devices = _devices(devices)
    if data * seq * model > len(devices):
        raise ConfigError(
            f"mesh {data}x{seq}x{model} needs {data * seq * model} devices, have {len(devices)}"
        )
    if seq > 1:
        return Mesh(_grid(devices[: data * seq * model], (data, seq, model)), (DATA_AXIS, SEQ_AXIS, MODEL_AXIS))
    return Mesh(_grid(devices[: data * model], (data, model)), (DATA_AXIS, MODEL_AXIS))


def make_hybrid_mesh(dcn_data: int, data: int = 1, model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """Multi-slice mesh ``(dcn_data, data, model)``: data parallelism across
    the outer axis, TP and data parallelism within each slice."""
    devices = _devices(devices)
    need = dcn_data * data * model
    if need > len(devices):
        raise ConfigError(f"hybrid mesh {dcn_data}x{data}x{model} needs {need} devices, have {len(devices)}")
    return Mesh(_grid(devices[:need], (dcn_data, data, model)), (DCN_DATA_AXIS, DATA_AXIS, MODEL_AXIS))


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """Every data-parallel axis of ``mesh`` larger than 1, outer first."""
    return tuple(a for a in (DCN_DATA_AXIS, DATA_AXIS) if mesh.shape.get(a, 1) > 1)


def _axis(mesh: Mesh, axis: str, dim: int) -> Optional[str]:
    """Shard ``dim`` over ``axis`` only when it divides evenly."""
    size = mesh.shape[axis]
    return axis if size > 1 and dim % size == 0 else None


def param_pspecs(cfg: GemmaConfig, mesh: Mesh) -> dict[str, Any]:
    """Spec tree matching ``init_params``'s output."""
    m = lambda dim: _axis(mesh, MODEL_AXIS, dim)  # noqa: E731
    return {
        "embed": (m(cfg.vocab_size), None),
        "layers": {
            "pre_attn_norm": (None, None),
            "pre_mlp_norm": (None, None),
            "wq": (None, None, m(cfg.n_heads), None),
            "wk": (None, None, m(cfg.n_kv_heads), None),
            "wv": (None, None, m(cfg.n_kv_heads), None),
            "wo": (None, m(cfg.n_heads), None, None),
            "w_gate": (None, None, m(cfg.d_ff)),
            "w_up": (None, None, m(cfg.d_ff)),
            "w_down": (None, m(cfg.d_ff), None),
        },
        "final_norm": (None,),
    }


def kv_cache_pspecs(cfg: GemmaConfig, mesh: Mesh, batch: int) -> dict[str, Spec]:
    b = _axis(mesh, DATA_AXIS, batch)
    k = _axis(mesh, MODEL_AXIS, cfg.n_kv_heads)
    spec = (None, b, None, k, None)  # [L, B, S, K, hd]
    return {"k": spec, "v": spec}


def data_pspec(mesh: Mesh, batch: int) -> Spec:
    return (_axis(mesh, DATA_AXIS, batch),)


def replicated(mesh: Mesh) -> Spec:
    return ()


def indices_map(shape: Sequence[int], spec: Spec, mesh: Mesh) -> dict[tuple[int, ...], tuple[slice, ...]]:
    """For each mesh coordinate, the tuple of slices of an array of ``shape``
    that it holds under ``spec``: ``slice(None)`` on a replicated dimension,
    the coordinate's block on a sharded one (several axes on one dimension
    split it major axis first). Raises when a sharded dimension does not
    divide."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if len(spec) != len(shape):
        raise ConfigError(f"spec {spec} has more entries than shape {tuple(shape)}")
    pos = {a: i for i, a in enumerate(mesh.axis_names)}
    out = {}
    for coord in np.ndindex(*mesh.devices.shape):
        idx = []
        for dim, entry in zip(shape, spec):
            axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
            if not axes:
                idx.append(slice(None))
                continue
            ways, block = 1, 0
            for a in axes:
                ways, block = ways * mesh.shape[a], block * mesh.shape[a] + coord[pos[a]]
            if dim % ways:
                raise ConfigError(f"dimension {dim} does not divide over {axes} ({ways} ways)")
            per = dim // ways
            idx.append(slice(block * per, (block + 1) * per))
        out[coord] = tuple(idx)
    return out


class Sharded:
    """A tensor placed over several distinct devices: ``blocks`` maps each
    device to (the slices it holds, the tensor of them)."""

    def __init__(self, shape: tuple[int, ...], spec: Spec, blocks: dict) -> None:
        self.shape, self.spec, self.blocks = tuple(shape), spec, blocks

    def __repr__(self) -> str:
        return f"Sharded(shape={self.shape}, spec={self.spec}, devices={list(self.blocks)})"


def _hull(slices: list[tuple[slice, ...]], shape: Sequence[int]) -> tuple[slice, ...]:
    out = []
    for d, dim in enumerate(shape):
        starts = [s[d].indices(dim)[0] for s in slices]
        stops = [s[d].indices(dim)[1] for s in slices]
        lo, hi = min(starts), max(stops)
        out.append(slice(None) if (lo, hi) == (0, dim) else slice(lo, hi))
    return tuple(out)


def place(x: torch.Tensor, spec: Spec, mesh: Mesh):
    """``x`` placed on ``mesh`` under ``spec``: each device holds the box of
    its coordinates' slices (``indices_map``), copied there with
    ``.to(device, non_blocking=True)``. On a mesh of one device (a virtual
    mesh) that box is the whole tensor, so ``x`` comes back whole on that
    device, never duplicated; over several devices a ``Sharded``."""
    by_device: dict[torch.device, list] = {}
    for coord, idx in indices_map(tuple(x.shape), spec, mesh).items():
        by_device.setdefault(mesh.devices[coord], []).append(idx)
    blocks = {}
    for dev, idxs in by_device.items():
        box = _hull(idxs, x.shape)
        part = x if all(b == slice(None) for b in box) else x[box]
        blocks[dev] = (box, part.to(dev, non_blocking=True))
    if len(blocks) == 1:
        return next(iter(blocks.values()))[1]
    return Sharded(tuple(x.shape), tuple(spec), blocks)


def shard_pytree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """Place a nested dict of tensors on the mesh by a spec tree of the same
    structure."""
    if isinstance(tree, dict):
        return {k: shard_pytree(v, specs[k], mesh) for k, v in tree.items()}
    return place(tree, specs, mesh)


def serving_devices(mesh: Mesh) -> list[torch.device]:
    """The distinct devices of a mesh an entry point serves, in coordinate
    order (``canonical``). A mesh is one device at every coordinate (a
    virtual mesh, on one card or the CPU) or a distinct device at each:
    CUDA cards, or indexed host devices ``cpu:0..n-1`` (as the reference's
    tests' host devices; each copy between them is a real one). ``meta``
    holds no data and a card that is not visible cannot hold any, so both
    raise, naming the device."""
    devices = list(dict.fromkeys(canonical(d) for d in mesh.devices.flat))
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for d in devices:
        if d.type == "meta":
            raise EngineError(f"{mesh}: device meta holds no data; a mesh's coordinates must be cards or the CPU")
        if d.type == "cuda" and d.index >= visible:
            raise EngineError(f"{mesh}: device {d} is not visible ({visible} CUDA device(s) visible)")
    if len(devices) > 1:
        if len({d.type for d in devices}) > 1:
            raise EngineError(f"{mesh}: a mesh over several devices takes CUDA cards or host devices, not both")
        if len(devices) != mesh.devices.size:
            raise EngineError(
                f"{mesh}: {len(devices)} devices at {mesh.devices.size} coordinates; a mesh is one device at "
                "every coordinate or a distinct device at each"
            )
    return devices


def _model_dim(spec: Spec) -> Optional[int]:
    """The dimension a spec shards over ``model``, or None."""
    for d, entry in enumerate(spec):
        if entry == MODEL_AXIS or (isinstance(entry, tuple) and MODEL_AXIS in entry):
            return d
    return None


class AttnShard:
    """One model shard's attention: its query heads ``heads``, the KV heads
    ``kv`` they read (a leading-dim range of the page pools), and the query
    heads per KV head in the shard (``groups``), so its queries are
    ``[B, T, kv[1] - kv[0], groups, hd]``."""

    def __init__(self, heads: tuple[int, int], kv: tuple[int, int], groups: int) -> None:
        self.heads, self.kv, self.groups = heads, kv, groups

    def __repr__(self) -> str:
        return f"AttnShard(heads={self.heads}, kv={self.kv}, groups={self.groups})"


class ServeLayout:
    """What each coordinate of a ``(data, model)`` mesh computes of a Gemma
    forward, as ``param_pspecs`` and ``data_pspec`` place it (the ranges come
    from ``indices_map``, so they agree with the spec trees):

      - ``heads``, ``kv_heads``, ``ff``, ``vocab``: per model coordinate,
        its ``(start, stop)`` of the query heads, KV heads, ``d_ff`` columns
        and vocabulary (the whole range where a dimension does not divide);
      - ``sharded``: leaf name -> the dimension split over ``model``
        (``quant_pspecs`` splits an int8 leaf's codes the same way, and its
        scales unless that dimension is contracted);
      - ``attn``: the distinct attention shards (one when the heads stay
        whole), ``kv_split`` whether each projects and writes KV heads of
        its own (else the KV heads are projected once and every shard reads
        the ones its query heads belong to, as MQA keeps them whole);
        ``n_ff`` and ``n_vocab``: the distinct MLP and vocabulary shards;
      - ``rows(B)``: the distinct row blocks of a batch of ``B`` over
        ``data`` (one block when ``B`` does not divide); block ``j`` runs at
        data coordinate ``j``;
      - ``card(d, m)``: the device of coordinate ``(d, m)`` (the first
        coordinate of any other axis); ``cross``: whether the coordinates
        are distinct devices, cards or host devices (``serving_devices``),
        else every coordinate is the one device of a virtual mesh.
        Coordinate ``(0, 0)`` is the control card: the engine's slab, page
        tables and sampler live there.

    On a virtual mesh every block is computed in turn on the one device; on
    cards each coordinate computes on its own (``parallel/transfer.py``)."""

    def __init__(self, mesh: Mesh, cfg: GemmaConfig, split_rows: bool = True) -> None:
        self.mesh, self.cfg, self.split_rows = mesh, cfg, split_rows
        self.data = mesh.shape.get(DATA_AXIS, 1)
        self.model = mesh.shape.get(MODEL_AXIS, 1)
        self.devices = serving_devices(mesh)
        self.cross = len(self.devices) > 1
        at = [0] * len(mesh.axis_names)
        self._cards: dict[tuple[int, int], torch.device] = {}
        for d in range(self.data):
            for m in range(self.model):
                if DATA_AXIS in mesh.shape:
                    at[mesh.axis_names.index(DATA_AXIS)] = d
                if MODEL_AXIS in mesh.shape:
                    at[mesh.axis_names.index(MODEL_AXIS)] = m
                self._cards[(d, m)] = canonical(mesh.devices[tuple(at)])
        self._local = {m: sorted({m2 for (_, m2), c in self._cards.items() if c == self._cards[(0, m)]}).index(m)
                       for m in range(self.model)}
        specs = param_pspecs(cfg, mesh)
        L, D, H, K, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.heads = self._ranges((L, D, H, hd), specs["layers"]["wq"], 2)
        self.kv_heads = self._ranges((L, D, K, hd), specs["layers"]["wk"], 2)
        self.ff = self._ranges((L, D, cfg.d_ff), specs["layers"]["w_gate"], 2)
        self.vocab = self._ranges((cfg.vocab_size, D), specs["embed"], 0)
        leaves = {"embed": specs["embed"], **specs["layers"]}
        self.sharded = {k: d for k, s in leaves.items() if (d := _model_dim(s)) is not None}
        self.kv_split = len(set(self.kv_heads)) > 1
        self.n_ff = len(set(self.ff))
        self.n_vocab = len(set(self.vocab))
        G = cfg.q_per_kv
        if len(set(self.heads)) == 1:
            self.attn = (AttnShard((0, H), (0, K), G),)
        elif self.kv_split:
            self.attn = tuple(AttnShard(h, k, G) for h, k in zip(self.heads, self.kv_heads))
        else:
            n = H // self.model
            if G % n:
                raise ConfigError(
                    f"{self.model} model shards of {H} query heads in groups of {G}: a shard's heads "
                    "straddle KV heads"
                )
            self.attn = tuple(AttnShard(h, (h[0] // G, h[0] // G + 1), n) for h in self.heads)
        self._rows: dict[int, tuple[tuple[int, int], ...]] = {}
        self._model_only: Optional[ServeLayout] = None

    def _ranges(self, shape: tuple[int, ...], spec: Spec, dim: int) -> tuple[tuple[int, int], ...]:
        pos = self.mesh.axis_names.index(MODEL_AXIS) if MODEL_AXIS in self.mesh.axis_names else None
        out: dict[int, tuple[int, int]] = {}
        for coord, idx in indices_map(shape, spec, self.mesh).items():
            out.setdefault(0 if pos is None else coord[pos], idx[dim].indices(shape[dim])[:2])
        return tuple(out[m] for m in range(self.model))

    def card(self, d: int, m: int) -> torch.device:
        """The device of coordinate ``(d, m)``."""
        return self._cards[(d, m)]

    def coords(self) -> dict[tuple[int, int], torch.device]:
        """Each ``(data, model)`` coordinate's device."""
        return dict(self._cards)

    @property
    def control(self) -> torch.device:
        return self._cards[(0, 0)]

    def local(self, m: int) -> int:
        """Model shard ``m``'s index among the shards its device's tree holds
        (``transfer.tree_at``): every shard on a virtual mesh's device, one
        on each card (``params.on_cards``)."""
        return self._local[m]

    def kv_range(self, card: torch.device) -> Optional[tuple[int, int]]:
        """The KV heads ``card``'s pools hold: the span of the attention
        shards of its coordinates (every head on a virtual mesh), None when
        it computes no attention."""
        spans = [self.attn[m].kv for (d, m), c in self._cards.items() if c == card and m < len(self.attn)]
        if not spans:
            return None
        return min(s[0] for s in spans), max(s[1] for s in spans)

    @property
    def trivial(self) -> bool:
        """Nothing splits: every forward is the unmeshed one."""
        return not self.sharded and (self.data == 1 or not self.split_rows)

    def model_only(self) -> "ServeLayout":
        """The same model shards with the batch kept whole (ring prefill's
        data coordinates are its seq axis)."""
        if not self.split_rows:
            return self
        if self._model_only is None:
            self._model_only = ServeLayout(self.mesh, self.cfg, split_rows=False)
        return self._model_only

    def rows(self, batch: int) -> tuple[tuple[int, int], ...]:
        """The distinct ``(start, stop)`` row blocks of a ``batch``-row array
        under ``data_pspec``, in data order."""
        if batch not in self._rows:
            blocks: list[tuple[int, int]] = []
            if self.split_rows:
                for idx in indices_map((batch,), data_pspec(self.mesh, batch), self.mesh).values():
                    r = idx[0].indices(batch)[:2]
                    if r not in blocks:
                        blocks.append(r)
            self._rows[batch] = tuple(sorted(blocks)) or ((0, batch),)
        return self._rows[batch]

    def signature(self) -> tuple:
        """What a captured window bakes in of the layout."""
        return ("mesh", self.data if self.split_rows else 1, self.model)

    def __repr__(self) -> str:
        return (f"ServeLayout(data={self.data}, model={self.model}, attn={self.attn}, n_ff={self.n_ff}, "
                f"n_vocab={self.n_vocab})")


def serve_layout(mesh: Optional[Mesh], cfg: GemmaConfig) -> Optional[ServeLayout]:
    """The layout of ``mesh``, or None when nothing splits on it."""
    if mesh is None:
        return None
    layout = ServeLayout(mesh, cfg)
    return None if layout.trivial else layout
