"""Per-executable cost accounting + the capture sentinel (the roofline cost
observatory's data plane).

PyTorch-port counterpart of ``mcpx/telemetry/costs.py``. The reference
wraps each ``jax.jit`` callable and reads XLA's ``cost_analysis()``; the
port has no compiler to ask, so its costs are analytic (``cost_basis:
"analytic"``), from one documented function of the model config and the
call's shape (:func:`forward_cost`), computed on the host when a key is
first seen. The device is never read for them.

  - An *executable* is one body of the engine: ``prefill`` (dense
    prefill), ``suffix_prefill``, ``admit`` (the first sample),
    ``window`` (a decode window, plain, drafted, heterogeneous or
    speculative: the body is part of its key; :func:`window_cost`) and,
    with the tiered KV cache on, ``spill_gather`` and ``spill_readmit``
    (the page-run copies, eager, keyed by their page count;
    :func:`spill_copy_cost`). A *signature* is its capture or shape key.
  - **Capture sentinel**: a key seen for the first time is a compile: on
    CUDA a decode window is captured into a CUDA graph exactly then, on
    the CPU it is its first eager run; the eager executables (prefill,
    suffix prefill, first sample) count the first run of a shape on
    either device. It increments
    ``mcpx_engine_compiles_total{executable}`` and logs the key's delta
    against the previous one, at INFO during startup and at WARNING once
    the engine serves (``arm()``): a stream of those lines names the key
    element that churns.
  - ``snapshot()`` is the ``GET /costs`` body's ``engine`` block, in the
    reference's JSON shape: per-executable compile counts and per-signature
    costs and calls, and the executed-work totals (Σ cost × calls) whose
    deltas give a timed phase's FLOPs and bytes.
  - Disabled (``telemetry.cost_accounting=false``) ``record`` does nothing
    and the snapshot is empty.

Roofline helpers (:func:`device_peaks`, :func:`roofline`) turn executed
FLOPs/bytes and wall time into achieved rates and a roofline position
against the card's datasheet peaks; :func:`hbm_stats` and
:func:`update_hbm_gauges` expose the CUDA caching allocator's numbers as
the ``mcpx_hbm_bytes_*`` gauges.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional

log = logging.getLogger("mcpx_torch.costs")

__all__ = [
    "CostRegistry",
    "device_peaks",
    "forward_cost",
    "hbm_stats",
    "roofline",
    "rounded_roofline",
    "spill_copy_cost",
    "update_hbm_gauges",
    "window_cost",
]

# bf16 dense FLOP/s and HBM bytes/s per card, by device-name substring:
# datasheet numbers (NVIDIA H100 SXM at its 700 W limit). Peaks are only
# reported for recognised hardware; any other device reports None.
_GPU_PEAKS: tuple[tuple[str, float, float], ...] = (("H100", 989.4e12, 3.35e12),)


def device_peaks() -> dict:
    """Datasheet peaks of the visible CUDA devices (None on the CPU and on
    cards not in the table)."""
    import torch

    cuda = torch.cuda.is_available()
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    out: dict[str, Any] = {
        "device_kind": name,
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "flops_per_chip": None,
        "hbm_bytes_s_per_chip": None,
        "basis": None,
    }
    for sub, flops, bw in _GPU_PEAKS:
        if cuda and sub in name:
            out["flops_per_chip"] = flops
            out["hbm_bytes_s_per_chip"] = bw
            out["basis"] = "datasheet"
            break
    return out


def hbm_stats() -> list[dict]:
    """Per-device allocator snapshot (bytes in use / limit / peak). Without
    CUDA: ``available: false``, never a guess."""
    import torch

    if not torch.cuda.is_available():
        return [{"device": "cpu", "available": False}]
    out: list[dict] = []
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        out.append(
            {
                "device": f"cuda:{i}",
                "available": True,
                "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
                "bytes_limit": torch.cuda.mem_get_info(i)[1],
                "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
            }
        )
    return out


def update_hbm_gauges(metrics: Any) -> None:
    """Refresh the ``mcpx_hbm_bytes_*`` gauges (scrape time: ``GET
    /metrics`` and ``GET /costs`` call it when an engine is ready)."""
    for row in hbm_stats():
        if not row.get("available"):
            continue
        dev = row["device"]
        metrics.hbm_bytes_in_use.labels(device=dev).set(row["bytes_in_use"])
        metrics.hbm_bytes_limit.labels(device=dev).set(row["bytes_limit"])


def roofline(
    flops: Optional[float],
    bytes_accessed: Optional[float],
    wall_s: float,
    *,
    peak_flops: Optional[float] = None,
    peak_bytes_s: Optional[float] = None,
) -> dict:
    """Achieved rates + roofline position for ``flops``/``bytes_accessed``
    of work done in ``wall_s`` seconds. Keys are only present when their
    inputs are: no peak -> no ``mfu``/``bound`` (never a made-up one)."""
    out: dict[str, Any] = {}
    if wall_s <= 0:
        return out
    if flops:
        out["achieved_flops_s"] = flops / wall_s
        if peak_flops:
            out["mfu"] = flops / wall_s / peak_flops
    if bytes_accessed:
        out["achieved_bytes_s"] = bytes_accessed / wall_s
        if peak_bytes_s:
            out["hbm_bw_util"] = bytes_accessed / wall_s / peak_bytes_s
    if flops and bytes_accessed:
        out["arithmetic_intensity"] = flops / bytes_accessed
        if peak_flops and peak_bytes_s:
            ridge = peak_flops / peak_bytes_s
            out["ridge_ai"] = ridge
            out["bound"] = "memory" if out["arithmetic_intensity"] < ridge else "compute"
    return out


# Report precision per roofline key: one contract shared by the engine's
# span attrs and every phase that reads the totals.
_ROOFLINE_ROUNDING = {
    "achieved_flops_s": 1,
    "achieved_bytes_s": 1,
    "arithmetic_intensity": 3,
    "ridge_ai": 3,
    "mfu": 6,
    "hbm_bw_util": 6,
}


def rounded_roofline(
    flops: Optional[float],
    bytes_accessed: Optional[float],
    wall_s: float,
    *,
    peak_flops: Optional[float] = None,
    peak_bytes_s: Optional[float] = None,
) -> dict:
    """:func:`roofline` at report precision (floats coerced so numpy
    scalars can't leak into json.dumps consumers like /traces)."""
    rl = roofline(
        float(flops) if flops is not None else None,
        float(bytes_accessed) if bytes_accessed is not None else None,
        float(wall_s),
        peak_flops=peak_flops,
        peak_bytes_s=peak_bytes_s,
    )
    return {
        k: (round(v, _ROOFLINE_ROUNDING[k]) if k in _ROOFLINE_ROUNDING else v)
        for k, v in rl.items()
    }


# ------------------------------------------------------------ analytic costs
def forward_cost(
    cfg: Any,
    *,
    batch: int,
    width: int,
    context: int,
    unembed_rows: int,
    unembed_cols: int,
    forwards: int = 1,
    elt_bytes: int = 2,
    quantized: bool = False,
) -> tuple[float, float]:
    """(FLOPs, bytes) of ``forwards`` model forwards over ``batch`` rows of
    ``width`` token slots each, as the port computes them:

      - every slot goes through the projections and the MLP, idle rows and
        pads included: ``2 * batch * width`` FLOPs per matmul weight;
      - attention: ``4 * head_dim`` FLOPs per (query head, query slot,
        context position), over ``context`` positions per row: the page
        table's full span for a paged forward (the most a row can attend,
        so an upper bound of what a ragged launch does), the bucket width
        for a dense prefill (what its masked einsum computes);
      - the tied unembedding: ``2 * d_model`` FLOPs per (row, column);

    and bytes: the layer weights and the unembedded embedding rows read
    once, every slot's embedding row read, each row's K and V over
    ``context`` read and every slot's K and V written, the fp32 logits
    written, at ``elt_bytes`` per weight and cache element. With
    ``quantized`` (int8 weights, ``models/gemma/quant.py``) a weight is one
    byte, plus a 4-byte scale per output channel of each matrix and per
    embedding row read; the cache stays at ``elt_bytes``."""
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L, Fd = cfg.n_layers, cfg.d_ff
    slots = batch * width
    layer_weights = D * H * hd + 2 * D * K * hd + H * hd * D + 3 * D * Fd
    flops = (
        2.0 * slots * layer_weights * L
        + 4.0 * slots * H * hd * context * L
        + 2.0 * unembed_rows * unembed_cols * D
    )
    embed_rows = unembed_cols + slots
    if quantized:
        # Output channels: wq H*hd, wk and wv K*hd, wo D, w_gate and w_up F,
        # w_down D.
        layer_scales = H * hd + 2 * K * hd + 2 * D + 2 * Fd
        weight_bytes = layer_weights * L + 4.0 * layer_scales * L + embed_rows * (D + 4.0)
    else:
        weight_bytes = (layer_weights * L + embed_rows * D) * elt_bytes
    nbytes = (
        weight_bytes
        + 2.0 * batch * context * K * hd * L * elt_bytes
        + 2.0 * slots * K * hd * L * elt_bytes
        + 4.0 * unembed_rows * unembed_cols
    )
    return forwards * flops, forwards * nbytes


def spill_copy_cost(cfg: Any, *, pages: int, page_size: int, elt_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one tier copy of a ``pages``-page run (a spill's
    gather to the host or a readmit's copy back into the pools): no
    arithmetic, and the run's K and V, every layer, read once and written
    once."""
    run = 2.0 * cfg.n_kv_heads * cfg.n_layers * pages * page_size * cfg.head_dim * elt_bytes
    return 0.0, 2.0 * run


def window_cost(
    cfg: Any, body: str, *, batch: int, width: int, context: int, columns: int, forwards: int,
    quantized: bool = False,
) -> tuple[float, float]:
    """(FLOPs, bytes) of one decode window of ``body`` (the engine's window
    key): :func:`forward_cost` of its ``forwards`` forwards over the whole
    slab at the window's ``width``, each row attending ``context``
    positions, with the body's unembedding:

      - ``draft`` (prompt drafting): every slot over the grammar's
        ``columns`` (the compact unembed);
      - ``fast`` and ``hetero`` (fast-forward, homogeneous or per row): one
        slot a row over the vocabulary;
      - ``spec`` (speculative, ``width`` = K + 1): every slot over the
        vocabulary, plus the drafter's K scoring products a row and
        forward (``drafter_flops_per_token`` each), each reading the
        embedding table (int8 rows and their scales with ``quantized``) and
        writing [batch, V] fp32 scores."""
    from mcpx_torch.engine.speculative import drafter_flops_per_token

    V, D = cfg.vocab_size, cfg.d_model
    every_slot = body in ("draft", "spec")
    flops, nbytes = forward_cost(
        cfg, batch=batch, width=width, context=context,
        unembed_rows=batch * width if every_slot else batch,
        unembed_cols=columns if body == "draft" else V, forwards=forwards, quantized=quantized,
    )
    if body == "spec":
        drafts = forwards * (width - 1)
        table = V * (D + 4.0) if quantized else V * D * 2
        flops += drafts * batch * drafter_flops_per_token(D, V)
        nbytes += drafts * (table + 4.0 * batch * V)
    return flops, nbytes


# ------------------------------------------------------------ registry
def _exact(v: Optional[float]) -> float:
    """A cost as an exact integer when it is integral (None counts 0), so
    executed totals sum without rounding past 2**53."""
    if v is None:
        return 0
    return int(v) if float(v).is_integer() else v


def _sig_delta(old: tuple, new: tuple) -> str:
    """Which elements of a key changed: the sentinel's log payload."""
    if len(old) != len(new):
        return f"arity {len(old)} -> {len(new)}"
    deltas = [f"[{i}] {a!r} -> {b!r}" for i, (a, b) in enumerate(zip(old, new)) if a != b]
    return "; ".join(deltas) or "structure changed"


@dataclass
class ExecCost:
    """One (executable, signature)'s cost facts and call count, in the
    reference's ``to_dict`` shape."""

    signature: str
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    cost_basis: str = "analytic"
    calls: int = 0

    def to_dict(self) -> dict:
        return {
            "signature": self.signature,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "temp_bytes": None,
            "argument_bytes": None,
            "output_bytes": None,
            "cost_basis": self.cost_basis,
            "calls": self.calls,
        }


class CostRegistry:
    """The engine's executables: the capture sentinel, the per-signature
    cost table and the executed-work totals. ``record`` runs on the engine
    worker thread; ``snapshot`` reads from any thread."""

    def __init__(self, metrics: Any = None, *, enabled: bool = True, name: str = "engine") -> None:
        self.enabled = enabled
        self.name = name
        self._metrics = metrics
        self._lock = threading.Lock()
        # executable -> {key: ExecCost}, in first-seen order; last key seen.
        self._entries: dict[str, dict[tuple, ExecCost]] = {}
        self._last: dict[str, tuple] = {}
        # executable -> (FLOPs, bytes) executed, Σ cost × calls, kept as
        # exact integers while the costs are integral (the analytic ones
        # always are): the cost ledger apportions these deltas, so its
        # bills add up exactly to the executed totals. A tuple is swapped
        # in whole per record (a GIL-atomic write; any thread may copy).
        self._executed: dict[str, tuple] = {}
        # Before arm(), at startup, new keys are the expected cold path and
        # log at INFO; after it every new key is a capture in the serving
        # path and logs at WARNING. The counter increments either way.
        self.armed = False

    def arm(self) -> None:
        self.armed = True

    def record(
        self, name: str, key: tuple, cost: Callable[[], tuple[float, float]]
    ) -> Optional[ExecCost]:
        """Count one run of ``name`` at ``key``; on the key's first run
        compute its cost with ``cost()`` and count a compile. Returns the
        entry (None while disabled)."""
        if not self.enabled:
            return None
        entries = self._entries.get(name)
        entry = entries.get(key) if entries is not None else None
        if entry is None:
            entry = self._on_compile(name, key, cost)
        entry.calls += 1
        f, b = self._executed.get(name, (0, 0))
        self._executed[name] = (f + _exact(entry.flops), b + _exact(entry.bytes_accessed))
        return entry

    def _on_compile(self, name: str, key: tuple, cost: Callable[[], tuple[float, float]]) -> ExecCost:
        flops, nbytes = cost()
        entry = ExecCost(signature=repr(key), flops=float(flops), bytes_accessed=float(nbytes))
        with self._lock:
            entries = self._entries.setdefault(name, {})
            last = self._last.get(name)
            entries[key] = entry
            self._last[name] = key
        if self._metrics is not None:
            self._metrics.engine_compiles.labels(executable=name).inc()
        if last is None:
            log.info("%s executable '%s' compiling signature #1 %s", self.name, name, entry.signature)
        elif not self.armed:
            log.info(
                "%s executable '%s' compiling signature #%d (startup): %s",
                self.name, name, len(entries), _sig_delta(last, key),
            )
        else:
            log.warning(
                "%s executable '%s' RETRACED in the serving path (compile #%d): %s",
                self.name, name, len(entries), _sig_delta(last, key),
            )
        return entry

    def entry(self, name: str, key: tuple) -> Optional[ExecCost]:
        """The entry of ``name`` at ``key``, if it has run."""
        entries = self._entries.get(name)
        return entries.get(key) if entries is not None else None

    def executed(self) -> dict[str, tuple]:
        """(FLOPs, bytes) executed so far per executable, Σ cost × calls:
        exact integers while the costs are integral."""
        return dict(self._executed)

    def totals(self) -> tuple[float, float]:
        """(FLOPs, bytes) executed so far: Σ cost × calls over every
        executable (exact integers while the costs are integral)."""
        flops = nbytes = 0
        for f, b in self.executed().values():
            flops += f
            nbytes += b
        return flops, nbytes

    def snapshot(self, materialize: bool = True) -> dict:
        """The ``GET /costs`` ``engine`` block, in the reference's shape.
        ``materialize`` is accepted for its signature: analytic costs exist
        from a key's first run."""
        del materialize
        with self._lock:
            tracked = {n: list(es.values()) for n, es in self._entries.items()}
        executables: dict[str, Any] = {}
        for name, entries in tracked.items():
            executables[name] = {
                "compiles": len(entries),
                "signatures": [e.to_dict() for e in entries],
            }
        flops, nbytes = self.totals()
        return {
            "enabled": self.enabled,
            "executables": executables,
            "totals": {
                "flops_executed": flops,
                "bytes_executed": nbytes,
                "unaccounted_calls": 0,
            },
        }
