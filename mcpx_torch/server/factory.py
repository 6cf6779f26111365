"""Application factory: config -> wired ControlPlane on a device.

Trimmed PyTorch-port copy of ``mcpx/server/factory.py`` for
``planner.kind`` in {"llm", "heuristic"} over the in-memory registry.
``device=None`` means the GPU and raises without CUDA; pass ``device="cpu"``
for the plain PyTorch path.
"""

from __future__ import annotations

from typing import Optional

import torch

from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.core.errors import ConfigError
from mcpx_torch.device import resolve_device
from mcpx_torch.planner.base import Planner
from mcpx_torch.planner.heuristic import HeuristicPlanner
from mcpx_torch.registry import make_registry
from mcpx_torch.registry.base import RegistryBackend
from mcpx_torch.retrieval.index import RetrievalIndex
from mcpx_torch.server.control import ControlPlane


def build_control_plane(
    config: Optional[MCPXConfig] = None,
    *,
    registry: Optional[RegistryBackend] = None,
    planner: Optional[Planner] = None,
    retriever=None,
    device: "torch.device | str | None" = None,
) -> ControlPlane:
    config = config or MCPXConfig()
    config.validate()
    device = resolve_device(device)
    registry = registry if registry is not None else make_registry(config.registry)
    if retriever is None and config.retrieval.enabled:
        retriever = RetrievalIndex(config.retrieval)
    if planner is None:
        if config.planner.kind == "heuristic":
            planner = HeuristicPlanner(config.planner)
        elif config.planner.kind == "llm":
            from mcpx_torch.planner.llm import LLMPlanner

            planner = LLMPlanner.from_config(config, retriever=retriever, device=device)
        else:
            raise ConfigError(
                f"planner.kind={config.planner.kind!r} is not ported to mcpx_torch yet"
            )
    return ControlPlane(config=config, registry=registry, planner=planner, retriever=retriever)
