"""Cluster layer: a multi-replica engine pool behind the single-engine
duck surface, a scored routing pipeline (queue/ETA baseline, prefix-locality
affinity, cost/burn-aware placement), replica lifecycle
(spawn/warm/drain/kill/rejoin with warm-restart snapshots), and row-sharded
registry retrieval.

The PyTorch port of ``mcpx.cluster``, with the reference's exports.
``cluster.enabled=false`` (the default) builds none of this — the factory's
single bare engine path is unchanged. ``ShardedRetrievalIndex`` lives in
``mcpx_torch.cluster.sharding``.
"""

from mcpx_torch.cluster.pool import ClusterPin, EnginePool
from mcpx_torch.cluster.replica import ReplicaHandle
from mcpx_torch.cluster.routing import (
    CostBurnPolicy,
    PrefixAffinityPolicy,
    QueueDepthPolicy,
    RoundRobinPolicy,
    RouteRequest,
    RoutingPipeline,
    affinity_key,
    build_pipeline,
    rendezvous_choice,
)

__all__ = [
    "ClusterPin",
    "CostBurnPolicy",
    "EnginePool",
    "PrefixAffinityPolicy",
    "QueueDepthPolicy",
    "ReplicaHandle",
    "RoundRobinPolicy",
    "RouteRequest",
    "RoutingPipeline",
    "affinity_key",
    "build_pipeline",
    "rendezvous_choice",
]
