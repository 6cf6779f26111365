"""Built-in mcpxlint rules. Importing this package registers every rule
with the core registry; add a module here (and import it below) to ship a
new rule — see mcpx_torch/analysis/README.md."""

from mcpx_torch.analysis.rules import (  # noqa: F401
    async_rules,
    cache_rules,
    graph_contract_rules,
    io_rules,
    loop_rules,
    metrics_rules,
    ownership_rules,
    resilience_rules,
    sharding_rules,
    style_rules,
    torch_rules,
    tracing_rules,
    transfer_rules,
)
