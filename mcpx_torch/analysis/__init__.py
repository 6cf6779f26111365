"""mcpxlint for the PyTorch port: AST-based static analysis for
async-safety, thread ownership and PyTorch/CUDA hot-path hygiene. See
mcpx_torch/analysis/README.md.

Entry points: ``python -m mcpx_torch.cli lint`` (mcpx_torch/cli/main.py),
the gate over the port's tree (tests/test_torch_mcpxlint.py), and this
package's :func:`scan_paths` API.
"""

from mcpx_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    apply_baseline,
    load_baseline,
    save_baseline,
)
from mcpx_torch.analysis.core import Finding, Rule, ScanResult, all_rules, scan_paths

__all__ = [
    "DEFAULT_BASELINE",
    "Finding",
    "Rule",
    "ScanResult",
    "all_rules",
    "apply_baseline",
    "load_baseline",
    "save_baseline",
    "scan_paths",
]
