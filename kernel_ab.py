"""Times the ragged paged-attention kernel of several checkouts side by side
on one GPU.

    python3 kernel_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository, for instance a ``git archive`` of
an earlier commit unpacked into a gitignored directory. Every tree's kernels
are built first, all at once. Then each tree's ``ragged_paged_attention`` is
timed in a process of its own, in the order given and then reversed
(A B B A), at the batches of ``chip_smoke.py``'s kernel phase, by both
of its methods: back-to-back eager calls (``ms``, host work included) and
device time by CUDA-graph replays (``device_ms``), with the plain version and
one SDPA call beside them. Each process first holds its kernel against the
plain version (atol = rtol = 2e-2). One JSON line per tree and batch, with
the card's name and power limit; a batch whose shape a tree's kernel does
not take (an older kernel's narrower domain) gets a line saying so.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = (
    "import sys; sys.path.insert(0, sys.argv[1]); "
    "from mcpx_torch.engine.kernels import build; build.build_all()"
)


def child(tree: str, run: int) -> None:
    import torch

    import chip_smoke as cs  # from this checkout; mcpx_torch from the tree

    sys.path.insert(0, tree)
    from mcpx_torch.core.errors import EngineError
    from mcpx_torch.engine.kernels.paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_reference,
    )

    card = cs.card_line()
    for cell, G, hd, L, live, psz, pmax in cs.CELLS:
        q, kp, vp, table, starts, q_lens = cs.cell_batch(0, G, hd, L, live, psz, pmax)
        try:
            out = ragged_paged_attention(q, kp, vp, table, starts, q_lens, L - 1)
        except EngineError as e:
            if "unsupported shape" not in str(e):
                raise
            print(json.dumps({"tree": tree, "run": run, "cell": cell, "card": card, "refused": str(e)}))
            continue
        ref = ragged_paged_attention_reference(q, kp, vp, table, starts, q_lens, L - 1)
        err = (out.float() - ref.float()).abs()
        if bool((err > cs.ATOL + cs.RTOL * ref.float().abs()).any()):
            raise SystemExit(f"{tree} {cell}: kernel disagrees with plain version")
        times = cs.kernel_times(q, kp, vp, table, starts, q_lens, L)
        print(json.dumps({
            "tree": tree, "run": run, "cell": cell, "card": card,
            "max_abs_err": float(err.max()), **times,
        }), flush=True)


def main(trees: list[str]) -> int:
    trees = [os.path.abspath(t) for t in trees]
    builds = [subprocess.Popen([sys.executable, "-c", BUILD, t]) for t in trees]
    if any(p.wait() != 0 for p in builds):
        return 1
    failed = 0
    for run, tree in enumerate(trees + trees[::-1]):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree, str(run)]).returncode
        if rc != 0:
            print(json.dumps({"tree": tree, "run": run, "failed": rc}), flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.path.insert(0, HERE)
        child(sys.argv[2], int(sys.argv[3]))
    elif len(sys.argv) < 2:
        sys.exit(__doc__)
    else:
        sys.exit(main(sys.argv[1:]))
