"""Times the ragged paged-attention kernel of several checkouts side by side
on one GPU.

    python3 kernel_ab.py [--only PATTERN[,PATTERN ...]] TREE [TREE ...]

Each TREE is a checkout of this repository, for instance a ``git archive`` of
an earlier commit unpacked into a gitignored directory. Every tree's kernels
are built first, all at once. Then each tree's ``ragged_paged_attention`` is
timed in a process of its own, in the order given and then reversed
(A B B A), at the batches of ``chip_smoke.py``'s kernel phase and at the
rows of ``EXTRA`` (phase 28's one-token steps and long tables), by both
of its methods: back-to-back eager calls (``ms``, host work included) and
device time by CUDA-graph replays (``device_ms``), with the plain version and
one SDPA call beside them. Each process first holds its kernel against the
plain version (atol = rtol = 2e-2). One JSON line per tree and batch, with
the card's name and power limit, the bound (``chip_smoke.attention_bound``)
and the launch's design, grid and span (``launch_plan``); a batch whose
shape a tree's kernel does not take (an older kernel's narrower domain)
gets a line saying so. With ``--only``, only the rows whose cell name
matches one of the shell-style PATTERNs run (``test,2b,*mix*,*long*``).
"""

from __future__ import annotations

import fnmatch
import json
import os
import random
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = (
    "import sys; sys.path.insert(0, sys.argv[1]); "
    "from mcpx_torch.engine.kernels import build; build.build_all()"
)

PRESETS = (("test", 4, 32, 2), ("2b", 8, 256, 18))  # (cell prefix, G, hd, L)
# (cell, G, hd, L, kind, B, S, Psz, Pmax) beside chip_smoke's CELLS:
# ``step`` is phase 28's one-token step (B 8, S 1, 64-token pages, starts
# DECODE_STARTS); ``serve`` the engine's decode window of width 1 at the
# serving geometry (B 64, 64-token pages, 4 a row) with the serving bursts'
# live rows (16 at test, 8 at 2b; ``mixed_batch``); ``long`` four rows at
# the end of a 1,024- or 2,048-position table of 16-token pages, S 1
# (decode) or S 8 (a window), every query live: the long-context tables
# where positions split.
EXTRA = [(f"{size}/decode_step", G, hd, L, "step", 8, 1, 64, 4) for size, G, hd, L in PRESETS] + [
    (f"{size}/serve_s1", G, hd, L, "serve", 64, 1, 64, 4) for size, G, hd, L in PRESETS
] + [
    (f"{size}/long{n}_s{S}", G, hd, L, "long", 4, S, 16, n // 16)
    for size, G, hd, L in PRESETS for n in (1024, 2048) for S in (1, 8)
]


def extra_batch(cs, seed: int, G: int, hd: int, L: int, kind: str, B: int, S: int, psz: int, pmax: int):
    """An ``EXTRA`` row's batch: random distinct pages (``mixed_batch``),
    q_len S on every row, starts DECODE_STARTS (``step``) or within 64
    positions of the table's end (``long``); or ``mixed_batch``'s serving
    mix (``serve``: 8 live rows at hd 256, 16 otherwise, as the kernel
    phase's serve_mix cells)."""
    import torch

    if kind == "serve":
        return cs.mixed_batch(seed, B, S, 1, G, hd, L, psz, pmax, torch.bfloat16, live=8 if hd == 256 else 16)
    q, kp, vp, table, _, _ = cs.mixed_batch(seed, B, S, 1, G, hd, L, psz, pmax, torch.bfloat16, live=B)
    rng = random.Random(seed)
    total = psz * pmax
    starts = list(cs.DECODE_STARTS) if kind == "step" else [total - S - rng.randint(0, 63) for _ in range(B)]
    as_i32 = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")  # noqa: E731
    return q, kp, vp, table, as_i32(starts), as_i32([S] * B)


def child(tree: str, run: int, only: list[str]) -> None:
    import torch

    import chip_smoke as cs  # from this checkout; mcpx_torch from the tree

    sys.path.insert(0, tree)
    from mcpx_torch.core.errors import EngineError
    from mcpx_torch.engine.kernels.paged_attention import (
        launch_plan,
        ragged_paged_attention,
        ragged_paged_attention_reference,
    )

    card = cs.card_line()
    rows = [(cell, c[2], lambda c=c: cs.cell_batch(0, *c)) for cell, *c in cs.CELLS]
    rows += [(cell, c[2], lambda c=c: extra_batch(cs, 0, *c)) for cell, *c in EXTRA]
    for cell, L, batch in rows:
        if only and not any(fnmatch.fnmatch(cell, pattern) for pattern in only):
            continue
        q, kp, vp, table, starts, q_lens = batch()
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
        bound_ms, bound_by, _, _ = cs.attention_bound(q, kp, table, starts, q_lens)
        plan = launch_plan(q, kp, table)
        print(json.dumps({
            "tree": tree, "run": run, "cell": cell, "card": card, "max_abs_err": float(err.max()),
            **{k: plan[k] for k in ("design", "grid", "span")}, **times, "bound_ms": bound_ms,
            "bound_by": bound_by,
        }), flush=True)


def main(trees: list[str], only: list[str]) -> int:
    trees = [os.path.abspath(t) for t in trees]
    builds = [subprocess.Popen([sys.executable, "-c", BUILD, t]) for t in trees]
    if any(p.wait() != 0 for p in builds):
        return 1
    failed = 0
    for run, tree in enumerate(trees + trees[::-1]):
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree, str(run), ",".join(only)]
        rc = subprocess.run(cmd).returncode
        if rc != 0:
            print(json.dumps({"tree": tree, "run": run, "failed": rc}), flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.path.insert(0, HERE)
        child(sys.argv[2], int(sys.argv[3]), [n for n in sys.argv[4].split(",") if n])
    else:
        args = sys.argv[1:]
        only = args[1].split(",") if args[:1] == ["--only"] else []
        trees = args[2:] if only else args
        if not trees:
            sys.exit(__doc__)
        sys.exit(main(trees, only))
