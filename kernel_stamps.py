"""Where one block of the ragged kernel spends its cycles, design by design,
on one GPU.

    python3 kernel_stamps.py SCRATCH_DIR [DESIGN ...]

DESIGN is ``rowwise``, ``mma_sync`` or ``narrow`` (all three by default).
For each, copies this checkout's ``mcpx_torch`` into SCRATCH_DIR/DESIGN (a
directory that ``.gitignore`` lists, such as ``_chipcheck/stamps``) and
adds ``clock64`` stamps at the points of ``STEPS[DESIGN]``; thread 0 of
each block writes them into the launch's scratch (beside the ``%globaltimer``
of its start, and, where it ends the row, of its end). The copies are built
together, then each is launched alone (after 20 warm launches) in a process
of its own:

* ``rowwise`` at each one-split rowwise cell of ``chip_smoke.py``'s kernel
  phase: entry; start, q_len and page ids read; first stages issued; q
  landed; every stage computed; the warpgroups merged; the rows stored;
* ``mma_sync`` and ``narrow`` at 2b's one-token rows (``2b/tier_decode``
  of the kernel phase; ``2b/decode_step``, ``2b/serve_s1`` and the S 1
  long tables of ``kernel_ab.EXTRA``), the ``mma_sync`` copy routing them
  to ``mma_sync`` as the design before ``narrow`` did. ``mma_sync``: entry; page offsets
  read; the first K and V landed; products and softmax done; partial
  stored; ticket drawn; the last block's merge done. ``narrow``: entry;
  start and q_len read; first loads issued; q landed; K landed; scores
  done; the row's statistics merged over the cluster; products done; the
  outputs exchanged; the rows stored.

One line a cell, layer 1: the median and largest cycles of each step over
the blocks that reached it, and the ``%globaltimer`` span from the first
block's start to the last block's end; for ``mma_sync`` also the merging
block's ns from its ticket to its end and the row's span (median over
rows). The checkout's kernel is not changed: the copies are instruments.
The stamps are placed by source lines of the kernel; where one no longer
matches, the script stops and names it.
"""

from __future__ import annotations

import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = {
    "rowwise": ["reads", "issued", "q landed", "stages", "merged", "stored"],
    "mma_sync": ["offsets", "K/V landed", "products", "partial stored", "ticket", "merge"],
    "narrow": ["reads", "issued", "q landed", "K landed", "scores", "row stats", "products", "exchanged", "stored"],
}
# Each kernel's signature: its stamps are placed from there on.
KERNELS = {
    "rowwise": "ragged_rowwise_kernel(const __grid_constant__",
    "mma_sync": "ragged_paged_attention_kernel(const Args a) {",
    "narrow": "ragged_narrow_kernel(const __grid_constant__",
}
GTIME = (
    "__device__ __forceinline__ uint32_t smem_u32(const void* p) {\n"
    "  return (uint32_t)__cvta_generic_to_shared(p);\n}\n",
    "__device__ __forceinline__ uint32_t smem_u32(const void* p) {\n"
    "  return (uint32_t)__cvta_generic_to_shared(p);\n}\n"
    "__device__ __forceinline__ long long gtime() {\n  long long t;\n"
    '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n  return t;\n}\n'
    "#define STAMP_AT(i, t) do { if (threadIdx.x == 0) dbg[(blockIdx.x * gridDim.y + blockIdx.y) * 16 + (i)] = (t); } while (0)\n"
    "#define STAMP(i) STAMP_AT(i, clock64())\n",
)
# mma_sync's blocks write partials to `ml`: its stamps sit past them.
MS_DBG = ("long long* dbg = reinterpret_cast<long long*>(a.ml + ((gridDim.x * gridDim.y * 2 * a.trows + 3) & ~3));")
# (source text, what it becomes) in csrc/ragged_paged_attention.cu, from the kernel's signature on.
KERNEL_EDITS = {
    "rowwise": [
        ("  const int wg = warp / 4, tw = tid % 128;\n  Block blk;\n",
         "  const int wg = warp / 4, tw = tid % 128;\n"
         "  long long* dbg = reinterpret_cast<long long*>(a.ml);\n"
         "  STAMP_AT(15, gtime());\n  STAMP(0);\n  Block blk;\n"),
        ("  const int nt = c < nwork ? cdiv(blk.c1 - blk.c0, kWgPos) : 0;  // stages this block computes\n",
         "  const int nt = c < nwork ? cdiv(blk.c1 - blk.c0, kWgPos) : 0;  // stages this block computes\n"
         "  STAMP(1);\n"),
        ("    rw_load_q<HD, R::kThreads>(a, blk, smem + R::kHead);\n",
         "    STAMP(2);\n    rw_load_q<HD, R::kThreads>(a, blk, smem + R::kHead);\n"),
        ('    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n    __syncthreads();\n'
         "    const int lim0",
         '    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n    __syncthreads();\n'
         "    STAMP(3);\n    const int lim0"),
        ("    }\n\n    // The warpgroups' states merge in warpgroup order:",
         "    }\n    STAMP(4);\n\n    // The warpgroups' states merge in warpgroup order:"),
        ("  bf16* out = static_cast<bf16*>(a.out);\n  if (a.nsplit == 1) {",
         "  STAMP(5);\n  bf16* out = static_cast<bf16*>(a.out);\n  if (a.nsplit == 1) {"),
        ("        }\n      }\n    } else {  // the window's pad rows",
         "        }\n      }\n      STAMP(6);\n      STAMP_AT(14, gtime());\n"
         "    } else {  // the window's pad rows"),
    ],
    "mma_sync": [
        ("  extern __shared__ __align__(128) unsigned char smem[];\n  __shared__ int last;\n",
         "  extern __shared__ __align__(128) unsigned char smem[];\n  __shared__ int last;\n"
         f"  {MS_DBG}\n  STAMP_AT(15, gtime());\n  STAMP(0);\n"),
        ("    attend<T, kWide>(a, lay, smem, blk, st);\n",
         "    attend<T, kWide>(a, lay, smem, blk, st);\n    STAMP(3);\n"),
        ("    st.finish(a, lay, smem, blk, part + (size_t)c * rows * a.hd, ml + (size_t)c * 2 * rows);\n  }\n",
         "    st.finish(a, lay, smem, blk, part + (size_t)c * rows * a.hd, ml + (size_t)c * 2 * rows);\n"
         "    STAMP(4);\n  }\n"),
        ("  if (threadIdx.x == 0) last = atomicAdd(a.tickets + bkt, 1) == a.nsplit - 1;\n  __syncthreads();\n",
         "  if (threadIdx.x == 0) last = atomicAdd(a.tickets + bkt, 1) == a.nsplit - 1;\n  __syncthreads();\n"
         "  STAMP(5);\n  STAMP_AT(13, gtime());\n"),
        ("  merge<T, kThreads>(a, reinterpret_cast<float*>(smem + lay.w), lay.rows, blk, nwork, part, ml,\n"
         "                     BlockSync());\n",
         "  merge<T, kThreads>(a, reinterpret_cast<float*>(smem + lay.w), lay.rows, blk, nwork, part, ml,\n"
         "                     BlockSync());\n  STAMP(6);\n  STAMP_AT(14, gtime());\n"),
    ],
    "narrow": [
        ("  const int ii = warp >> 2;  // warps 0 and 4 issue loads 0 and 1 (and refill buffers 0 and 1)\n",
         "  const int ii = warp >> 2;  // warps 0 and 4 issue loads 0 and 1 (and refill buffers 0 and 1)\n"
         "  long long* dbg = reinterpret_cast<long long*>(a.ml);\n  STAMP_AT(15, gtime());\n  STAMP(0);\n"),
        ("  const int n = max(blk.c1 - blk.c0, 0), nr = cdiv(n, kNwRound), nl = 2 * nr;\n",
         "  const int n = max(blk.c1 - blk.c0, 0), nr = cdiv(n, kNwRound), nl = 2 * nr;\n  STAMP(1);\n"),
        ("      nw_issue(&kmap, &vmap, a, blk, base, ii, nr, t, bx, buf, t < 32 ? id0 : id1);\n  }\n",
         "      nw_issue(&kmap, &vmap, a, blk, base, ii, nr, t, bx, buf, t < 32 ? id0 : id1);\n  }\n"
         "  STAMP(2);\n"),
        ("  __syncthreads();  // q landed; every barrier initialised\n",
         "  __syncthreads();  // q landed; every barrier initialised\n  STAMP(3);\n"),
        ("    mbar_wait(base + 8 * j, 0);  // every barrier serves one load: phase 0\n",
         "    mbar_wait(base + 8 * j, 0);  // every barrier serves one load: phase 0\n    if (j == 0) STAMP(4);\n"),
        ("    refill(j + 2);\n  }\n", "    refill(j + 2);\n  }\n  STAMP(5);\n"),
        ("  const float inv = L > 0.f ? 1.f / L : 0.f;\n",
         "  const float inv = L > 0.f ? 1.f / L : 0.f;\n  STAMP(6);\n"),
        ("    refill(nr + j + 2);\n  }\n", "    refill(nr + j + 2);\n  }\n  STAMP(7);\n"),
        ("  nw_wait(out_bar);\n", "  nw_wait(out_bar);\n  STAMP(8);\n"),
        ("    store4(out + blk.at(a, r) + 4 * (v0 + v), o);\n  }\n",
         "    store4(out + blk.at(a, r) + 4 * (v0 + v), o);\n  }\n  STAMP(9);\n  STAMP_AT(14, gtime());\n"),
    ],
}
# mma_sync's page offsets and first stage are stamped inside `attend`.
ATTEND_EDITS = [
    ("    off[p] = ((((long long)blk.kh * a.L + a.layer) * a.N + page) * a.psz + pos % a.psz) * a.hd;\n"
     "  }\n  __syncthreads();\n",
     "    off[p] = ((((long long)blk.kh * a.L + a.layer) * a.N + page) * a.psz + pos % a.psz) * a.hd;\n"
     f"  }}\n  __syncthreads();\n  {MS_DBG}\n  STAMP(1);\n"),
    ("    __syncthreads();\n    st.tile(a, lay, smem, blk, t & 1, blk.c0 + t * kTile);\n",
     "    __syncthreads();\n    if (t == 0) STAMP(2);\n    st.tile(a, lay, smem, blk, t & 1, blk.c0 + t * kTile);\n"),
]
# The wrapper zeroes the launch's scratch and adds 16 stamps a block past
# it (16-byte aligned), kept as STAMPS. The mma_sync copy routes 2b's
# one-token windows to mma_sync, as the design before narrow did.
WRAPPER_EDITS = [
    ("_LOCK = threading.Lock()\n", "_LOCK = threading.Lock()\nSTAMPS = None\n"),
    ("        scratch = torch.empty(n_acc + blocks * 2 * t_rows, dtype=torch.float32, device=q.device)\n",
     "        grid_blocks = B * K * n_tiles * n_split\n"
     "        tail = -(-(n_acc + blocks * 2 * t_rows) // 4) * 4\n"
     "        scratch = torch.zeros(tail + 32 * grid_blocks, dtype=torch.float32, device=q.device)\n"
     "        global STAMPS\n"
     "        STAMPS = scratch[tail:].view(torch.int64)\n"),
]
ROUTE_EDIT = ('        if S * G <= NARROW_ROWS and hd > 128:\n            return "narrow"\n',
              '        if S * G <= NARROW_ROWS and hd > 128:\n            return "mma_sync"\n')


def edit(path: str, edits: list[tuple[str, str]], after: str = "") -> None:
    with open(path) as f:
        src = f.read()
    start = src.index(after) if after else 0
    for old, new in edits:
        at = start if "STAMP" in new and "#define" not in new else 0
        if old not in src[at:]:
            raise SystemExit(f"{path}: the kernel no longer has\n{old}")
        src = src[:at] + src[at:].replace(old, new, 1)
    with open(path, "w") as f:
        f.write(src)


def stamped_copy(dst: str, design: str) -> None:
    shutil.rmtree(os.path.join(dst, "mcpx_torch"), ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "mcpx_torch"), os.path.join(dst, "mcpx_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    kernels = os.path.join(dst, "mcpx_torch", "engine", "kernels")
    cu = os.path.join(kernels, "csrc", "ragged_paged_attention.cu")
    edit(cu, [GTIME])
    edit(cu, KERNEL_EDITS[design], after=KERNELS[design])
    if design == "mma_sync":
        edit(cu, ATTEND_EDITS, after="__device__ __forceinline__ void attend(")
    edit(os.path.join(kernels, "paged_attention.py"), WRAPPER_EDITS + ([ROUTE_EDIT] if design == "mma_sync" else []))


def batches(design: str):
    """(cell, L, batch thunk) of the rows a design's copy is stamped at."""
    import chip_smoke as cs
    import kernel_ab

    if design == "rowwise":
        return [(cell, c[2], lambda c=c: cs.cell_batch(0, *c)) for cell, *c in cs.CELLS]
    rows = [(cell, c[2], lambda c=c: cs.cell_batch(0, *c)) for cell, *c in cs.CELLS if cell == "2b/tier_decode"]
    return rows + [(cell, c[2], lambda c=c: kernel_ab.extra_batch(cs, 0, *c)) for cell, *c in kernel_ab.EXTRA
                   if cell in ("2b/decode_step", "2b/serve_s1", "2b/long1024_s1", "2b/long2048_s1")]


def med_max(xs: list) -> list:
    return [int(statistics.median(xs)), int(max(xs))] if xs else []


def child(dst: str, design: str) -> None:
    sys.path.insert(0, dst)
    import torch

    import chip_smoke as cs  # from this checkout; mcpx_torch from the stamped copy
    from mcpx_torch.engine.kernels import paged_attention as tk

    print(design, cs.card_line(), flush=True)
    for cell, L, batch in batches(design):
        q, kp, vp, table, starts, q_lens = batch()
        plan = tk.launch_plan(q, kp, table)
        if plan["design"] != design or (design == "rowwise" and plan["n_split"] != 1):
            continue
        for _ in range(20):
            tk.ragged_paged_attention(q, kp, vp, table, starts, q_lens, 1)
        torch.cuda.synchronize()
        for _ in range(2):  # the last launch alone on the card
            tk.ragged_paged_attention(q, kp, vp, table, starts, q_lens, 1)
            torch.cuda.synchronize()
        n_rows, n_split = plan["grid"]
        d = tk.STAMPS.view(n_rows, n_split, 16).cpu()
        d = d[q_lens.cpu() > 0]  # the live rows' blocks: [rows, splits, 16]
        flat = d.reshape(-1, 16)
        steps = {}
        for i, name in enumerate(STEPS[design], 1):
            # A step counts in the blocks that stamped it and the step before.
            ok = (flat[:, i] > 0) & (flat[:, i - 1] > 0)
            steps[name] = med_max((flat[ok, i] - flat[ok, i - 1]).tolist())
        ends = flat[:, 14][flat[:, 14] > 0]
        span_ns = int(ends.max() - flat[:, 15][flat[:, 15] > 0].min()) if len(ends) else 0
        line = f"{design} {cell} grid {plan['grid']} span {plan['span']} cycles (median, largest): {steps}"
        if design == "mma_sync":
            merge_ns, row_ns = [], []
            for row in d:
                last = row[row[:, 14] > 0]
                if len(last):
                    merge_ns.append(int(last[0, 14] - last[0, 13]))
                    row_ns.append(int(last[0, 14] - row[:, 15][row[:, 15] > 0].min()))
            line += f" | merging block, ticket to end ns: {med_max(merge_ns)}; row span ns: {med_max(row_ns)}"
        print(line, f"| globaltimer ns, first start to last end: {span_ns}", flush=True)


def main(dst: str, designs: list[str]) -> int:
    from concurrent.futures import ThreadPoolExecutor

    for design in designs:
        stamped_copy(os.path.join(dst, design), design)
    build = "import sys; sys.path.insert(0, sys.argv[1]); from mcpx_torch.engine.kernels import build; build.build_all()"
    with ThreadPoolExecutor(len(designs)) as pool:
        rcs = list(pool.map(lambda d: subprocess.run([sys.executable, "-c", build, os.path.join(dst, d)]).returncode,
                            designs))
    if any(rcs):
        return 1
    failed = 0
    for design in designs:
        failed += subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                                  os.path.join(dst, design), design]).returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.path.insert(0, HERE)
        child(sys.argv[2], sys.argv[3])
    elif len(sys.argv) < 2 or any(d not in STEPS for d in sys.argv[2:]):
        sys.exit(__doc__)
    else:
        sys.path.insert(0, HERE)
        sys.exit(main(os.path.abspath(sys.argv[1]), sys.argv[2:] or list(STEPS)))
