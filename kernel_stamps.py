"""Where one block of the ragged kernel's rowwise design spends its cycles,
on one GPU.

    python3 kernel_stamps.py SCRATCH_DIR

Copies this checkout's ``mcpx_torch`` into SCRATCH_DIR (a directory that
``.gitignore`` lists, such as ``_chipcheck/stamps``) and adds ``clock64``
stamps at seven points of ``ragged_rowwise_kernel``: its entry; start, q_len
and page ids read; its first stages issued; q landed; every stage computed
(the softmax's statistics and the products); the warpgroups merged; the
rows stored.
Thread 0 of each block writes them into the launch's scratch. The copy is
built and launched alone (after 20 warm launches) at each one-tile cell of
``chip_smoke.py``'s kernel phase, layer 1; one line a cell gives the median
and largest cycles of each step over the live rows' blocks, and the
``%globaltimer`` span from the first block's start to the last block's end.
The checkout's kernel is not changed: the copy is an instrument. The stamps
are placed by source lines of the kernel; where one no longer matches, the
script stops and names it.
"""

from __future__ import annotations

import os
import shutil
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = ["reads", "issued", "q landed", "stages", "merged", "stored"]

# (source text, what it becomes) in csrc/ragged_paged_attention.cu; those
# that write a STAMP are found from the rowwise kernel's signature on.
KERNEL_EDITS = [
    ("__device__ __forceinline__ uint32_t smem_u32(const void* p) {\n"
     "  return (uint32_t)__cvta_generic_to_shared(p);\n}\n",
     "__device__ __forceinline__ uint32_t smem_u32(const void* p) {\n"
     "  return (uint32_t)__cvta_generic_to_shared(p);\n}\n"
     "__device__ __forceinline__ long long gtime() {\n  long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n  return t;\n}\n'
     "#define STAMP(i) do { if (threadIdx.x == 0) dbg[blockIdx.x * 16 + (i)] = clock64(); } while (0)\n"),
    ("  const int wg = warp / 4, tw = tid % 128;\n  Block blk;\n",
     "  const int wg = warp / 4, tw = tid % 128;\n"
     "  long long* dbg = reinterpret_cast<long long*>(a.ml);\n"
     "  if (threadIdx.x == 0) dbg[blockIdx.x * 16 + 15] = gtime();\n  STAMP(0);\n  Block blk;\n"),
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
     "        }\n      }\n      STAMP(6);\n      if (threadIdx.x == 0) dbg[blockIdx.x * 16 + 14] = gtime();\n"
     "    } else {  // the window's pad rows"),
]
# The wrapper hands each launch a zeroed int64 buffer, 16 stamps a block,
# as its `ml` scratch and keeps it as STAMPS: only one-split rowwise launches,
# which use no `ml`, may run on the copy.
WRAPPER_EDITS = [
    ("_LOCK = threading.Lock()\n", "_LOCK = threading.Lock()\nSTAMPS = None\n"),
    ("        scratch = torch.empty(n_acc + blocks * 2 * t_rows, dtype=torch.float32, device=q.device)\n",
     "        scratch = torch.empty(n_acc + blocks * 2 * t_rows, dtype=torch.float32, device=q.device)\n"
     "        global STAMPS\n"
     "        STAMPS = torch.zeros(B * K * 16, dtype=torch.int64, device=q.device)\n"),
    ("            scratch.data_ptr() + 4 * n_acc, tickets.data_ptr(),",
     "            STAMPS.data_ptr(), tickets.data_ptr(),"),
]


def edit(path: str, edits: list[tuple[str, str]], after: str = "") -> None:
    with open(path) as f:
        src = f.read()
    start = src.index(after) if after else 0
    for old, new in edits:
        at = start if "STAMP(" in new and "#define" not in new else 0
        if old not in src[at:]:
            raise SystemExit(f"{path}: the kernel no longer has\n{old}")
        src = src[:at] + src[at:].replace(old, new, 1)
    with open(path, "w") as f:
        f.write(src)


def stamped_copy(dst: str) -> None:
    shutil.rmtree(os.path.join(dst, "mcpx_torch"), ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "mcpx_torch"), os.path.join(dst, "mcpx_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    kernels = os.path.join(dst, "mcpx_torch", "engine", "kernels")
    edit(os.path.join(kernels, "csrc", "ragged_paged_attention.cu"), KERNEL_EDITS,
         after="ragged_rowwise_kernel(const __grid_constant__")
    edit(os.path.join(kernels, "paged_attention.py"), WRAPPER_EDITS)


def main(dst: str) -> None:
    stamped_copy(dst)
    sys.path.insert(0, dst)
    import torch

    import chip_smoke as cs  # from this checkout; mcpx_torch from the stamped copy
    from mcpx_torch.engine.kernels import paged_attention as tk

    print(cs.card_line(), flush=True)
    for cell, G, hd, L, live, psz, pmax in cs.CELLS:
        q, kp, vp, table, starts, q_lens = cs.cell_batch(0, G, hd, L, live, psz, pmax)
        plan = tk.launch_plan(q, kp, table)
        if plan["design"] != "rowwise" or plan["n_split"] != 1:
            continue
        for _ in range(20):
            tk.ragged_paged_attention(q, kp, vp, table, starts, q_lens, 1)
        torch.cuda.synchronize()
        for _ in range(2):  # the last launch alone on the card
            tk.ragged_paged_attention(q, kp, vp, table, starts, q_lens, 1)
            torch.cuda.synchronize()
        d = tk.STAMPS.view(-1, 16).cpu()[q_lens.cpu() > 0]
        steps = {}
        for i, name in enumerate(STEPS, 1):
            cycles = (d[:, i] - d[:, i - 1]).tolist()
            steps[name] = [int(statistics.median(cycles)), int(max(cycles))]
        total = (d[:, len(STEPS)] - d[:, 0]).tolist()
        print(cell, "cycles (median, largest):", steps, "total", [int(statistics.median(total)), int(max(total))],
              "| globaltimer ns, first start to last end:", int(d[:, 14].max() - d[:, 15].min()), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.path.insert(0, HERE)
    main(os.path.abspath(sys.argv[1]))
