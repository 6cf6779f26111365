"""The kernel phase's least-time count (``chip_smoke.attention_bound``):
it charges what the function needs, no more."""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def test_attention_bound_counts_live_queries_and_visible_positions():
    B, S, K, G, hd, psz, p_max = 4, 8, 1, 8, 256, 64, 4
    q = torch.zeros((B, S, K, G, hd), dtype=torch.bfloat16)
    k_pages = torch.zeros((K, 2, B * p_max + 1, psz, hd), dtype=torch.bfloat16)
    table = torch.zeros((B, p_max), dtype=torch.int32)
    # One live row: 3 queries from position 70 (73 visible positions, 2
    # pages), one row whose window runs past the table (clamped to 256
    # positions, 4 pages), two idle rows.
    starts = torch.tensor([70, 0, 250, 5], dtype=torch.int32)
    q_lens = torch.tensor([3, 0, 8, 0], dtype=torch.int32)
    _, by, nbytes, flops = chip_smoke.attention_bound(q, k_pages, table, starts, q_lens)
    elt = 2
    want = (
        (3 + 8) * K * G * hd * elt  # live queries
        + (73 + 256) * K * hd * 2 * elt  # visible K and V positions
        + B * S * K * G * hd * elt  # out, written in full
        + 4 * ((2 + 4) + 2 * B)  # page-table entries, start_pos, q_lens
    )
    assert nbytes == want and by == "bytes"
    visible = [71, 72, 73] + [min(250 + i + 1, 256) for i in range(8)]
    assert flops == K * G * 4 * hd * sum(visible)
