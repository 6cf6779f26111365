"""Grammar-aware speculative decoding: the single-model recurrent drafter.

Port of ``mcpx/engine/speculative.py``. A drafter proposes up to K tokens a
row, and the slab verifies the whole ``[rows, K+1]`` window in one forward
(``decode_chunk_paged`` through the ragged kernel): accepted drafts ride
along, the first rejection's verification sample is the correction token,
so every forward still nets at least one token, and the window's shape is
fixed, so one captured graph serves every acceptance pattern.

The drafter adds no parameters:

  - a per-row state ``h`` evolves as an embedding EWMA
    ``h <- DRAFT_DECAY * h + embed(token)`` over the row's emitted tokens;
  - each of the K draft steps scores ``h`` against the tied unembedding
    (``h @ embed.T``, one plain product per step, left to ``torch.matmul``
    as the reference leaves it to XLA; on int8 weights the per-row scales
    multiply the fp32 scores, ``quant.unembed``), takes the best-scoring
    grammar-admissible non-EOS token from the row's current draft state,
    advances the automaton and chains ``h`` over its own proposal;
  - after verification, ``h`` advances over the accepted tokens in closed
    form (:func:`advance_drafter_state`).

Proposals pass through the row's stacked grammar (``planner/grammar.py``
``stacked_tables``) under the same budget-finishability mask, with its
degrade-to-legal fallback, that verification samples under: a constrained
row drafts only admissible tokens, and single-successor states force the
draft, which verification accepts with certainty. Free rows
(``dfa_id == 0``) draft unmasked from the drafter scores. EOS is never
drafted.

Every function here is plain tensor code with no host synchronisation, so
the engine captures it inside its speculative window's CUDA graph.
"""

from __future__ import annotations

import torch

from typing import Any

from mcpx_torch.engine.sampling import NEG_INF
from mcpx_torch.models.gemma.quant import embed_lookup, unembed

# Embedding-EWMA decay of the drafter state. A constant, not a knob: the
# drafter is untrained by design, and the grammar pre-filter carries the
# acceptance rate on constrained rows.
DRAFT_DECAY = 0.5


def drafter_flops_per_token(d_model: int, vocab_size: int) -> float:
    """FLOPs of one drafter proposal: the ``h @ embed.T`` scoring product
    (2·D·V), billed beside the model's own forwards."""
    return 2.0 * d_model * vocab_size


def advance_drafter_state(
    hstate: torch.Tensor,  # [B, H] fp32
    embed: Any,  # [V, H], or its int8 leaf
    window: torch.Tensor,  # [B, W] current token + drafts
    n_absorb: torch.Tensor,  # [B] accepted count + 1
) -> torch.Tensor:
    """The drafter state after the first ``n_absorb`` tokens of ``window``,
    in closed form:

        h' = decay^n · h + sum_{i<n} decay^(n-1-i) · embed(window[i])

    one embedding gather and a decay-weighted cumulative sum, no loop. The
    current token is always absorbed; the correction becomes the next
    current token and is absorbed in the next window."""
    B, W = window.shape
    dt = hstate.dtype
    emb = embed_lookup(embed, window, dt)  # [B, W, H]
    i_ar = torch.arange(W, dtype=dt, device=hstate.device)
    # prefix[m] = sum_{i<=m} decay^-i · emb[i]: every candidate end at once,
    # then decay^(n-1) renormalises the selected one.
    prefix = torch.cumsum(emb * torch.pow(DRAFT_DECAY, -i_ar)[None, :, None], dim=1)
    m = torch.clamp(n_absorb.long() - 1, 0, W - 1)
    sel = prefix[torch.arange(B, device=hstate.device), m]  # [B, H]
    return (
        torch.pow(DRAFT_DECAY, n_absorb.to(dt))[:, None] * hstate
        + torch.pow(DRAFT_DECAY, m.to(dt))[:, None] * sel
    )


def draft_window(
    embed: Any,  # [V, H] model embedding (tied unembedding), or its int8 leaf
    sdfa: tuple,  # stacked (trans, mask, dist_succ, active_ids, eos_cols)
    dfa_id: torch.Tensor,  # [B] grammar slot per row
    st: torch.Tensor,  # [B] DFA state after the current token
    cur: torch.Tensor,  # [B] current token (last emitted)
    hstate: torch.Tensor,  # [B, H] drafter state (before cur)
    emitted: torch.Tensor,  # [B] tokens emitted so far
    budgets: torch.Tensor,  # [B] decode budgets
    done: torch.Tensor,  # [B] finished rows
    cons_v: torch.Tensor,  # [B] constrained flag per row
    free_mask: torch.Tensor,  # [V] draftable vocabulary of free rows (no EOS)
    pad_id: int,
    *,
    k: int,
    mode: str,  # "recurrent" | "grammar"
) -> tuple:
    """Propose up to ``k`` tokens a row, walking the row's stacked grammar.
    Returns

      - ``p_toks`` [B, K] proposed ids (PAD where none),
      - ``p_use`` [B, K] whether a token was proposed there,
      - ``s_before`` [B, K] the DFA state before each proposal
        (``s_before[:, 0] == st``),
      - ``s_fin`` [B] the state after the whole chain,
      - ``masks`` [B, K+1, C] the verify window's admissibility at each
        position (``stacked_window_admissibility``'s semantics), gathered
        by the walk at the states verification samples from; position K,
        the correction slot when all K are accepted, is one more lookup at
        ``s_fin``. ``sdfa`` carries ``dist_succ`` in the distance slot, so
        finishability is one gather.

    A row stops proposing for good at its first position with no budget,
    no admissible non-EOS column (constrained) or, with ``mode="grammar"``,
    a branch point (that mode drafts only forced chains, and free rows
    never draft). A stopped row's later mask slots repeat its frozen state's
    mask; verification never reads them. The walk chains a throwaway copy
    of the drafter state over its own proposals; the engine advances the
    real one over the verified tokens (:func:`advance_drafter_state`)."""
    strans, smask, sdist_succ, sactive, seos = sdfa
    B = cur.shape[0]
    b_idx = torch.arange(B, device=cur.device)
    act_rows = sactive[dfa_id].long()  # [B, C]
    eos_rows = seos[dfa_id]  # [B, C]
    recurrent = mode == "recurrent"
    if recurrent:
        h = DRAFT_DECAY * hstate + embed_lookup(embed, cur, hstate.dtype)
        free_ok = ~done
    else:
        h = hstate  # grammar mode never scores
        free_ok = torch.zeros_like(done)

    def admissible(s, rem):
        """Legal and budget-finishable (degrade-to-legal) at ``s``: drafting
        proposes from this support and verification samples under it."""
        legal = smask[dfa_id, s]  # [B, C]
        finishable = legal & (eos_rows | (sdist_succ[dfa_id, s] <= rem[:, None]))
        return torch.where(finishable.any(dim=-1, keepdim=True), finishable, legal), legal

    s, alive, ej = st, ~done, emitted
    p_toks, p_use, s_before, vmasks = [], [], [], []
    for _ in range(k):
        support, legal = admissible(s, budgets - ej - 1)
        m_prop = support & ~eos_rows  # EOS is sampled at verify, never drafted
        has_prop = m_prop.any(dim=-1)
        if recurrent:
            scores = unembed(h, embed)  # [B, V] fp32
            c_scores = torch.gather(scores, 1, act_rows)
            col = torch.argmax(torch.where(m_prop, c_scores, NEG_INF), dim=-1)
            free_tok = torch.argmax(torch.where(free_mask, scores, NEG_INF), dim=-1)
        else:
            # Forced-successor drafting: only where the legal set is one column.
            col = torch.argmax(m_prop.to(torch.uint8), dim=-1)
            has_prop = has_prop & (legal.sum(dim=-1) == 1)
            free_tok = torch.full_like(cur, pad_id)
        p_tok = torch.where(cons_v, act_rows[b_idx, col], free_tok)
        use = alive & (ej < budgets) & torch.where(cons_v, has_prop, free_ok)
        s_before.append(s)
        vmasks.append(support)
        p_toks.append(torch.where(use, p_tok, pad_id))
        p_use.append(use)
        s = torch.where(use & cons_v, strans[dfa_id, s, col].long(), s)
        if recurrent:
            h = torch.where(use[:, None], DRAFT_DECAY * h + embed_lookup(embed, p_tok, h.dtype), h)
        alive = use
        ej = ej + use.long()
    m_fin, _ = admissible(s, budgets - emitted - k - 1)
    masks = torch.stack(vmasks + [m_fin], dim=1)
    return torch.stack(p_toks, 1), torch.stack(p_use, 1), torch.stack(s_before, 1), s, masks
