"""Speculative decoding: n-gram prompt-lookup drafter + acceptance rule —
the port's copy of ``paddle_tpu/generation/speculative.py`` (pure numpy).

Autoregressive decode pays one full forward per token; speculative
decoding proposes ``k`` cheap draft tokens and verifies them all in ONE
batched forward (``PagedGenerationSession.verify``), committing the
longest agreeing prefix — accepted spans multiply tokens/s per stream
at zero quality cost.

No second model: the drafter is **prompt lookup** (n-gram copying) —
find the most recent earlier occurrence of the context's trailing
n-gram and propose its continuation.  Chat traffic repeats itself
(system prompts, quoted code, retrieved documents), so acceptance rates
are workload-high exactly where serving cost concentrates, and a miss
costs only the draft width of an already-batched forward.

The **equivalence guarantee** (pinned by the tests): a
draft ``d_j`` is accepted only when it equals the token the model's own
sampler produces at that position — greedy argmax for ``temperature <=
0`` rows, the seeded Gumbel draw keyed on (request seed, position)
otherwise (``sampling.py`` is deterministic given (seed, position,
logits)).  The
committed stream is therefore bit-identical to non-speculative decode,
for greedy AND sampled requests; the drafter only changes how many
forwards it takes to produce it.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["propose_drafts", "accept_span", "draft_row",
           "fill_verify_row"]


def propose_drafts(context, k: int, ngram: int = 2) -> List[int]:
    """Up to ``k`` draft tokens for ``context`` (1-D int array/list:
    prompt + tokens generated so far) by prompt lookup: the longest
    trailing n-gram (width ``ngram`` down to 1) that re-occurs earlier
    in the context contributes the tokens that followed its most
    recent earlier occurrence.  Returns ``[]`` when nothing matches —
    the caller then runs a plain decode-width step."""
    k = int(k)
    if k <= 0:
        return []
    ctx = np.asarray(context, dtype=np.int64).reshape(-1)
    n = ctx.size
    for g in range(min(int(ngram), n - 1), 0, -1):
        pattern = ctx[n - g:]
        # one vectorized pass over every earlier length-g window (the
        # engine calls this per live slot at every decode boundary on
        # the scheduler thread — a Python per-offset scan would grow
        # with context length and serialize all streams behind it);
        # rightmost earlier occurrence wins: recent phrasing predicts
        # the continuation better than a distant one
        windows = np.lib.stride_tricks.sliding_window_view(
            ctx, g)[:n - g]                      # starts 0 .. n-g-1
        hits = np.nonzero((windows == pattern).all(axis=1))[0]
        if hits.size:
            i = int(hits[-1])
            cont = ctx[i + g:i + g + k]
            if cont.size:
                return [int(t) for t in cont]
    return []


def draft_row(context, k: int, room: int, ngram: int = 2) -> List[int]:
    """Clamped per-row draft for one decode boundary: at most
    ``room - 1`` drafts, so the verify window (drafts plus the
    correction token) never writes past the row's remaining cache
    capacity ``room`` — the clamp the equivalence guarantee assumes.
    Shared by the standalone ``PagedGenerationSession.generate`` loop
    and the engine's ``_decode_round`` so the guarantee-bearing rule
    lives in exactly one place."""
    return propose_drafts(context, min(int(k), max(int(room) - 1, 0)),
                          ngram=ngram)


def fill_verify_row(ids, feed, row: int, last: int,
                    drafts: Sequence[int]):
    """Write one row of the batched verify window: position 0 carries
    the row's last committed token (exactly its plain-decode feed),
    the drafts follow, and ``feed[row]`` is the attended width — one
    layout definition shared by the standalone and engine loops so
    the two paths cannot diverge."""
    ids[row, 0] = last
    if drafts:
        ids[row, 1:1 + len(drafts)] = drafts
    feed[row] = 1 + len(drafts)


def accept_span(drafts: Sequence[int], sampled) -> List[int]:
    """Tokens to commit from one verify step: ``sampled[j]`` is the
    model's own token after the row's first ``j`` window tokens, so
    draft ``j`` is accepted iff ``drafts[j] == sampled[j]`` — and the
    first disagreeing position still yields ``sampled[m]``, the
    correct token there (the "bonus" token; a step never commits less
    than plain decode would).  Commits ``m + 1`` tokens where ``m`` is
    the longest agreeing prefix."""
    m = 0
    for j, d in enumerate(drafts):
        if int(sampled[j]) == int(d):
            m += 1
        else:
            break
    return [int(sampled[j]) for j in range(m + 1)]
