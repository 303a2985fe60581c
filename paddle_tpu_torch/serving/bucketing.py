"""Power-of-two shape buckets — the counterpart of
``paddle_tpu/serving/bucketing.py`` (``next_bucket``, ``seq_buckets``).

Prompts are right-padded to a bucket so that a prefill runs at one of a
few shapes; on the card that keeps the set of launch shapes small."""
from __future__ import annotations

from typing import List, Optional

__all__ = ["next_bucket", "seq_buckets"]


def next_bucket(n: int, min_bucket: int = 1, cap: Optional[int] = None
                ) -> int:
    """Smallest power of two >= ``n`` (and >= ``min_bucket``), clamped to
    ``cap`` when given.  ``n`` itself is returned when it exceeds the cap
    — the caller decided to admit it, so it gets its own bucket."""
    if n < 0:
        raise ValueError(f"bucket size for negative dim {n}")
    b = max(int(min_bucket), 1)
    while b < n:
        b <<= 1
    if cap is not None and b > cap:
        return n if n > cap else cap
    return b


def seq_buckets(max_length: int, min_bucket: int = 8) -> List[int]:
    """All power-of-two sequence buckets in ``[min_bucket, max_length]``
    (the last clamps to ``max_length``): the prefill shapes a session
    can run."""
    out, b = [], max(1, int(min_bucket))
    cap = max(1, int(max_length))
    while b < cap:
        out.append(b)
        b <<= 1
    out.append(cap)
    return out
