"""``SelectedRows`` — the row-sparse gradient, the counterpart of
``paddle_tpu/core/selected_rows.py`` (reference
``framework/selected_rows.h``): the (rows, values) pair a sparse
embedding's backward gives, so that a large table never gets a dense
(V, D) gradient.

It is carried on torch's own sparse gradient.  ``F.embedding(...,
sparse=True)`` leaves an uncoalesced COO ``.grad`` with one row per
looked-up id, and torch accumulates a sparse gradient into a sparse one
by concatenation (the reference's :meth:`merge`: two backwards of 24 ids
hold 48 rows) and a sparse one into a dense one as a dense sum (the
reference's ``Tensor._accumulate_grad``).  ``Tensor.grad`` gives a
:class:`SelectedRows` view of such a gradient; :func:`merged_grad` is
what an optimizer step reads.

:meth:`SelectedRows.merged` (the reference's ``scatter::MergeAdd``) sorts
the rows stably, then sums each row's slices in the order they were
looked up (``torch.segment_reduce``, one thread a segment and column): no
atomics, so two runs on the card agree bit for bit.  Finding the unique
rows reads their count back to the host, as the reference's
``np.unique`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["SelectedRows", "merged_grad"]


def _torch(x) -> torch.Tensor:
    from .tensor import unwrap
    x = unwrap(x)
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


class SelectedRows:
    """Rows (int64, may repeat unless merged) and their values, of a
    gradient of ``dense_shape``."""

    __slots__ = ("_rows", "_values", "dense_shape", "_is_merged")

    def __init__(self, rows, values, dense_shape: Tuple[int, ...],
                 _is_merged: bool = False):
        self._rows = _torch(rows).reshape(-1).long()
        self._values = _torch(values)
        self.dense_shape = tuple(int(s) for s in dense_shape)
        # rows known sorted and unique (merged() made them): a later
        # merged() skips the sort and the host read
        self._is_merged = bool(_is_merged)
        if self._values.shape[0] != self._rows.shape[0] or \
                tuple(self._values.shape[1:]) != self.dense_shape[1:]:
            raise ValueError(f"SelectedRows: {self._rows.shape[0]} rows "
                             f"and values {tuple(self._values.shape)} for "
                             f"a gradient of {self.dense_shape}")

    @classmethod
    def of(cls, grad: torch.Tensor) -> "SelectedRows":
        """The view of torch's sparse COO gradient ``grad`` (rows along
        its first dimension)."""
        return cls(grad._indices()[0], grad._values(), grad.shape,
                   _is_merged=grad.is_coalesced())

    @property
    def rows(self):
        from .tensor import Tensor
        return Tensor(self._rows)

    @property
    def values(self):
        from .tensor import Tensor
        return Tensor(self._values)

    @property
    def shape(self):
        return list(self.dense_shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._values.dtype

    def merge(self, other: "SelectedRows") -> "SelectedRows":
        """The two gradients' slices concatenated (accumulation)."""
        if self.dense_shape != other.dense_shape:
            raise ValueError(f"SelectedRows.merge: {self.dense_shape} and "
                             f"{other.dense_shape}")
        return SelectedRows(torch.cat([self._rows, other._rows]),
                            torch.cat([self._values, other._values]),
                            self.dense_shape)

    def merged(self) -> "SelectedRows":
        """Unique rows in ascending order, each row's slices summed in
        the order they were looked up (deterministic: no atomics)."""
        if self._is_merged:
            return self
        rows, order = torch.sort(self._rows, stable=True)
        values = self._values.index_select(0, order)
        uniq, counts = torch.unique_consecutive(rows, return_counts=True)
        if uniq.numel() != rows.numel():
            values = torch.segment_reduce(
                values.float(), "sum", lengths=counts, axis=0).to(
                    values.dtype)
        return SelectedRows(uniq, values, self.dense_shape, _is_merged=True)

    def to_dense(self):
        """The dense gradient, as a Tensor: the merged values written
        into zeros (no repeated row, so no accumulation order)."""
        from .tensor import Tensor
        m = self.merged()
        out = torch.zeros(self.dense_shape, dtype=m._values.dtype,
                          device=m._values.device)
        out.index_copy_(0, m._rows, m._values)
        return Tensor(out)

    def scale(self, s) -> "SelectedRows":
        return SelectedRows(self._rows, self._values * _torch(s),
                            self.dense_shape, _is_merged=self._is_merged)

    def to_torch(self) -> torch.Tensor:
        """torch's sparse COO tensor of this gradient (marked coalesced
        when merged)."""
        return torch.sparse_coo_tensor(
            self._rows.reshape(1, -1), self._values, self.dense_shape,
            is_coalesced=self._is_merged, check_invariants=False)

    def __repr__(self):
        return (f"SelectedRows(rows={self._rows.shape[0]}, "
                f"dense_shape={self.dense_shape})")


def merged_grad(grad: torch.Tensor) -> torch.Tensor:
    """torch's sparse gradient ``grad`` merged (:meth:`SelectedRows.merged`)
    and marked coalesced; a coalesced one as it is."""
    if grad.is_coalesced():
        return grad
    return SelectedRows.of(grad).merged().to_torch()
