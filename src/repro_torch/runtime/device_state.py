"""Persistent device-resident decode-loop state (port of
``repro.runtime.device_state``).

The four loop arrays — page table (B, M), lengths, pending tokens and
remaining budgets (B,), all int32 — live on the device as persistent
tensors. The engine's numpy mirrors stay the bookkeeping source of
truth; ``sync`` uploads only the slot rows the host touched since the
last horizon (admission, growth, CoW, slot recycle) with one
``index_copy_`` per array, and a fused decode advances the device
tensors in place by the same arithmetic the host applies to its mirrors,
so nothing is downloaded but the tokens.

The object also owns the host<->device traffic counters the reports
publish (``device_dispatches``, ``host_syncs``,
``page_table_upload_bytes``), counted exactly as the reference counts
them so the two engines' ledgers compare equal.
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceLoopState:
    """Device twins of the engine's decode-loop arrays.

    ``touch(slot)`` marks a slot's mirror row dirty; ``sync`` uploads
    every dirty row at once, the slot list padded to a power of two as
    the reference pads it (duplicates write identical values)."""

    def __init__(self, num_slots: int, max_rows: int, device):
        self.device = torch.device(device)
        z = dict(dtype=torch.int32, device=self.device)
        self.table = torch.zeros((num_slots, max_rows), **z)
        self.lengths = torch.zeros((num_slots,), **z)
        self.pending = torch.zeros((num_slots,), **z)
        self.remaining = torch.zeros((num_slots,), **z)
        self._dirty: set[int] = set(range(num_slots))
        self._row_bytes = max_rows * 4
        self.device_dispatches = 0
        self.host_syncs = 0
        self.page_table_upload_bytes = 0

    def touch(self, slot: int) -> None:
        self._dirty.add(slot)

    def count(self, dispatches: int = 0, syncs: int = 0,
              upload_bytes: int = 0) -> None:
        """Shared traffic ledger for the per-step path (one dispatch +
        one sync + one full-table upload per decode step)."""
        self.device_dispatches += dispatches
        self.host_syncs += syncs
        self.page_table_upload_bytes += upload_bytes

    def sync(self, page_table: np.ndarray, lengths: np.ndarray,
             pending: np.ndarray, remaining: np.ndarray) -> None:
        """Upload the dirty slots' mirror rows to the device tensors."""
        if not self._dirty:
            return
        idx = sorted(self._dirty)
        self._dirty.clear()
        width = 1
        while width < len(idx):
            width *= 2
        idx += [idx[-1]] * (width - len(idx))

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a[idx])).to(
                self.device)

        rows = torch.tensor(idx, dtype=torch.long, device=self.device)
        for dst, src in ((self.table, page_table), (self.lengths, lengths),
                         (self.pending, pending),
                         (self.remaining, remaining)):
            dst.index_copy_(0, rows, up(src))
        self.device_dispatches += 1
        self.page_table_upload_bytes += width * self._row_bytes
