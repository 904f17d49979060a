"""The fused decode horizon as CUDA-graph replays.

The reference runs a horizon of h greedy decode steps as one XLA
``lax.fori_loop`` dispatch (``repro.models.layers.multi_step_decode``).
Eager PyTorch would enqueue every kernel of every step from the host,
which on the card takes longer than the kernels run. ``DecodeGraph``
captures the decode-step body once, at the engine's fixed shape (B slots,
M page-table rows), and replays it: the host then enqueues one graph
launch a step instead of every kernel of the step.

The body is ``layers.decode_loop_step``, the loop body of
``multi_step_decode``, run over static buffers: the pending tokens,
lengths and budgets, the masked page table, the slot mask, the teacher
rows and the (hmax, B) token buffer, with the step index held in a device
tensor; greedy sampling and the loop bookkeeping stay on the device. A
horizon copies the engine's loop tensors into the buffers, replays the
one-step graph h times, and copies them back. The engine clamps h so the
page table is constant within a horizon. (Capturing bodies of 1, 2, 4,
... steps and replaying the binary digits of h was measured against this
on the H100 and lost on wall and capture time: PERF.md.)

Capture records without running, so the first horizon runs its first step
eagerly: that builds the kernels, sets their one-time attributes and
warms the allocator, none of which a capture may do. The kernel wrappers'
``launches`` counters rise while the step is captured; the rise is taken
back and added again at every replay, so they count launches as the eager
loop does. On the card a failed capture or replay raises; there is no
eager fallback. On the CPU the same body runs eagerly through the same
buffers, which is how the CPU tests hold it against
``multi_step_decode``.
"""

from __future__ import annotations

import gc

import torch

from ..kernels import ops
from ..models.layers import decode_loop_step


class DecodeGraph:
    """Greedy fused horizons of ``step_fn`` at a fixed (B, M), replayed
    from CUDA graphs on the card.

    ``step_fn(tokens, page_table, lengths, active) -> logits`` is one
    paged decode step that updates its KV pool in place (the pool must
    stay where it is: the graph holds its address)."""

    def __init__(self, step_fn, num_slots: int, max_rows: int, hmax: int,
                 device):
        dev = torch.device(device)
        z = dict(dtype=torch.int32, device=dev)
        self.step_fn, self.hmax = step_fn, hmax
        self.graphed = dev.type == "cuda"
        self.pending = torch.zeros((num_slots,), **z)
        self.lengths = torch.zeros((num_slots,), **z)
        self.remaining = torch.zeros((num_slots,), **z)
        self.table = torch.zeros((num_slots, max_rows), **z)
        self.mask = torch.zeros((num_slots,), dtype=torch.bool, device=dev)
        self.teacher = torch.zeros((hmax, num_slots), **z)
        self.use_teacher = torch.zeros((), dtype=torch.bool, device=dev)
        self.out = torch.zeros((hmax, num_slots), **z)
        self.step = torch.zeros((1,), dtype=torch.long, device=dev)
        self.graph = None       # the captured step
        self.rise: list[int] = []   # its launches, counter by counter
        self.horizons = 0
        self.replays = 0

    def body(self) -> None:
        """One decode step through the static buffers."""
        decode_loop_step(self.step_fn, self.step, self.pending, self.lengths,
                         self.remaining, self.table, self.mask, self.teacher,
                         self.use_teacher, self.out)

    def capture(self) -> None:
        """Capture one step. Must follow one eager step at this shape (the
        warm-up). Python's cyclic garbage collector is off meanwhile: a
        dropped backend and its DecodeGraph form a cycle (through the
        bound step function), and collecting one inside a capture resets
        its CUDA graph, which invalidates the capture in progress."""
        counters = ops.launch_counters()
        before = [c.launches for c in counters]
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self.body()
        finally:
            if collecting:
                gc.enable()
        self.rise = [c.launches - b for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            c.launches = b              # captured, not launched
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        for c, r in zip(ops.launch_counters(), self.rise):
            c.launches += r
        self.replays += 1

    def run(self, pending, lengths, remaining, page_table, mask, h: int,
            teacher=None):
        """``multi_step_decode``'s contract: up to ``h`` (<= hmax) greedy
        steps; ``pending``, ``lengths`` and ``remaining`` (B,) int32
        advance in place; ``mask`` (B,) bool selects the slots; inactive
        slots read a table row of trash pages; ``teacher`` ((hmax, B)
        int32 or None) forces the fed-back tokens. Returns the (hmax, B)
        int32 tokens, rows past ``h`` zero."""
        if not 1 <= h <= self.hmax:
            raise ValueError(f"horizon {h} outside [1, {self.hmax}]")
        if page_table.shape != self.table.shape:
            raise ValueError(f"page table {tuple(page_table.shape)}, graph "
                             f"captured at {tuple(self.table.shape)}")
        self.pending.copy_(pending)
        self.lengths.copy_(lengths)
        self.remaining.copy_(remaining)
        self.mask.copy_(mask)
        self.table.copy_(torch.where(self.mask[:, None], page_table, 0))
        self.use_teacher.fill_(teacher is not None)
        if teacher is not None:
            self.teacher.copy_(teacher)
        self.out.zero_()
        self.step.zero_()
        if not self.graphed:
            for _ in range(h):
                self.body()
        else:
            if self.graph is None:
                self.body()             # the warm-up is this horizon's first
                h -= 1
                self.capture()
            for _ in range(h):
                self.replay()
        pending.copy_(self.pending)
        lengths.copy_(self.lengths)
        remaining.copy_(self.remaining)
        self.horizons += 1
        return self.out.clone()
