"""Paged KV-cache block pool with host offload (vLLM-style paging, CAM-sized).

The HBM pool holds ``num_blocks`` KV blocks of ``block_tokens`` tokens each;
overflow blocks live in host memory and are fetched on reference.  Logical
block references come from decode attention (every live request touches its
context blocks each step) and prefix-shared blocks are hot across requests —
exactly the buffered-disk structure of the paper, with HBM as the page buffer
and PCIe/DMA as the "disk".  ``serve/planner.py`` sizes this pool with the
CAM machinery; this module is the runtime that the planner's predictions are
validated against (tests replay real traces through it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core import replay as replay_mod

__all__ = ["PagedKVPool", "BlockTrace"]


@dataclasses.dataclass
class PagedKVPool:
    """Accounting model of the HBM block pool (eviction + transfer stats)."""

    num_blocks: int
    block_tokens: int
    bytes_per_block: int
    policy: str = "lru"

    def __post_init__(self):
        self.buffer = replay_mod.make_buffer(self.policy, self.num_blocks)
        self.logical_refs = 0
        self.host_fetches = 0

    def reference(self, block_id: int) -> bool:
        self.logical_refs += 1
        hit = self.buffer.access(block_id)
        if not hit:
            self.host_fetches += 1
        return hit

    @property
    def transfer_bytes(self) -> int:
        return self.host_fetches * self.bytes_per_block

    @property
    def hit_rate(self) -> float:
        return 1.0 - self.host_fetches / max(self.logical_refs, 1)


class BlockTrace:
    """Builds logical block-reference traces for decode workloads.

    Requests share a common prefix of ``shared_prefix`` tokens (system
    prompt / few-shot header) and then diverge; every decode step references
    all context blocks of the scheduled request (attention reads the whole
    KV), so hot shared blocks dominate — the popularity skew CAM models.
    """

    def __init__(self, block_tokens: int):
        self.block_tokens = block_tokens
        self._next_private = 1_000_000

    def request_blocks(self, shared_prefix: int, private_len: int,
                       request_id: int) -> List[int]:
        n_shared = shared_prefix // self.block_tokens
        n_private = -(-private_len // self.block_tokens)
        shared = list(range(n_shared))
        private = [self._private_id(request_id, i) for i in range(n_private)]
        return shared + private

    def _private_id(self, request_id: int, i: int) -> int:
        return 1_000_000 + request_id * 10_000 + i

    def decode_trace(self, schedule: List[Tuple[int, int, int]]
                     ) -> List[int]:
        """schedule: [(request_id, shared_prefix, context_len)] per decode
        step (round-robin batched decode); returns the flat block refs."""
        refs: List[int] = []
        for rid, shared, ctx in schedule:
            refs.extend(self.request_blocks(shared, ctx, rid))
        return refs
