"""Prefix KV block pool — block-granular prompt-prefix reuse. Host-only
copy of paddle_tpu/serving/prefix_cache.py (numpy and hashlib), with
array spans as torch tensors.

The unit of sharing is one decode block of K/V per layer: ``[L, H,
block, hd]`` for K and for V (a scaled-int8 span is the pair ``(codes
[L, H, block, hd], steps [L, H, block])``), or on a paged session a
:class:`PageSpan` naming the pool pages that hold it.

Keying: a hash CHAIN at block granularity — block i's key digests the
whole token prefix ``tokens[0 : (i+1)*block]`` (previous hash ‖ block
tokens as int32 bytes), so two prompts share an entry iff they agree on
every token up to that block boundary. Lookup walks the chain from block
0 and stops at the first miss, which also makes LRU eviction of a middle
block safe: the chain breaks there and the tail ages out.

The pool is a bounded LRU over blocks (``max_blocks``). Extraction is
guarded by second-touch promotion (``promote_after``): a block's K/V is
read out of the cache only once its key has been seen that many times,
so unique prompts never pay a span read.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["PrefixCache", "PageSpan", "chain_keys", "span_slice",
           "span_concat", "span_tokens"]


class PageSpan:
    """A K-or-V span held by reference as a list of physical KV-pool page
    ids — the paged session's pool-entry form. Sharing one is free (the
    session bumps the pages' refcounts)."""
    __slots__ = ("pages", "block")

    def __init__(self, pages, block: int):
        self.pages = [int(p) for p in pages]
        self.block = int(block)

    def tokens(self) -> int:
        return len(self.pages) * self.block

    def __repr__(self):
        return f"PageSpan(pages={self.pages}, block={self.block})"


def span_slice(kv, start: int, length: int):
    """Slice a K or V span along the position axis (axis 2 of [L, H, len,
    hd]); a scaled-int8 pair slices codes and steps together, a
    :class:`PageSpan` by page-id sublist (page-aligned only)."""
    if isinstance(kv, PageSpan):
        if start % kv.block or length % kv.block:
            raise ValueError(
                f"PageSpan slices must be page-aligned: [{start}, "
                f"{start + length}) vs page size {kv.block}")
        b = kv.block
        return PageSpan(kv.pages[start // b:(start + length) // b], b)
    if isinstance(kv, tuple):
        return tuple(span_slice(e, start, length) for e in kv)
    return kv[:, :, start:start + length]


def span_concat(blocks):
    """Concatenate K (or V) span blocks along the position axis, steps
    riding with codes; :class:`PageSpan` runs merge their page lists
    (mixing span kinds in one run is an error)."""
    if isinstance(blocks[0], PageSpan):
        if not all(isinstance(b, PageSpan) for b in blocks):
            raise TypeError("cannot concatenate PageSpan and array spans")
        return PageSpan([p for b in blocks for p in b.pages],
                        blocks[0].block)
    if isinstance(blocks[0], tuple):
        return tuple(span_concat([b[i] for b in blocks])
                     for i in range(len(blocks[0])))
    if len(blocks) == 1:
        return blocks[0]
    return torch.cat(blocks, dim=2)


def span_tokens(kv) -> int:
    """Token length of a span (the position axis of its data leaf)."""
    if isinstance(kv, PageSpan):
        return kv.tokens()
    if isinstance(kv, tuple) and isinstance(kv[0], PageSpan):
        return kv[0].tokens()
    return int((kv[0] if isinstance(kv, tuple) else kv).shape[2])


def chain_keys(tokens, block: int, n_blocks: int | None = None) -> list[str]:
    """Chained block-hash keys for the first ``n_blocks`` full blocks of a
    prompt (key i commits to every token before block i ends). Tokens hash
    as int32 bytes whatever their dtype, so an int64 prompt keys like the
    same int32 prompt."""
    tokens = np.ascontiguousarray(np.asarray(tokens).astype(np.int32))
    if n_blocks is None:
        n_blocks = tokens.shape[0] // int(block)
    keys, h = [], b""
    for i in range(n_blocks):
        blk = tokens[i * block:(i + 1) * block]
        h = hashlib.sha1(h + blk.tobytes()).digest()
        keys.append(h.hex())
    return keys


class PrefixCache:
    def __init__(self, block: int, max_blocks: int,
                 promote_after: int = 2, on_release=None):
        """``promote_after``: how many times a block key must be seen
        before its K/V is extracted into the pool (1 = on first sight).
        ``on_release(entry)``: called with each (k, v) entry LRU eviction
        drops — the paged session's refcount decrement, so a pooled
        :class:`PageSpan`'s pages return to the free list only once no row
        aliases them."""
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if max_blocks < 1:
            raise ValueError(f"max_blocks must be >= 1, got {max_blocks}")
        if promote_after < 1:
            raise ValueError(
                f"promote_after must be >= 1, got {promote_after}")
        self.block = int(block)
        self.max_blocks = int(max_blocks)
        self.promote_after = int(promote_after)
        self._on_release = on_release
        self._pool: OrderedDict[str, tuple] = OrderedDict()
        # bounded LRU of (key -> times seen) for not-yet-promoted keys
        self._seen: OrderedDict[str, int] = OrderedDict()
        self._seen_cap = 8 * self.max_blocks
        self.hits = 0        # blocks served from the pool
        self.misses = 0      # lookups that matched zero blocks
        self.insertions = 0
        self.injections = 0  # of insertions: handed-off blocks (inject)
        self.evictions = 0
        self.reads = 0       # span reads paid for promotion

    def __len__(self) -> int:
        return len(self._pool)

    def has_block(self, key: str) -> bool:
        """Is this chain key pooled? No LRU touch, no accounting."""
        return key in self._pool

    def _chain(self, tokens: np.ndarray, n_blocks: int) -> list[str]:
        return chain_keys(tokens, self.block, n_blocks)

    def _lookup(self, tokens, max_prefix):
        tokens = np.asarray(tokens).astype(np.int32).reshape(-1)
        limit = tokens.shape[0] if max_prefix is None \
            else min(max_prefix, tokens.shape[0])
        keys, blocks = [], []
        for key in self._chain(tokens, limit // self.block):
            entry = self._pool.get(key)
            if entry is None:
                break
            keys.append(key)
            blocks.append(entry)
        return keys, blocks

    def match(self, tokens, max_prefix: int | None = None):
        """Longest cached block-aligned prefix of ``tokens``: ``(prefix_len,
        blocks)``, the (k, v) entries to hand to ``copy_prefix_into``.
        ``max_prefix`` caps the match (the engine passes ``prompt_len -
        1``: the last prompt position must prefill so its logits exist)."""
        keys, blocks = self._lookup(tokens, max_prefix)
        self._touch_chain(keys)
        if blocks:
            self.hits += len(blocks)
        else:
            self.misses += 1
        return len(blocks) * self.block, blocks

    def peek(self, tokens, max_prefix: int | None = None):
        """:meth:`match` without side effects (no LRU touch, no hit/miss
        accounting). Returns ``(prefix_len, keys, blocks)``."""
        keys, blocks = self._lookup(tokens, max_prefix)
        return len(blocks) * self.block, keys, blocks

    def inject(self, tokens, blocks) -> int:
        """Pool externally computed K/V blocks (``blocks[i]`` is the (k, v)
        pair of full block i of ``tokens``), bypassing second-touch
        promotion; keys already pooled are skipped. Returns how many new
        blocks landed."""
        blocks = list(blocks)
        keys = self._chain(tokens, len(blocks))
        added = 0
        for key, (k, v) in zip(keys, blocks):
            if key not in self._pool:
                self._pool[key] = (k, v)
                self.insertions += 1
                self.injections += 1
                added += 1
        self._touch_chain(keys)
        while len(self._pool) > self.max_blocks:
            self._evict_one()
        return added

    def _evict_one(self) -> None:
        """Drop the LRU entry, notifying ``on_release``."""
        _, entry = self._pool.popitem(last=False)
        self.evictions += 1
        if self._on_release is not None:
            self._on_release(entry)

    def _touch_chain(self, keys) -> None:
        """LRU-touch a chain tail-first, so the head ends up most recent:
        evicting a head would strand its whole tail unreachable."""
        for key in reversed(keys):
            self._pool.move_to_end(key)

    def insert(self, tokens, read_span) -> int:
        """Record the full blocks of ``tokens``; promote the ones seen
        ``promote_after`` times into the pool. ``read_span(start, length)``
        returns the (k, v) span resident at positions [start, start +
        length); it is called at most once per insert, for the contiguous
        run of promotable blocks. Returns how many new blocks landed."""
        tokens = np.asarray(tokens).astype(np.int32).reshape(-1)
        n_full = tokens.shape[0] // self.block
        keys = self._chain(tokens, n_full)
        i = 0
        while i < n_full and keys[i] in self._pool:
            i += 1
        j = i
        while j < n_full and \
                self._seen.get(keys[j], 0) + 1 >= self.promote_after:
            j += 1
        added = 0
        if j > i:
            k, v = read_span(i * self.block, (j - i) * self.block)
            self.reads += 1
            for b in range(i, j):
                o = (b - i) * self.block
                self._pool[keys[b]] = (span_slice(k, o, self.block),
                                       span_slice(v, o, self.block))
                self._seen.pop(keys[b], None)
                self.insertions += 1
                added += 1
        # one tail-first recency pass over the whole pooled chain, THEN
        # trim, so the chain head outlives its tail
        self._touch_chain(keys[:j])
        while len(self._pool) > self.max_blocks:
            self._evict_one()
        for b in range(j, n_full):
            self._seen[keys[b]] = self._seen.get(keys[b], 0) + 1
            self._seen.move_to_end(keys[b])
            while len(self._seen) > self._seen_cap:
                self._seen.popitem(last=False)
        return added

    def stats(self) -> dict:
        return {
            "blocks": len(self._pool),
            "block_tokens": self.block,
            "max_blocks": self.max_blocks,
            "promote_after": self.promote_after,
            "hits": self.hits,
            "misses": self.misses,
            "insertions": self.insertions,
            "injections": self.injections,
            "evictions": self.evictions,
            "reads": self.reads,
        }
