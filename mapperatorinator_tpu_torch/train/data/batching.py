"""Batching: token-balanced bin-packing and host->device collation.

``TokenBalancedBatcher`` buffers N samples, sorts by token count, and greedily
heap-packs them into equal-cost batches (reference:
``osuT5/osuT5/utils/model_utils.py:627-690``) — on TPU this equalizes the
useful work per static-shape batch. ``cycle_interleave`` reproduces the
cycle-length interleaving of sub-iterators (reference: ors_dataset.py:153-187).
"""

from __future__ import annotations

import heapq
import random
from typing import Any, Iterable, Iterator

import numpy as np


class TokenBalancedBatcher:
    def __init__(self, source_dataset: Iterable[dict], batch_size: int = 16, buffer_size: int = 2048):
        assert buffer_size % batch_size == 0, "Buffer size must be an integer multiple of batch_size."
        self.source_dataset = source_dataset
        self.batch_size = batch_size
        self.buffer_size = buffer_size

    def __iter__(self) -> Iterator[list[dict]]:
        buffer: list[tuple[int, dict]] = []
        for sample in self.source_dataset:
            length = int(np.sum(sample["decoder_attention_mask"]))
            buffer.append((length, sample))
            if len(buffer) == self.buffer_size:
                yield from self._emit_batches(buffer)
                buffer = []
        if buffer:
            yield from self._emit_batches(buffer)

    def _emit_batches(self, buffer: list[tuple[int, dict]]) -> Iterator[list[dict]]:
        batch_size = self.batch_size
        num_batches = len(buffer) // batch_size
        usable = num_batches * batch_size
        buffer = sorted(buffer[:usable], key=lambda x: x[0], reverse=True)

        batches: list[list[dict]] = [[] for _ in range(num_batches)]
        totals = [0] * num_batches
        heap = [(0, i) for i in range(num_batches)]
        heapq.heapify(heap)

        for length, sample in buffer:
            total, batch_idx = heapq.heappop(heap)
            batches[batch_idx].append(sample)
            totals[batch_idx] += length
            if len(batches[batch_idx]) < batch_size:
                heapq.heappush(heap, (totals[batch_idx], batch_idx))

        for batch in batches:
            if len(batch) == batch_size:
                yield batch


def collate_batch(samples: list[dict]) -> dict:
    """Stack per-sample dicts into batched numpy arrays."""
    keys = samples[0].keys()
    out = {}
    for key in keys:
        vals = [np.asarray(s[key]) for s in samples]
        out[key] = np.stack(vals, axis=0)
    return out


def prefetch_iterator(iterable: Iterable[Any], buffer_size: int = 4) -> Iterator[Any]:
    """Run the (host-side) data pipeline on a background thread so audio
    decode/parsing overlaps device steps — the role of the reference's torch
    DataLoader workers (model_utils.py:555-624). Exceptions propagate to the
    consumer; the thread is a daemon so abandoned iterators don't hang exit."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    _END = object()

    def produce():
        try:
            for item in iterable:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 — forwarded to consumer
            q.put(e)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def cycle_interleave(factory, items: list, cycle_length: int) -> Iterator[Any]:
    """Round-robin over ``cycle_length`` concurrently-open sub-iterators, each
    built by ``factory`` over a shard of ``items``."""
    if cycle_length <= 1:
        yield from factory(items)
        return
    shards = [items[i::cycle_length] for i in range(cycle_length)]
    iterators = [iter(factory(shard)) for shard in shards if shard]
    while iterators:
        alive = []
        for it in iterators:
            try:
                yield next(it)
                alive.append(it)
            except StopIteration:
                pass
        iterators = alive


def batch_iterator(
    dataset: Iterable[dict],
    batch_size: int,
    balancer_buffer_size: int = 0,
    drop_last: bool = True,
    seed: int = 0,
) -> Iterator[dict]:
    """Dataset -> collated numpy batches, with optional token balancing."""
    if balancer_buffer_size > 0:
        for batch in TokenBalancedBatcher(dataset, batch_size, balancer_buffer_size):
            yield collate_batch(batch)
        return

    batch: list[dict] = []
    for sample in dataset:
        batch.append(sample)
        if len(batch) == batch_size:
            yield collate_batch(batch)
            batch = []
    if batch and not drop_last:
        yield collate_batch(batch)
