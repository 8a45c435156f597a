"""Batched loading and the host-to-device feed (counterpart of ``tubedetr_tpu/data/loader.py``).

``DataLoader`` yields ``(batch, meta)`` pairs: the indices shuffled with
``default_rng(seed + epoch)`` (``set_epoch``; the processes pass one seed,
so their shares partition the epoch), sharded contiguous-strided over
processes, grouped into batches (``drop_last`` for training: the indices
cut to a multiple of the processes' global batch first, so every process
runs the same number of steps and no collective waits alone), each
sample cut into ``div_vid``-frame clips for evaluation, and collated. With
``num_workers`` a producer thread fetches each batch's samples on a pool of
that many threads and keeps up to ``prefetch`` collated batches in a
bounded queue. ``ConcatDataset`` and ``EpochChunkView`` are the CLI's
``--combine_datasets`` and ``--epoch_chunks``.

``DevicePrefetcher`` (``--device_prefetch N``) copies the next ``N``
batches to the card on a thread of its own, from pinned memory with
``non_blocking`` copies on a side stream; the consumer's stream waits on
each batch's event, and the batch's tensors are recorded on that stream so
the caching allocator does not hand their memory back while a step still
reads it. ``prefetch_to_device`` is the same-thread feed for
``--device_prefetch 0``. A loader error re-raises in the consumer.
"""

from __future__ import annotations

import collections
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Queue
from typing import Iterator, List, Sequence

import numpy as np
import torch

from tubedetr_tpu_torch.data.collate import batch_meta, collate, split_video_into_clips

_END = object()


def _drain(q: Queue, thread: threading.Thread) -> None:
    """Unblock a producer waiting on a full queue, then join it."""
    while thread.is_alive():
        try:
            q.get(timeout=0.05)
        except Empty:
            pass
    thread.join()


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        t: int,
        stride: int,
        max_text_len: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 42,
        num_workers: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        div_vid: int = 0,
        with_fast: bool = True,
        tokenizer=None,
        prefetch: int = 2,
        frames_dtype="float32",
        compact_pad_masks: bool = False,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.t = t
        self.stride = stride
        self.max_text_len = max_text_len
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.process_index = process_index
        self.process_count = process_count
        self.div_vid = div_vid
        self.with_fast = with_fast
        self.tokenizer = tokenizer
        self.prefetch = prefetch
        self.frames_dtype = frames_dtype
        self.compact_pad_masks = compact_pad_masks
        self.pin_memory = pin_memory
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self) -> List[int]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        if self.drop_last:  # every process the same number of batches
            idx = idx[:len(idx) - len(idx) % (self.process_count * self.batch_size)]
        return list(idx[self.process_index::self.process_count])

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def _batches(self) -> List[List[int]]:
        """This epoch's index groups, in order."""
        indices = self._indices()
        groups = [indices[i:i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            groups = [g for g in groups if len(g) == self.batch_size]
        return groups

    def _make_batch(self, samples) -> tuple:
        t = self.t
        if self.div_vid:
            samples = [c for s in samples for c in split_video_into_clips(s, self.div_vid)]
            t = self.div_vid
        batch = collate(samples, t, self.stride, self.max_text_len, with_fast=self.with_fast,
                        compact_pad_masks=self.compact_pad_masks, frames_dtype=self.frames_dtype,
                        tokenizer=self.tokenizer, pin_memory=self.pin_memory)
        return batch, batch_meta(samples)

    def __iter__(self) -> Iterator:
        groups = self._batches()
        if self.num_workers <= 0:
            for g in groups:
                yield self._make_batch([self.dataset[int(i)] for i in g])
            return

        q: Queue = Queue(maxsize=max(self.prefetch, 1))
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for g in groups:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, [int(i) for i in g]))
                        q.put(self._make_batch(samples))
                q.put(_END)
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                q.put(e)

        th = threading.Thread(target=producer, name="loader", daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            _drain(q, th)


def _host_tensors(batch: dict, pin: bool) -> dict:
    """Each numpy array of ``batch`` as a CPU tensor, pinned with ``pin``."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if pin and torch.is_tensor(v) and v.device.type == "cpu" and not v.is_pinned():
            v = v.pin_memory()
        out[k] = v
    return out


def _to(batch: dict, device: torch.device, non_blocking: bool = False) -> dict:
    return {k: v.to(device, non_blocking=non_blocking) if torch.is_tensor(v) else v
            for k, v in batch.items()}


class DevicePrefetcher:
    """Copy the next ``size`` batches of ``loader`` to ``device`` on a
    thread of its own, so the upload of batch k+1 runs behind step k.

    On the card: each batch's tensors are pinned (the loader's collate
    already pins its frames), copied with ``non_blocking=True`` inside
    ``torch.cuda.stream(side)``, and an event is recorded after the copies.
    The consumer's current stream waits on that event before the batch is
    yielded, and ``record_stream`` marks each device tensor as used on it.
    The pinned host tensors stay referenced until their event has completed.
    On the CPU there is nothing to overlap: the thread only moves the batch
    (numpy arrays become tensors), and the first iteration prints so."""

    def __init__(self, loader, size: int = 2, device="cuda"):
        self.loader, self.size, self.device = loader, size, torch.device(device)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        device = self.device
        on_card = device.type == "cuda"
        if on_card and device.index is None:  # the producer thread names the card
            device = torch.device("cuda", torch.cuda.current_device())
        if not on_card:
            print(f"[prefetch] device {device}: batches are only moved (no side stream, "
                  "no pinned memory)")
        side = torch.cuda.Stream(device) if on_card else None
        q: Queue = Queue(maxsize=max(self.size, 1))
        stop = threading.Event()

        def producer():
            try:
                if on_card:
                    torch.cuda.set_device(device)
                for batch, meta in self.loader:
                    if stop.is_set():
                        return
                    host = _host_tensors(batch, pin=on_card)
                    if on_card:
                        with torch.cuda.stream(side):
                            dev = _to(host, device, non_blocking=True)
                            event = torch.cuda.Event()
                            event.record(side)
                    else:
                        dev, event = _to(host, device), None
                    q.put((dev, meta, event, host))
                q.put(_END)
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                q.put(e)

        th = threading.Thread(target=producer, name="device-prefetch", daemon=True)
        th.start()
        in_flight = collections.deque()  # (event, pinned host batch) until the copy is done
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                dev, meta, event, host = item
                if on_card:
                    consumer = torch.cuda.current_stream(device)
                    consumer.wait_event(event)
                    for v in dev.values():
                        if torch.is_tensor(v):
                            v.record_stream(consumer)
                    in_flight.append((event, host))
                    while in_flight and in_flight[0][0].query():
                        in_flight.popleft()
                del host
                yield dev, meta
        finally:
            stop.set()
            _drain(q, th)
            for event, _ in in_flight:
                event.synchronize()


def prefetch_to_device(iterator, device, size: int = 2):
    """Same-thread double buffering: keep ``size`` batches' copies in flight
    ahead of the consumer. Copies from pinned memory are asynchronous on the
    current stream, so they overlap only while the consumer does not wait
    on the card."""
    device = torch.device(device)
    queue = collections.deque()

    def enqueue(n):
        for _ in range(n):
            try:
                batch, meta = next(iterator)
            except StopIteration:
                return
            queue.append((_to(_host_tensors(batch, pin=False), device, non_blocking=True), meta))

    enqueue(size)
    while queue:
        yield queue.popleft()
        enqueue(1)


class ConcatDataset:
    """The datasets of ``--combine_datasets`` one after another."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx: int):
        di = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.datasets[di][idx - int(self.offsets[di])]

    def set_epoch(self, epoch: int):
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)


class EpochChunkView:
    """Chunk ``chunk`` of ``n_chunks`` of a permutation of ``dataset``
    (``--epoch_chunks``: checkpoints and evaluation more often than once an
    epoch)."""

    def __init__(self, dataset, n_chunks: int, chunk: int, seed: int = 42):
        perm = np.random.default_rng(seed).permutation(len(dataset))
        per = math.ceil(len(dataset) / n_chunks)
        self.indices = perm[chunk * per:(chunk + 1) * per]
        self.dataset = dataset

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[int(self.indices[i])]

    def set_epoch(self, epoch: int):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
