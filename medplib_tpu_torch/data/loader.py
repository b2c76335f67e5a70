"""Prefetching training data loader (medplib_tpu/data/loader.py).

Sample loading and preprocessing run in a thread pool (PIL decode, the
numpy resamplers and the tokenizer's string work release the interpreter
lock for much of their time), and finished macro-batches wait in a bounded
queue, so the host prepares the next batch while the device runs the
current step. Deterministic: the index stream is the JAX loader's (same
seed, same permutation, same wrap-around), so resume replay and loss
curves do not depend on the loader or its worker count.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from medplib_tpu_torch.data.dataset import (CollatorConfig, collate,
                                            to_model_batch)


def stack_batches(micros):
    """[Batch] -> one Batch whose tensors carry a leading [accum] axis."""
    from medplib_tpu_torch.models.medplib import Batch
    return Batch(*[None if xs[0] is None else torch.stack(xs)
                   for xs in zip(*micros)])


class PrefetchLoader:
    """Iterates Batch trees with a leading [accum] microbatch axis (the
    train step's contract) on `device`, forever, loading samples
    concurrently. num_workers=0 loads synchronously in the caller's
    thread. shard=(i, n): load only block i of n of every global batch of
    batch_size rows (a process's rows under a mesh; the index stream is
    the same in every process)."""

    def __init__(self, dataset, cc: CollatorConfig, batch_size: int,
                 accum_steps: int = 1, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 42, collate_fn=None,
                 device="cuda", shard=(0, 1)):
        if batch_size % shard[1]:
            raise ValueError(f"batch of {batch_size} rows does not split "
                             f"over {shard[1]} shards")
        self.dataset = dataset
        self.cc = cc
        # collate_fn(samples, cc) -> (arrays, meta): data/icl_dataset's
        # collate_icl for the ICL stage
        self.collate_fn = collate_fn or collate
        self.batch_size = batch_size
        self.accum_steps = accum_steps
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.device = device
        self.shard = shard
        self._stop = threading.Event()

    def _index_stream(self) -> Iterator[list]:
        """Per step, accum_steps groups of batch_size dataset indices: one
        seeded permutation, read in order and wrapped around."""
        rng = np.random.default_rng(self.seed)
        order = rng.permutation(len(self.dataset))
        pos = 0
        while True:
            micro_groups = []
            for _ in range(self.accum_steps):
                micro_groups.append([int(order[(pos + j) % len(self.dataset)])
                                     for j in range(self.batch_size)])
                pos += self.batch_size
            yield micro_groups

    def _build(self, micro_groups, pool: Optional[ThreadPoolExecutor]):
        i, n = self.shard
        c = self.batch_size // n
        micro_groups = [g[i * c:(i + 1) * c] for g in micro_groups]
        if pool is not None:
            flat = [i for g in micro_groups for i in g]
            it = iter(list(pool.map(self.dataset.__getitem__, flat)))
            samples_per_group = [[next(it) for _ in g] for g in micro_groups]
        else:
            samples_per_group = [[self.dataset[i] for i in g]
                                 for g in micro_groups]
        micros = [to_model_batch(self.collate_fn(samples, self.cc)[0],
                                 self.device)
                  for samples in samples_per_group]
        return stack_batches(micros)

    def __iter__(self):
        if self.num_workers <= 0:
            for groups in self._index_stream():
                if self._stop.is_set():
                    return
                yield self._build(groups, None)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        pool = ThreadPoolExecutor(self.num_workers)
        err: list = []

        def put(item) -> bool:
            """Bounded put that gives up once the consumer went away."""
            while not self._stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for groups in self._index_stream():
                    if not put(self._build(groups, pool)):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised below
                err.append(e)
                put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    raise err[0]
                yield batch
        finally:
            self._stop.set()
            pool.shutdown(wait=False)

    def close(self):
        self._stop.set()
