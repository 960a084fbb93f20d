"""Prefetching loader: the counterpart of ``openess_tpu/data/pipeline.py``.

``num_workers`` threads assemble and upload the next batches while the
device runs the current step. Threads suffice: the host C++ (the packer,
the host voxelizers), PNG decoding and h5 reads release the GIL, and the
windowed C++ calls spread over ``num_cpu_workers`` threads of their own.
Batches come out in submission order whatever the worker count, so a
shuffle stays reproducible; the order is :func:`batch_indices`'.

On a CUDA device each worker assembles and uploads on a stream of its own,
so a batch's copies and any kernel its ``get_batch`` launches (K5, K6 on
the grid wire) overlap the step on the consumer's stream. The consumer's
stream waits on an event recorded after that work, and every CUDA tensor
of the batch is marked as used there (``record_stream``), so its memory
is not handed out again while the step still reads it.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch


def batch_indices(n: int, batch_size: int, *, shuffle: bool, rng,
                  drop_last: bool, pad_last: bool):
    """Yield ``(indices, valid)`` per batch. ``drop_last`` drops a trailing
    partial batch (training). ``pad_last`` pads it to ``batch_size`` by
    repeating its last sample and gives every batch a bool ``valid`` mask
    (validation: fixed shapes, exact metrics); otherwise ``valid`` is
    None."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    stop = n - batch_size + 1 if drop_last else n
    for i in range(0, stop, batch_size):
        idx = order[i:i + batch_size]
        if not pad_last:
            yield idx, None
            continue
        valid = np.arange(batch_size) < len(idx)
        pad = batch_size - len(idx)
        if pad:
            idx = np.concatenate([idx, np.full(pad, idx[-1])])
        yield idx, valid


class PrefetchLoader:
    """Batches of ``dataset.get_batch`` over :func:`batch_indices`, each
    passed through ``put_fn`` (the upload) in a worker thread, at most
    ``num_workers + prefetch`` in flight. ``pad_last`` batches carry the
    ``valid`` mask. ``device``: where ``put_fn`` puts the batch; a CUDA
    device gives each worker its own stream (module docstring)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool,
                 rng: Optional[np.random.Generator] = None, put_fn=None,
                 device=None, prefetch: int = 2, drop_last: bool = True,
                 pad_last: bool = False, num_workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = rng or np.random.default_rng(0)
        self.put_fn = put_fn or (lambda b: b)
        self.device = None if device is None else torch.device(device)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_workers = max(1, int(num_workers))

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _assemble(self, idx, valid):
        batch = self.dataset.get_batch(idx)
        if valid is not None:
            batch["valid"] = valid
        return self.put_fn(batch)

    def __iter__(self) -> Iterator[dict]:
        plan = list(batch_indices(
            len(self.dataset), self.batch_size, shuffle=self.shuffle,
            rng=self.rng, drop_last=self.drop_last, pad_last=self.pad_last))
        cuda = self.device is not None and self.device.type == "cuda"
        local = threading.local()

        def work(idx, valid):
            if not cuda:
                return self._assemble(idx, valid), None
            stream = getattr(local, "stream", None)
            if stream is None:
                stream = local.stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(stream):
                batch = self._assemble(idx, valid)
                done = torch.cuda.Event()
                done.record(stream)
            return batch, done

        def take(future):
            batch, done = future.result()
            if done is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(done)
                for v in batch.values():
                    if isinstance(v, torch.Tensor) and v.is_cuda:
                        v.record_stream(stream)
            return batch

        # num_workers batches being assembled, `prefetch` finished ones
        # waiting for the consumer
        max_inflight = self.num_workers + self.prefetch
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            try:
                for idx, valid in plan:
                    pending.append(pool.submit(work, idx, valid))
                    if len(pending) >= max_inflight:
                        yield take(pending.pop(0))
                while pending:
                    yield take(pending.pop(0))
            finally:
                for f in pending:
                    f.cancel()
