"""Batch loader: dataset + train pipeline -> fixed-shape batches of tensors.

Port of ``r3det_tpu/datasets/loader.py::DetLoader``. Every batch is
{'image': (B, H, W, 3) f32, 'gt_bboxes': (B, G, 5), 'gt_labels': (B, G)
int32, 'gt_mask': (B, G) bool}, tensors on the loader's device (the card
unless the caller asks for the CPU), collated by ``torch.stack``. Samples
the pipeline rejects (PolyRandomRotate killing all gt) are resampled, as
mmdet's None-filtering collate does.

The host work, reading and decoding each file (``image_io``: zlib and the
C++ unfilter release the GIL), runs in a thread pool ahead of the batch
being built. The pipeline (its copy to the device, its transforms there
and its random draws) runs on one producer thread in sample order, so a
batch is the JAX loader's with ``num_workers=1`` for any worker count;
with more workers the JAX loader's draws follow thread timing.
"""
import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class DetLoader:
    """``batch_size`` is the PER-PROCESS batch. With ``process_index`` /
    ``process_count`` every process draws the same seeded epoch
    permutation and takes its own stride of it (DistributedSampler
    semantics), so the union over processes covers the epoch once.
    ``prefetch`` batches wait in a queue; the pool decodes up to
    ``(prefetch + 1) * batch_size`` samples ahead of the one the pipeline
    takes."""

    def __init__(self, dataset, pipeline, batch_size=2, shuffle=True,
                 seed=0, prefetch=2, drop_last=True, num_workers=4,
                 process_index=0, process_count=1, device='cuda'):
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("DetLoader: no CUDA card; pass device='cpu' "
                               'to load batches on the CPU')
        if not 0 <= process_index < process_count:
            raise ValueError(f'process_index {process_index} outside '
                             f'[0, {process_count})')
        self.dataset = dataset
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.process_index = process_index
        self.process_count = process_count
        self.device = device

    def __len__(self):
        n = len(self.dataset) // self.process_count \
            if self.process_count > 1 else len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def _sample(self, sample):
        """The pipeline on a decoded sample; a rejected one is replaced by
        a sample drawn with the loader's generator (decoded here)."""
        for _ in range(10):
            out = self.pipeline(sample)
            if out is not None:
                return out
            sample = self.dataset.get_sample(
                self.rng.randint(len(self.dataset)))
        raise RuntimeError('pipeline rejected 10 consecutive samples')

    def _epoch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            # the same permutation on every process (seeded identically):
            # the per-process strides partition the epoch exactly
            self.rng.shuffle(idx)
        if self.process_count > 1:
            idx = idx[self.process_index::self.process_count]
        return idx

    def _batches(self):
        """This epoch's batches of dataset indices."""
        idx = self._epoch_indices()
        out = []
        for b in range(len(self)):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                break
            out.append(chunk)
        return out

    def _collate(self, samples):
        return {k: torch.stack([s[k] for s in samples]).to(self.device)
                for k in samples[0]}

    def __iter__(self):
        q = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def _put(item):
            # poll, so the producer ends soon after the consumer walks away
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                batches = self._batches()
                order = collections.deque(i for c in batches for i in c)
                ahead = (self.prefetch + 1) * self.batch_size
                decoding = collections.deque()
                for chunk in batches:
                    samples = []
                    for _ in chunk:
                        if stop.is_set():
                            return
                        while order and len(decoding) < ahead:
                            decoding.append(pool.submit(
                                self.dataset.get_sample, order.popleft()))
                        samples.append(self._sample(
                            decoding.popleft().result()))
                    if not _put(self._collate(samples)):
                        return
                _put(sentinel)
            except BaseException as e:         # handed to the consumer
                _put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
            thread.join()
