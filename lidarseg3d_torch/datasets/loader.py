"""Input pipeline: one process's sampling, threaded prefetch and the
padded collate (own copy of EpochSampler and the thread mode of
SegDataLoader in lidarseg3d_tpu/datasets/loader.py).

Frame ``j`` of batch ``step`` in epoch ``epoch`` draws from
``np.random.default_rng((seed * 1_000_003 + epoch) * 1_000_003 + step * 64
+ j)``, the JAX package's seeding, so both loaders give the same batches.
The shared-memory and process worker modes are not ported yet and raise.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .batching import collate_segnet


class EpochSampler:
    """Deterministic per-epoch shuffling for one process. The JAX
    package's multi-host sharding (ROADMAP A7) and grouped shuffle come
    with their first caller."""

    def __init__(self, n, batch_size, shuffle=True, seed=0, drop_last=True):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def epoch_indices(self, epoch):
        idx = np.arange(self.n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + epoch).permutation(idx)
        if self.drop_last:
            nb = len(idx) // self.batch_size
            idx = idx[: nb * self.batch_size]
        else:
            nb = -(-len(idx) // self.batch_size)
            idx = np.resize(idx, nb * self.batch_size)  # wraps if short
        return idx.reshape(-1, self.batch_size)

    def steps_per_epoch(self):
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)


class SegDataLoader:
    """Prefetching loader producing padded numpy batches, built by a pool
    of threads (``worker_mode="thread"``). Use it as a context manager, or
    call ``shutdown``, to stop the pool."""

    def __init__(self, dataset, batch_size, max_voxels, max_points,
                 shuffle=True, seed=0, num_workers=4, prefetch=4,
                 drop_last=True, ignore_label=0, worker_mode="thread",
                 on_overflow="warn"):
        if worker_mode != "thread":
            raise NotImplementedError(
                f"SegDataLoader worker_mode={worker_mode!r} is not ported "
                "to lidarseg3d_torch yet (only 'thread' is)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_voxels = max_voxels
        self.max_points = max_points
        self.sampler = EpochSampler(len(dataset), batch_size, shuffle, seed,
                                    drop_last)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.ignore_label = ignore_label
        self.on_overflow = on_overflow
        self.seed = seed
        self.worker_mode = worker_mode
        self._pool = None

    def steps_per_epoch(self):
        return self.sampler.steps_per_epoch()

    def _make_batch(self, batch_idx, epoch, step):
        frames = []
        for j, i in enumerate(batch_idx):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + epoch) * 1_000_003 + step * 64 + j)
            fr = self.dataset.get_sensor_data(int(i), rng=rng)
            frames.extend(fr if isinstance(fr, list) else [fr])
        return collate_segnet(frames, self.max_voxels, self.max_points,
                              self.ignore_label, self.on_overflow)

    def epoch(self, epoch):
        """Yield the batches of one epoch in order, each built ahead by the
        pool (at most max(prefetch, num_workers) in flight)."""
        batches = self.sampler.epoch_indices(epoch)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        window = max(self.prefetch, self.num_workers)
        futures = [self._pool.submit(self._make_batch, bidx, epoch, step)
                   for step, bidx in enumerate(batches[:window])]
        nxt = len(futures)
        for i in range(len(batches)):
            batch = futures[i].result()
            futures[i] = None  # drop the finished batch's reference now
            if nxt < len(batches):
                futures.append(self._pool.submit(
                    self._make_batch, batches[nxt], epoch, nxt))
                nxt += 1
            yield batch

    def shutdown(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
