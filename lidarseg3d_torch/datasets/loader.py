"""Input pipeline: each process's shard of the sampling, prefetch by a
pool of workers and the padded collate (own copy of EpochSampler and
SegDataLoader in lidarseg3d_tpu/datasets/loader.py).

Frame ``j`` of batch ``step`` in epoch ``epoch`` draws from
``np.random.default_rng((seed * 1_000_003 + epoch) * 1_000_003 + step * 64
+ j)``, the JAX package's seeding, so every worker mode and both packages
give the same batches.

Worker modes:
- ``thread``: a thread pool in this process (the pipeline's numpy holds
  the GIL for part of its time);
- ``process``: spawned worker processes; each batch comes back pickled
  through a pipe;
- ``shm``: spawned worker processes that write each batch's arrays into
  a ring of shared-memory slots, whose layout comes from one batch built
  in this process (the collated shapes are static); only the metadata
  travels through a queue. ``shutdown`` (or the context manager) stops
  the workers and unlinks the blocks. With one worker, ``shm`` runs as
  ``thread``, as in the JAX package.
Workers are spawned, never forked (the parent may hold a CUDA context),
and hide every card from themselves before they build a batch; a
worker's exception is raised in this process when its batch is due.
"""

import atexit
import os
import pickle
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .batching import collate_segnet

MODES = ("thread", "process", "shm")


def default_worker_mode(cfg_data):
    """The config's ``worker_mode``, else ``shm`` on a host with more than
    two CPUs and ``thread`` on a smaller one (the JAX tools' default)."""
    return cfg_data.get("worker_mode",
                        "shm" if (os.cpu_count() or 1) > 2 else "thread")


def _hide_cards():
    """A worker builds batches on the host only: no CUDA context."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def make_batch(dataset, batch_idx, epoch, step, seed, max_voxels,
               max_points, ignore_label, on_overflow="warn"):
    """Collated batch ``step`` of epoch ``epoch``: frame j of
    ``batch_idx`` from the generator of the loader's seeding."""
    frames = []
    for j, i in enumerate(batch_idx):
        rng = np.random.default_rng(
            (seed * 1_000_003 + epoch) * 1_000_003 + step * 64 + j)
        fr = dataset.get_sensor_data(int(i), rng=rng)
        frames.extend(fr if isinstance(fr, list) else [fr])
    return collate_segnet(frames, max_voxels, max_points, ignore_label,
                          on_overflow)


def _slot_views(buf, schema):
    """{key: ndarray} views of one slot's block, in schema order."""
    view, off = {}, 0
    for key, (shape, dtype) in schema.items():
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        view[key] = np.ndarray(shape, dtype, buffer=buf[off:off + nbytes])
        off += nbytes
    return view


def _shm_worker(ds_bytes, schema, shm_names, task_q, done_q, seed,
                max_voxels, max_points, ignore_label, on_overflow):
    """Shared-memory worker (a spawned process): builds the batches it is
    asked for and writes their arrays into the given slot; the rest of a
    batch (metadata) goes back on the done queue, an exception as its
    traceback."""
    _hide_cards()
    from multiprocessing import shared_memory

    dataset = pickle.loads(ds_bytes)
    shms = [shared_memory.SharedMemory(name=n) for n in shm_names]
    views = [_slot_views(shm.buf, schema) for shm in shms]
    try:
        while True:
            task = task_q.get()
            if task is None:
                return
            slot, step, epoch, batch_idx = task
            try:
                batch = make_batch(dataset, batch_idx, epoch, step, seed,
                                   max_voxels, max_points, ignore_label,
                                   on_overflow)
                extras = {}
                for key, val in batch.items():
                    if key in schema:
                        views[slot][key][...] = val
                    else:
                        extras[key] = val
                done_q.put((step, slot, extras, None))
            except Exception:
                done_q.put((step, slot, None, traceback.format_exc()))
    finally:
        del views
        for shm in shms:
            shm.close()


class EpochSampler:
    """Deterministic per-epoch shuffling, sharded over ``num_hosts``
    processes as the JAX package's sampler shards it: the epoch's order
    (a permutation drawn from ``seed + epoch``, or dataset order) is
    padded with its leading frames to a multiple of ``num_hosts``, and
    process ``host_id`` takes every ``num_hosts``-th frame from its own
    position. So every process takes the same number of batches. The JAX
    package's grouped shuffle (``flags``) is left out: no dataset of the
    port has more than one group."""

    def __init__(self, n, batch_size, shuffle=True, seed=0, num_hosts=1,
                 host_id=0, drop_last=True):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.drop_last = drop_last

    def _shard(self, epoch):
        """-> (this process's frames, and whether each is its frame's
        first appearance in the padded epoch: False for the padding)."""
        idx = np.arange(self.n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + epoch).permutation(idx)
        per_host = -(-len(idx) // self.num_hosts)
        pad = per_host * self.num_hosts - len(idx)
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
        first = np.arange(len(idx)) < self.n
        return (idx[self.host_id::self.num_hosts],
                first[self.host_id::self.num_hosts])

    def _batched(self, a, fill):
        if self.drop_last:
            nb = len(a) // self.batch_size
            a = a[: nb * self.batch_size]
        else:
            nb = -(-len(a) // self.batch_size)
            short = nb * self.batch_size - len(a)
            # the frames wrap around if short (the padding is no frame's
            # first appearance)
            a = np.concatenate([a, np.resize(a, short) if fill is None
                                else np.full(short, fill)])
        return a.reshape(-1, self.batch_size)

    def epoch_indices(self, epoch):
        return self._batched(self._shard(epoch)[0], None)

    def owned(self, epoch):
        """[batches, batch_size] bools beside ``epoch_indices``: True where
        this process evaluates the frame for the whole run, False on the
        repeated frames that pad the shards and the last batch. Over all
        processes each frame is True exactly once (unless drop_last drops
        it)."""
        return self._batched(self._shard(epoch)[1], False)

    def steps_per_epoch(self):
        per_host = -(-self.n // self.num_hosts)
        if self.drop_last:
            return per_host // self.batch_size
        return -(-per_host // self.batch_size)


class SegDataLoader:
    """Prefetching loader producing padded numpy batches of this process's
    shard (``num_hosts``, ``host_id``: EpochSampler), built by a pool of
    workers (``worker_mode``: ``thread``, ``process`` or ``shm``; see the
    module's docstring). Use it as a context manager, or call
    ``shutdown``, to stop the workers."""

    def __init__(self, dataset, batch_size, max_voxels, max_points,
                 shuffle=True, seed=0, num_hosts=1, host_id=0,
                 num_workers=4, prefetch=4, drop_last=True, ignore_label=0,
                 worker_mode="thread", on_overflow="warn"):
        if worker_mode not in MODES:
            raise ValueError(f"SegDataLoader worker_mode={worker_mode!r}: "
                             f"one of {MODES}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_voxels = max_voxels
        self.max_points = max_points
        self.sampler = EpochSampler(len(dataset), batch_size, shuffle, seed,
                                    num_hosts, host_id, drop_last)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.ignore_label = ignore_label
        self.on_overflow = on_overflow
        self.seed = seed
        self.worker_mode = worker_mode
        self._pool = None
        self._shm = None

    def steps_per_epoch(self):
        return self.sampler.steps_per_epoch()

    def _args(self):
        return (self.seed, self.max_voxels, self.max_points,
                self.ignore_label, self.on_overflow)

    def _make_batch(self, batch_idx, epoch, step):
        return make_batch(self.dataset, batch_idx, epoch, step,
                          *self._args())

    def _submit(self, bidx, epoch, step):
        if self._pool is None:
            if self.worker_mode == "process":
                import multiprocessing
                from concurrent.futures import ProcessPoolExecutor

                self._pool = ProcessPoolExecutor(
                    max_workers=self.num_workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_hide_cards)
            else:
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        if self.worker_mode == "process":
            return self._pool.submit(make_batch, self.dataset, bidx, epoch,
                                     step, *self._args())
        return self._pool.submit(self._make_batch, bidx, epoch, step)

    def _start_shm(self, schema):
        """Create the slot ring and spawn the shared-memory workers."""
        import multiprocessing as mp
        from multiprocessing import shared_memory

        ctx = mp.get_context("spawn")
        n_slots = max(self.prefetch, self.num_workers) + 2
        total = sum(int(np.prod(shape)) * np.dtype(dtype).itemsize
                    for shape, dtype in schema.values())
        st = dict(schema=schema, blocks=[], procs=[], views=[],
                  task_q=ctx.Queue(), done_q=ctx.Queue())
        self._shm = st  # from here on, shutdown unlinks what exists
        for _ in range(n_slots):
            st["blocks"].append(shared_memory.SharedMemory(
                create=True, size=max(total, 1)))
        st["views"] = [_slot_views(b.buf, schema) for b in st["blocks"]]
        ds_bytes = pickle.dumps(self.dataset)
        names = [b.name for b in st["blocks"]]
        for _ in range(self.num_workers):
            p = ctx.Process(target=_shm_worker, daemon=True, args=(
                ds_bytes, schema, names, st["task_q"], st["done_q"],
                *self._args()))
            p.start()
            st["procs"].append(p)
        atexit.register(self.shutdown)

    def _epoch_shm(self, epoch, batches):
        """The epoch through the slot ring, in batch order."""
        if self._shm is None:
            probe = self._make_batch(batches[0], epoch, 0)
            self._start_shm({k: (v.shape, v.dtype) for k, v in probe.items()
                             if isinstance(v, np.ndarray)})
        st = self._shm
        free = list(range(len(st["blocks"])))
        pending, nxt = {}, 0

        def submit():
            nonlocal nxt
            while free and nxt < len(batches):
                st["task_q"].put((free.pop(), nxt, epoch,
                                  list(batches[nxt])))
                nxt += 1

        submit()
        for step in range(len(batches)):
            while step not in pending:
                done, slot, extras, err = self._next_done(st)
                if err is not None:
                    raise RuntimeError(f"loader worker failed on batch "
                                       f"{done} of epoch {epoch}:\n{err}")
                # copy out of the slot, then hand the slot on at once
                batch = {k: np.array(v) for k, v in st["views"][slot].items()}
                batch.update(extras)
                pending[done] = batch
                free.append(slot)
                submit()
            yield pending.pop(step)

    @staticmethod
    def _next_done(st):
        """The next finished batch; raises if every worker has died."""
        import queue

        while True:
            try:
                return st["done_q"].get(timeout=5)
            except queue.Empty:
                if not any(p.is_alive() for p in st["procs"]):
                    codes = [p.exitcode for p in st["procs"]]
                    raise RuntimeError(f"every loader worker exited "
                                       f"(exit codes {codes})")

    def epoch(self, epoch):
        """Yield the batches of one epoch in order, each built ahead by the
        workers (at most max(prefetch, num_workers) in flight; the slot
        ring holds two more)."""
        batches = self.sampler.epoch_indices(epoch)
        if (self.worker_mode == "shm" and self.num_workers > 1
                and len(batches) > 0):
            yield from self._epoch_shm(epoch, batches)
            return
        window = max(self.prefetch, self.num_workers)
        futures = [self._submit(bidx, epoch, step)
                   for step, bidx in enumerate(batches[:window])]
        nxt = len(futures)
        for i in range(len(batches)):
            batch = futures[i].result()
            futures[i] = None  # drop the finished batch's reference now
            if nxt < len(batches):
                futures.append(self._submit(batches[nxt], epoch, nxt))
                nxt += 1
            yield batch

    def shutdown(self):
        """Stop the workers and unlink the shared-memory blocks."""
        import queue

        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        st, self._shm = self._shm, None
        if st is None:
            return
        atexit.unregister(self.shutdown)
        try:
            while True:  # batches nobody will read
                st["task_q"].get_nowait()
        except queue.Empty:
            pass
        for _ in st["procs"]:
            st["task_q"].put(None)
        for p in st["procs"]:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
        st["views"].clear()
        for block in st["blocks"]:
            try:
                block.close()
            except BufferError:  # a view still exported: unlink all same
                pass
            block.unlink()
        for q in (st["task_q"], st["done_q"]):
            q.cancel_join_thread()
            q.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
