"""Host input-pipeline utilities: fixed-shape batching and device prefetch.

Replacement for the reference's uniform
``.shuffle(k·batch).batch(b).prefetch(10)`` idiom (``ctr/train.py:59-61``,
``dien/train.py:120-122``, ``esmm/train.py:219-234``, ``eges/train.py:99-103``)
without the tf.data C++ runtime: numpy batches are produced by (optionally
background-threaded) generators and transferred ahead of compute so the
device never waits on the host.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import jax
import numpy as np


def batch_iterator(
    arrays: dict,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    epochs: int | None = 1,
    start_batch: int = 0,
) -> Iterator[dict]:
    """Yield dict batches from a dict of equal-length numpy arrays.

    ``start_batch`` skips that many batches of the (seed-determined) stream
    before yielding — the data-iterator half of checkpoint resume: a run
    restored at step k continues on exactly the batches it would have seen
    (``start_batch=k``). Skipping is index arithmetic; whole skipped epochs
    still draw their permutation so the stream stays bit-identical.
    """
    n = len(next(iter(arrays.values())))
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        stop = (n // batch_size) * batch_size if drop_remainder else n
        per_epoch = len(range(0, stop, batch_size))
        if start_batch >= per_epoch:
            if shuffle:
                rng.permutation(n)  # consume this epoch's draw
            start_batch -= per_epoch
            epoch += 1
            continue
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(start_batch * batch_size, stop, batch_size):
            sel = idx[s : s + batch_size]
            yield {k: v[sel] for k, v in arrays.items()}
        start_batch = 0
        epoch += 1


class Prefetcher:
    """Background-thread prefetch with clean shutdown.

    ``put_fn`` (e.g. ``Trainer.put_batch``) runs in the background thread so
    H2D transfer overlaps the previous step's compute. ``close()`` (also
    called on garbage collection / generator exit) unblocks and stops the
    producer — without it, endless iterators leak threads parked on full
    queues.
    """

    _END = object()

    def __init__(
        self,
        it: Iterable = None,
        size: int = 2,
        put_fn: Callable = None,
        workers: list | None = None,
    ):
        # ``workers=[it0, it1, ...]`` fans out to one producer thread each
        # (unordered interleave into the shared queue) — for iid sampler
        # streams whose per-batch host cost exceeds the device step, e.g.
        # PinSage block sampling (C++ via ctypes releases the GIL, so
        # threads genuinely parallelize the sampling). Fan-out is EXPLICIT:
        # a plain list passed as ``it`` is treated as one iterable of items
        # (a list of dict batches prefetches the batches, not their keys).
        # ``put_fn`` runs in the producer threads — host-side work only
        # (batch assembly/encoding); device_put belongs on the consumer
        # thread (device APIs are not thread-safe against a concurrently
        # executing jit — see Trainer.fit).
        if workers is not None:
            if it is not None:
                raise ValueError("pass either `it` or `workers=`, not both")
            its = list(workers)
        else:
            if it is None:
                raise ValueError("pass an iterable `it` or `workers=[...]`")
            its = [it]
        self._q: queue.Queue = queue.Queue(maxsize=max(size, len(its)))
        self._stop = threading.Event()
        self._put_fn = put_fn
        self._error: BaseException | None = None
        self._live = len(its)
        self._live_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._producer, args=(i,), daemon=True)
            for i in its
        ]
        for t in self._threads:
            t.start()

    def _producer(self, it):
        try:
            for item in it:
                if self._stop.is_set():
                    return
                out = self._put_fn(item) if self._put_fn else item
                while not self._stop.is_set():
                    try:
                        self._q.put(out, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # surfaced to the consumer in __next__
            self._error = e
        finally:
            # the LAST live producer delivers the END marker (errors end the
            # stream immediately), even when the queue is full (blocking
            # put_nowait would drop it and deadlock the consumer); give up
            # only once the consumer called close()
            with self._live_lock:
                self._live -= 1
                last = self._live == 0
            if last or self._error is not None:
                while not self._stop.is_set():
                    try:
                        self._q.put(Prefetcher._END, timeout=0.1)
                        break
                    except queue.Full:
                        continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is Prefetcher._END:
            if self._error is not None:  # producer died — fail loudly
                raise RuntimeError("prefetch producer failed") from self._error
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # drain so the producer unblocks quickly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        stop = getattr(self, "_stop", None)  # __init__ may raise pre-assignment
        if stop is not None:
            stop.set()


def prefetch_to_device(
    it: Iterable = None,
    size: int = 2,
    put_fn: Callable = None,
    workers: list | None = None,
) -> Prefetcher:
    """One background producer for ``it``, or one per iterable in
    ``workers=[...]`` (unordered interleave) — see ``Prefetcher``."""
    return Prefetcher(it, size=size, put_fn=put_fn, workers=workers)


def interleave_ordered(
    its: list, size: int = 2, put_fn: Callable = None, start_worker: int = 0,
) -> Iterator:
    """DETERMINISTIC round-robin interleave of worker iterators, each
    prefetched by its own background thread.

    ``Prefetcher(workers=[...])`` interleaves UNORDERED (whoever fills the
    queue first) — fine for iid sampler streams (PinSage), wrong for a
    resumable data stream: an unordered merge can never replay
    bit-identically. This merge yields worker 0, 1, …, W-1, 0, … strictly,
    so the merged stream is a pure function of the worker streams — and a
    resumed run reconstructs it exactly by fast-forwarding each worker and
    starting the rotation at ``start_worker`` (see
    ``cli/train_ctr.py``'s --prefetch_workers resume arithmetic). Each
    worker still prefetches ``size`` batches ahead, so host-side shard
    read + slice parallelize across workers; the rotation blocks only when
    the NEXT worker's queue is empty.

    A worker that exhausts drops out of the rotation (deterministic,
    since exhaustion order is); with ``epochs=None`` workers this never
    happens."""
    ps = [Prefetcher(it, size=size, put_fn=put_fn) for it in its]
    n = len(ps)
    alive = [True] * n
    i = start_worker % n
    try:
        while any(alive):
            if alive[i]:
                try:
                    yield next(ps[i])
                except StopIteration:
                    alive[i] = False
            i = (i + 1) % n
    finally:
        for p in ps:
            p.close()


def shard_for_host(arrays: dict, host_id: int, num_hosts: int) -> dict:
    """Deterministic per-host data sharding (replaces
    ``experimental_distribute_dataset``, ``dien/distribute_train.py:190-191``)."""
    return {k: v[host_id::num_hosts] for k, v in arrays.items()}


def with_dedup_plans(
    it: Iterable,
    key: str = "cat_features",
    plan_key: str = "cat_dedup",
    u_cap: int | None = None,
) -> Iterator[dict]:
    """Attach a host-precomputed embedding-ID dedup plan to each batch.

    Adds ``batch[plan_key] = {"perm", "slot", "uniq"}`` over the flattened
    ``batch[key]`` ids (``data.dedup.build_plan`` — C++ radix plan, built
    in the producer thread). Models pass the plan to their
    shared ``Embedding``, whose backward then scatters only unique rows
    (``ops.embedding_kernels.embedding_lookup_dedup``; chip_smoke.py phase
    ``kernels`` checks and times it).

    The dedup'd backward's cost scales with ``u_cap`` (the segment-sum dest
    and the final scatter's padded stream), so the cap must sit close to the
    real unique count for the path's full win. ``u_cap=None`` (default) sizes
    it ADAPTIVELY: the first batch's observed uniques + 25% headroom, rounded
    up to 8192 (DLRM b8192: ~36k uniques → cap 49,152, vs 106,496 at the old
    fixed N/2). A later batch overflowing the cap re-sizes it upward once
    (one jit retrace for the new shape) rather than degrading to a planless
    step forever; caps only grow, so steady state is one compiled shape.

    Runs on the host stream BEFORE ``prefetch_to_device``. Single-data-shard
    scope (see ``embedding_lookup_dedup``); the CTR CLI gates it on
    ``mesh.data == 1``.
    """
    import dataclasses

    from recommender_tpu.data.dedup import PAD_ID, build_plan

    def round8k(n: int) -> int:
        return max(8192, ((n + 8191) // 8192) * 8192)

    def sized(plan, cap: int):
        """Re-pad a generously-capped plan's uniq array to ``cap``."""
        if plan.uniq.size == cap:
            return plan
        if plan.uniq.size > cap:
            return dataclasses.replace(plan, uniq=plan.uniq[:cap])
        uniq = np.full(cap, PAD_ID, np.int32)
        uniq[: plan.uniq.size] = plan.uniq
        return dataclasses.replace(plan, uniq=uniq)

    cap = u_cap
    for batch in it:
        ids = batch[key]
        if u_cap is not None:
            plan = build_plan(ids, u_cap)  # fixed cap: overflow → planless
        else:
            if cap is None:  # size from the first batch
                probe = build_plan(ids, ids.size)
                cap = round8k(int(probe.n_unique * 1.25))
                plan = sized(probe, cap)
            else:
                plan = build_plan(ids, cap)
                if plan is None:  # grow the cap once, keep the plan
                    probe = build_plan(ids, ids.size)
                    cap = round8k(int(probe.n_unique * 1.25))
                    plan = sized(probe, cap)
        if plan is not None:
            batch = dict(batch)
            batch[plan_key] = {
                "perm": plan.perm,
                "slot": plan.slot_sorted,
                "uniq": plan.uniq,
            }
        yield batch
