"""Multi-host runtime entry point.

The reference's multi-device story is single-host MirroredStrategy with
``experimental_distribute_dataset`` feeding per-replica data
(``dien/distribute_train.py:132,190-192``). The equivalent here for N hosts
(processes) is:

1. every process calls ``jax.distributed.initialize`` (coordinator
   rendezvous) BEFORE any other jax call, so ``jax.devices()`` returns the
   GLOBAL device set and collectives span every host;
2. the 2-D (data, model) mesh is built over the global devices exactly as
   on one host — no model/trainer code changes;
3. each process feeds only its own slice of the input stream
   (``data.pipeline.shard_for_host`` keyed by ``jax.process_index()``), and
   ``Trainer.put_batch`` assembles the global batch from per-process local
   data (``jax.make_array_from_process_local_data``);
4. checkpointing: orbax writes/reads sharded checkpoints collectively —
   every process must call save/restore (primary-host coordination and
   per-host shard IO are handled inside orbax); single-host restores of a
   multi-host checkpoint reshard on load (``tests/test_checkpoint.py``
   cross-mesh coverage).

``initialize_from_flags`` is wired into every train CLI via
``cli/common.py`` (flags ``--coordinator_address --num_processes
--process_id``, or the standard JAX env vars / cluster auto-detection via
``--distributed``); with none of them set it is a no-op returning
``(0, 1)``, so the single-process path is untouched. Multi-host launch on
GPUs is exercised here only as multi-process on CPU (tests/test_multihost.py).
"""
from __future__ import annotations

import os


def initialize_from_flags(
    coordinator_address: str = "",
    num_processes: int = 0,
    process_id: int = -1,
    auto: bool = False,
) -> tuple[int, int]:
    """Initialize ``jax.distributed`` when configured; return
    ``(process_index, process_count)``.

    Resolution order (mirrors ``jax.distributed.initialize``'s own):
    explicit args > ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` env vars > ``auto=True`` (bare initialize — the
    cluster auto-detection JAX supports, e.g. SLURM) > no-op single process.

    Must run before the first device-touching jax call of the process.
    Safe to call twice (the second call is a no-op if the runtime is
    already initialized).
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS", ""
    )
    if num_processes <= 0:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    if process_id < 0:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "-1") or -1)

    if coordinator_address:
        if num_processes <= 0 or process_id < 0:
            raise SystemExit(
                "--coordinator_address needs --num_processes and "
                "--process_id (or JAX_NUM_PROCESSES / JAX_PROCESS_ID)"
            )
        _initialize_once(
            jax,
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    elif auto:
        # every process discovers the coordinator from the cluster
        # environment; where JAX finds none this raises, which is the
        # right failure (the flag asked for a cluster launch that isn't one)
        _initialize_once(jax)
    return jax.process_index(), jax.process_count()


def _initialize_once(jax, **kw):
    try:
        jax.distributed.initialize(**kw)
    except RuntimeError as e:
        # already initialized (idempotent re-entry, e.g. tests calling the
        # CLI twice in-process) — anything else propagates
        if "already initialized" not in str(e):
            raise


def shard_arrays_for_process(arrays: dict) -> dict:
    """Per-process slice of a host data dict: process p of N takes rows
    ``p::N`` (``data.pipeline.shard_for_host``). The union over processes
    is the full dataset, the slices are disjoint, and the assignment is
    deterministic — the replacement for
    ``experimental_distribute_dataset`` (dien/distribute_train.py:190-192).
    No-op when single-process."""
    import jax

    from recommender_tpu.data.pipeline import shard_for_host

    if jax.process_count() == 1:
        return arrays
    return shard_for_host(arrays, jax.process_index(), jax.process_count())


def per_process_batch_size(global_batch: int) -> int:
    """Each process feeds ``global/process_count`` rows per step;
    ``Trainer.put_batch`` assembles them into the global batch."""
    import jax

    n = jax.process_count()
    if global_batch % n:
        raise SystemExit(
            f"global batch {global_batch} not divisible by "
            f"{n} processes"
        )
    return global_batch // n
