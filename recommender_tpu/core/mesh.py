"""Device mesh construction and canonical shardings.

The framework uses a 2-D logical mesh:

* ``data``  — batch (data-parallel) axis. Gradients are reduced over it by
  an XLA-inserted all-reduce (the replacement for the reference's
  ``tf.distribute.MirroredStrategy`` NCCL all-reduce, e.g.
  ``ctr/train.py:71``, ``dien/distribute_train.py:92-93``).
* ``model`` — table/model-parallel axis. Embedding tables are **row-sharded**
  over it (see ``recommender_tpu.embedding.sharded``); dense params are
  replicated.

On a single device both axes have size 1 and every sharding degenerates to
fully-replicated, so the same jitted step runs unchanged from 1 device to
several. The mesh follows the algorithm alone: the GPUs of one host reach
each other all to all (NVLink), so device order carries no topology.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. ``data * model`` must equal the device count."""

    data: int = 1
    model: int = 1

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data, self.model)


def make_mesh(
    spec: Optional[MeshSpec] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build the 2-D (data, model) mesh over ``devices`` in their order.

    With no spec, all devices go on the ``data`` axis (pure DP — the
    reference's only strategy, SURVEY.md §2.6).
    """
    devices = list(devices if devices is not None else jax.devices())
    if spec is None:
        spec = MeshSpec(data=len(devices), model=1)
    n_need = spec.data * spec.model
    if n_need != len(devices):
        raise ValueError(
            f"mesh {spec.shape} needs {n_need} devices, got {len(devices)}"
        )
    return Mesh(np.asarray(devices).reshape(spec.shape), (DATA_AXIS, MODEL_AXIS))


def data_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Shard the leading (batch) dim over ``data``, replicate the rest."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (ndim - 1))))


def batch_pspec(ndim: int = 1) -> P:
    return P(DATA_AXIS, *([None] * (ndim - 1)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Row-shard dim 0 over the ``model`` axis (embedding tables)."""
    return NamedSharding(mesh, P(MODEL_AXIS, *([None] * (ndim - 1))))


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.shape[DATA_AXIS]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by data={n}")
    return global_batch // n
