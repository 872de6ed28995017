"""Param/opt-state partitioning: PartitionSpec trees → NamedShardings.

The reference's only distribution story is replicated variables under
``MirroredStrategy`` (SURVEY.md §2.6). Here every model names the params
it shards in ``sharded_params()`` (``{"embedding/embedding":
P("model", None)}`` — '/'-joined param paths, e.g. embedding tables
row-sharded over ``model``); ``param_pspecs`` builds the full
PartitionSpec tree beside the params, replicating everything else.
Optimizer state mirrors the parameter layout (Adam moments of a
row-sharded table are row-sharded too, so the update is fully
shard-local).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def path_str(path) -> str:
    """'/'-joined dict keys of a pytree path."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def param_pspecs(params: Any, sharded: dict) -> Any:
    """PartitionSpec tree for ``params``: ``sharded[path]`` for each
    '/'-joined path it names, ``P()`` elsewhere. A named path missing from
    ``params`` is an error (a renamed param must not silently replicate)."""
    seen = set()

    def spec(path, _):
        key = path_str(path)
        if key in sharded:
            seen.add(key)
            return sharded[key]
        return P()

    specs = jax.tree_util.tree_map_with_path(spec, params)
    missing = set(sharded) - seen
    if missing:
        raise KeyError(f"sharded params not in the param tree: {sorted(missing)}")
    return specs


def table_specs(tables: dict) -> dict:
    """``{prefix: Embedding}`` → ``{prefix/embedding: spec}`` for the
    partitioned tables — the usual body of a model's ``sharded_params``."""
    return {
        f"{prefix}/embedding": emb.spec
        for prefix, emb in tables.items()
        if emb.partition is not None
    }


def _to_named(spec_tree: Any, mesh: Mesh) -> Any:
    return jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), spec_tree, is_leaf=lambda x: isinstance(x, P)
    )


def param_shardings(model, params: Any, mesh: Mesh) -> Any:
    """NamedSharding tree for ``model``'s ``params`` (arrays or shapes)."""
    return _to_named(param_pspecs(params, model.sharded_params()), mesh)


def model_shardings(model, example: dict, mesh: Mesh, seed: int = 0) -> Any:
    """``param_shardings`` from shapes alone (no param materialization)."""
    shapes, _ = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(seed), example))
    return param_shardings(model, shapes, mesh)


def validate_divisibility(params: Any, specs: Any, mesh: Mesh) -> None:
    """Raise a clear error when a sharded param's dim is not divisible by
    its mesh axis — e.g. restoring a vocab-252 row-sharded table onto
    ``model=8``. GSPMD would silently pad the shards, and the shard-local
    lookup/update paths (embedding/sharded.py) would then address phantom
    rows: a wrong result, not a crash. Checked at ``Trainer.init_state``
    so both fresh runs and cross-mesh checkpoint restores fail loudly at
    state-building time."""
    flat_specs = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    flat_params = jax.tree_util.tree_flatten_with_path(params)[0]
    for (path, leaf), spec in zip(flat_params, flat_specs):
        for dim, name in enumerate(spec):
            if name is None:
                continue
            axis = mesh.shape[name]
            if leaf.shape[dim] % axis:
                raise ValueError(
                    f"param {jax.tree_util.keystr(path)} dim {dim} (size "
                    f"{leaf.shape[dim]}) is sharded over mesh axis '{name}' "
                    f"(size {axis}) but is not divisible by it; pad the vocab "
                    f"to a multiple of the axis size or restore onto a "
                    f"compatible mesh"
                )


def opt_state_shardings(opt_state: Any, params: Any, param_spec: Any, mesh: Mesh) -> Any:
    """Mirror param specs onto every params-shaped subtree of the opt state.

    Optax states embed zero or more pytrees with the params' treedef (Adam's
    mu/nu); those inherit the param layout; scalar counters replicate.
    """
    p_struct = jax.tree_util.tree_structure(params)

    def is_params_like(x):
        return jax.tree_util.tree_structure(x) == p_struct

    def map_subtree(x):
        if is_params_like(x):
            return _to_named(param_spec, mesh)
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map(map_subtree, opt_state, is_leaf=is_params_like)


def state_shardings(state, params_sharding, mesh: Mesh):
    """Shardings for a TrainState: params per spec, rest replicated-or-mirrored."""
    rep = NamedSharding(mesh, P())
    pspec = jax.tree_util.tree_map(
        lambda ns: ns.spec, params_sharding, is_leaf=lambda x: isinstance(x, NamedSharding)
    )
    return dataclasses.replace(
        state,
        step=rep,
        params=params_sharding,
        opt_state=opt_state_shardings(state.opt_state, state.params, pspec, mesh),
        model_state=jax.tree_util.tree_map(lambda _: rep, state.model_state),
    )
