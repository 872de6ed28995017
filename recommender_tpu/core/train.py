"""The training engine: jitted step, eval cadence, checkpointing, logging.

One engine replaces the reference's five hand-rolled loops
(``ctr/train.py:85-97`` keras-fit, ``dien/train.py:12-66`` +
``dien/distribute_train.py:14-107``, ``esmm/train.py:14-151``,
``eges/train.py:104-115``, ``pinsage/train/train.py:40-91``).

Design:
* ONE jitted train step, donated state, explicit in/out shardings derived
  from the model's PartitionSpec tree — runs identically on 1 device or a
  (data × model) mesh; XLA inserts the all-reduce over ``data`` that
  replaces MirroredStrategy's NCCL all-reduce.
* Loss convention: ``loss_fn`` returns **per-example** loss; the engine
  takes the local mean. Because gradients are averaged over the ``data``
  axis by GSPMD (mean of per-device means with equal local batches), this
  reproduces the reference's global-batch scaling
  (``tf.nn.compute_average_loss``, ``dien/distribute_train.py:53``).
* Metrics (AUC etc.) accumulate on device inside the jitted eval step.
* Checkpoint/resume via orbax (params + opt state + step), sharded-aware —
  the genuine resume the reference lacks (SURVEY.md §5 Checkpoint). orbax
  is imported only when a checkpoint directory is configured.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from recommender_tpu.core import mesh as mesh_lib
from recommender_tpu.core.metrics import (
    AUCState,
    MeanState,
    auc_from_state,
    auc_update,
    mean_from_state,
    mean_update,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Any
    opt_state: Any
    model_state: Any  # non-trained state (batch_stats), possibly empty dict


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float | Callable = 1e-3
    optimizer: str = "adam"
    log_every: int = 100
    eval_every: int = 1000
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # 0 = only on demand
    max_to_keep: int = 3
    seed: int = 0
    # early stopping on an eval metric (keras EarlyStopping(val_auc, patience)
    # parity, ctr/train.py:88-96): 0 = disabled; checkpoints save only on
    # improvement when a checkpoint_dir is configured (best-only semantics)
    early_stop_patience: int = 0
    early_stop_metric: str = "eval_auc"
    early_stop_mode: str = "max"
    # Split the train step into a grads jit + an optimizer jit. In one fused
    # graph XLA may pick a column-major layout for a big narrow embedding
    # table (to suit the optimizer's elementwise update), which slows the
    # row gather and inserts layout-flip copies. The second dispatch has a
    # fixed cost, so splitting only pays when such a table exists AND the
    # step scatters enough ids. The gate was tuned on earlier hardware and
    # is not yet re-tuned on the current GPU.
    # None = auto: big narrow table in the param tree (2-D leaf, ≥8M
    # elements, ≤32 columns) and ≥_SPLIT_MIN_IDS integer elements in the
    # batch — decided per batch structure (a warm-up minibatch doesn't
    # latch the full-size steps onto the fused path).
    split_step: Optional[bool] = None
    # Divergence guard: at every log point (where the loss is fetched to the
    # host anyway, so it costs nothing) raise TrainingDiverged on a NaN/Inf
    # loss instead of silently training garbage for the rest of the run.
    # Recovery story: restart with --resume from the last good checkpoint
    # (docs/DESIGN.md "Failure/restart story").
    nan_guard: bool = True
    # Gradient accumulation: >1 splits each batch into that many equal
    # microbatches inside the jitted step (lax.scan) and averages their
    # grads before ONE optimizer update — peak activation memory drops
    # ~accum_steps× so the effective batch can grow past HBM limits.
    # Math matches accum_steps=1 up to per-microbatch dropout rngs and
    # batch stats (see compute_grads).
    accum_steps: int = 1
    # Per-parameter update scaling: {path-pattern: multiplier} applied
    # AFTER the base optimizer (Adam normalizes away plain gradient scaling,
    # so this is the only way to give a subtree a different effective LR).
    # Motivation (quality experiment, benchmarks/quality_runs.py): GES/EGES
    # share one cat/brand table across
    # every item in the batch, so those tables receive ALIGNED updates every
    # step and OVER-move relative to the per-item id table — at reference
    # semantics the models collapse mid-training (AUC 0.95 -> 0.72) and
    # re-converge ~4x slower than BGE. DAMPING the shared tables' updates
    # (scale 0.1-0.5, `--shared_lr_scale 0.5`) removes the collapse and
    # converges in ~1/7 the steps to a better stable floor; UP-scaling
    # (the old 1/3-gradient-split theory) is strictly worse at every scale
    # tried and was refuted by the same experiment. A pattern is one or more
    # '/'-separated path components; it matches a parameter whose
    # '/'-joined path contains that exact component run (substring matches
    # across component boundaries do NOT count: 'cat_embedding' does not
    # match 'concat_embedding').
    lr_scales: Optional[dict] = None
    # Stochastic rounding for low-precision (bf16-stored) params. None =
    # AUTO: enabled iff the param tree has a low-precision float leaf —
    # resolved at init_state. When on (and optimizer='adam') the engine
    # swaps in core.optim.adam_sr (f32 moment math, stochastic-rounded
    # bf16 moment storage) and applies updates via apply_updates_sr (f32
    # add + stochastic-rounded param write). Without it, sub-ulp Adam
    # updates round away on a bf16 table and early training slows
    # (AUC 0.736 -> 0.700 @300 steps); with it a bf16 table trains to the
    # f32 table's quality.
    stochastic_round: Optional[bool] = None
    # Storage dtype for Adam moments under adam_sr: None = the param's own
    # dtype (bf16 table -> bf16 moments, max HBM win); 'float32' = full-
    # precision moments (2x optimizer-state traffic, for A/B isolation).
    moment_dtype: Optional[str] = None


def _scale_updates_by_path(scales: dict) -> optax.GradientTransformation:
    """Stateless transform multiplying updates whose param path matches.

    Matching is by whole '/'-separated path components (a key like
    'cat_embedding' must equal a component — it does NOT match
    'concat_embedding'); multi-component keys ('id_embedding/table') must
    appear as a consecutive component run."""

    def path_mult(path) -> float:
        segs = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        m = 1.0
        for pat, s in scales.items():
            want = [p for p in str(pat).split("/") if p]
            n = len(want)
            if n and any(
                segs[i : i + n] == want for i in range(len(segs) - n + 1)
            ):
                m *= float(s)
        return m

    def update_fn(updates, state, params=None):
        del params
        scaled = jax.tree_util.tree_map_with_path(
            lambda path, u: u * path_mult(path), updates
        )
        return scaled, state

    return optax.GradientTransformation(lambda params: optax.EmptyState(), update_fn)


def make_optimizer(
    cfg: TrainConfig, stochastic: bool = False
) -> optax.GradientTransformation:
    lr = cfg.learning_rate
    if cfg.optimizer == "adam":
        if stochastic:
            from recommender_tpu.core.optim import adam_sr

            base = adam_sr(lr, seed=cfg.seed, moment_dtype=cfg.moment_dtype)
        else:
            base = optax.adam(lr)
    elif cfg.optimizer == "adagrad":
        base = optax.adagrad(lr)
    elif cfg.optimizer == "sgd":
        base = optax.sgd(lr)
    else:
        raise ValueError(cfg.optimizer)
    if cfg.lr_scales:
        return optax.chain(base, _scale_updates_by_path(cfg.lr_scales))
    return base


class TrainingDiverged(RuntimeError):
    """Raised by the fit loop's nan_guard on a non-finite loss."""


class Trainer:
    """Generic engine.

    ``loss_fn(params, model_state, batch, rng, train) ->
        (per_example_loss [B], aux_dict, new_model_state)``

    ``eval_fn(params, model_state, batch) -> (scores, labels)`` feeds the
    streaming-AUC accumulator; models with bespoke eval (hit-rate, link
    prediction) pass their own ``metric_update``.
    """

    def __init__(
        self,
        loss_fn: Callable,
        cfg: TrainConfig,
        mesh: Optional[Mesh] = None,
        param_shardings: Any = None,
        eval_fn: Optional[Callable] = None,
    ):
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh()
        self.optimizer = make_optimizer(cfg)
        # stochastic-round apply: resolved in init_state (needs the param
        # dtypes); False until then so manually-built states keep the plain
        # optax.apply_updates path. The jitted steps trace on first call —
        # after init_state — so they see the resolved value.
        self._sr_apply = bool(cfg.stochastic_round)
        if self._sr_apply:
            self.optimizer = make_optimizer(cfg, stochastic=True)
        self._sr_key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 0x5EED)
        self._param_shardings = param_shardings
        self._ckpt_mgr = None
        if cfg.checkpoint_dir:
            self._ckpt_mgr = _make_ckpt_manager(cfg.checkpoint_dir, cfg.max_to_keep)
        self._build()

    # ------------------------------------------------------------------ build
    def _build(self):
        loss_fn = self.loss_fn
        mesh = self.mesh
        batch_spec = NamedSharding(mesh, P(mesh_lib.DATA_AXIS))
        rep = NamedSharding(mesh, P())

        def compute_grads(state: TrainState, batch, rng):
            """(loss, aux, new_model_state), grads — with optional gradient
            accumulation: ``cfg.accum_steps`` > 1 reshapes the batch
            [B, ...] → [A, B/A, ...] and ``lax.scan``s microbatch
            value_and_grads, summing into one grad tree. Peak activation
            memory drops ~A× (one microbatch live at a time) for identical
            math on equal microbatches (mean of means == global mean; the
            optimizer update stays whole-batch). Divergences vs A=1:
            per-microbatch dropout rngs and per-microbatch batch stats."""
            rng = jax.random.fold_in(rng, state.step)
            accum = max(int(getattr(self.cfg, "accum_steps", 1) or 1), 1)

            def scalar_loss(params, model_state, mb, mb_rng):
                per_ex, aux, new_ms = loss_fn(params, model_state, mb, mb_rng, True)
                return jnp.mean(per_ex), (aux, new_ms)

            if accum == 1:
                (loss, (aux, new_ms)), grads = jax.value_and_grad(
                    scalar_loss, has_aux=True
                )(state.params, state.model_state, batch, rng)
                return loss, aux, new_ms, grads

            # Host dedup plans index the GLOBAL flat id stream; slicing them
            # into microbatches keeps shapes self-consistent but makes the
            # perm indices point past the microbatch cotangent — silently
            # corrupted table gradients. Fail loudly instead (the CTR CLI
            # gates dedup off when accum_steps > 1).
            if isinstance(batch, dict):
                plans = [k for k in batch if k.endswith("_dedup")]
                if plans:
                    raise ValueError(
                        f"dedup plan keys {plans} are incompatible with "
                        f"accum_steps={accum} (plans index the whole-batch id "
                        "stream); drop the plans or set accum_steps=1"
                    )

            def to_micro(leaf):
                b = leaf.shape[0]
                if b % accum:
                    raise ValueError(
                        f"accum_steps={accum} must divide the batch size {b}"
                    )
                return leaf.reshape((accum, b // accum) + leaf.shape[1:])

            micro = jax.tree_util.tree_map(to_micro, batch)

            # Accumulate float grads in f32 even for low-precision params:
            # summing bf16 microbatch grads in bf16 loses sub-ulp
            # contributions exactly the way the SR machinery exists to
            # prevent on the param write. adam_sr's f32 moment math
            # consumes the f32 sums directly.
            def zero_acc(p):
                dt = p.dtype
                if jnp.issubdtype(dt, jnp.floating):
                    dt = jnp.promote_types(dt, jnp.float32)
                return jnp.zeros(p.shape, dt)

            zero_grads = jax.tree_util.tree_map(zero_acc, state.params)

            def body(carry, inp):
                acc, ms = carry
                i, mb = inp
                (loss, (aux, new_ms)), g = jax.value_and_grad(
                    scalar_loss, has_aux=True
                )(state.params, ms, mb, jax.random.fold_in(rng, i))
                acc = jax.tree_util.tree_map(
                    lambda a, gg: a + gg.astype(a.dtype), acc, g
                )
                return (acc, new_ms), (loss, aux)

            (gsum, new_ms), (losses, auxs) = jax.lax.scan(
                body, (zero_grads, state.model_state), (jnp.arange(accum), micro)
            )
            grads = jax.tree_util.tree_map(lambda g: g / accum, gsum)
            aux = jax.tree_util.tree_map(jnp.mean, auxs)
            return jnp.mean(losses), aux, new_ms, grads

        # Two step flavors — see TrainConfig.split_step and the layout study
        # in docs/DESIGN.md. The fused single-jit step is best for small
        # models (one dispatch); the split grads|optimizer pair keeps
        # row-major layouts for big narrow embedding tables (1.6× DLRM).
        def fused_step(state: TrainState, batch, rng):
            loss, aux, new_ms, grads = compute_grads(state, batch, rng)
            updates, new_opt = self.optimizer.update(
                grads, state.opt_state, state.params
            )
            new_params = self._apply(state, updates)
            new_state = TrainState(
                step=state.step + 1,
                params=new_params,
                opt_state=new_opt,
                model_state=new_ms,
            )
            metrics = dict(aux)
            metrics["loss"] = loss
            return new_state, metrics

        def grad_step(state: TrainState, batch, rng):
            loss, aux, new_ms, grads = compute_grads(state, batch, rng)
            metrics = dict(aux)
            metrics["loss"] = loss
            return grads, new_ms, metrics

        def apply_step(state: TrainState, grads, new_ms):
            updates, new_opt = self.optimizer.update(
                grads, state.opt_state, state.params
            )
            new_params = self._apply(state, updates)
            return TrainState(
                step=state.step + 1,
                params=new_params,
                opt_state=new_opt,
                model_state=new_ms,
            )

        self._fused_step = jax.jit(fused_step, donate_argnums=(0,))
        self._grad_step = jax.jit(grad_step)
        # apply_step warns "Some donated buffers were not usable" for the
        # param shapes: benign — 4 donated trees of those shapes (params,
        # grads, mu, nu) feed 3 outputs, so one buffer per shape is surplus.
        self._apply_step = jax.jit(apply_step, donate_argnums=(0, 1, 2))
        self._split = self.cfg.split_step
        self._has_big_table: Optional[bool] = None
        self._split_by_shape: dict = {}

        def _auto_split(state, batch) -> bool:
            # Split only when (a) a big narrow table exists (the layout-
            # flip shape class) AND (b) this step scatters enough ids
            # that the layout win can exceed the second-dispatch cost —
            # a small batch into a big table stays fused. Decided PER BATCH
            # STRUCTURE (cached, like jit retracing): a warm-up minibatch
            # must not latch the full-size steps onto the fused path.
            if self._has_big_table is None:
                self._has_big_table = _has_big_narrow_table(state.params)
            if not self._has_big_table:
                return False
            key = tuple(
                (getattr(l, "shape", ()), str(getattr(l, "dtype", "")))
                for l in jax.tree_util.tree_leaves(batch)
            )
            hit = self._split_by_shape.get(key)
            if hit is None:
                hit = _batch_id_volume(batch) >= _SPLIT_MIN_IDS
                self._split_by_shape[key] = hit
            return hit

        def train_step(state: TrainState, batch, rng):
            split = self._split
            if split is None:
                split = _auto_split(state, batch)
            if not split:
                return self._fused_step(state, batch, rng)
            grads, new_ms, metrics = self._grad_step(state, batch, rng)
            new_state = self._apply_step(state, grads, new_ms)
            return new_state, metrics

        self._train_step = train_step

        if self.eval_fn is not None:
            eval_fn = self.eval_fn

            def eval_step(
                state: TrainState, batch, auc: AUCState, mloss: MeanState, acc: MeanState
            ):
                from recommender_tpu.nn.losses import binary_cross_entropy

                scores, labels = eval_fn(state.params, state.model_state, batch)
                auc = auc_update(auc, scores, labels)
                mloss = mean_update(mloss, binary_cross_entropy(scores, labels))
                from recommender_tpu.core.metrics import accuracy_update

                acc = accuracy_update(acc, scores, labels)
                # scores/labels ride back as device arrays (no transfer
                # unless the caller fetches them for the exact final AUC)
                return auc, mloss, acc, scores, labels

            self._eval_step = jax.jit(eval_step)
        self._batch_sharding = batch_spec
        self._rep = rep

    def _apply(self, state: TrainState, updates):
        """Param write — traced inside the step jits. Plain optax add, or
        (for low-precision param trees) an f32 add + stochastic-rounded
        write keyed by the step counter (deterministic, resume-safe)."""
        if self._sr_apply:
            from recommender_tpu.core.optim import apply_updates_sr

            key = jax.random.fold_in(self._sr_key, state.step)
            return apply_updates_sr(state.params, updates, key)
        return optax.apply_updates(state.params, updates)

    # ------------------------------------------------------------------- init
    def init_state(self, init_params_fn: Callable[[], tuple]) -> TrainState:
        """``init_params_fn() -> (params, model_state)`` (host or jit).

        Also resolves ``cfg.stochastic_round`` auto mode: a low-precision
        float leaf in the params swaps the optimizer for ``adam_sr`` and
        turns on the stochastic-rounded param write BEFORE the optimizer
        state is created / the steps first trace."""
        params, model_state = init_params_fn()
        if self.cfg.stochastic_round is None:
            from recommender_tpu.core.optim import has_low_precision_leaf

            sr = has_low_precision_leaf(params)
        else:
            sr = bool(self.cfg.stochastic_round)
        if sr != self._sr_apply:
            self._sr_apply = sr
            self.optimizer = make_optimizer(self.cfg, stochastic=sr)
        opt_state = self.optimizer.init(params)
        state = TrainState(
            step=jnp.zeros((), jnp.int32),
            params=params,
            opt_state=opt_state,
            model_state=model_state,
        )
        if self._param_shardings is not None:
            from recommender_tpu.parallel.partitioning import (
                state_shardings,
                validate_divisibility,
            )

            specs = jax.tree_util.tree_map(
                lambda ns: ns.spec, self._param_shardings,
                is_leaf=lambda x: isinstance(x, NamedSharding),
            )
            validate_divisibility(params, specs, self.mesh)
            shardings = state_shardings(state, self._param_shardings, self.mesh)
            state = jax.device_put(state, shardings)
        else:
            state = jax.device_put(state, self._rep)  # replicate over the mesh
        return state

    # ------------------------------------------------------------------- loop
    def fit(
        self,
        state: TrainState,
        train_iter: Iterable,
        steps: int,
        eval_iter_fn: Optional[Callable[[], Iterable]] = None,
        eval_batches: int = 0,
        log_fn: Callable[[dict], None] = None,
        rng: Optional[jax.Array] = None,
        prefetch: int = 2,
    ) -> tuple[TrainState, list[dict]]:
        cfg = self.cfg
        rng = rng if rng is not None else jax.random.PRNGKey(cfg.seed)
        history: list[dict] = []
        t0 = time.perf_counter()
        window_examples = 0
        prefetcher = None
        if prefetch:
            from recommender_tpu.data.pipeline import prefetch_to_device

            # host-side batch assembly runs ahead in a background thread;
            # device_put stays on this thread (device APIs are not
            # thread-safe against a concurrently executing jit)
            prefetcher = prefetch_to_device(train_iter, size=prefetch)
            train_iter = prefetcher
        try:
            return self._fit_loop(
                state, train_iter, steps, eval_iter_fn, eval_batches,
                log_fn, rng, False, history, t0, window_examples,
            )
        finally:
            if prefetcher is not None:
                prefetcher.close()

    def _fit_loop(
        self, state, train_iter, steps, eval_iter_fn, eval_batches,
        log_fn, rng, prefetched, history, t0, window_examples,
    ):
        cfg = self.cfg
        best = None
        stale_evals = 0
        sign = 1.0 if cfg.early_stop_mode == "max" else -1.0
        for i, batch in enumerate(train_iter):
            if i >= steps:
                break
            if not prefetched:
                batch = self.put_batch(batch)
            state, metrics = self._train_step(state, batch, rng)
            window_examples += _batch_size(batch)
            step = i + 1
            if step % cfg.log_every == 0:
                metrics = {k: float(v) for k, v in jax.device_get(metrics).items()}
                if cfg.nan_guard and not math.isfinite(metrics.get("loss", 0.0)):
                    raise TrainingDiverged(
                        f"non-finite loss {metrics['loss']} at step {step}; "
                        "resume from the last checkpoint (--resume) with a "
                        "lower learning rate"
                    )
                dt = time.perf_counter() - t0
                metrics["examples_per_s"] = window_examples / max(dt, 1e-9)
                metrics["step"] = step
                history.append(metrics)
                if log_fn:
                    log_fn(metrics)
                t0 = time.perf_counter()
                window_examples = 0
            if (
                eval_iter_fn is not None
                and cfg.eval_every
                and step % cfg.eval_every == 0
            ):
                ev = self.evaluate(state, eval_iter_fn(), eval_batches)
                ev["step"] = step
                history.append(ev)
                if log_fn:
                    log_fn(ev)
                # eval wall-clock must not pollute the throughput window
                t0 = time.perf_counter()
                window_examples = 0
                if cfg.early_stop_patience:
                    value = sign * ev.get(cfg.early_stop_metric, float("-inf"))
                    if best is None or value > best:
                        best = value
                        stale_evals = 0
                        if self._ckpt_mgr is not None:
                            self.save(state)  # best-only checkpointing
                    else:
                        stale_evals += 1
                        if stale_evals >= cfg.early_stop_patience:
                            history.append({"early_stopped": True, "step": step})
                            break
            if (
                self._ckpt_mgr is not None
                and cfg.checkpoint_every
                and step % cfg.checkpoint_every == 0
            ):
                self.save(state)
        return state, history

    def evaluate(
        self, state: TrainState, batches: Iterable, limit: int = 0,
        exact: bool = False,
    ) -> dict:
        """Streaming histogram AUC (in-loop default); ``exact=True`` also
        gathers scores/labels to host for the sort-based exact AUC
        (``core.metrics.exact_auc``) — use for final parity numbers, where
        the 8192-bin histogram's ≲2e-3 error is the same order as the
        deltas being certified."""
        assert self.eval_fn is not None, "no eval_fn configured"
        if exact and jax.process_count() > 1:
            # exact AUC gathers every score to THIS host; a multi-host
            # global array is not fully addressable here. The streaming
            # histogram (psum'd in-jit, identical on all hosts) is the
            # multi-host metric; certify exact numbers single-host.
            import warnings

            warnings.warn(
                "evaluate(exact=True) is single-host only; falling back to "
                "the streaming histogram AUC (multi-host metric)",
                stacklevel=2,
            )
            exact = False
        auc = AUCState.init()
        mloss = MeanState.init()
        acc = MeanState.init()
        n = 0
        all_scores, all_labels = [], []
        for batch in batches:
            if limit and n >= limit:
                break
            batch = self.put_batch(batch)
            auc, mloss, acc, scores, labels = self._eval_step(
                state, batch, auc, mloss, acc
            )
            if exact:
                all_scores.append(jax.device_get(scores))
                all_labels.append(jax.device_get(labels))
            n += 1
        if n == 0:
            raise ValueError(
                "evaluate(): iterator yielded no batches — check that the eval "
                "set is at least one (drop-remainder) batch long"
            )
        out = {
            "eval_auc": float(auc_from_state(auc)),
            "eval_loss": float(mean_from_state(mloss)),
            "eval_accuracy": float(mean_from_state(acc)),
            "eval_batches": n,
        }
        if exact:
            from recommender_tpu.core.metrics import exact_auc

            out["eval_auc_exact"] = exact_auc(
                np.concatenate([s.reshape(-1) for s in all_scores]),
                np.concatenate([l.reshape(-1) for l in all_labels]),
            )
        return out

    def put_batch(self, batch):
        """Shard a host batch over the data axis.

        Multi-process (``jax.distributed``-initialized pods): each process
        passes only ITS rows of the global batch (global/num_hosts — see
        ``cli.common.host_batch_size``) and the global array is assembled
        from per-process local data; collectives then span the pod
        (core/distributed.py). Single-process: plain sharded device_put.
        """
        if jax.process_count() > 1:
            return jax.tree_util.tree_map(
                lambda x: jax.make_array_from_process_local_data(
                    self._data_sharding_for(x), np.asarray(x)
                ),
                batch,
            )
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(jnp.asarray(x), self._data_sharding_for(x)),
            batch,
        )

    def _data_sharding_for(self, x):
        nd = np.ndim(x)
        return NamedSharding(self.mesh, P(mesh_lib.DATA_AXIS, *([None] * (nd - 1))))

    # ------------------------------------------------------------ checkpoints
    def save(self, state: TrainState):
        assert self._ckpt_mgr is not None
        self._ckpt_mgr.save(int(state.step), args=_ckpt_args(state))
        self._ckpt_mgr.wait_until_finished()

    def restore(self, state_like: TrainState) -> TrainState:
        assert self._ckpt_mgr is not None
        step = self._ckpt_mgr.latest_step()
        if step is None:
            return state_like
        restored = self._ckpt_mgr.restore(
            step, args=_orbax().args.StandardRestore(state_like)
        )
        return restored


def _has_big_narrow_table(params) -> bool:
    """True if any 2-D F32 param is a big narrow embedding table — the
    shape class that trips XLA's fused-graph layout assignment (see
    TrainConfig.split_step; threshold shared with the Embedding lookup in
    ops.embedding_kernels.is_big_narrow_table). F32-only: bf16-table
    models keep one jit (the fused step was the faster one for them on
    the hardware the gate was tuned on)."""
    from recommender_tpu.ops.embedding_kernels import is_big_narrow_table

    for leaf in jax.tree_util.tree_leaves(params):
        if (
            getattr(leaf, "ndim", 0) == 2
            and getattr(leaf, "dtype", None) == jnp.float32
            and is_big_narrow_table(leaf.shape)
        ):
            return True
    return False


# Minimum integer-id volume per step for the split grads|optimizer pair to
# pay for its extra dispatch (same scale as embedding_kernels.PADDED_BWD_MIN_IDS:
# below ~32k scattered rows the narrow-scatter/layout costs are small).
_SPLIT_MIN_IDS = 32_768


def _batch_id_volume(batch) -> int:
    """Total integer elements in the batch — a PROXY for embedding ids
    scattered per step (float labels/features excluded). It over-counts
    models whose batches carry non-lookup integer fields (lengths,
    sampler metadata): those can trip the split for nothing — set
    ``TrainConfig.split_step`` explicitly for such models."""
    total = 0
    for leaf in jax.tree_util.tree_leaves(batch):
        if jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.integer):
            total += int(jnp.asarray(leaf).size)
    return total


def _batch_size(batch) -> int:
    leaves = jax.tree_util.tree_leaves(batch)
    return int(leaves[0].shape[0]) if leaves else 0


class CheckpointUnavailable(RuntimeError):
    """Raised when a checkpoint directory is configured but orbax is absent."""


def _orbax():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise CheckpointUnavailable(
            "checkpointing (--checkpoint_dir / TrainConfig.checkpoint_dir) "
            "needs the orbax-checkpoint package, which is not installed here; "
            "run without a checkpoint directory or install orbax-checkpoint"
        ) from e
    return ocp


def _make_ckpt_manager(path: str, max_to_keep: int):
    ocp = _orbax()

    options = ocp.CheckpointManagerOptions(max_to_keep=max_to_keep, create=True)
    return ocp.CheckpointManager(path, options=options)


def _ckpt_args(state: TrainState):
    return _orbax().args.StandardSave(state)
