#!/usr/bin/env python3
"""Bring-up smoke test: the DLRM training path on NVIDIA GPUs, checked.

Usage, from the repository root on a machine with the card(s):

    python3 chip_smoke.py           # one GPU: phases device, kernels, train, reference
    python3 chip_smoke.py --multi   # four GPUs: phases device, multi

Phases (each checks its outputs and raises on failure; none catches):

* ``device``    — refuses to run without a GPU; prints the device kind and
  count, and the card's name and power limit from ``nvidia-smi``.
* ``kernels``   — every embedding backward in ``ops/embedding_kernels.py``
  at the DLRM shape (8192 × 26 Zipf ids into 1M × 16), f32 and bf16,
  against ``jnp.zeros((V, D), f32).at[ids].add(cot)``; times the native
  scatter (in the cotangent dtype and accumulated in f32), the 64-lane
  padded and the sorted scatters.
* ``train``     — ``cli.train_ctr.main`` for 200 steps at full width, f32 and
  bf16 table: the loss falls, the final exact AUC clears 0.6; prints the
  steady step time, compile time, the step's memory analysis and the peak
  device memory.
* ``reference`` — the first 3 train steps on the GPU and on the CPU backend
  of this process from identical params and batches: per-step losses and
  table-gradient rows agree.
* ``multi``     — (``--multi``) DLRM row-sharded over 4 GPUs with the psum and
  all-to-all exchanges, and data-parallel over 4 GPUs, each against the same
  steps on one GPU, with an f32 and a bf16 table; the all-to-all overflow
  counter must be 0.

The last line of stdout is ``{"ok": true, "device": {...}}`` and nothing else.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

from recommender_tpu.core.compile_cache import enable_compile_cache
from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.data.synthetic import SyntheticCTR
from recommender_tpu.models.dlrm import DLRM
from recommender_tpu.models.tasks import make_ctr_task
from recommender_tpu.parallel.partitioning import param_shardings

# The width bench.py and the CLI default run: DLRM on Criteo-shaped data.
VOCAB = 1_000_000
DIM = 16
BATCH = 8192
NUM_CAT = 26
SEED = 0
TRAIN_STEPS = 200

# max|got - ref| / max|ref|. f32: only the order of the atomic adds differs.
# bf16 (a bf16 result): one bf16 rounding of the f32-accumulated sum.
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
LOSS_ATOL = 2e-3  # per-step loss, GPU vs CPU / 4 GPUs vs 1
# Table gradient, GPU vs CPU, at step 1 (identical params), within 1e-2
# relative. With f32 MLPs (the control) every touched row holds it. DLRM's
# own MLPs run in bf16 by design and the backends sum in different orders,
# so single bf16 roundings flip and a few rows touched by few examples
# differ by more: there the whole table (max|diff| / max|ref|) and 99% of
# its rows are held to it. After step 1 the params themselves differ:
# Adam's first updates are ~lr·sign(grad), so any element whose tiny
# gradient differs in sign moves differently; later gradients are printed,
# and the losses checked.
GRAD_RTOL = 1e-2
GRAD_ROW_QUANTILE = 0.99
MIN_AUC = 0.6


class SmokeFailure(RuntimeError):
    """A phase's output is wrong."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print("[chip_smoke]", *parts, flush=True)


# ---------------------------------------------------------------- helpers
def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """``name, power.limit`` csv rows (one per GPU) → [(name, limit)]."""
    rows = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip() or not limit.strip():
            raise SmokeFailure(f"unparseable nvidia-smi line {line!r}")
        rows.append((name.strip(), limit.strip()))
    if not rows:
        raise SmokeFailure("nvidia-smi reported no GPU")
    return rows


def card_lines() -> list[str]:
    """The card lines exactly as nvidia-smi prints them (validated)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    parse_nvidia_smi(out)
    return [line.strip() for line in out.strip().splitlines()]


def max_rel_err(got, want) -> float:
    """max|got - want| / max|want| (both taken in float64)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / scale) if scale > 0 else float(np.max(np.abs(got)))


def row_rel_errs(got, want) -> np.ndarray:
    """Per-row relative L2 errors over the rows ``want`` touches, plus one
    inf for every row that ``got`` touches and ``want`` leaves at zero."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ref = np.linalg.norm(want, axis=1)
    diff = np.linalg.norm(got - want, axis=1)
    touched = ref > 0
    stray = np.count_nonzero(diff[~touched] > 0)
    return np.concatenate([diff[touched] / ref[touched], np.full(stray, np.inf)])


def row_rel_err(got, want) -> float:
    """Largest per-row relative L2 error (``row_rel_errs``); 0 if no row."""
    errs = row_rel_errs(got, want)
    return float(errs.max()) if errs.size else 0.0


def time_ms(fn, *args, iters: int = 20) -> float:
    """Mean wall time of ``fn(*args)`` after one warm-up call, synced with
    ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


class CompileTimer:
    """Sums JAX's backend-compile durations (compile, or load from the
    persistent cache) between ``start()`` and ``stop()``."""

    def __init__(self):
        self._durations: list[float] = []
        self._on = False
        jax.monitoring.register_event_duration_secs_listener(self._record)

    def _record(self, event: str, duration: float, **_) -> None:
        if self._on and event == "/jax/core/compile/backend_compile_duration":
            self._durations.append(duration)

    def start(self) -> None:
        self._durations, self._on = [], True

    def stop(self) -> tuple[float, float, int]:
        """(total seconds, largest single compile, number of compiles)."""
        self._on = False
        d = self._durations
        return sum(d), max(d, default=0.0), len(d)


def run_steps(model, mesh, params, batches, *, table_grads: bool = False):
    """Train steps of ``model`` on ``mesh`` from host ``params`` — one per
    host batch — through the Trainer's grads|optimizer step pair. Returns
    (losses, per-step table gradients on host or None, per-step metrics)."""
    loss_fn, _ = make_ctr_task(model)
    tr = Trainer(
        loss_fn, TrainConfig(learning_rate=1e-3, log_every=10**9, split_step=True),
        mesh=mesh, param_shardings=param_shardings(model, params, mesh),
    )
    state = tr.init_state(lambda: (params, {}))
    rng = jax.random.PRNGKey(SEED)
    losses, grads_out, metrics_out = [], [], []
    for b in batches:
        grads, new_ms, metrics = tr._grad_step(state, tr.put_batch(b), rng)
        metrics = jax.device_get(metrics)
        losses.append(float(metrics["loss"]))
        metrics_out.append(metrics)
        if table_grads:
            grads_out.append(jax.device_get(grads["embedding"]["embedding"]))
        state = tr._apply_step(state, grads, new_ms)
    jax.block_until_ready(state)
    return losses, (grads_out if table_grads else None), metrics_out


def _data(vocab: int, batch: int, n: int):
    gen = SyntheticCTR(vocab_size=vocab, seed=SEED)
    return [gen.sample(batch, seed=100 + i) for i in range(n)]


# ----------------------------------------------------------------- phases
def phase_device(expect: int) -> dict:
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU; JAX found {platform!r}")
    check(len(devices) >= expect, f"need {expect} GPU(s), found {len(devices)}")
    device = {"platform": platform, "kind": devices[0].device_kind, "count": len(devices)}
    log(f"device: kind={device['kind']} count={device['count']}")
    for line in card_lines():
        log(f"card: {line}")
    return device


def phase_kernels(vocab: int = VOCAB, batch: int = BATCH) -> None:
    from recommender_tpu.data.dedup import build_plan
    from recommender_tpu.ops.embedding_kernels import (
        embedding_lookup,
        embedding_lookup_dedup,
        embedding_take,
        native_scatter_add,
        padded_scatter_add,
        scatter_add_dense,
    )

    ids_np = _data(vocab, batch, 1)[0]["cat_features"]  # [B, 26] Zipf ids
    plan = build_plan(ids_np, u_cap=ids_np.size)
    # ids and plan go in as arguments, not constants XLA could fold
    ids, perm, slot, uniq = (
        jnp.asarray(a) for a in (ids_np, plan.perm, plan.slot_sorted, plan.uniq))
    log(f"kernels: {ids_np.size} ids, {plan.n_unique} unique, into {vocab} x {DIM}")

    def vjp(lookup):
        return jax.jit(lambda t, c, *idx: jax.vjp(lambda tt: lookup(tt, *idx), t)[1](c)[0])

    lookup_vjp = vjp(embedding_lookup)
    take_vjp = vjp(embedding_take)
    dedup_vjp = vjp(embedding_lookup_dedup)
    native = jax.jit(lambda c, i: jnp.zeros((vocab, DIM), c.dtype).at[i].add(c))
    native_f32 = jax.jit(lambda c, i: native_scatter_add(i, c, vocab))
    padded = jax.jit(lambda c, i: padded_scatter_add(i, c, vocab))
    sorted_ = jax.jit(lambda c, i: scatter_add_dense(i, c, vocab))

    for dtype in (jnp.float32, jnp.bfloat16):
        name = jnp.dtype(dtype).name
        cot = jax.random.normal(jax.random.PRNGKey(1), (*ids_np.shape, DIM), dtype)
        table = jnp.zeros((vocab, DIM), dtype)
        ref = jax.device_get(
            jnp.zeros((vocab, DIM), jnp.float32).at[ids].add(cot.astype(jnp.float32)))
        # (name, output, kind of result) — the lookups return the table dtype
        results = (
            ("lookup_vjp", lookup_vjp(table, cot, ids), name),
            ("take_vjp", take_vjp(table, cot, ids), name),
            ("dedup_vjp", dedup_vjp(table, cot, ids, perm, slot, uniq), name),
            ("native_f32", native_f32(cot, ids), "float32"),
            ("padded", padded(cot, ids), "float32"),
            ("sorted", sorted_(cot, ids), "float32"),
        )
        for vname, out, kind in results:
            err = max_rel_err(jax.device_get(out).astype(np.float32), ref)
            log(f"kernels {name} {vname}: out={out.dtype} max_rel_err={err:.3e} "
                f"(bound {KERNEL_TOL[kind]:.1e})")
            check(err <= KERNEL_TOL[kind], f"{vname} ({name}) differs from the reference")
        for vname, fn in (("native", native), ("native_f32", native_f32),
                          ("padded", padded), ("sorted", sorted_)):
            log(f"kernels {name} time {vname}: {time_ms(fn, cot, ids):.4f} ms")


def phase_train(embed_dtype: str, timer: CompileTimer, vocab: int = VOCAB,
                batch: int = BATCH, steps: int = TRAIN_STEPS) -> None:
    from recommender_tpu.cli import train_ctr

    argv = [
        "--model_type", "DLRM", "--synthetic", "--steps", str(steps),
        "--train_batch_size", str(batch), "--test_batch_size", str(batch),
        "--log_every", str(max(steps // 10, 1)), "--eval_every", "0",
        "--vocab_size", str(vocab), "--embedding_size", str(DIM),
        "--embed_dtype", embed_dtype, "--seed", str(SEED),
    ]
    out = io.StringIO()
    timer.start()
    with contextlib.redirect_stdout(out):
        trainer, state = train_ctr.main(argv)
    compile_s, compile_max_s, n_compiles = timer.stop()
    lines = [json.loads(l) for l in out.getvalue().splitlines() if l.startswith("{")]
    losses = [l["loss"] for l in lines if "loss" in l and "final" not in l]
    final = [l for l in lines if l.get("final")]
    tag = f"train {embed_dtype}"
    log(f"{tag}: losses every {steps // 10} steps: {losses}")
    log(f"{tag}: compile (or cache load) {compile_s:.3f} s over {n_compiles} "
        f"executables, largest {compile_max_s:.3f} s")
    check(len(losses) >= 2 and all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall ({losses[0]} -> {losses[-1]})")
    check(len(final) == 1, f"{tag}: no final eval")
    auc = final[0]["eval_auc_exact"]
    log(f"{tag}: final exact eval AUC {auc}")
    check(auc > MIN_AUC, f"{tag}: final AUC {auc} <= {MIN_AUC}")

    # steady state: the same (already compiled) step on one device batch
    host = _data(vocab, batch, 1)[0]
    dev_batch = trainer.put_batch(host)
    rng = jax.random.PRNGKey(SEED)
    for _ in range(5):
        state, metrics = trainer._train_step(state, dev_batch, rng)
    jax.block_until_ready((state, metrics))
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        state, metrics = trainer._train_step(state, dev_batch, rng)
    jax.block_until_ready((state, metrics))
    step_ms = (time.perf_counter() - t0) / n * 1e3
    log(f"{tag}: steady step {step_ms:.4f} ms ({batch / step_ms * 1e3:.1f} examples/s)")

    split = any(trainer._split_by_shape.values())
    if split:
        grads, new_ms, _ = jax.eval_shape(trainer._grad_step, state, dev_batch, rng)
        compiled = {
            "grad_step": trainer._grad_step.lower(state, dev_batch, rng).compile(),
            "apply_step": trainer._apply_step.lower(state, grads, new_ms).compile(),
        }
    else:
        compiled = {"fused_step": trainer._fused_step.lower(state, dev_batch, rng).compile()}
    for cname, c in compiled.items():
        m = c.memory_analysis()
        log(f"{tag}: {cname} memory_analysis: arguments={m.argument_size_in_bytes} "
            f"outputs={m.output_size_in_bytes} temp={m.temp_size_in_bytes} "
            f"alias={m.alias_size_in_bytes} code={m.generated_code_size_in_bytes} bytes")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"{tag}: peak_bytes_in_use={stats.get('peak_bytes_in_use')}")


@dataclasses.dataclass(frozen=True)
class _DLRMf32MLP(DLRM):
    """DLRM with f32 MLPs — the reference phase's control, isolating what
    the bf16 MLPs contribute to the GPU/CPU difference."""

    @property
    def bottom_mlp(self):
        return dataclasses.replace(super().bottom_mlp, compute_dtype=jnp.float32)

    @property
    def top_mlp(self):
        return dataclasses.replace(super().top_mlp, compute_dtype=jnp.float32)


def phase_reference(vocab: int = VOCAB, batch: int = BATCH, steps: int = 3,
                    device=None) -> None:
    batches = _data(vocab, batch, steps)
    device = device or jax.devices()[0]
    for label, cls, row_q in (("", DLRM, GRAD_ROW_QUANTILE),
                              (" control f32 MLPs", _DLRMf32MLP, 1.0)):
        model = cls(vocab_size=vocab, embed_dim=DIM)
        params, _ = jax.device_get(model.init(jax.random.PRNGKey(SEED), batches[0]))
        with jax.default_matmul_precision("highest"):
            dev_loss, dev_grads, _ = run_steps(
                model, make_mesh(MeshSpec(1, 1), [device]), params, batches,
                table_grads=True)
            cpu_loss, cpu_grads, _ = run_steps(
                model, make_mesh(MeshSpec(1, 1), jax.devices("cpu")[:1]), params,
                batches, table_grads=True)
        for i in range(steps):
            tag = f"reference{label} step {i + 1}"
            loss_err = abs(dev_loss[i] - cpu_loss[i])
            table_err = max_rel_err(dev_grads[i], cpu_grads[i])
            rows = row_rel_errs(dev_grads[i], cpu_grads[i])
            q50, q99, q999, q_row = np.quantile(rows, [0.5, 0.99, 0.999, row_q])
            log(f"{tag}: loss {device.platform}={dev_loss[i]:.7f} cpu={cpu_loss[i]:.7f} "
                f"|diff|={loss_err:.3e} (bound {LOSS_ATOL:.0e}); table grad "
                f"max_rel_err={table_err:.3e}; row rel err over {rows.size} rows: "
                f"median={q50:.3e} p99={q99:.3e} p99.9={q999:.3e} max={rows.max():.3e}")
            check(loss_err <= LOSS_ATOL, f"{tag}: losses differ")
            if i == 0:  # identical params: the backward itself is compared
                check(table_err <= GRAD_RTOL and q_row <= GRAD_RTOL,
                      f"{tag}: table gradients differ (bound {GRAD_RTOL:.0e} "
                      f"on the whole table and on {row_q:.0%} of rows)")


def phase_multi(devices, vocab: int = VOCAB, batch: int = BATCH, steps: int = 3) -> None:
    check(len(devices) == 4, f"--multi needs 4 devices, found {len(devices)}")
    batches = _data(vocab, batch, steps)
    configs = (
        ("psum (data=1, model=4)", MeshSpec(1, 4), dict(partition="model", lookup_mode="psum")),
        ("a2a (data=1, model=4)", MeshSpec(1, 4),
         dict(partition="model", lookup_mode="a2a", capacity_factor=4.0)),
        ("dp (data=4, model=1)", MeshSpec(4, 1), {}),
    )
    for dtype in (jnp.float32, jnp.bfloat16):
        dname = jnp.dtype(dtype).name
        base = DLRM(vocab_size=vocab, embed_dim=DIM, embed_param_dtype=dtype)
        params, _ = jax.device_get(base.init(jax.random.PRNGKey(SEED), batches[0]))
        single, _, _ = run_steps(base, make_mesh(MeshSpec(1, 1), devices[:1]), params, batches)
        log(f"multi {dname} single-device losses: {single}")
        for name, spec, kw in configs:
            tag = f"multi {dname} {name}"
            mesh = make_mesh(spec, devices)
            model = DLRM(vocab_size=vocab, embed_dim=DIM, embed_param_dtype=dtype,
                         mesh=mesh if "lookup_mode" in kw else None, **kw)
            losses, _, metrics = run_steps(model, mesh, params, batches)
            err = max(abs(a - b) for a, b in zip(losses, single))
            log(f"{tag}: losses {losses} max |diff| vs 1 device {err:.3e} "
                f"(bound {LOSS_ATOL:.0e})")
            check(err <= LOSS_ATOL, f"{tag}: losses differ from one device")
            if kw.get("lookup_mode") == "a2a":
                overflow = [int(m["a2a_overflow"]) for m in metrics]
                log(f"{tag}: a2a_overflow per step {overflow}")
                check(sum(overflow) == 0, f"{tag}: all-to-all dropped ids")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU path (row-sharded psum/a2a and "
                         "data-parallel DLRM, f32 and bf16 table, vs one GPU)")
    args = ap.parse_args(argv)
    cache_dir = enable_compile_cache()  # before the first compile
    log(f"compile cache: {cache_dir}")
    device = phase_device(expect=4 if args.multi else 1)
    if args.multi:
        phase_multi(jax.devices()[:4])
    else:
        timer = CompileTimer()
        phase_kernels()
        phase_train("f32", timer)
        phase_train("bf16", timer)
        phase_reference()
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
