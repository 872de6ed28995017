"""Headline benchmark: DLRM (Criteo-scale) training throughput on the GPU.

Prints the device (platform, kind, count) and then ONE JSON line:
  {"metric": "dlrm_train_examples_per_s", "value": N, "unit": "examples/s/device",
   "vs_baseline": N, "device": {...}}

Refuses to run (non-zero exit) without a GPU: a CPU number is not a
device measurement.

Baseline context: the reference publishes no DLRM throughput; its only
training-throughput numbers are DIN ~470 ex/s on a V100 (`dien/logs/din.log`)
and PinSage ~690 ex/s (`pinsage/train/logs/log.jpg`). ``vs_baseline`` is
computed against 470 ex/s — the reference's best published *model-zoo*
training throughput — as examples/s/device ratio. Apples-to-oranges across
models, but it is the only throughput the reference ever measured; the
real target is the BASELINE.json north star (ex/s/device + scaling).
"""
import json
import sys
import time

import jax
import jax.numpy as jnp
from recommender_tpu.core.compile_cache import enable_compile_cache
from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.data.synthetic import SyntheticCTR
from recommender_tpu.models.dlrm import DLRM
from recommender_tpu.models.tasks import init_model, make_ctr_task
from recommender_tpu.parallel.partitioning import model_shardings

REFERENCE_BEST_EXAMPLES_PER_S = 470.0  # DIN on V100, dien/logs/din.log

BATCH = 8192
VOCAB = 1_000_000  # ctr/train.py:64-65 table size
STEPS = 100
WARMUP = 10


def main():
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; found {dev.platform!r}")
    n_dev = len(jax.devices())
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": n_dev}
    mesh = make_mesh(MeshSpec(data=n_dev, model=1))
    # bf16-STORED table + stochastic-rounded updates (auto-enabled by the
    # Trainer for low-precision params): quality-neutral, half the table
    # bytes in the scatter backward and the Adam table update.
    model = DLRM(vocab_size=VOCAB, embed_dim=16, embed_param_dtype=jnp.bfloat16)
    gen = SyntheticCTR(vocab_size=VOCAB, seed=0)
    host = gen.sample(BATCH, seed=1)

    loss_fn, eval_fn = make_ctr_task(model)
    cfg = TrainConfig(learning_rate=1e-3, log_every=10**9, eval_every=0)
    example = {k: v[:8] for k, v in host.items()}
    pshard = model_shardings(model, example, mesh)
    trainer = Trainer(loss_fn, cfg, mesh=mesh, param_shardings=pshard, eval_fn=eval_fn)
    state = trainer.init_state(lambda: init_model(model, example))

    batch = trainer.put_batch(host)
    rng = jax.random.PRNGKey(0)
    step = trainer._train_step
    # warmup / compile
    for _ in range(WARMUP):
        state, metrics = step(state, batch, rng)
    jax.block_until_ready((state, metrics))

    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, metrics = step(state, batch, rng)
    jax.block_until_ready((state, metrics))
    dt = time.perf_counter() - t0

    ex_per_s = BATCH * STEPS / dt / max(n_dev, 1)
    print(
        json.dumps(
            {
                "metric": "dlrm_train_examples_per_s",
                "value": ex_per_s,
                "unit": "examples/s/device",
                "vs_baseline": ex_per_s / REFERENCE_BEST_EXAMPLES_PER_S,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
