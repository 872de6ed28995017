"""Weak-scaling harness: DLRM examples/s/device at 1..N GPUs.

The BASELINE.json north star: ≥80% weak-scaling efficiency on
embedding-bound DLRM at N devices. This harness keeps the per-device batch
fixed and grows the ``data`` axis (optionally with a ``model`` axis for the
table), reporting ex/s/device and efficiency vs the 1-device run.

Usage: ``python benchmarks/scaling.py [--vocab V] [--per_device_batch B]
[--steps S]``. On one GPU it degenerates to the 1-device row; on several it
measures the collectives between them. Refuses to run without a GPU.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from recommender_tpu.core.compile_cache import enable_compile_cache
from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.data.synthetic import SyntheticCTR
from recommender_tpu.models.dlrm import DLRM
from recommender_tpu.models.tasks import init_model, make_ctr_task
from recommender_tpu.parallel.partitioning import model_shardings

def bench_mesh(data: int, model_axis: int, vocab: int, per_device_batch: int,
               steps: int) -> float:
    devices = jax.devices()[: data * model_axis]
    mesh = make_mesh(MeshSpec(data, model_axis), devices=devices)
    model = DLRM(
        vocab_size=vocab, embed_dim=16,
        partition="model" if model_axis > 1 else None,
    )
    gen = SyntheticCTR(vocab_size=vocab, seed=0)
    host = gen.sample(per_device_batch * data, seed=1)
    loss_fn, eval_fn = make_ctr_task(model)
    ex = {k: v[:8] for k, v in host.items()}
    pshard = model_shardings(model, ex, mesh)
    tr = Trainer(loss_fn, TrainConfig(), mesh=mesh, param_shardings=pshard,
                 eval_fn=eval_fn)
    state = tr.init_state(lambda: init_model(model, ex))
    batch = tr.put_batch(host)
    rng = jax.random.PRNGKey(0)
    step = tr._train_step
    for _ in range(5):
        state, m = step(state, batch, rng)
    jax.block_until_ready((state, m))
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch, rng)
    jax.block_until_ready((state, m))
    dt = (time.perf_counter() - t0) / steps
    return per_device_batch * data / dt / (data * model_axis)


def main(argv=None):
    ap = argparse.ArgumentParser(description="DLRM weak scaling over the GPUs")
    ap.add_argument("--vocab", type=int, default=1_000_000)
    ap.add_argument("--per_device_batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"scaling.py measures GPUs; found {dev.platform!r}")
    n = len(jax.devices())
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": n}
    sizes = (args.vocab, args.per_device_batch, args.steps)
    base = None
    data = 1
    while data <= n:
        ex_per_dev = bench_mesh(data, 1, *sizes)
        if base is None:
            base = ex_per_dev
        print(
            json.dumps(
                {
                    "devices": data,
                    "mesh": [data, 1],
                    "examples_per_s_per_device": ex_per_dev,
                    "weak_scaling_efficiency": ex_per_dev / base,
                    "device": device,
                }
            ),
            flush=True,
        )
        data *= 2
    if n >= 4:
        ex_per_dev = bench_mesh(n // 2, 2, *sizes)
        print(
            json.dumps(
                {
                    "devices": n,
                    "mesh": [n // 2, 2],
                    "examples_per_s_per_device": ex_per_dev,
                    "weak_scaling_efficiency": ex_per_dev / base,
                    "device": device,
                    "note": "row-sharded table over model axis",
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
