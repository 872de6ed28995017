"""Per-family training-throughput benchmarks on the attached GPU.

Usage: ``python benchmarks/bench_models.py [dlrm deepfm ...]`` (default: the
list at the bottom). Prints one JSON line per benchmark:
  {"bench": "...", "ms_per_step": X, "examples_per_s": Y, "batch": B,
   "device": {"platform": ..., "kind": ..., "count": N}}

The repo-root ``bench.py`` reports DLRM only; this harness covers the zoo.
Every timed window ends in ``jax.block_until_ready``. Refuses to run
without a GPU (a CPU time is not a device measurement).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from recommender_tpu.core.compile_cache import enable_compile_cache
from recommender_tpu.core.mesh import MeshSpec, make_mesh
from recommender_tpu.core.train import TrainConfig, Trainer
from recommender_tpu.models.tasks import (
    init_model,
    make_aux_loss_task,
    make_ctr_task,
    make_multitask_task,
    make_skipgram_task,
)


def _bench_steps(trainer, state, batch, steps=50, warmup=5):
    rng = jax.random.PRNGKey(0)
    step = trainer._train_step
    for _ in range(warmup):
        state, m = step(state, batch, rng)
    jax.block_until_ready((state, m))
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch, rng)
    jax.block_until_ready((state, m))
    return (time.perf_counter() - t0) / steps


def _device() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def report(name, dt, batch_size):
    print(
        json.dumps(
            {
                "bench": name,
                "ms_per_step": dt * 1e3,
                "examples_per_s": batch_size / dt,
                "batch": batch_size,
                "device": _device(),
            }
        ),
        flush=True,
    )


def bench_dlrm():
    from recommender_tpu.data.synthetic import SyntheticCTR
    from recommender_tpu.models.dlrm import DLRM

    B = 8192
    mesh = make_mesh(MeshSpec(len(jax.devices()), 1))
    model = DLRM(vocab_size=1_000_000, embed_dim=16)
    gen = SyntheticCTR(vocab_size=1_000_000, seed=0)
    host = gen.sample(B, seed=1)
    loss_fn, eval_fn = make_ctr_task(model)
    tr = Trainer(loss_fn, TrainConfig(), mesh=mesh, eval_fn=eval_fn)
    state = tr.init_state(lambda: init_model(model, {k: v[:8] for k, v in host.items()}))
    report("dlrm_criteo_b8192", _bench_steps(tr, state, tr.put_batch(host)), B)


def bench_deepfm():
    from recommender_tpu.data.synthetic import SyntheticCTR
    from recommender_tpu.models.deepfm import DeepFM

    B = 8192
    mesh = make_mesh(MeshSpec(len(jax.devices()), 1))
    gen = SyntheticCTR(vocab_size=1_000_000, seed=0)
    host = gen.sample(B, seed=1)
    for tag, dtype in (("", None), ("_bf16sr", "bf16")):
        import jax.numpy as jnp

        model = DeepFM(
            vocab_size=1_000_000, embed_dim=16,
            embed_param_dtype=jnp.bfloat16 if dtype else jnp.float32,
        )
        loss_fn, eval_fn = make_ctr_task(model)
        tr = Trainer(loss_fn, TrainConfig(), mesh=mesh, eval_fn=eval_fn)
        state = tr.init_state(lambda: init_model(model, {k: v[:8] for k, v in host.items()}))
        report(f"deepfm_criteo_b8192{tag}", _bench_steps(tr, state, tr.put_batch(host)), B)


def bench_dcn():
    from recommender_tpu.data.synthetic import SyntheticCTR
    from recommender_tpu.models.dcn import DCN

    B = 8192
    mesh = make_mesh(MeshSpec(len(jax.devices()), 1))
    gen = SyntheticCTR(vocab_size=1_000_000, seed=0)
    host = gen.sample(B, seed=1)
    for tag, dtype in (("", None), ("_bf16sr", "bf16")):
        import jax.numpy as jnp

        model = DCN(
            vocab_size=1_000_000, embed_dim=16,
            embed_param_dtype=jnp.bfloat16 if dtype else jnp.float32,
        )
        loss_fn, eval_fn = make_ctr_task(model)
        tr = Trainer(loss_fn, TrainConfig(), mesh=mesh, eval_fn=eval_fn)
        state = tr.init_state(lambda: init_model(model, {k: v[:8] for k, v in host.items()}))
        report(f"dcn_criteo_b8192{tag}", _bench_steps(tr, state, tr.put_batch(host)), B)


def bench_dien(B=128, T=100, dtype=None, tag=""):
    # reference protocol: batch 128, history 100
    from recommender_tpu.data.synthetic import SyntheticSequence
    from recommender_tpu.models.dien import DIEN

    gen = SyntheticSequence(num_items=400_000, num_cats=1500, max_len=T, seed=0)
    host = gen.sample(B, seed=1)
    mesh = make_mesh(MeshSpec(len(jax.devices()), 1))
    model = DIEN(item_vocab=gen.num_items, cat_vocab=gen.num_cats,
                 embed_param_dtype=dtype or jnp.float32)
    loss_fn, eval_fn = make_aux_loss_task(model)
    tr = Trainer(loss_fn, TrainConfig(), mesh=mesh, eval_fn=eval_fn)
    state = tr.init_state(lambda: init_model(model, {k: v[:8] for k, v in host.items()}))
    report(f"dien_amazon_b{B}_T{T}{tag}", _bench_steps(tr, state, tr.put_batch(host)), B)


def bench_bst(B=1024, T=100):
    """BST at the dien_large shape — the no-scan transformer alternative:
    the whole forward is batched matmuls, so compare directly against
    dien_amazon_b1024_T100 (the scan path)."""
    from recommender_tpu.data.synthetic import SyntheticSequence
    from recommender_tpu.models.bst import BST

    gen = SyntheticSequence(num_items=400_000, num_cats=1500, max_len=T, seed=0)
    host = gen.sample(B, seed=1)
    host = {k: v for k, v in host.items() if not k.startswith("neg_")}
    mesh = make_mesh(MeshSpec(len(jax.devices()), 1))
    for tag, dtype in (("", None), ("_bf16sr", "bf16")):
        model = BST(item_vocab=gen.num_items, cat_vocab=gen.num_cats,
                    embed_param_dtype=jnp.bfloat16 if dtype else jnp.float32)
        loss_fn, eval_fn = make_ctr_task(model)
        tr = Trainer(loss_fn, TrainConfig(), mesh=mesh, eval_fn=eval_fn)
        state = tr.init_state(lambda: init_model(model, {k: v[:8] for k, v in host.items()}))
        report(f"bst_amazon_b{B}_T{T}{tag}", _bench_steps(tr, state, tr.put_batch(host)), B)


def bench_dien_large():
    """Large-batch DIEN: big enough histories (2x 102k ids/call) that the
    volume-gated padded-scatter backward kicks in (use_padded_backward).
    The _bf16sr row stores both tables bf16 with auto stochastic rounding."""
    bench_dien(B=1024)
    bench_dien(B=1024, dtype=jnp.bfloat16, tag="_bf16sr")


def bench_mmoe(B: int = 512, dtype=None, tag=""):
    # B=512: reference train batch (esmm/train.py default), dispatch-bound
    from recommender_tpu.data.synthetic import SyntheticMultiTask
    from recommender_tpu.models.esmm import MMOE

    gen = SyntheticMultiTask(vocab_sizes=tuple([100_000] * 18), seed=0)
    host = gen.sample(B, seed=1)
    mesh = make_mesh(MeshSpec(len(jax.devices()), 1))
    model = MMOE(vocab_sizes=list(gen.vocab_sizes),
                 embed_param_dtype=dtype or jnp.float32)
    loss_fn, eval_fn = make_multitask_task(model)
    tr = Trainer(loss_fn, TrainConfig(), mesh=mesh, eval_fn=eval_fn)
    state = tr.init_state(lambda: init_model(model, {k: v[:8] for k, v in host.items()}))
    report(f"mmoe_aliccp_b{B}{tag}", _bench_steps(tr, state, tr.put_batch(host)), B)


def bench_mmoe_large():
    """Large-batch MMOE (18 per-table scatters of 8192 ids each — below
    the per-call padded-backward threshold and with no big-narrow table,
    so the plain fused native path). The _bf16sr row stores the 18 tables
    bf16 with auto stochastic rounding."""
    bench_mmoe(B=8192)
    bench_mmoe(B=8192, dtype=jnp.bfloat16, tag="_bf16sr")


def bench_eges():
    from recommender_tpu.graph.store import WeightedGraph
    from recommender_tpu.graph.walks import skipgram_batches
    from recommender_tpu.models.eges import EGES

    rng = np.random.default_rng(0)
    V = 100_000
    src = rng.integers(1, V, 2_000_000)
    dst = rng.integers(1, V, 2_000_000)
    w = rng.random(2_000_000).astype(np.float32)
    g = WeightedGraph.from_edges(src, dst, w, num_nodes=V)
    side = {
        "cat": rng.integers(1, 200, V).astype(np.int32),
        "brand": rng.integers(1, 2000, V).astype(np.int32),
    }
    B = 4096
    it = skipgram_batches(g, batch_size=B, walks_per_round=512, side_info=side, seed=0)
    model = EGES(vocab_size=V, cat_vocab=200, brand_vocab=2000, embed_dim=128)
    loss_fn, eval_fn = make_skipgram_task(model)
    mesh = make_mesh(MeshSpec(len(jax.devices()), 1))
    tr = Trainer(loss_fn, TrainConfig(), mesh=mesh, eval_fn=eval_fn)
    example = next(it)
    state = tr.init_state(lambda: init_model(model, example))
    # device-step benchmark
    report("eges_device_b4096", _bench_steps(tr, state, tr.put_batch(example)), B)
    # host sampling throughput (pairs/s), the reference's bottleneck
    t0 = time.perf_counter()
    n = 0
    for _ in range(10):
        b = next(it)
        n += len(b["target"])
    dt = (time.perf_counter() - t0) / 10
    report("eges_host_sampling_b4096", dt, B)


def bench_pinsage(B=32):
    from recommender_tpu.graph.bipartite import BipartiteGraph
    from recommender_tpu.models.pinsage import ItemFeatures, PinSage
    from recommender_tpu.models.pinsage_task import (
        make_pinsage_task,
        pinsage_train_batches,
    )

    rng = np.random.default_rng(0)
    U, V, E = 6040, 3706, 900_000  # MovieLens-1M scale
    us = rng.integers(0, U, E)
    its = rng.integers(0, V, E)
    g = BipartiteGraph(us, its, U, V)
    feats = ItemFeatures(
        year=rng.integers(0, 81, V).astype(np.int32),
        genre=(rng.random((V, 18)) < 0.2).astype(np.float32),
    )
    # B=32 is the reference batch (pinsage/train/train.py); nothing in the
    # pipeline requires it — b512/b1024 amortize the fixed per-step dispatch
    # that dominates the b32 step.
    model = PinSage(features=feats)
    loss_fn = make_pinsage_task(model)
    mesh = make_mesh(MeshSpec(len(jax.devices()), 1))
    tr = Trainer(loss_fn, TrainConfig(), mesh=mesh)
    it = pinsage_train_batches(g, B, seed=0)
    example = next(it)
    state = tr.init_state(lambda: init_model(model, example))
    # full pipeline: host sampling + H2D prefetch + device step — the same
    # threaded prefetch_to_device Trainer.fit uses, so sampling and the
    # transfer overlap the device step instead of serializing
    from recommender_tpu.data.pipeline import prefetch_to_device

    rng_key = jax.random.PRNGKey(0)
    step = tr._train_step
    dev_batch = tr.put_batch(example)
    state, m = step(state, dev_batch, rng_key)
    jax.block_until_ready((state, m))
    if B > 64:  # device-only step on a resident batch, to split supply/step
        t0 = time.perf_counter()
        for _ in range(30):
            state, m = step(state, dev_batch, rng_key)
        jax.block_until_ready((state, m))
        report(f"pinsage_ml1m_b{B}_devicestep", (time.perf_counter() - t0) / 30, B)
    # at large batch the host sampling rivals the device step — fan out to
    # iid sampler threads (the C++ sampler releases the GIL)
    # put_fn stays HOST-side (sampling only); device_put runs on this
    # consumer thread, matching Trainer.fit — device APIs are not
    # thread-safe against a concurrently executing jit.
    if B <= 64:
        pf = prefetch_to_device(it, size=4)
    else:
        pf = prefetch_to_device(
            workers=[pinsage_train_batches(g, B, seed=s) for s in range(1, 4)],
            size=4,
        )
    try:
        state, m = step(state, tr.put_batch(next(pf)), rng_key)
        jax.block_until_ready((state, m))
        t0 = time.perf_counter()
        n_steps = 30
        for _ in range(n_steps):
            state, m = step(state, tr.put_batch(next(pf)), rng_key)
        jax.block_until_ready((state, m))
        dt = (time.perf_counter() - t0) / n_steps
    finally:
        pf.close()
    report(f"pinsage_ml1m_b{B}_endtoend", dt, B)


def bench_pinsage_large():
    bench_pinsage(B=512)
    bench_pinsage(B=1024)
    bench_pinsage(B=2048)


if __name__ == "__main__":
    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench_models.py measures the GPU; found {jax.devices()[0].platform!r}")
    which = sys.argv[1:] or [
        "dlrm", "deepfm", "dien", "dien_large", "mmoe", "mmoe_large",
        "eges", "pinsage",
    ]
    for name in which:
        globals()[f"bench_{name}"]()
