"""Worker process for tests/test_multihost.py::test_two_process_training
and ::test_two_process_checkpoint_resume.

Runs the REAL multi-host CLI wiring end-to-end: base_parser flags →
setup_distributed (jax.distributed.initialize rendezvous) → global mesh →
host_local_data / host_batch_size per-host input sharding →
Trainer.put_batch's make_array_from_process_local_data assembly → jitted
train steps whose gradient psum spans both processes (gloo CPU
collectives). Prints one JSON line with the per-step losses; the test
compares them against a single-process run of the same global stream
(deterministic shuffle=False streams; the global batch is the same row
SET either way, and per-example losses are meaned, so the trajectories
must agree to float tolerance).

Modes (argv[4], default "plain"; argv[5] = checkpoint dir for the rest):
* plain     — train STEPS steps, print losses.
* interrupt — train STEPS//2 steps, orbax-save COLLECTIVELY (every
              process calls save; orbax coordinates primary-host metadata
              + per-host shard IO), print losses.
* resume    — restore the collective checkpoint, fast-forward the
              per-host stream by the restored step, train the remaining
              steps.
* plain+save — plain, but also save at the end (single-process producer
              for cross-process-count restore checks).

Invoke: python multihost_worker.py <process_id> <num_processes> <port>
[mode] [ckpt_dir]   (single-process mode: process_id=0 num_processes=1
port=0 → no distributed flags).
"""
import json
import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mode = sys.argv[4] if len(sys.argv) > 4 else "plain"
ckpt_dir = sys.argv[5] if len(sys.argv) > 5 else ""

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
)
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from recommender_tpu.cli.common import (  # noqa: E402
    base_parser,
    build_mesh,
    build_trainer,
    host_batch_size,
    host_local_data,
    setup_distributed,
)
from recommender_tpu.data.pipeline import batch_iterator  # noqa: E402
from recommender_tpu.data.synthetic import SyntheticCTR  # noqa: E402
from recommender_tpu.models.dlrm import DLRM  # noqa: E402
from recommender_tpu.models.tasks import init_model, make_ctr_task  # noqa: E402

STEPS, GLOBAL_BATCH = 4, 32

flags = ["--steps", str(STEPS), "--train_batch_size", str(GLOBAL_BATCH),
         "--log_every", "1"]
if nproc > 1:
    flags += ["--coordinator_address", f"localhost:{port}",
              "--num_processes", str(nproc), "--process_id", str(pid)]
if ckpt_dir:
    flags += ["--checkpoint_dir", ckpt_dir]
args = base_parser("multihost smoke").parse_args(flags)
host_id, num_hosts = setup_distributed(args)
assert (host_id, num_hosts) == (pid, nproc), (host_id, num_hosts)

gen = SyntheticCTR(num_int=4, num_cat=3, vocab_size=500, seed=0)
full = gen.sample(STEPS * GLOBAL_BATCH, seed=1)
local = host_local_data(full)

model = DLRM(vocab_size=500, embed_dim=8, num_int=4, num_cat=3,
             bottom_units=(16, 8), top_units=(16, 1))
loss_fn, _ = make_ctr_task(model)
mesh = build_mesh(args)  # all global devices on the data axis
trainer = build_trainer(args, loss_fn, None, mesh)
example = {k: v[: host_batch_size(GLOBAL_BATCH)] for k, v in full.items()}
state = trainer.init_state(lambda: init_model(model, example, seed=0))

start = 0
steps = STEPS
if mode == "interrupt":
    steps = STEPS // 2
elif mode == "resume":
    state = trainer.restore(state)
    start = int(state.step)
    assert start > 0, "resume mode found no checkpoint"
    steps = STEPS - start

it = batch_iterator(local, host_batch_size(GLOBAL_BATCH), shuffle=False,
                    epochs=None, start_batch=start)

losses = []
log = lambda m: losses.append(m["loss"]) if "loss" in m else None
state, _ = trainer.fit(state, it, steps=steps, log_fn=log)
if mode in ("interrupt", "plain+save"):
    trainer.save(state)  # collective: every process participates
print(json.dumps({"pid": pid, "nproc": nproc, "mode": mode,
                  "step": int(state.step), "losses": losses}), flush=True)
