"""recommender_tpu — a recommender-system framework in JAX.

A ground-up JAX/XLA re-design of the capability surface of the
neoyinyao/Recommender model zoo (CTR ranking, behavior-sequence CTR,
multi-task CTR/CVR, graph item embedding, GNN retrieval), running on NVIDIA
GPUs (one or several on a host) and testable on CPU:

* ``core``      — mesh/sharding setup, config, jittable metrics, train engine,
                  checkpoint/resume, profiling hooks.
* ``nn``        — parameter primitives and feature-interaction & sequence
                  layers (MLP, FM cross, DotInteraction, DIN attention,
                  GRU/AUGRU as ``lax.scan``, MMOE gating), losses, LR
                  schedules — plain JAX over dict pytrees.
* ``embedding`` — the sharded embedding subsystem: row-sharded tables over a
                  ``model`` mesh axis, masked-gather + psum and all-to-all
                  exchanges, planner.
* ``ops``       — embedding backward paths (padded / sorted scatter-add,
                  dedup'd scatter-add VJP), stochastic rounding.
* ``data``      — host input pipelines (Criteo / Amazon Books / Ali-CCP /
                  synthetic), fixed-shape batching, negative samplers.
* ``graph``     — host-side graph store (CSR, weighted), random walks,
                  skip-gram pair generation, PinSAGE importance sampler;
                  on-device segment-sum convolution.
* ``models``    — DeepFM, DLRM, DCN, BASE/DIN/DIEN/BST, BASE/ESMM/MMOE,
                  BGE/GES/EGES, PinSage, TwoTower.
* ``retrieval`` — full-corpus embedding inference, sharded top-k, hit-rate.
* ``parallel``  — partitioning rules and collective helpers.

Reference parity map: see SURVEY.md at the repo root; each module docstring
cites the reference repository's files (paths relative to its root) whose
behaviour it covers.
"""

__version__ = "0.1.0"
