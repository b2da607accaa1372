"""Convergence soak of the bench fast stack (G=4/K=64 + int16 SP) on
the reference's noisy-pattern workload. Defaults: 2000 steps x 256
streams at the 2048x32 headline config; --column_dim/--cell_dim/--batch
scale it (e.g. the 16384x64 scaled config at --batch 64).

Healthy result: bursting -> ~0, correct -> ~A/A by the end, zero (or
counted-benign) drop counters, pool occupancy well under C*G.
Run on the GPU: python scripts/soak_fast_stack.py
"""
import os, sys, time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax, jax.numpy as jnp
from bithtm_tpu import htm_init_batch, htm_scan, make_htm_config
from bithtm_tpu.utils.metrics_log import capacity_health

import argparse
_p = argparse.ArgumentParser()
_p.add_argument("--allocation_policy", default="evict",
                choices=("reference", "evict"))
_p.add_argument("--column_dim", type=int, default=2048)
_p.add_argument("--cell_dim", type=int, default=32)
_p.add_argument("--batch", type=int, default=256)
_p.add_argument("--chunks", type=int, default=10,
                help="chunks of 200 steps each (default 2000 total)")
_p.add_argument("--patterns", type=int, default=100)
_args = _p.parse_args()
from bithtm_tpu.utils.profiling import require_gpu

require_gpu()
cfg = make_htm_config(input_dim=1000, column_dim=_args.column_dim,
                      cell_dim=_args.cell_dim,
                      segments_per_column=4, synapse_capacity=64,
                      allocation_policy=_args.allocation_policy,
                      sp_overrides={"permanence_dtype": "int16"})
B, T, P = _args.batch, 200, _args.patterns
rng = np.random.RandomState(7)
patterns = rng.rand(P, 1000) < 0.2
state = htm_init_batch(jax.random.key(0), cfg, B)
drop_tot = {}
for chunk in range(_args.chunks):
    t0 = time.time()
    idx = (np.arange(T) + chunk * T) % P
    noise = rng.rand(T, B, 1000) < 0.05
    seq = jnp.asarray(patterns[idx][:, None, :] ^ noise)
    t1 = time.time()
    state, m = htm_scan(cfg, state, seq, True)
    host = jax.device_get({k: m[k][-1] for k in
        ("bursting", "correct", "incorrect")})
    # capacity_health owns the counter classification (one source of
    # truth with the JSONL logger)
    health = capacity_health(jax.device_get(m), scan=True,
                             pool_slots=cfg.tm.segment_capacity)
    for k, v in health.items():
        if isinstance(v, int):
            drop_tot[k] = drop_tot.get(k, 0) + v
    occ_frac = health.get("pool_occupancy_frac", 0.0)
    print(f"step {(chunk+1)*T}: bursting={np.mean(host['bursting']):.2f} "
          f"correct={np.mean(host['correct']):.1f} "
          f"incorrect={np.mean(host['incorrect']):.1f} "
          f"(gen {t1-t0:.1f}s run {time.time()-t1:.1f}s)", flush=True)
print(f"total drops over {_args.chunks * T} steps x {B} streams:",
      drop_tot, flush=True)
print(f"pool occupancy (final): {occ_frac:.3f} of "
      f"{cfg.tm.segment_capacity} slots/stream", flush=True)
