"""Deployment-scale soak of `allocation_policy="evict"` under sustained
column-pool pressure.

Scales `tests/test_pool_pressure.py`'s worst-case workload to the full
2048x32 config on the GPU: per stream, N rotating context patterns
each followed by one shared pattern S, with N > segments_per_column, so
S's columns must host one segment per context in a pool that cannot fit
them all. The reference would grow its table without bound
(`/root/reference/bithtm/projections.py:79-95`, `utils.py:113-135`); the
static-pool analogue must keep recovering by evicting the weakest stale
slot instead — sustained, bounded, and without throughput decay.

Healthy result over >=10k steps x B streams:
  * zero dropped allocations (every overflow served by an eviction)
  * eviction rate bounded and stationary (no runaway churn)
  * the shared pattern keeps returning to full prediction in every
    window (recovery, not permanent lockout)
  * steps/s flat across windows

Run on the GPU:  python scripts/soak_evict_pressure.py
CPU smoke (minutes):  python scripts/soak_evict_pressure.py --cpu \
    --steps 800 --batch 4
"""
import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

p = argparse.ArgumentParser()
p.add_argument("--steps", type=int, default=10240,
               help="total scan steps (context/shared pairs = steps/2)")
p.add_argument("--batch", type=int, default=32)
p.add_argument("--contexts", type=int, default=6,
               help="rotating contexts per stream (> G forces eviction)")
p.add_argument("--window", type=int, default=1024)
p.add_argument("--policy", default="evict", choices=("evict", "reference"))
p.add_argument("--cpu", action="store_true")
args = p.parse_args()

if args.cpu:
    import jax

    jax.config.update("jax_platforms", "cpu")
import jax
import jax.numpy as jnp

from bithtm_tpu import TMConfig
from bithtm_tpu.models.temporal_memory import tm_step
from bithtm_tpu.state import tm_init
from bithtm_tpu.utils.profiling import require_gpu

require_gpu(args.cpu)

C, D, A, G = 2048, 32, 41, 4
N, B = args.contexts, args.batch
cfg = TMConfig(
    column_dim=C, cell_dim=D, active_columns=A,
    segments_per_column=G, synapse_capacity=64,
    allocation_policy=args.policy,
)

rng = np.random.RandomState(11)
# Per stream: N disjoint context column sets + one shared set S, all
# sorted; S is the same columns every cycle, so its pools saturate.
cols_all = np.stack([
    rng.choice(C, size=(N + 1) * A, replace=False).reshape(N + 1, A)
    for _ in range(B)
])                                                   # (B, N+1, A)
cols_all.sort(axis=-1)
ctxs, shared = cols_all[:, :N], cols_all[:, N]       # (B,N,A), (B,A)

T = args.steps
# step t: even -> context (t//2 % N), odd -> shared
seq = np.empty((T, B, A), np.int32)
for t in range(T):
    seq[t] = ctxs[:, (t // 2) % N] if t % 2 == 0 else shared
seq = jnp.asarray(seq)
shared_j = jnp.asarray(shared)

state0 = jax.vmap(lambda _: tm_init(cfg))(jnp.arange(B))
keys0 = jax.vmap(jax.random.key)(jnp.arange(B, dtype=jnp.uint32))


@functools.partial(jax.jit, donate_argnums=(0,))
def run_window(carry, cols_seq):
    def body(c, cols):
        tm, key = c
        split = jax.vmap(lambda k: jax.random.split(k, 2))(key)
        key, subs = split[:, 0], split[:, 1]
        # fraction of the upcoming columns already predicted (recovery
        # signal when the upcoming set is S)
        pred = jax.vmap(
            lambda t, cc: (t.prediction[:, cc] != 0).any(0)
            .sum(dtype=jnp.int32)
        )(tm, cols)
        new_tm, out = jax.vmap(
            lambda t, k, cc: tm_step(cfg, t, k, cc, learning=True,
                                     detailed_metrics=False)
        )(tm, subs, cols)
        m = out.metrics
        return (new_tm, key), {
            "pred_frac": pred,
            "bursting": m["tm_bursting_columns"],
            "drops": m["tm_dropped_new_segments"],
            "evicted": m["tm_evicted_segments"],
            "syn_drops": m["tm_dropped_synapses"],
        }
    return jax.lax.scan(body, carry, cols_seq)


carry = (state0, keys0)
W = args.window
assert T % W == 0 and W % 2 == 0
rates = []
print(f"# policy={args.policy} {C}x{D} G={G} N={N} B={B} T={T}",
      flush=True)
for w in range(T // W):
    t0 = time.time()
    carry, m = run_window(carry, seq[w * W:(w + 1) * W])
    m = jax.device_get(m)
    dt = time.time() - t0
    # shared-pattern steps are the odd positions; pred_frac at odd t is
    # the prediction of S formed by the preceding context step
    s_pred = m["pred_frac"][1::2] / A                 # (W/2, B)
    recovered = (m["pred_frac"][1::2] == A).any(axis=0).mean()
    sps = W * B / dt
    rates.append(sps)
    print(
        f"steps {(w + 1) * W:6d}: evicted/step {m['evicted'].sum() / W:6.1f}"
        f"  drops {int(m['drops'].sum())}"
        f"  syn_drops {int(m['syn_drops'].sum())}"
        f"  S-pred mean {s_pred.mean():.3f} max {s_pred.max():.3f}"
        f"  streams@full {recovered:.2f}"
        f"  burst(S) {m['bursting'][1::2].mean():5.1f}/{A}"
        f"  {sps:8.0f} steps/s",
        flush=True,
    )
    jax.block_until_ready(carry)

print(f"# throughput first->last window: {rates[0]:.0f} -> {rates[-1]:.0f} "
      f"steps/s ({rates[-1] / max(rates[0], 1e-9):.2f}x) on "
      f"{jax.devices()[0].device_kind}", flush=True)
