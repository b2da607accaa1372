"""Measure the 16K x 64 step at tuned growth/winner capacities.

The auto capacity formulas (config.py: Wc = roundup(2A, 128),
L = roundup(2A, 8)) budget 2x the active-column count as safety
headroom; at the 16K geometry (A=328) that makes the growth block
(existing-target compare, block sorts, key builds) run at
(L, Wc) = (656, 768) while the observed winner / learning-segment
counts sit near A. This probe times the full learning scan at the
default and at tuned capacities and reports the overflow counters
(`tm_dropped_winner_candidates`, `tm_dropped_growth_segments`,
`tm_dropped_new_segments`) so a tuned operating point is only adopted
drop-free. Run on the GPU:

    python scripts/mb_growth_caps.py [--steps 192] [--repeats 3]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

p = argparse.ArgumentParser()
p.add_argument("--column_dim", type=int, default=16384)
p.add_argument("--cell_dim", type=int, default=64)
p.add_argument("--batch", type=int, default=64)
p.add_argument("--input_dim", type=int, default=1000)
p.add_argument("--steps", type=int, default=192)
p.add_argument("--chunk", type=int, default=0,
               help="split the scan into this many steps per device "
                    "dispatch (0 = one dispatch)")
p.add_argument("--repeats", type=int, default=3)
p.add_argument("--patterns", type=int, default=100)
p.add_argument("--caps", type=str, default="0:0,448:384,384:336",
               help="comma list of Wc:L pairs (0:0 = auto defaults)")
args = p.parse_args()

import jax
import jax.numpy as jnp

from bithtm_tpu import htm_init_batch, htm_scan, make_htm_config
from bithtm_tpu.utils.profiling import require_gpu

require_gpu()

print(f"# devices: {jax.devices()}", file=sys.stderr)

B, T = args.batch, args.steps
rng = np.random.RandomState(0)
patterns = rng.rand(args.patterns, B, args.input_dim) < 0.2
idx = np.arange(T) % args.patterns
noise = rng.rand(T, B, args.input_dim) < 0.05
seq = jnp.asarray(patterns[idx] ^ noise)

for pair in args.caps.split(","):
    wc, gl = (int(x) for x in pair.split(":"))
    cfg = make_htm_config(
        input_dim=args.input_dim,
        column_dim=args.column_dim,
        cell_dim=args.cell_dim,
        segments_per_column=4,
        synapse_capacity=64,
        winner_capacity=wc,
        growth_capacity=gl,
        sp_overrides={"permanence_dtype": "int16"},
    )
    rc = (cfg.tm.resolved_winner_capacity, cfg.tm.resolved_growth_capacity)
    state = htm_init_batch(jax.random.key(0), cfg, B)
    chunk = args.chunk or T
    assert T % chunk == 0
    chunks = [seq[i:i + chunk] for i in range(0, T, chunk)]

    def run(st):
        ms = []
        for c in chunks:
            # htm_scan is already jitted with these static/donate
            # settings — wrapping it in a fresh jax.jit per call would
            # retrace inside the timed region
            st, m = htm_scan(cfg, st, c, True)
            ms.append(m)
        jax.block_until_ready((st, ms))
        return st, ms

    state, metric_chunks = run(state)
    best = 0.0
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        state, metric_chunks = run(state)
        best = max(best, B * T / (time.perf_counter() - t0))
    drops = {
        k: sum(int(np.asarray(m[k].sum())) for m in metric_chunks)
        for k in ("tm_dropped_winner_candidates",
                  "tm_dropped_growth_segments",
                  "tm_dropped_new_segments")
    }
    peak = {
        "winners": max(int(np.asarray(m["tm_winner_cells"]).max())
                       for m in metric_chunks),
        "learn_segs": max(int(np.asarray(m["tm_learning_segments"]).max())
                          for m in metric_chunks),
    }
    print(f"Wc={rc[0]} L={rc[1]}: {best:,.0f} steps/s  drops={drops}  "
          f"peak_usage={peak}", flush=True)
    del state, metric_chunks
