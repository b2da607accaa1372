"""Full-shape model-parallel equality check for the 16K x 64 config.

`tests/test_parallel.py` proves sharded == unsharded bit-equality at a
toy shape and `__graft_entry__.dryrun_multichip` re-asserts it on tiny
shapes every round; this script runs the same assertion at the REAL
scaled-config shape (column_dim=16384, cell_dim=64, A=328, fast stack)
— the config whose scaling axis IS model parallelism — over an
8-virtual-device CPU
mesh, all devices on the model axis, so the C-axis sharding (2048
columns per device), the replicated active-set lists, and the GSPMD
collectives are exercised at deployment geometry rather than toy
geometry.

Run: python scripts/model_parallel_16k_check.py [--steps 2] [--batch 1]
Expected output: "sharded == unsharded bit-equal at 16384x64 ..."
Recorded result (2026-08-18, --steps 2 --batch 1, ~45 min on 8 virtual
CPU devices): PASS — full state pytree + metrics bit-equal for both
phases, with the step-2 growth pass grown at the full load (10,496 =
A*32 synapses).
"""

import argparse
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from bithtm_tpu import htm_init_batch, make_htm_config  # noqa: E402
from bithtm_tpu.models.htm import htm_step_batch  # noqa: E402
from bithtm_tpu.parallel.mesh import (  # noqa: E402
    make_mesh,
    shard_batched_state,
    sharded_step,
)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--input_dim", type=int, default=1000)
    args = p.parse_args()

    assert jax.device_count() == 8, jax.devices()
    cfg = make_htm_config(
        input_dim=args.input_dim, column_dim=16384, cell_dim=64,
        segments_per_column=4, synapse_capacity=64,
        sp_overrides={"permanence_dtype": "int16"},
    )
    B = args.batch
    rng = np.random.RandomState(0)
    xs = [jnp.asarray(rng.rand(B, cfg.input_dim) < 0.2)
          for _ in range(args.steps)]

    def run(step, state):
        metrics = None
        for i, x in enumerate(xs):
            state, metrics = step(state, x)
            jax.block_until_ready(metrics)
            print(f"  step {i + 1}/{len(xs)} done", flush=True)
        return jax.device_get(state), jax.device_get(metrics)

    print("unsharded control ...", flush=True)
    step_ref = jax.jit(lambda s, x: (
        lambda r: (r[0], r[1].metrics)
    )(htm_step_batch(cfg, s, x, True)))
    final_ref, m_ref = run(step_ref, htm_init_batch(jax.random.key(0), cfg, B))

    print("8-way model-parallel ...", flush=True)
    mesh = make_mesh(n_data=1, n_model=8)
    state_sh = shard_batched_state(htm_init_batch(jax.random.key(0), cfg, B),
                                   mesh)
    final_sh, m_sh = run(sharded_step(cfg, mesh, learning=True), state_sh)

    from bithtm_tpu.utils.checks import assert_trees_bit_equal

    assert_trees_bit_equal(final_sh, final_ref, got_metrics=m_sh,
                           want_metrics=m_ref)
    grown = int(np.asarray(m_ref["tm_grown_synapses"]).sum())
    print(f"sharded == unsharded bit-equal at 16384x64 (A=328, fast "
          f"stack): {args.steps} steps x {B} streams, full state + "
          f"metrics; last step grew {grown} synapses")


if __name__ == "__main__":
    main()
