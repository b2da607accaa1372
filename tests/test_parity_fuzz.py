"""Config-fuzz oracle parity: bit-exact TM parity over ~20 geometries
spanning the implementation's own boundaries (SURVEY.md §4's parity
mandate).

Each case runs the full learning parity loop (`test_tm_parity.run_parity`:
JAX step vs the clean-room NumPy oracle, full-state comparison every
step) at a geometry chosen to sit ON a dispatch or encoding boundary:

* ``cell_dim`` not a multiple of 32 (partial cell-bitmask words, W=1
  and W=2 edges of `active_set.pack_bits`/`prediction_words`);
* ``synapse_capacity`` crossing the packed-activity dtype lines
  (`act_dtype`: u8 through K=125 — incl. K=64's non-power-of-two
  scale — bf16 for K=126..127, f32 from K=128);
* J = G*K not a multiple of 128 (odd tilings);
* ``column_dim`` not a multiple of 8;
* ``active_columns`` at 47/48/63/64 (crossovers of earlier matcher
  forms, kept as odd geometries);
* tight pools (G=1..2) and both allocation policies under the same
  odd geometries.

The suite runs on the CPU backend (conftest); `chip_smoke.py` runs the
same oracle parity with the step compiled for the GPU.
"""

import pytest

from bithtm_tpu import TMConfig

from .test_tm_parity import run_parity


def _cfg(**kw):
    base = dict(
        column_dim=64,
        cell_dim=4,
        active_columns=6,
        segments_per_column=4,
        synapse_capacity=12,
        segment_activation_threshold=2,
        segment_matching_threshold=2,
        segment_sampling_synapses=4,
        # incommensurate constants: no permanence lands exactly on the
        # 0.0 death threshold (see test_tm_parity.make_cfg)
        permanence_initial=0.2137,
        permanence_increment=0.1003,
        permanence_decrement=0.0997,
        permanence_punishment=0.0251,
    )
    base.update(kw)
    return TMConfig(**base)


# (name, config overrides, steps) — names make failures addressable.
FUZZ_CASES = [
    # --- cell_dim off the 32-boundary (partial bitmask words) ---
    ("D3_W1_partial", dict(cell_dim=3), 60),
    ("D24_W1_partial", dict(cell_dim=24), 50),
    ("D33_W2_minimal", dict(cell_dim=33), 50),
    ("D48_W2_partial", dict(cell_dim=48, column_dim=48,
                            active_columns=5), 50),
    ("D64_W2_full", dict(cell_dim=64, column_dim=32), 40),
    # --- K across the packed-activity dtype lines (act_dtype) ---
    ("K125_last_u8", dict(synapse_capacity=125, segments_per_column=2,
                          segment_sampling_synapses=6), 40),
    ("K126_first_bf16", dict(synapse_capacity=126, segments_per_column=2,
                             segment_sampling_synapses=6), 40),
    ("K127_last_bf16", dict(synapse_capacity=127, segments_per_column=2,
                            segment_sampling_synapses=6), 40),
    ("K128_first_f32", dict(synapse_capacity=128, segments_per_column=2,
                            segment_sampling_synapses=6), 40),
    # --- lane-unfriendly J = G*K ---
    ("J120_G3K40", dict(segments_per_column=3, synapse_capacity=40), 50),
    ("J66_G2K33", dict(segments_per_column=2, synapse_capacity=33,
                       segment_sampling_synapses=5), 50),
    # --- column_dim % 8 != 0 (XLA-fallback geometries) ---
    ("C37_fallback", dict(column_dim=37, active_columns=5), 60),
    ("C250_fallback", dict(column_dim=250, active_columns=9), 40),
    # --- A at the matcher crossovers (hash 48 / bisect 64) ---
    ("A47_hash_edge", dict(column_dim=128, active_columns=47), 30),
    ("A48_chain_edge", dict(column_dim=128, active_columns=48), 30),
    ("A63_chain_edge", dict(column_dim=192, active_columns=63), 30),
    ("A64_bisect_edge", dict(column_dim=192, active_columns=64), 30),
    # --- combined odd geometry + tight pools + policies ---
    ("D5_G1_recycle", dict(cell_dim=5, segments_per_column=1), 60),
    ("D7_G2_evict", dict(cell_dim=7, segments_per_column=2,
                         allocation_policy="evict",
                         synapse_capacity=9,
                         segment_sampling_synapses=3), 60),
    ("D7_G2_reference", dict(cell_dim=7, segments_per_column=2,
                             allocation_policy="reference",
                             synapse_capacity=9,
                             segment_sampling_synapses=3), 60),
    ("C44_D36_odd_both", dict(column_dim=44, cell_dim=36,
                              active_columns=7), 50),
    ("K13_prime_slots", dict(synapse_capacity=13,
                             segment_sampling_synapses=5), 50),
]


@pytest.mark.parametrize(
    "name,overrides,steps", FUZZ_CASES, ids=[c[0] for c in FUZZ_CASES]
)
def test_parity_fuzz(name, overrides, steps):
    cfg = _cfg(**overrides)
    # distinct seed per case so the RNG trajectories differ too
    run_parity(cfg, steps=steps, seed=hash(name) % 10_000)
