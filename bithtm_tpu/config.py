"""Static configuration for the HTM framework.

The reference (cokwa/bitHTM) scatters hyperparameters across constructor
defaults (`projections.py:7-10,205-223`, `regularizations.py:5-7`,
`networks.py:132-137`). Here they live in frozen dataclasses so they are
hashable jit-static arguments; array shapes derived from them are static,
which is what XLA's compilation model requires.

Capacity fields (``segments_per_column``, ``synapse_capacity``) have no
reference counterpart: the reference grows its tables dynamically
(`utils.py:79-135`). This build pre-allocates a **per-column** padded
segment pool (see `bithtm_tpu/models/temporal_memory.py`): slot
``(c, g)`` can only host segments of column ``c``'s cells, which turns
every per-cell reduction into a scatter-free one-hot over ``cell_dim``
and keeps all learning compacted to the ``active_columns`` rows.
"""

from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class SPConfig:
    """SpatialPooler hyperparameters.

    Defaults mirror the reference: `projections.py:7-10` (proximal
    permanences), `regularizations.py:5-7` (boosting).
    """

    input_dim: int
    column_dim: int
    active_columns: int

    permanence_mean: float = 0.0
    permanence_std: float = 0.1
    permanence_threshold: float = 0.0
    permanence_increment: float = 0.03
    permanence_decrement: float = 0.015

    boosting_intensity: float = 0.3
    duty_cycle_momentum: float = 0.99

    # "float32" keeps the reference's real-valued permanences (the
    # parity-test contract). "int16" stores permanences as integer
    # multiples of `permanence_quantum`: updates become exact integer
    # arithmetic at half the memory traffic (thresholding at 0 and the
    # resulting connectivity/behavior are equivalent; only the Gaussian
    # init is quantized). See docs/QUALITY.md for its convergence.
    permanence_dtype: str = "float32"
    permanence_quantum: float = 0.005

    def __post_init__(self):
        if not (0 < self.active_columns <= self.column_dim):
            raise ValueError(
                f"active_columns={self.active_columns} must be in "
                f"[1, column_dim={self.column_dim}]"
            )
        if self.input_dim <= 0 or self.column_dim <= 0:
            raise ValueError("input_dim and column_dim must be positive")
        if self.permanence_dtype not in ("float32", "int16"):
            raise ValueError(
                f"permanence_dtype must be 'float32' or 'int16', got "
                f"{self.permanence_dtype!r}"
            )
        if self.permanence_quantum <= 0:
            raise ValueError("permanence_quantum must be positive")

    @property
    def density(self) -> float:
        # regularizations.py:9
        return self.active_columns / self.column_dim

    @property
    def quantized(self) -> bool:
        return self.permanence_dtype == "int16"

    def to_units(self, value: float) -> int:
        """Quantize a permanence-scale constant to integer units."""
        q = round(value / self.permanence_quantum)
        if abs(q * self.permanence_quantum - value) >= 1e-9:
            raise ValueError(
                f"{value} is not a multiple of permanence_quantum "
                f"{self.permanence_quantum}"
            )
        return q


@dataclasses.dataclass(frozen=True)
class TMConfig:
    """TemporalMemory hyperparameters.

    Algorithmic defaults mirror `projections.py:205-223`. Capacity fields
    are new (static per-column pools replacing `DynamicArray2D` growth).
    `active_columns` is here too: the recurrent active/winner-set state
    is stored compactly as exactly-A column lists (SP inhibition always
    picks a fixed top-k), which sizes static arrays.
    """

    column_dim: int
    cell_dim: int
    active_columns: int

    # Static pool capacities (no reference counterpart).
    # The reference workload (100 patterns, 2% sparsity) stabilises at
    # ~2.5 segments/column; 8 slots give 3x headroom with zero drops
    # (drops are counted in metrics if a workload ever exceeds them).
    segments_per_column: int = 8    # G: segment slots per column
    synapse_capacity: int = 48      # K: synapse slots per segment
    winner_capacity: int = 0        # Wc: growth-candidate list width
                                    # (0 = auto: min(A*D, max(128,
                                    # roundup(2A, 128))))
    growth_capacity: int = 0        # L: segments growing per step
                                    # (0 = auto: min(A*G, max(64,
                                    # roundup(2A, 8))))
    # NOTE: no punish capacity knob — punishment is unbounded, fused
    # into the full-table pass.

    # Distal permanence dynamics (projections.py:205-219).
    permanence_initial: float = 0.21
    permanence_threshold: float = 0.5
    permanence_increment: float = 0.1
    permanence_decrement: float = 0.1
    permanence_punishment: float = 0.01

    # Segment thresholds (projections.py:221-223).
    segment_activation_threshold: int = 15
    segment_matching_threshold: int = 15
    segment_sampling_synapses: int = 32

    # What happens when a winner cell needs a new segment but its
    # column's G slots are all mature (live synapses >= matching
    # threshold, so not recyclable under the reference's `add_output`
    # rule, `projections.py:80`):
    #   "evict" (default) — evict the weakest non-matching mature slot
    #     (fewest live synapses, ties by ascending slot), the
    #     static-shape analogue of the reference's unbounded growth
    #     (`projections.py:79-95`, `utils.py:113-135`) for
    #     continual-learning workloads. Counted in
    #     `tm_evicted_segments`. Recyclable slots always outrank
    #     evictable ones in the allocation order, so this is
    #     bit-identical to "reference" until the step where "reference"
    #     would drop an allocation (proven by the tier-key ordering in
    #     `_allocate`; pinned by tests/test_pool_pressure.py and the
    #     explicit-policy parity tests).
    #   "reference" — drop the allocation instead and count it
    #     (`tm_dropped_new_segments`), mirroring recycle-or-grow minus
    #     the grow (static shapes cannot grow). A column saturated with
    #     old contexts can then never host a new one — opt in only if
    #     you need drop-not-evict semantics.
    allocation_policy: str = "evict"

    epsilon: float = 1e-8

    def __post_init__(self):
        if not (0 < self.active_columns <= self.column_dim):
            raise ValueError(
                f"active_columns={self.active_columns} must be in "
                f"[1, column_dim={self.column_dim}]"
            )
        if self.cell_dim <= 0 or self.segments_per_column <= 0:
            raise ValueError("cell_dim and segments_per_column must be "
                             "positive")
        if self.segments_per_column > 32:
            # the punished-segment mask rides through the table pass
            # as one i32 bit per slot per column
            raise ValueError(
                f"segments_per_column={self.segments_per_column} "
                f"exceeds the supported maximum of 32"
            )
        if self.synapse_capacity <= 0 or \
                self.segment_sampling_synapses <= 0:
            raise ValueError("synapse_capacity and "
                             "segment_sampling_synapses must be positive")
        if self.winner_capacity < 0 or self.growth_capacity < 0:
            raise ValueError("winner_capacity/growth_capacity "
                             "must be >= 0 (0 = auto)")
        if self.synapse_capacity < self.segment_sampling_synapses:
            # legal in principle (growth clips to free slots) but almost
            # certainly a mistake: a fresh segment could never reach the
            # sampling target
            import warnings

            warnings.warn(
                f"bithtm_tpu: synapse_capacity={self.synapse_capacity} < "
                f"segment_sampling_synapses="
                f"{self.segment_sampling_synapses}: new segments can "
                f"never grow the full sample; growth clips to capacity.",
                stacklevel=3,
            )
        if self.allocation_policy not in ("reference", "evict"):
            raise ValueError(
                f"allocation_policy must be 'reference' or 'evict', got "
                f"{self.allocation_policy!r}"
            )

    @property
    def num_cells(self) -> int:
        return self.column_dim * self.cell_dim

    @property
    def segment_capacity(self) -> int:
        """Total pool slots S = C * G; global slot id = c * G + g."""
        return self.column_dim * self.segments_per_column

    @property
    def cell_words(self) -> int:
        """uint32 words per per-column cell bitmask."""
        return (self.cell_dim + 31) // 32

    @property
    def _auto_compaction_width(self) -> int:
        """Auto heuristic for the winner-candidate list: 2x the
        active-column count (winners are ~1 per active column in steady
        state; 2x absorbs multi-predicted columns), rounded up to a
        multiple of 128, never below 128. Scales with
        `active_columns` so large configs (e.g. 16K columns, A=328) are
        not silently truncated to the lowest 128 ids (a bias toward
        low cell ids). Overflow is still dropped + counted
        (`tm_dropped_winner_candidates`). The growth list L uses its
        own formula (`resolved_growth_capacity`)."""
        return max(128, _round_up(2 * self.active_columns, 128))

    @property
    def resolved_winner_capacity(self) -> int:
        """Static width Wc of the synapse-growth candidate list
        (previous winner cells, ascending cell id; overflow dropped +
        counted). Keeps the growth selection ops an order of magnitude
        smaller than the full A*D grid."""
        if self.winner_capacity:
            return self.winner_capacity
        return min(self.active_columns * self.cell_dim,
                   self._auto_compaction_width)

    @property
    def resolved_growth_capacity(self) -> int:
        """Static width L of the per-step growing-segment list. The
        candidate-selection math runs on this compact list instead of
        all A*G active-column slots.

        The auto floor is 2x the active-column count rounded up to a
        multiple of 8 (steady-state learning segments are ~1 per active
        column; 2x absorbs multi-matching winners — overflow is dropped +
        counted in `tm_dropped_growth_segments`), with zero drops on the
        2000-step reference-workload soak at this width. Large-A configs
        (A >= 128) get 2.5x instead: the 16K x 64 growth-cap soak
        peaked at 655 of the 2x floor's 656 slots. L is per-step
        scratch, not state: a config with a wider (or explicit)
        `growth_capacity` resumes from the SAME state pytree, so a
        counted drop has a zero-migration mitigation — re-jit with a
        bigger L and continue (tested in
        tests/test_pool_pressure.py::test_growth_cap_drop_mitigation)."""
        if self.growth_capacity:
            return self.growth_capacity
        mult = 5 if self.active_columns >= 128 else 4  # halves of A
        return min(self.active_columns * self.segments_per_column,
                   max(64, _round_up(mult * self.active_columns // 2, 8)))

@dataclasses.dataclass(frozen=True)
class HTMConfig:
    sp: SPConfig
    tm: TMConfig

    @property
    def input_dim(self) -> int:
        return self.sp.input_dim

    @property
    def column_dim(self) -> int:
        return self.sp.column_dim

    @property
    def cell_dim(self) -> int:
        return self.tm.cell_dim


def make_tm_config(
    column_dim: int,
    cell_dim: int,
    active_columns: int,
    **overrides,
) -> TMConfig:
    """Build a TMConfig with derived capacities.

    Capacity heuristics: at the reference's default 2048x32 workload the
    pool stabilises around ~2.5 segments per column, so the default 8
    slots per column give 3x headroom (overflow is dropped + counted in
    metrics). 48 synapse slots = 32 sampled (`projections.py:223`) +
    headroom for accumulation across contexts.
    """
    return TMConfig(
        column_dim=column_dim,
        cell_dim=cell_dim,
        active_columns=active_columns,
        **overrides,
    )


def config_to_dict(cfg: HTMConfig) -> dict:
    """Serialize an HTMConfig (e.g. alongside a checkpoint)."""
    return {
        "sp": dataclasses.asdict(cfg.sp),
        "tm": dataclasses.asdict(cfg.tm),
    }


def config_from_dict(d: dict) -> HTMConfig:
    """Inverse of `config_to_dict`."""
    tm = dict(d["tm"])
    # removed knob (round 5): old serialized configs may still carry it
    tm.pop("punish_capacity", None)
    return HTMConfig(sp=SPConfig(**d["sp"]), tm=TMConfig(**tm))


def make_htm_config(
    input_dim: int,
    column_dim: int,
    cell_dim: int,
    active_columns: int | None = None,
    *,
    sp_overrides: dict | None = None,
    **tm_overrides,
) -> HTMConfig:
    """Composition-root defaults, mirroring `networks.py:136-137`:
    active_columns defaults to round(0.02 * column_dim)."""
    if active_columns is None:
        active_columns = round(column_dim * 0.02)
    sp = SPConfig(
        input_dim=input_dim,
        column_dim=column_dim,
        active_columns=active_columns,
        **(sp_overrides or {}),
    )
    tm = make_tm_config(column_dim, cell_dim, active_columns, **tm_overrides)
    return HTMConfig(sp=sp, tm=tm)
