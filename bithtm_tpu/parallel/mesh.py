"""Device mesh + sharding layouts.

The reference is a single-process, single-thread NumPy program with no
distributed execution of any kind (SURVEY.md §2 parallelism inventory).
Scaling here is mesh-native instead of backend-ported:

  * **data axis** — independent HTM streams (the batch dimension added
    by `htm_step_batch`). Zero cross-device communication: every stream
    owns its whole model state.
  * **model axis** — shards the segment pool (S) and the SP column
    dimension (C) for configs whose tables exceed one device (e.g. the
    16K-column x 64-cell scaled config). GSPMD inserts the collectives:
    per-cell prediction reduction is a scatter-max across pool shards
    (psum-like), SP top-k gathers the (C,) boosted overlaps.

Everything goes through `jax.jit` with NamedSharding annotations; XLA
inserts the collectives (over NVLink between the GPUs of a host).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..state import HTMState, SPState, TMState

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """Build a (data, model) mesh. Defaults to all devices on data."""
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_model
    assert n_data * n_model == len(devices), (
        f"{n_data}x{n_model} mesh != {len(devices)} devices"
    )
    dev = np.asarray(devices).reshape(n_data, n_model)
    return Mesh(dev, (DATA_AXIS, MODEL_AXIS))


def batched_state_specs(state: HTMState) -> HTMState:
    """PartitionSpecs for a *batched* HTMState (leading stream axis on
    every leaf): streams over data; the column axis C — which fronts
    both the SP matrices and the per-column TM segment pool — over
    model. The compact active-set lists (A-sized) are replicated over
    model: they are the only cross-column state and they are tiny."""
    d, m = DATA_AXIS, MODEL_AXIS
    sp = SPState(
        permanence=P(d, m, None),   # (B, C, I)
        connected=P(d, m, None),    # (B, C, Iw packed)
        duty_cycle=P(d, m),         # (B, C)
    )
    tm = TMState(
        synapse_cell=P(d, m, None),   # (B, C, G*K)
        synapse_perm=P(d, m, None),   # (B, C, G*K)
        seg_cell=P(d, m),             # (B, C, G)
        active_cols=P(d),             # (B, A) replicated over model
        active_bits=P(d),             # (B, A, W)
        winner_bits=P(d),             # (B, A, W)
        synapse_act=P(d, m),          # (B, C, G*K)
        prediction=P(d, None, m),     # (B, W, C) packed, C on model
        matching_word=P(d, m),        # (B, C) packed flag word
        step=P(d),
    )
    return HTMState(sp=sp, tm=tm, key=P(d))


def shard_batched_state(state: HTMState, mesh: Mesh) -> HTMState:
    """Place a batched HTMState onto the mesh with the standard layout.

    Works in single- and multi-process settings: with multiple processes
    (`jax.distributed`), every process holds the full host-side state
    (deterministic init) and contributes its addressable shards via
    `make_array_from_callback` — `device_put` cannot target
    non-addressable global shardings."""
    specs = batched_state_specs(state)

    def place(x, s):
        sharding = NamedSharding(mesh, s)
        if jax.process_count() > 1:
            host = jax.device_get(x)
            return jax.make_array_from_callback(
                host.shape, sharding, lambda idx: host[idx]
            )
        return jax.device_put(x, sharding)

    return jax.tree_util.tree_map(place, state, specs)


def sharded_step(cfg, mesh: Mesh, learning: bool = True):
    """jit-compile the batched training step with explicit input/output
    shardings on `mesh`. Carry layout in == out so the step self-composes
    under scan without resharding; the carry is donated."""
    from ..models.htm import htm_step_batch

    specs = batched_state_specs(None)
    shardings = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P),
    )
    input_sharding = NamedSharding(mesh, P(DATA_AXIS, None))

    def step(state, x):
        new_state, out = htm_step_batch(cfg, state, x, learning)
        return new_state, out.metrics

    return jax.jit(
        step,
        in_shardings=(shardings, input_sharding),
        out_shardings=(shardings, None),
        donate_argnums=(0,),
    )


def sharded_serve_step(cfg, mesh: Mesh):
    """The serving step (`htm_serve_scan` semantics: learning off,
    winner pass off) with explicit mesh shardings — model-parallel
    serving for configs whose tables exceed one device. Bit-identical to
    the unsharded serve path
    (`tests/test_parallel.py::test_sharded_serve_matches_unsharded`)::

        step = sharded_serve_step(cfg, mesh)
        state, metrics = step(state, x)
    """
    from ..models.htm import htm_step_batch

    specs = batched_state_specs(None)
    shardings = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P),
    )
    input_sharding = NamedSharding(mesh, P(DATA_AXIS, None))

    def step(state, x):
        new_state, out = htm_step_batch(
            cfg, state, x, learning=False, compute_winner=False,
        )
        return new_state, out.metrics

    return jax.jit(
        step,
        in_shardings=(shardings, input_sharding),
        out_shardings=(shardings, None),
        donate_argnums=(0,),
    )
