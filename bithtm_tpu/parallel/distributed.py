"""Multi-host (multi-process) execution.

The reference is strictly single-process (SURVEY.md §2: no
multiprocessing, sockets, or collectives anywhere). Here multi-host
scale rides entirely on `jax.distributed` + GSPMD: every process calls
`initialize()`, builds the same global mesh over all devices, and the
`parallel.mesh.sharded_step` program runs unmodified — XLA routes the
(tiny, A-sized) cross-shard traffic between the devices.

HTM's stream axis is embarrassingly parallel, so the recommended
multi-host layout is data-parallel over all hosts (zero inter-host
traffic during the step; each host feeds its local shard of the stream
batch) with model-parallel sharding only among the devices of one host
for configs whose tables exceed one device.

Fault tolerance (SURVEY.md §5): the whole model is one pytree, so
elastic recovery is checkpoint/restore (`utils.checkpoint`) — on any
worker failure, restart the job and resume from the last step's
checkpoint; there is no optimizer or data-loader state beyond the
pytree and the step counter inside it. Each process saves its OWN
batch shard with `checkpoint.save(..., backend="npz")` (orbax's
multihost commit protocol is wrong for independent per-process trees)
and a restarted job reassembles the global state with
`make_global_array`. The full drill — run, checkpoint, SIGKILL both
workers mid-step, restore into fresh processes + a fresh mesh,
continue bit-identically to an uninterrupted single-process run — is
exercised by `tests/test_multiprocess.py::
test_elastic_recovery_restart_resumes_bitexact`.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize multi-process JAX. Pass ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id``; with no
    arguments JAX must find them in a cluster environment it knows
    (e.g. SLURM), and fails where there is none."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def local_batch_slice(global_batch: int) -> slice:
    """The slice of the global stream batch this process should feed
    when the batch axis is sharded over all devices in process order."""
    n = jax.process_count()
    assert global_batch % n == 0, (global_batch, n)
    per = global_batch // n
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)


def local_data_slice(global_batch: int, mesh) -> slice:
    """The slice of the global stream batch this process should feed
    for a (data x model) `mesh` whose batch axis is sharded over the
    DATA axis only. Unlike `local_batch_slice` (which assumes one
    process per data block), this reads which data-axis rows this
    process's devices actually address — when the MODEL axis spans
    processes, several processes feed the SAME batch rows (the rows
    are replicated over model shards and
    `make_array_from_process_local_data` expects each process to hand
    over its addressable portion)."""
    import numpy as np

    dev = np.asarray(mesh.devices)            # (n_data, n_model)
    n_data = dev.shape[0]
    assert global_batch % n_data == 0, (global_batch, n_data)
    per = global_batch // n_data
    local_ids = {d.id for d in jax.local_devices()}
    rows = [i for i in range(n_data)
            if any(d.id in local_ids for d in dev[i].ravel())]
    assert rows == list(range(rows[0], rows[0] + len(rows))), (
        f"process-local devices cover non-contiguous data rows {rows}; "
        f"feed with explicit per-shard assembly instead"
    )
    return slice(rows[0] * per, (rows[-1] + 1) * per)


def make_global_array(local_np, mesh, spec):
    """Assemble per-process host data into one globally-sharded array
    (the data-loading path for multi-host runs)."""
    from jax.sharding import NamedSharding

    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), local_np
    )
