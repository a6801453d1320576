"""Shape provenance and the per-replica budget of the event-step kernel
(counterpart of ``happysim_tpu/tpu/kernels/support.py`` and of the sizing
helpers in ``happysim_tpu/tpu/kernels/event_step.py``).

The JAX package sizes a replica tile against a VMEM budget. On the card
one thread runs one replica: the kernel keeps each server's small
registers (queue head and length, earliest completion, counters and
integrals) in per-thread register arrays sized at compile time, and
leaves the slot arrays, queue rings and histogram in device memory in
the JAX layout. The budget is therefore a set of launch bounds, checked
here before every launch, plus the device memory the state occupies.
"""

from __future__ import annotations

import numpy as np

from happysim_tpu_torch.model import EnsembleModel

#: Servers per chain: the kernel's per-server register arrays are
#: instantiated for 1, 2, 4 and 8 servers (kernels/csrc/event_step.cu).
KERNEL_MAX_SERVERS = 8
#: Slots per server (a loop over device memory at each event).
KERNEL_MAX_CONCURRENCY = 1024
#: Queue-ring length.
KERNEL_MAX_QUEUE = 1 << 20
#: Uniform draws per step (3 for an exponential-service chain).
KERNEL_MAX_DRAWS = 8
#: Event steps per launch.
KERNEL_MAX_MACRO = 4096

#: Leaves the kernel reads and writes; the other state leaves (the key and
#: the inert brownout/deadline/router/limiter columns) are not touched.
KERNEL_LEAVES = (
    "t", "src_next", "events",
    "srv_slot_done", "srv_slot_created", "srv_q_created", "srv_q_enq",
    "srv_q_head", "srv_q_len", "srv_started", "srv_completed",
    "srv_dropped", "srv_wait_n", "srv_busy_int", "srv_depth_int",
    "srv_wait_sum", "sink_count", "sink_sum", "sink_sq", "sink_hist",
)
#: Leaves whose entries a block touches only at events (ring pushes and
#: pulls, histogram bumps): left out of the bytes bound, which keeps it a
#: lower bound.
SPARSE_LEAVES = ("srv_q_created", "srv_q_enq", "sink_hist")


def kernel_plan(model: EnsembleModel) -> dict:
    """``{"shape": "mm1" | "chain", "servers": [...]}``: the chain the
    kernel runs, servers in the order a job visits them. Models outside
    the chain shape raise in ``model.validate()``."""
    servers = model.chain_order()
    return {"shape": "mm1" if len(servers) == 1 else "chain", "servers": servers}


def check_kernel_bounds(compiled, macro: int) -> None:
    """Raise ``ValueError`` naming the bound a launch would break."""
    bounds = (
        ("servers", compiled.nV, KERNEL_MAX_SERVERS),
        ("concurrency", compiled.C, KERNEL_MAX_CONCURRENCY),
        ("queue_capacity", compiled.K, KERNEL_MAX_QUEUE),
        ("uniform draws per step", compiled.n_draws, KERNEL_MAX_DRAWS),
        ("macro_block", macro, KERNEL_MAX_MACRO),
    )
    for name, value, bound in bounds:
        if value > bound:
            raise ValueError(
                f"event-step kernel: {name}={value} exceeds its bound {bound}"
            )


def replica_tile_bytes(leaves) -> int:
    """Bytes one replica's copy of ``leaves`` occupies (tensors without
    the replica axis)."""
    return sum(
        int(np.prod(tuple(leaf.shape), dtype=np.int64)) * leaf.element_size()
        for leaf in leaves
    )


def replica_working_set_bytes(compiled, macro: int, state: dict) -> int:
    """Bytes one replica must move in one macro-block on the kernel path:
    every dense kernel leaf read once and written once, the block's
    uniform rows and the parameter rows read once. ``state`` is an
    ``(R, ...)`` state dict; ring and histogram traffic is left out."""
    dense = [state[name][0] for name in KERNEL_LEAVES if name not in SPARSE_LEAVES]
    return (
        2 * replica_tile_bytes(dense)
        + macro * compiled.n_draws * 4
        + (compiled.nS + compiled.nV) * 4
    )
