#!/usr/bin/env python3
"""Where the port's plain event step and the compiled JAX step round an
event time differently, model by model, on the CPU:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2 \
        python3 tools/contraction_probe.py [model ...]

For each model (default: every model below), 1,024 replicas start from
JAX's initial state; then, 60 times, both packages take one event step
from the same state (the port's state is set to JAX's before each step)
on the same uniforms, drawn so that torch's and XLA's float32 ``log``
round every one of them alike. Every leaf entry that differs afterwards
is one where the two steps round a float differently (XLA contracts
``c + a * b`` into one multiply-add inside some fusions; the port rounds
each such sum once where ``engine._fused`` says so), or where another
float32 function (``log1p``, ``exp``, ``pow``, ``log`` of a product)
differs. Prints the count of differing entries per leaf and model.

``partitioned-barrier`` probes the partitioned executor's window barrier
instead: JAX's ``run_partitioned`` resumes a two-partition ring from a
snapshot whose lanes hold random queue lengths, depth integrals and
clocks and no event, so its last window is the barrier alone, and the
port's ``plain_barrier`` runs the same barrier with the close-out
``depth + q_len * gap`` rounded once (as ``engine._fused`` rounds it) and
rounded twice; prints how many depth integrals each way differs from JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import test_torch_event_step as steps  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu.engine import _Compiled as JCompiled  # noqa: E402
from happysim_tpu_torch import convert  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch.engine import _Compiled as TCompiled  # noqa: E402
from happysim_tpu_torch.kernels.event_step import plain_block_step  # noqa: E402
from test_torch_chaos_models import CHAOS_MODELS  # noqa: E402
from test_torch_resilience_models import RESILIENCE_MODELS  # noqa: E402
from test_torch_telemetry_models import TELEMETRY_MODELS  # noqa: E402

REPLICAS, STEPS = 1024, 60
MODELS = {
    "mm1": lambda mod: mod.mm1_model(8.0, 10.0, 200.0),
    "pipeline": lambda mod: mod.pipeline_model(8.0, (0.05, 0.08, 0.06), 200.0),
    "mg1-erlang2": lambda mod: steps.mg1(mod, "erlang", horizon_s=200.0, service_k=2),
    "mg1-lognormal": lambda mod: steps.mg1(mod, "lognormal", horizon_s=200.0, service_scv=2.0),
    "families-chain": lambda mod: steps.families_chain(mod, 200.0),
    "fanout-random": lambda mod: steps.fanout(mod, "random", 200.0),
    **{f"chaos-{k}": v for k, v in CHAOS_MODELS.items()},
    **{f"telemetry-{k}": v for k, v in TELEMETRY_MODELS.items()},
    **{f"resilience-{k}": v for k, v in RESILIENCE_MODELS.items()},
}


def probe(name: str) -> dict:
    jm, tm = MODELS[name](jmodel), MODELS[name](tmodel)
    jc, tc = JCompiled(jm), TCompiled(tm)
    params = steps._params(jm, REPLICAS)
    jstate = steps._jax_state(jc, params, REPLICAS, seed=5)
    jstate.pop("key")
    tparams = convert.params_from_numpy(params)
    run = steps._lax_block(jc, float(jm.horizon_s))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    draws = np.random.default_rng(0)
    differ: dict = {}
    for _ in range(STEPS):
        U = steps._log_agreeing_uniforms(draws, (REPLICAS, 1, jc.n_draws))
        tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()})
        jstate = run(jstate, jnp.asarray(U), jparams)
        plain_block_step(tc, tstate, torch.from_numpy(U), tparams)
        for leaf, value in jstate.items():
            want, got = np.asarray(value), tstate[leaf].numpy()
            bad = int((~((want == got) | (np.isnan(want) & np.isnan(got)))).sum())
            if bad:
                differ[leaf] = differ.get(leaf, 0) + bad
    return differ


def probe_barrier() -> dict:
    """Depth integrals where the port's barrier differs from JAX's, with
    the close-out rounded once and rounded twice."""
    from happysim_tpu.tpu import partitioned as jpart
    from happysim_tpu_torch import partitioned as tpart
    from happysim_tpu_torch.kernels import partition_barrier
    from test_torch_partitioned_models import HOP_S, ring

    P, R = 2, 4096
    kw = dict(window_s=HOP_S, n_replicas=R, seed=1, checkpoint_every_windows=1)
    mesh = jpart.partition_mesh(jax.devices("cpu")[:P])
    snaps: list = []
    jpart.run_partitioned(ring(jmodel, 2 * HOP_S), mesh=mesh, checkpoint_callback=snaps.append, **kw)
    state = {k: v.copy() for k, v in snaps[0].state.items()}
    draws = np.random.default_rng(0)
    for leaf in ("src_next", "srv_slot_done", "tr_time"):
        state[leaf][:] = np.inf
    state["srv_q_len"][:] = draws.integers(0, 200, state["srv_q_len"].shape)
    state["srv_depth_int"][:] = draws.uniform(0, 50, state["srv_depth_int"].shape).astype(np.float32)
    state["t"][:] = draws.uniform(0.0, 2 * HOP_S, state["t"].shape).astype(np.float32)
    n_windows = int(np.ceil(3 * HOP_S / HOP_S))
    start = jpart.PartitionedCheckpoint(window_index=1, n_windows=n_windows, n_partitions=P,
                                        n_replicas=R, seed=1, state=state)
    out: list = []
    jpart.run_partitioned(ring(jmodel, 3 * HOP_S), mesh=mesh, resume_from=start,
                          checkpoint_callback=out.append, **kw)
    want = out[0].state["srv_depth_int"]  # after window 1's barrier
    compiled = tpart._PartitionCompiled(ring(tmodel, 3 * HOP_S), 128)
    counts = {}
    fused = partition_barrier._fused
    for name, close in (("rounded once", fused), ("rounded twice", lambda b, t: b + t[0] * t[1])):
        flat = {k: torch.from_numpy(v.reshape((P * R,) + v.shape[2:]).copy()) for k, v in state.items()}
        partition_barrier._fused = close
        try:
            partition_barrier.plain_barrier(compiled, flat, P, tpart.window_end(1, HOP_S))
        finally:
            partition_barrier._fused = fused
        got = flat["srv_depth_int"].numpy().reshape(want.shape)
        counts[name] = int((got.view(np.int32) != want.view(np.int32)).sum())
    counts["entries"] = int(want.size)
    return counts


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    for name in sys.argv[1:] or list(MODELS) + ["partitioned-barrier"]:
        result = probe_barrier() if name == "partitioned-barrier" else probe(name)
        print(f"{name}: {result}", flush=True)


if __name__ == "__main__":
    main()
