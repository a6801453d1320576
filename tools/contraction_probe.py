#!/usr/bin/env python3
"""Where the port's plain event step and the compiled JAX step round an
event time differently, model by model, on the CPU:

    JAX_PLATFORMS=cpu python3 tools/contraction_probe.py [model ...]

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


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    for name in sys.argv[1:] or list(MODELS):
        print(f"{name}: {probe(name)}", flush=True)


if __name__ == "__main__":
    main()
