"""The port's public surface against the JAX package's: ``__all__`` holds
every name of JAX's ``happysim_tpu.tpu.__all__`` but those left out by
design (XLA and Pallas switches, the Pallas dispatch), the mesh's (A.13)
and the partitioned module's (A.14) included; and the
result's ``kernel_decline`` and the model's ``kernel_supported()``. The
result's ``summary()`` is held against JAX's in test_torch_summary.py.
"""

import pytest

pytest.importorskip("torch")

import happysim_tpu.tpu as jtpu  # noqa: E402

import happysim_tpu_torch as port  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import run_ensemble  # noqa: E402
from happysim_tpu_torch.kernels import support  # noqa: E402

# XLA and Pallas switches, and the Pallas dispatch (it takes a JAX mesh).
LEFT_OUT = {"KERNEL_ENV", "pallas_available", "maybe_enable_compile_cache", "kernel_decision"}
# mesh.py (ROADMAP A.13) and partitioned.py (A.14), ported.
MESH_NAMES = {
    "STATE_PARTITION_RULES", "ensemble_state_shardings", "ensemble_state_specs",
    "match_partition_rules", "HOST_AXIS", "REPLICA_AXIS", "distributed_initialize",
    "host_replica_mesh", "pad_to_multiple", "replica_mesh", "replica_sharding",
    "replicated_sharding",
}
PARTITIONED_NAMES = {
    "run_partitioned", "PARTITION_AXIS", "PartitionedCheckpoint", "PartitionedResult",
    "partition_mesh",
}


def test_all_holds_every_ported_name_of_jax():
    missing = set(jtpu.__all__) - LEFT_OUT - set(port.__all__)
    assert not missing, sorted(missing)
    assert MESH_NAMES <= set(port.__all__)
    assert PARTITIONED_NAMES <= set(port.__all__)
    assert not (set(port.__all__) & LEFT_OUT)
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    # The left-out and the mesh's and partitioned module's names are all JAX's.
    assert (LEFT_OUT | MESH_NAMES | PARTITIONED_NAMES) <= set(jtpu.__all__)


def test_package_docstring_names_what_is_left_out():
    for name in sorted(LEFT_OUT):
        assert name in port.__doc__, name


@pytest.mark.parametrize("name", sorted(set(port.__all__) & set(jtpu.__all__)))
def test_exported_name_is_the_same_kind_as_jax(name):
    """A class stays a class, a function a function, a constant equal."""
    ours, theirs = getattr(port, name), getattr(jtpu, name)
    assert isinstance(ours, type) == isinstance(theirs, type), name
    assert callable(ours) == callable(theirs), name
    if not callable(ours):
        assert ours == theirs, name


def test_kernel_decline_names_the_cpu():
    """A CPU run did not launch the kernel and says why; a chain-form run
    reaches no kernel dispatch, as in JAX ("")."""
    model = tmodel.mm1_model(8.0, 10.0, 5.0)
    scan = run_ensemble(model, n_replicas=8, device="cpu", max_events=256)
    assert scan.engine_path == "scan" and scan.kernel_decline == 'device="cpu"'
    assert scan.engine_report()["kernel_decline"] == 'device="cpu"'
    chain = run_ensemble(model, n_replicas=8, device="cpu")
    assert chain.engine_path == "chain" and chain.kernel_decline == ""


def test_kernel_decline_names_the_bound_past_which_a_model_is():
    model = tmodel.EnsembleModel(horizon_s=2.0)
    src = model.source(rate=5.0)
    servers = [model.server(service_mean=0.01) for _ in range(2)]
    servers.append(model.server(service_mean=0.01,
                                concurrency=support.KERNEL_MAX_CONCURRENCY + 1))
    model.connect(src, servers[0])
    for a, b in zip(servers, servers[1:]):
        model.connect(a, b)
    model.connect(servers[-1], model.sink())
    supported, reason = model.kernel_supported()
    assert not supported and f"concurrency={support.KERNEL_MAX_CONCURRENCY + 1}" in reason
    result = run_ensemble(model, n_replicas=2, device="cpu", max_events=64)
    assert result.kernel_decline == f'device="cpu"; {reason}'


def test_kernel_supported_on_a_model_within_the_bounds():
    assert tmodel.mm1_model(8.0, 10.0, 5.0).kernel_supported() == (True, "")
