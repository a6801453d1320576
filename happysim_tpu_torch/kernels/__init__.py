"""Hand-written CUDA kernels of the port (counterpart of
``happysim_tpu/tpu/kernels/``).

:mod:`~happysim_tpu_torch.kernels.event_step` holds the macro-block
event-step kernel (CUDA C++ in ``csrc/event_step.cuh``, launched from
``csrc/event_step.cu``, ``event_step_telemetry.cu`` and
``event_step_resilience.cu``), which draws its own uniforms with the
threefry of ``csrc/threefry.cuh``, its wrapper and its plain torch-op
version; :mod:`~happysim_tpu_torch.kernels.uniform` the standalone draw
kernel of the chain form (``csrc/uniform.cu``, the same threefry);
:mod:`~happysim_tpu_torch.kernels.mm1_scan` the M/M/1 ensemble's Lindley
kernel (``csrc/mm1_scan.cu``, the same threefry) and its plain version;
:mod:`~happysim_tpu_torch.kernels.partition_barrier` the partitioned
executor's window barrier (``csrc/partition_barrier.cu``, parking
merged jobs as the event step parks them, ``csrc/transit.cuh``) and its
plain version; :mod:`~happysim_tpu_torch.kernels.build` their nvcc
build;
:mod:`~happysim_tpu_torch.kernels.support` the event step's shape
provenance, launch bounds and bytes and operations counts.
"""
