"""Hand-written CUDA kernels of the port (counterpart of
``happysim_tpu/tpu/kernels/``).

:mod:`~happysim_tpu_torch.kernels.event_step` holds the macro-block
event-step kernel (CUDA C++ in ``csrc/event_step.cuh``, launched from
``csrc/event_step.cu``, ``event_step_telemetry.cu`` and
``event_step_resilience.cu``), its wrapper and
its plain torch-op version; :mod:`~happysim_tpu_torch.kernels.support`
holds its shape provenance and launch bounds.
"""
