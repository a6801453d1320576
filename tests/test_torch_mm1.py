"""The port's M/M/1 ensemble (``happysim_tpu_torch.mm1``) against the JAX
package's ``happysim_tpu/tpu/mm1.py`` on the CPU.

``plain_mm1_scan``, what the CPU runs and what the CUDA kernel is held
against on the card, follows XLA's compiled ``_mm1_scan``: with XLA's
``log`` substituted it is bit-equal to it. With torch's own ``log`` the
per-replica sums agree within rel 1e-5 (XLA's CPU ``log`` differs from
torch's by an ulp on some draws, ROADMAP.md C; measured worst rel 7.1e-7
over the runs below), and so do the ensemble statistics. The kernel's
source, built as host C++ with g++ and run one lane a block, agrees with
``plain_mm1_scan`` within the same rel 1e-5 (glibc's ``logf`` against
torch's CPU ``log``).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from happysim_tpu.tpu.mesh import replica_mesh  # noqa: E402
from happysim_tpu.tpu.mm1 import _mm1_scan as j_scan  # noqa: E402
from happysim_tpu.tpu.mm1 import run_mm1_ensemble as j_run  # noqa: E402
from happysim_tpu_torch import MM1Result, rng, run_mm1_ensemble  # noqa: E402
from happysim_tpu_torch.kernels import mm1_scan  # noqa: E402
from happysim_tpu_torch.kernels.build import CSRC  # noqa: E402

RTOL = 1e-5
# (replicas, customers, warmup, lambda, mu, seed): the second pair of
# rates has inexact float32 reciprocals, R = 300 is no multiple of the
# kernel's block.
SCANS = {
    "rho0.8": (256, 512, 128, 8.0, 10.0, 0),
    "rho0.78": (300, 256, 64, 7.0, 9.0, 5),
}


def _jax_sums(R, n, warmup, lam, mu, seed):
    scan = jax.jit(j_scan, static_argnums=(2, 3, 4, 5))
    sums = scan(jax.random.PRNGKey(seed), jnp.zeros((R,), jnp.float32), lam, mu, n, warmup)
    return [np.asarray(s) for s in sums]


@pytest.mark.parametrize("name", sorted(SCANS))
def test_plain_scan_matches_jax_scan(name):
    R, n, warmup, lam, mu, seed = SCANS[name]
    expected = _jax_sums(R, n, warmup, lam, mu, seed)
    got = mm1_scan.plain_mm1_scan(rng.PRNGKey(seed), R, lam, mu, n, warmup)
    for label, g, e in zip(("sum_w", "sum_sq", "sum_s"), got, expected):
        assert g.dtype == torch.float32 and g.shape == (R,)
        np.testing.assert_allclose(g.numpy(), e, rtol=RTOL, err_msg=label)
        assert (e > 0).all(), label


@pytest.mark.parametrize("name", sorted(SCANS))
def test_plain_scan_with_xla_log_is_the_jax_scan_bit_for_bit(name, monkeypatch):
    """The divisions as products with float32 reciprocals and the four
    multiply-adds rounded once are XLA's: fed XLA's own log, the plain
    scan reproduces every per-replica sum exactly."""
    R, n, warmup, lam, mu, seed = SCANS[name]
    expected = _jax_sums(R, n, warmup, lam, mu, seed)
    xla_log = jax.jit(jnp.log)
    monkeypatch.setattr(
        torch, "log", lambda x: torch.from_numpy(np.asarray(xla_log(x.numpy())).copy())
    )
    got = mm1_scan.plain_mm1_scan(rng.PRNGKey(seed), R, lam, mu, n, warmup)
    for label, g, e in zip(("sum_w", "sum_sq", "sum_s"), got, expected):
        np.testing.assert_array_equal(g.numpy(), e, err_msg=label)


@pytest.mark.parametrize("lam,mu,R,n,seed", [(8.0, 10.0, 512, 512, 0), (5.0, 10.0, 384, 256, 2)])
def test_ensemble_statistics_match_jax(lam, mu, R, n, seed):
    expected = j_run(lam, mu, R, n, seed=seed, mesh=replica_mesh(jax.devices("cpu")[:1]))
    got = run_mm1_ensemble(lam, mu, R, n, seed=seed, device="cpu")
    assert isinstance(got, MM1Result) and got.device_name == "cpu"
    for field in ("mean_wait_s", "std_wait_s", "mean_sojourn_s"):
        np.testing.assert_allclose(getattr(got, field), getattr(expected, field), rtol=RTOL,
                                   err_msg=field)
    for field in ("analytic_wait_s", "n_replicas", "customers_per_replica", "simulated_events"):
        assert getattr(got, field) == getattr(expected, field), field


def test_mean_wait_within_one_percent_of_theory():
    """BASELINE.json's gate, rho / (mu - lambda) = 0.4 s, at 1,024
    replicas of 1,024 customers; the sojourn adds the mean service."""
    result = run_mm1_ensemble(8.0, 10.0, 1024, 1024, seed=0, device="cpu")
    assert result.analytic_wait_s == pytest.approx(0.4)
    assert result.wait_error_rel < 0.01
    assert result.mean_sojourn_s == pytest.approx(0.5, rel=0.02)
    assert result.simulated_events == 2 * 1024 * 1024
    assert result.wall_seconds > 0 and result.events_per_second > 0


def test_unstable_queue_is_rejected():
    with pytest.raises(ValueError, match="Unstable queue"):
        run_mm1_ensemble(10.0, 10.0, device="cpu")


def test_seed_determinism_and_variation():
    a = run_mm1_ensemble(n_replicas=128, n_customers=128, seed=9, device="cpu")
    b = run_mm1_ensemble(n_replicas=128, n_customers=128, seed=9, device="cpu")
    c = run_mm1_ensemble(n_replicas=128, n_customers=128, seed=10, device="cpu")
    assert a.mean_wait_s == b.mean_wait_s and a.std_wait_s == b.std_wait_s
    assert a.mean_wait_s != c.mean_wait_s


def test_replicas_are_not_padded_and_warmup_defaults_to_a_quarter():
    """One device pads nothing; a replica's draws depend on the replica
    count (elements r and R + r of each step's draw), as in JAX."""
    result = run_mm1_ensemble(n_replicas=101, n_customers=64, seed=3, device="cpu")
    assert result.n_replicas == 101
    explicit = run_mm1_ensemble(n_replicas=101, n_customers=64, warmup=16, seed=3, device="cpu")
    assert explicit.mean_wait_s == result.mean_wait_s
    key = rng.PRNGKey(3)
    small = mm1_scan.plain_mm1_scan(key, 100, 8.0, 10.0, 64, 16)[0]
    large = mm1_scan.plain_mm1_scan(key, 101, 8.0, 10.0, 64, 16)[0]
    assert not torch.equal(small, large[:100])


def test_entry_point_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="run_mm1_ensemble runs on a CUDA device"):
        run_mm1_ensemble(n_replicas=8, n_customers=8)


def test_wrapper_runs_the_plain_version_only_for_the_cpu():
    """The wrapper's CPU answer is the plain version's; another device
    without a kernel is refused, not served by the plain version."""
    key = rng.PRNGKey(1)
    got = mm1_scan.mm1_scan(key, 64, 8.0, 10.0, 32, 8)
    want = mm1_scan.plain_mm1_scan(key, 64, 8.0, 10.0, 32, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="unsupported device"):
        mm1_scan.mm1_scan(key.to("meta"), 64, 8.0, 10.0, 32, 8)


# The kernel as host C++: the CUDA qualifiers shimmed away, one lane a
# thread block (so the lane folds its block's step keys itself), lanes in
# turn.
_MM1_HOST = r"""
#include <math.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
struct dim3 { unsigned x = 0, y = 0, z = 0; };
static dim3 blockIdx, threadIdx, blockDim;
inline void __syncthreads() {}
inline int min(int a, int b) { return a < b ? a : b; }
#include "mm1_scan.cu"
extern "C" void run_mm1(const uint32_t* key, int R, int n, int warmup, float lo, float span,
                        float inv_lam, float inv_mu, float* sum_w, float* sum_sq, float* sum_s) {
  blockDim.x = 1;
  threadIdx.x = 0;
  for (int r = 0; r < R; ++r) {
    blockIdx.x = r;
    mm1_scan_kernel(key, R, n, warmup, lo, span, inv_lam, inv_mu, sum_w, sum_sq, sum_s);
  }
}
"""


@pytest.fixture(scope="module")
def host_mm1(tmp_path_factory):
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        pytest.skip("needs a host C++ compiler to build the kernel's source")
    build = tmp_path_factory.mktemp("mm1_host")
    (build / "cuda_runtime.h").write_text("")
    source = build / "host.cpp"
    source.write_text(_MM1_HOST)
    lib_path = build / "libmm1.so"
    subprocess.run(
        [compiler, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{build}", f"-I{CSRC}", "-o", str(lib_path), str(source)],
        check=True, capture_output=True, timeout=300,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.run_mm1.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float] * 4 + [
        ctypes.c_void_p
    ] * 3
    return lib


@pytest.mark.parametrize("name", sorted(SCANS))
def test_kernel_source_built_for_the_host_matches_the_plain_scan(host_mm1, name):
    """Lane r reads elements r and R + r of each step's draw, the step keys
    of a tile of 256 customers and the warmup cut, as plain_mm1_scan does
    (customers 512 and 256 cross two and one tiles)."""
    R, n, warmup, lam, mu, seed = SCANS[name]
    key = rng.PRNGKey(seed)
    key_words = np.ascontiguousarray(key.numpy().astype(np.uint32))
    got = [np.zeros(R, np.float32) for _ in range(3)]
    lo = np.float32(mm1_scan.MINVAL)
    span = np.float32(np.float32(mm1_scan.MAXVAL) - lo)
    host_mm1.run_mm1(
        key_words.ctypes.data, R, n, warmup, float(lo), float(span),
        float(mm1_scan._reciprocal(lam)), float(mm1_scan._reciprocal(mu)),
        *(g.ctypes.data for g in got),
    )
    want = mm1_scan.plain_mm1_scan(key, R, lam, mu, n, warmup)
    for label, g, w in zip(("sum_w", "sum_sq", "sum_s"), got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=RTOL, err_msg=label)
