"""The kernels' device threefry (csrc/threefry.cuh) and the event-step
kernel that draws its own uniforms, compiled as host C++ with g++.

The header is integer arithmetic plus one double multiply-add, with the
CUDA intrinsics behind a shim, so the CPU build computes what the card
does. Its fold_in and uniform are held bit for bit against the port's
torch-op threefry (rng.py) and jax.random; the host build of
event_step.cuh, given the replica keys and a block index in place of a
uniform block, is held against the plain torch-op step fed by rng.py's
draw of the same block (integer leaves exactly; float leaves within rel
1e-5, because glibc's float32 logf, expf and powf differ from torch's CPU
ones by an ulp on some inputs).
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

from happysim_tpu_torch import rng  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch.engine import _Compiled as TCompiled  # noqa: E402
from happysim_tpu_torch.engine import _resolve_params  # noqa: E402
from happysim_tpu_torch.kernels import event_step  # noqa: E402
from happysim_tpu_torch.kernels.build import CSRC  # noqa: E402
from test_torch_chaos_models import CHAOS_MODELS  # noqa: E402
from test_torch_consensus_models import CONSENSUS_MODELS  # noqa: E402
from test_torch_event_step import fanout  # noqa: E402
from test_torch_multisource_models import MULTI_MODELS, two_class  # noqa: E402
from test_torch_resilience_models import RESILIENCE_MODELS  # noqa: E402
from test_torch_telemetry_models import TELEMETRY_MODELS  # noqa: E402

SEEDS = range(16)
BLOCKS = (0, 1, 2, 7, 1 << 16, 123457, (1 << 31) - 1, 0xFFFFFFFF)
POSITIONS = 4096


def _compiler():
    compiler = shutil.which("g++") or shutil.which("c++")
    if compiler is None:
        pytest.skip("needs a host C++ compiler to build the kernels' headers")
    return compiler


_THREEFRY_CPP = r"""
#include "threefry.cuh"
extern "C" void fold(const uint32_t* keys, int n, uint32_t data, uint32_t* out) {
  for (int i = 0; i < n; ++i) {
    const HsKey k = hs_fold_in(HsKey{keys[2 * i], keys[2 * i + 1]}, data);
    out[2 * i] = k.k0;
    out[2 * i + 1] = k.k1;
  }
}
extern "C" void fill(const uint32_t* keys, int n, uint32_t data, int m, float lo, float span,
                     float* out) {
  for (int i = 0; i < n; ++i) {
    const HsKey k = hs_fold_in(HsKey{keys[2 * i], keys[2 * i + 1]}, data);
    for (int j = 0; j < m; ++j) out[(size_t)i * m + j] = hs_uniform_at(k, (uint32_t)j, lo, span);
  }
}
"""


@pytest.fixture(scope="module")
def threefry_lib(tmp_path_factory):
    compiler = _compiler()
    build = tmp_path_factory.mktemp("threefry")
    source = build / "threefry.cpp"
    source.write_text(_THREEFRY_CPP)
    lib_path = build / "libthreefry.so"
    subprocess.run(
        [compiler, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{CSRC}", "-o", str(lib_path), str(source)],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(str(lib_path))
    lib.fold.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p]
    lib.fill.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    return lib


def _replica_keys(seed: int, n: int) -> np.ndarray:
    return np.ascontiguousarray(rng.split(rng.PRNGKey(seed), n).numpy().astype(np.uint32))


@pytest.mark.parametrize("block", BLOCKS)
def test_fold_in_and_uniform_match_rng_and_jax_bit_for_bit(threefry_lib, block):
    """16 seeds' replica keys (4 replicas each) folded with ``block``, and
    4,096 positions of the uniform of each folded key: the header against
    rng.py and against jax.random, bit for bit."""
    keys = np.concatenate([_replica_keys(seed, 4) for seed in SEEDS])
    n = keys.shape[0]
    folded = np.empty_like(keys)
    threefry_lib.fold(keys.ctypes.data, n, block, folded.ctypes.data)
    want_fold = rng.fold_in(torch.from_numpy(keys.astype(np.int64)).to(torch.uint32), block)
    np.testing.assert_array_equal(folded, want_fold.numpy().astype(np.uint32))

    lo = np.float32(1e-12)
    span = np.float32(np.float32(1.0) - lo)
    got = np.empty((n, POSITIONS), np.float32)
    threefry_lib.fill(keys.ctypes.data, n, block, POSITIONS, float(lo), float(span), got.ctypes.data)
    torch_keys = torch.from_numpy(keys.astype(np.int64)).to(torch.uint32)
    want = rng.uniform(rng.fold_in(torch_keys, block), (POSITIONS,), minval=1e-12, maxval=1.0)
    np.testing.assert_array_equal(got.view(np.uint32), want.numpy().view(np.uint32))
    jax_want = jax.vmap(
        lambda k: jax.random.uniform(
            jax.random.fold_in(k, jnp.uint32(block)), (POSITIONS,), minval=1e-12, maxval=1.0
        )
    )(jnp.asarray(keys))
    np.testing.assert_array_equal(got.view(np.uint32), np.asarray(jax_want).view(np.uint32))


def test_uniform_with_another_span_matches_rng(threefry_lib):
    """A span below one rounds floats * span + lo once, as rng.uniform."""
    keys = _replica_keys(5, 8)
    lo, hi = np.float32(-2.5), np.float32(3.25)
    span = np.float32(hi - lo)
    got = np.empty((8, POSITIONS), np.float32)
    threefry_lib.fill(keys.ctypes.data, 8, 9, POSITIONS, float(lo), float(span), got.ctypes.data)
    torch_keys = torch.from_numpy(keys.astype(np.int64)).to(torch.uint32)
    want = rng.uniform(rng.fold_in(torch_keys, 9), (POSITIONS,), minval=float(lo), maxval=float(hi))
    np.testing.assert_array_equal(got.view(np.uint32), want.numpy().view(np.uint32))


# -- the event-step kernel, built for the host --------------------------------
# (MAXV, GRAPH, EXT, CHAOS, TEL, RES, CON, MULTI) of each model below.
_INSTANTIATIONS = {
    "mm1": (1, "false", "false", "false", "false", "false", "false", "false"),
    "fanout": (4, "true", "false", "false", "false", "false", "false", "false"),
    "chaos": (4, "true", "true", "true", "false", "false", "false", "false"),
    "telemetry": (4, "true", "true", "true", "true", "false", "false", "false"),
    "resilience": (4, "true", "true", "true", "true", "true", "false", "false"),
    "consensus": (4, "true", "true", "true", "true", "false", "true", "false"),
    "consensus_plain": (4, "true", "true", "true", "false", "false", "true", "false"),
    "consensus_resilience": (4, "true", "true", "true", "true", "true", "true", "false"),
    "multi": (4, "true", "true", "true", "true", "true", "true", "true"),
    "multi_lean": (4, "true", "true", "false", "false", "false", "false", "true"),
    "multi_lean_tel": (4, "true", "true", "false", "true", "false", "false", "true"),
    "multi_chaos": (4, "true", "true", "true", "false", "false", "false", "true"),
    "multi_chaos_tel": (4, "true", "true", "true", "true", "false", "false", "true"),
}
# Where the test holds the launcher's choice for an instantiation's
# models: the library, then the code its launch takes and whether with
# the telemetry sites (csrc/event_step_multi.cu's `launch`, by
# event_step.cuh's hs_code, as its hs_event_step_code names it).
_LIBRARIES = {
    "multi_lean": ("event_step_multi", "lean", False),
    "multi_lean_tel": ("event_step_multi", "lean", True),
    "multi_chaos": ("event_step_multi", "chaos", False),
    "multi_chaos_tel": ("event_step_multi", "chaos", True),
}
_HOST_MODELS = {
    "mm1": ("mm1", lambda: tmodel.mm1_model(8.0, 10.0, 20.0, warmup_s=5.0)),
    "fanout-random": ("fanout", lambda: fanout(tmodel, "random")),
    "fanout-weighted": ("fanout", lambda: fanout(tmodel, "weighted")),
    "chaos-pinned": ("chaos", lambda: CHAOS_MODELS["pinned"](tmodel)),
    "chaos-hedged": ("chaos", lambda: CHAOS_MODELS["hedged-mm1"](tmodel)),
    "chaos-bench": ("chaos", lambda: CHAOS_MODELS["bench-chaos"](tmodel)),
    "telemetry-chaos-fanout": ("telemetry", lambda: TELEMETRY_MODELS["chaos-fanout"](tmodel)),
    "resilience-fanout": ("resilience", lambda: RESILIENCE_MODELS["resilience-fanout"](tmodel)),
    "resilience-storm": ("resilience", lambda: RESILIENCE_MODELS["storm-defended"](tmodel)),
    # Several sources and sinks on the instantiation for them, nodes no
    # source reaches on the graph code; the consensus tier on its
    # instantiations.
    **{
        f"multi-{name}": (instantiation, lambda name=name: MULTI_MODELS[name](tmodel))
        for name, instantiation in (
            ("superpose", "multi"), ("superpose-tie", "multi"), ("two-class", "multi"),
            ("two-class-telemetry", "multi"), ("profiled", "multi"),
            ("orphan-router", "fanout"), ("orphan-limiter", "fanout"), ("no-sink", "fanout"),
        )
    },
    # The same models without chaos on the chaos-free code for several
    # sources or sinks (event_step_multi.cu), with the telemetry
    # sites where the model has a spec.
    **{
        f"multi-lean-{name}": (instantiation, lambda name=name: MULTI_MODELS[name](tmodel))
        for name, instantiation in (
            ("superpose", "multi_lean"), ("superpose-tie", "multi_lean"),
            ("two-class", "multi_lean"), ("two-class-telemetry", "multi_lean_tel"),
            ("profiled", "multi_lean"),
        )
    },
    # Several sources or sinks with chaos on the chaos code without the
    # defenses' and the consensus tier's sites, with the telemetry sites
    # where the model has a spec, and with a defense on the whole chaos
    # code (which also runs the chaos models above and here, every site's
    # switch unset).
    **{
        f"multi-chaos-{name}": (instantiation, lambda name=name: MULTI_MODELS[name](tmodel))
        for name, instantiation in (
            ("two-class-chaos", "multi_chaos"), ("superpose-faulted", "multi_chaos"),
        )
    },
    "multi-chaos-two-class-chaos-telemetry": ("multi_chaos_tel", lambda: two_class(
        tmodel, horizon_s=4.0, window_s=0.5, n_front=2, loss_p=0.05, deadline_s=0.25
    )),
    **{
        f"multi-{name}": ("multi", lambda name=name: MULTI_MODELS[name](tmodel))
        for name in ("two-class-chaos", "superpose-faulted", "two-class-defended")
    },
    **{
        f"consensus-{name}": (instantiation, lambda name=name: CONSENSUS_MODELS[name](tmodel))
        for name, instantiation in (
            ("quorum-undefended", "consensus"), ("quorum-defended", "consensus_resilience"),
            ("election-bully", "consensus"), ("stochastic", "consensus_plain"),
            ("delay", "consensus_plain"),
        )
    },
}

_SHIMS = r"""
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__
struct dim3 { unsigned x = 0, y = 0, z = 0; };
static dim3 blockIdx, threadIdx, blockDim;
inline void __syncthreads() {}
using std::isinf;
using std::isfinite;
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
#define HS_HOST_SHARED_FLOATS (1 << 20)
float hs_tables[HS_HOST_SHARED_FLOATS];
#include "event_step.cuh"
"""

# run_<name>(args, threads): the launch's thread blocks of `threads` lanes
# in turn over the one shared buffer, each block's profile tables staged
# before its lanes run (a lane runs its whole loop before the next
# starts, so a lane staging only its share of the tables would read the
# others' unstaged); returns 1 when the tables and the row tile do not fit.
_RUN = """
extern "C" int run_{name}(const EventStepArgs* a, int threads) {{
  const int tables = 2 * a->prof_n * a->has_profile;
  if (tables + a->stage.words * threads > HS_HOST_SHARED_FLOATS) return 1;
  blockDim.x = threads;
  for (int first = 0; first < a->R; first += threads) {{
    blockIdx.x = first / threads;
    stage_profiles(*a, 0, 1);
    for (int lane = 0; lane < threads; ++lane) {{
      threadIdx.x = lane;
      event_step_kernel<{maxv}, {flags}>(*a);
    }}
  }}
  return 0;
}}
"""


def build_host_kernel(build) -> ctypes.CDLL:
    """The host library of _INSTANTIATIONS in directory ``build``, each
    exported as ``run_<name>(args, threads)`` (see _RUN)."""
    compiler = _compiler()
    (build / "cuda_runtime.h").write_text("")
    body = [_SHIMS, "HS_EVENT_STEP_CODE(false)\n"]
    for name, (maxv, *flags) in _INSTANTIATIONS.items():
        body.append(_RUN.format(name=name, maxv=maxv, flags=", ".join(flags)))
    source = build / "host.cpp"
    source.write_text("".join(body))
    lib_path = build / "libhost.so"
    subprocess.run(
        [compiler, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{build}", f"-I{CSRC}", "-o", str(lib_path), str(source)],
        check=True, capture_output=True, timeout=600,
    )
    lib = ctypes.CDLL(str(lib_path))
    for name in _INSTANTIATIONS:
        getattr(lib, f"run_{name}").argtypes = [ctypes.POINTER(event_step._Args), ctypes.c_int]
        getattr(lib, f"run_{name}").restype = ctypes.c_int
    lib.hs_event_step_code.argtypes = [ctypes.POINTER(event_step._Args)]
    lib.hs_event_step_code.restype = ctypes.c_char_p
    return lib


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """One host library with the instantiations of _INSTANTIATIONS, each
    exported as run_<name>(args, threads)."""
    return build_host_kernel(tmp_path_factory.mktemp("event_step_host"))


@pytest.mark.parametrize("name", sorted(_HOST_MODELS))
def test_host_kernel_drawing_its_own_uniforms_matches_the_plain_step(host_kernel, name):
    """32 replicas, 4 blocks from the initial state with block indices
    above 2^16: the host build of the kernel, handed the keys and the
    block index, against plain_block_step on rng.py's draw of the block."""
    instantiation, build = _HOST_MODELS[name]
    model = build()
    compiled = TCompiled(model)
    n = 32
    params = {k: torch.from_numpy(v) for k, v in _resolve_params(model, compiled, n, None).items()}
    keys = rng.split(rng.PRNGKey(3), n)
    kernel_state = compiled.init_state(keys, params)
    plain_state = {k: v.clone() for k, v in kernel_state.items()}
    run = getattr(host_kernel, f"run_{instantiation}")
    draws = torch.zeros((n,), dtype=torch.int32)
    for block in (70000, 70001, 70002, 70003):
        live = ~compiled.replica_halted(kernel_state)
        halted = torch.empty((n,), dtype=torch.uint8)
        args = event_step.launch_args(compiled, kernel_state, keys, block, params, halted, draws)
        assert args.block == block and args.keys == keys.data_ptr() and args.n_blocks == 1
        if instantiation in _LIBRARIES:
            library, code, tel = _LIBRARIES[instantiation]
            assert event_step.library_of(args) == library
            assert (host_kernel.hs_event_step_code(ctypes.byref(args)).decode(),
                    bool(args.tel.nW)) == (code, tel)
        if name == "multi-two-class-defended":
            assert host_kernel.hs_event_step_code(ctypes.byref(args)) == b"full"
        assert run(ctypes.byref(args), 1) == 0
        plain_halted = event_step.plain_block_step(
            compiled, plain_state, event_step.block_uniforms(compiled, keys, block), params
        )
        assert torch.equal(halted.bool(), plain_halted), f"block {block}: halted"
        for leaf in sorted(plain_state):
            got, want = kernel_state[leaf], plain_state[leaf]
            if want.is_floating_point():
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, err_msg=f"{block} {leaf}")
            else:
                assert torch.equal(got, want), f"block {block}: {leaf}"
        # Each lane live at the block's start folded its key once and drew
        # at least the steps it took; a halted lane drew nothing.
        assert bool((draws[live] >= 1).all()) and bool((draws[~live] == 0).all())
    assert int(plain_state["events"].min()) > 0

