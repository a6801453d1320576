"""Rate profiles and the M/G/1 service families: the port's tables,
constants and float32 numerics against the JAX engine's.

The lookups and the family draws are compared value by value on inputs
made from a seed with numpy. Tolerances: the tables, the family
constants and the profile lookups must be bit-equal (both sides form the
tables in float64 and cast once, and the port rounds the multiply-adds
that XLA's CPU backend fuses once, as XLA does). The erfinv and the
family draws go through float32 ``log``/``log1p``/``exp``/``pow``,
where XLA's CPU code and torch's differ by an ulp on some inputs, so
they are held bit-equal wherever those agree and to a few ulp
elsewhere.
"""

import math
import re

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from happysim_tpu.tpu import engine as jengine  # noqa: E402
from happysim_tpu.tpu import model as jmodel  # noqa: E402
from happysim_tpu.tpu.kernels.event_step import shared_const_bytes as j_shared_const_bytes  # noqa: E402
from happysim_tpu_torch import engine as tengine  # noqa: E402
from happysim_tpu_torch import model as tmodel  # noqa: E402
from happysim_tpu_torch import numerics  # noqa: E402
from happysim_tpu_torch.kernels import support  # noqa: E402
from happysim_tpu_torch.kernels.event_step import _static_args, launch_args  # noqa: E402

F32_ULP = float(np.finfo(np.float32).eps)


# Profiled sources, each feeding one server; built the same way in both
# packages (``mod`` is either package's model module).
def _fed(mod, build_source, horizon_s=30.0):
    m = mod.EnsembleModel(horizon_s=horizon_s)
    src = build_source(m)
    srv = m.server(service_mean=0.05, queue_capacity=64)
    m.connect(src, srv)
    m.connect(srv, m.sink())
    return m


PROFILES = {
    "ramp-up": lambda m: m.ramp_source(2.0, 10.0, 30.0),
    "ramp-down-held": lambda m: m.ramp_source(12.0, 3.0, 12.5),
    "ramp-constant-kind": lambda m: m.ramp_source(2.0, 10.0, 30.0, kind="constant"),
    "spike": lambda m: m.spike_source(2.0, 20.0, 10.0, 20.0),
    "spike-off": lambda m: m.spike_source(6.0, 0.0, 10.0, 20.0),
    "bench-ramp": lambda m: m.ramp_source(20.0, 40.0, 20.0),
}


def _pair(name):
    return _fed(jmodel, PROFILES[name]), _fed(tmodel, PROFILES[name])


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_profile_tables_match_jax_bit_for_bit(name):
    jm, tm = _pair(name)
    jc, tc = jengine._Compiled(jm), tengine._Compiled(tm)
    assert tc.has_profile.tolist() == jc.has_profile.tolist() == [True]
    for leaf in ("profile_times", "profile_cum", "profile_end_rate"):
        expected, got = getattr(jc, leaf), getattr(tc, leaf)
        assert got.dtype == expected.dtype == np.float32 and got.shape == expected.shape
        np.testing.assert_array_equal(_bits(got), _bits(expected), err_msg=leaf)
    assert tc.profile_times.shape == (1, tengine.PROFILE_GRID_POINTS)
    assert support.shared_const_bytes(tc) == j_shared_const_bytes(jc) == 2 * 512 * 4 + 16


def test_flat_source_has_no_profile_tables():
    tc = tengine._Compiled(tmodel.mm1_model())
    assert not tc.has_profile.any() and support.shared_const_bytes(tc) == 0
    # A "constant" profile is the flat source: no tables, no lookups.
    m = tmodel.EnsembleModel(horizon_s=5.0)
    src = m.source(rate=3.0, profile=tmodel.RateProfile(kind="constant"))
    m.connect(src, m.sink())
    assert not tengine._Compiled(m).has_profile.any()


def _lookup_inputs(horizon_s, n=4096, seed=11):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 1.2 * horizon_s, n).astype(np.float32)
    t[:4] = [0.0, horizon_s, np.nextafter(np.float32(horizon_s), np.float32(0)), 1.5 * horizon_s]
    increment = (-np.log(rng.uniform(1e-12, 1.0, n))).astype(np.float32)
    return t, increment


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_profile_lookups_match_jax_bit_for_bit(name):
    """Lambda(t) and the inverse gap, inside the grid, at its end and
    beyond it (extrapolated at the final rate)."""
    jm, tm = _pair(name)
    jc, tc = jengine._Compiled(jm), tengine._Compiled(tm)
    t, increment = _lookup_inputs(jm.horizon_s)
    cum_at = jax.jit(jax.vmap(lambda x: jc._profile_cum_at(0, x)))
    gap = jax.jit(jax.vmap(lambda x, e: jc._invert_profile(0, x, e)))
    got_cum = tc._profile_cum_at(0, torch.from_numpy(t))
    got_gap = tc._invert_profile(0, torch.from_numpy(t), torch.from_numpy(increment))
    np.testing.assert_array_equal(_bits(got_cum), _bits(cum_at(jnp.asarray(t))))
    np.testing.assert_array_equal(
        _bits(got_gap), _bits(gap(jnp.asarray(t), jnp.asarray(increment)))
    )
    assert bool((got_gap > 0).all())


INTERP_GRIDS = {
    # (xp, fp): a smooth grid, a grid with runs of repeated xp (the
    # inverse lookup of a flat cumulative table), and a short grid.
    "smooth": (np.linspace(0.0, 40.0, 512), np.linspace(0.0, 40.0, 512) ** 1.5),
    "repeated-xp": (
        np.concatenate([np.linspace(0.0, 5.0, 50), np.full(30, 5.0), np.linspace(5.0, 9.0, 40)]),
        np.linspace(0.0, 30.0, 120),
    ),
    "short": (np.array([1.0, 2.0]), np.array([-3.0, 7.0])),
}


@pytest.mark.parametrize("grid", sorted(INTERP_GRIDS))
def test_interp_matches_jnp_interp(grid):
    """The torch copy of jnp.interp, bit for bit: points inside, on every
    grid point, on repeated xp values, and outside on both sides."""
    xp, fp = (a.astype(np.float32) for a in INTERP_GRIDS[grid])
    rng = np.random.default_rng(5)
    span = float(xp[-1] - xp[0])
    x = np.concatenate([
        rng.uniform(xp[0] - 0.2 * span, xp[-1] + 0.2 * span, 3000),
        xp,
        np.nextafter(xp, np.float32(np.inf)),
        [-1e30, 1e30],
    ]).astype(np.float32)
    # XLA's CPU code flushes subnormals (ROADMAP C); the step never
    # looks up a subnormal time, so the one next to 0 is left out.
    x = x[(x == 0) | (np.abs(x) >= np.finfo(np.float32).tiny)]
    expected = jax.jit(jnp.interp)(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))
    got = numerics.interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp))
    np.testing.assert_array_equal(_bits(got), _bits(expected))


def test_erfinv_matches_jax_over_the_open_interval():
    """Giles' polynomial as XLA evaluates it: bit-equal wherever torch's
    and XLA's float32 log1p agree on w, within 2 ulp of the result
    elsewhere; +-1 give +-inf."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.linspace(-1.0, 1.0, 20001)[1:-1],
        rng.uniform(-1.0, 1.0, 20000),
        1.0 - np.logspace(-7.2, -1, 200),
        [0.0, -0.0, 1e-30, -1e-30, 1.0, -1.0],
    ]).astype(np.float32)
    expected = np.asarray(jax.jit(jax.scipy.special.erfinv)(jnp.asarray(x)))
    got = numerics.erfinv(torch.from_numpy(x)).numpy()
    assert np.isinf(got[-2:]).all() and np.array_equal(got[-2:], expected[-2:])
    arg = (x * -x).astype(np.float32)
    same_log1p = _bits(torch.log1p(torch.from_numpy(arg))) == _bits(jax.jit(jnp.log1p)(jnp.asarray(arg)))
    assert same_log1p.mean() > 0.5
    np.testing.assert_array_equal(_bits(got)[same_log1p], _bits(expected)[same_log1p])
    finite = np.isfinite(expected)
    np.testing.assert_allclose(
        got[finite], expected[finite], rtol=2 * F32_ULP, atol=np.finfo(np.float32).tiny
    )


def test_fma_f32_rounds_once():
    a, b, c = (torch.tensor([v], dtype=torch.float32) for v in (1.0 + 2**-23, 1.0 - 2**-23, -1.0))
    # The exact product 1 - 2**-46 minus 1 survives only when rounded once.
    assert float(numerics.fma_f32(a, b, c)) == -(2.0**-46)
    assert float(c + a * b) == 0.0


SERVICES = {
    "erlang2": {"service": "erlang", "service_k": 2},
    "erlang3": {"service": "erlang", "service_k": 3},
    "hyperexp": {"service": "hyperexp", "service_scv": 4.0},
    "lognormal": {"service": "lognormal", "service_scv": 2.0},
    "pareto": {"service": "pareto", "pareto_alpha": 3.0},
}


def _one_server(mod, **shape):
    m = mod.EnsembleModel(horizon_s=10.0)
    src = m.source(rate=8.0)
    srv = m.server(service_mean=0.1, queue_capacity=64, **shape)
    m.connect(src, srv)
    m.connect(srv, m.sink())
    return m


def _every_family(mod):
    """Six servers, one per family, in a chain."""
    m = mod.EnsembleModel(horizon_s=10.0)
    src = m.source(rate=4.0)
    servers = [
        m.server(service_mean=0.02, service="constant"),
        m.server(service_mean=0.02),
        *(m.server(service_mean=0.02, **shape) for shape in SERVICES.values()),
    ]
    m.connect(src, servers[0])
    for upstream, downstream in zip(servers, servers[1:]):
        m.connect(upstream, downstream)
    m.connect(servers[-1], m.sink())
    return m


@pytest.mark.parametrize(
    "build",
    [_every_family] + [lambda mod, s=s: _one_server(mod, **s) for s in SERVICES.values()],
    ids=["every-family"] + sorted(SERVICES, key=list(SERVICES).index),
)
def test_family_constants_and_draw_slots_match_jax(build):
    jc, tc = jengine._Compiled(build(jmodel)), tengine._Compiled(build(tmodel))
    for leaf in (
        "service_kind", "srv_erlang_k", "srv_hyp_p1", "srv_hyp_f1", "srv_hyp_f2",
        "srv_ln_sigma", "srv_par_alpha", "srv_par_xmf",
    ):
        expected, got = getattr(jc, leaf), getattr(tc, leaf)
        assert got.dtype == expected.dtype
        np.testing.assert_array_equal(got.view(np.int32), expected.view(np.int32), err_msg=leaf)
    for attr in ("families_present", "n_svc_draws", "n_draws", "U_GAP", "U_SVC1", "U_SVC2"):
        assert getattr(tc, attr) == getattr(jc, attr), attr


@pytest.mark.parametrize("family", list(SERVICES))
def test_family_draws_match_jax(family):
    """One draw per lane from each family, both packages on the same
    uniform windows: within 4 ulp (8 for lognormal, whose exponent of
    magnitude up to ~4 carries the log1p differences and XLA's folding
    of sigma * sqrt(2) into one constant through exp; measured worst
    4.05 ulp), and bit-equal for erlang and hyperexp wherever torch's
    and XLA's float32 log agree."""
    jc = jengine._Compiled(_one_server(jmodel, **SERVICES[family]))
    tc = tengine._Compiled(_one_server(tmodel, **SERVICES[family]))
    rng = np.random.default_rng(8)
    n = 20000
    u = rng.uniform(1e-12, 1.0, (n, tc.n_draws)).astype(np.float32)
    mean = rng.uniform(0.01, 1.0, (n, 1)).astype(np.float32)
    draw = jax.jit(jax.vmap(
        lambda row, m: jc._sample_service(jc._usvc(row, jc.U_SVC1), 0, {"srv_mean": m})
    ))
    expected = np.asarray(draw(jnp.asarray(u), jnp.asarray(mean)))
    got = tc._sample_service(
        torch.from_numpy(u), tc.U_SVC1, 0, {"srv_mean": torch.from_numpy(mean)}
    ).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all() and (got >= 0).all()
    ulps = 8 if family == "lognormal" else 4
    np.testing.assert_allclose(got, expected, rtol=ulps * F32_ULP, atol=0)
    # Where torch's and XLA's float32 log agree, erlang and hyperexp
    # are bit-equal (the erlang-3 division included, as XLA computes it).
    if family in ("erlang2", "erlang3", "hyperexp"):
        k = {"erlang2": 2, "erlang3": 3}.get(family, 1)
        base = tc.U_SVC1 + (1 if family == "hyperexp" else 0)
        arg = np.prod(u[:, base : base + k], axis=1, dtype=np.float32)
        same = _bits(torch.log(torch.from_numpy(arg))) == _bits(jax.jit(jnp.log)(jnp.asarray(arg)))
        np.testing.assert_array_equal(_bits(got)[same], _bits(expected)[same])


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_default_event_budget_matches_jax_on_profiled_models(name):
    jm, tm = _pair(name)
    assert tengine._default_max_events(tm, None) == jengine._default_max_events(jm, None)
    sweep = {"service_mean": np.linspace(0.01, 0.1, 8)}
    assert tengine._default_max_events(tm, sweep) == jengine._default_max_events(jm, sweep)


def test_source_rate_sweep_over_a_profiled_source_is_refused_like_jax():
    jm, tm = _pair("ramp-up")
    sweep = {"source_rate": np.linspace(1.0, 2.0, 4)}
    with pytest.raises(ValueError) as jax_error:
        jax_mesh = __import__("happysim_tpu.tpu.mesh", fromlist=["replica_mesh"]).replica_mesh
        jengine.run_ensemble(jm, n_replicas=4, sweeps=sweep, mesh=jax_mesh(jax.devices("cpu")[:1]))
    with pytest.raises(ValueError, match=re.escape(str(jax_error.value))):
        tengine.run_ensemble(tm, n_replicas=4, sweeps=sweep, device="cpu")


@pytest.mark.parametrize(
    "make, message",
    [
        (lambda mod: mod.RateProfile(kind="sine"), "unknown profile kind"),
        (lambda mod: mod.RateProfile(kind="ramp", ramp_duration_s=0.0), "ramp_duration_s must be > 0"),
        (lambda mod: mod.RateProfile(kind="ramp", end_rate=-1.0, ramp_duration_s=1.0), "end_rate must be >= 0"),
        (lambda mod: mod.RateProfile(kind="spike", spike_rate=-1.0, spike_end_s=1.0), "spike_rate must be >= 0"),
        (lambda mod: mod.RateProfile(kind="spike", spike_start_s=2.0, spike_end_s=1.0), "need 0 <= spike_start_s"),
    ],
    ids=["kind", "ramp-duration", "ramp-end-rate", "spike-rate", "spike-window"],
)
def test_profile_validation_matches_jax(make, message):
    with pytest.raises(ValueError) as jax_error:
        jmodel.EnsembleModel().source(rate=1.0, profile=make(jmodel))
    assert message in str(jax_error.value)
    with pytest.raises(ValueError, match=re.escape(str(jax_error.value))):
        tmodel.EnsembleModel().source(rate=1.0, profile=make(tmodel))


@pytest.mark.parametrize(
    "shape",
    [
        {"service": "erlang", "service_k": 5},
        {"service": "hyperexp", "service_scv": 1.0},
        {"service": "lognormal", "service_scv": 0.0},
        {"service": "pareto", "pareto_alpha": 1.0},
        {"service": "weibull"},
    ],
    ids=["erlang-k", "hyperexp-scv", "lognormal-scv", "pareto-alpha", "unknown"],
)
def test_family_validation_matches_jax(shape):
    with pytest.raises(ValueError) as jax_error:
        jmodel.EnsembleModel().server(**shape)
    with pytest.raises(ValueError, match=re.escape(str(jax_error.value))):
        tmodel.EnsembleModel().server(**shape)


def test_rate_profile_rate_at_matches_jax():
    for kind, kw in (
        ("ramp", {"end_rate": 9.0, "ramp_duration_s": 4.0}),
        ("spike", {"spike_rate": 7.0, "spike_start_s": 1.0, "spike_end_s": 2.5}),
        ("constant", {}),
    ):
        jp, tp = jmodel.RateProfile(kind=kind, **kw), tmodel.RateProfile(kind=kind, **kw)
        for t in np.linspace(0.0, 6.0, 61):
            assert tp.rate_at(3.0, float(t)) == jp.rate_at(3.0, float(t))


@pytest.mark.parametrize(
    "build, ext, profile",
    [
        (lambda: tmodel.mm1_model(), 0, 0),
        (lambda: _one_server(tmodel, service="constant"), 0, 0),
        (lambda: _one_server(tmodel, **SERVICES["lognormal"]), 1, 0),
        (lambda: _every_family(tmodel), 1, 0),
        (lambda: _fed(tmodel, PROFILES["spike"]), 1, 1),
        (lambda: _fed(tmodel, lambda m: m.source(rate=2.0, profile=tmodel.RateProfile())), 0, 0),
    ],
    ids=["mm1", "constant", "lognormal", "every-family", "spike", "constant-profile"],
)
def test_extended_instantiation_only_for_families_and_profiles(build, ext, profile):
    """The flat instantiations keep their code: only a family beyond
    constant/exponential or a profiled source launches the extended one."""
    args = _static_args(tengine._Compiled(build()))
    assert (args.ext, args.has_profile) == (ext, profile)
    assert args.prof_n == (tengine.PROFILE_GRID_POINTS if profile else 0)


def test_launch_args_point_at_the_compiled_tables():
    tm = _fed(tmodel, PROFILES["bench-ramp"])
    compiled = tengine._Compiled(tm)
    n = 4
    params = {
        "src_rate": torch.full((n, 1), 20.0),
        "srv_mean": torch.full((n, 1), 0.05),
    }
    keys = tengine.rng.split(tengine.rng.PRNGKey(1), n)
    state = compiled.init_state(keys, params)
    args = launch_args(compiled, state, keys, 0, params, torch.empty((n,), dtype=torch.uint8))
    times, cum = compiled.profile_tensors("cpu")
    assert (args.prof_times, args.prof_cum) == (times.data_ptr(), cum.data_ptr())
    assert args.src[0].prof_end_rate == pytest.approx(40.0) and args.prof_n == 512
    # The tables are made once per device and kept with the model.
    assert compiled.profile_tensors(torch.device("cpu"))[0] is times


def test_kernel_bounds_name_the_profile_grid(monkeypatch):
    compiled = tengine._Compiled(_fed(tmodel, PROFILES["spike"]))
    support.check_kernel_bounds(compiled, 32)
    monkeypatch.setattr(support, "KERNEL_MAX_PROFILE_GRID", 256)
    with pytest.raises(ValueError, match=re.escape("profile grid points=512 exceeds its bound 256")):
        support.check_kernel_bounds(compiled, 32)


def test_launch_bytes_count_the_tables_once():
    compiled = tengine._Compiled(_fed(tmodel, PROFILES["bench-ramp"]))
    params = {"src_rate": torch.full((3, 1), 20.0), "srv_mean": torch.full((3, 1), 0.05)}
    state = compiled.init_state(tengine.rng.split(tengine.rng.PRNGKey(0), 3), params)
    per_replica = support.replica_working_set_bytes(compiled, state)
    assert support.launch_bytes(compiled, state) == 3 * per_replica + 2 * 512 * 4 + 16


def test_constant_kind_ramp_is_the_same_in_every_replica():
    """Arrivals at the inverse integral of 1, 2, 3, ...: the ramp 2 -> 10
    over 30 s brings 180 jobs to every replica's sink."""
    m = tmodel.EnsembleModel(horizon_s=30.0)
    m.connect(PROFILES["ramp-constant-kind"](m), m.sink())
    result = tengine.run_ensemble(m, n_replicas=8, seed=2, device="cpu")
    assert result.sink_count[0] % 8 == 0
    assert math.isclose(result.sink_count[0] / 8, 180.0, abs_tol=3.0)
    assert result.engine_path == "scan" and result.server_completed == []
