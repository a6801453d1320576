"""The macro-block event-step kernel: its wrapper, its build, and its plain
torch-op version (counterpart of ``happysim_tpu/tpu/kernels/event_step.py``,
whose ``build_block_step`` reaches the Pallas kernel).

:func:`block_steps` runs every replica's macro-blocks ``first, ...,
first + n - 1`` of ``macro`` event steps in place, each replica until it
halts, and adds to each replica's count of blocks run: the JAX engine's
``replica_chunks``, one launch for a whole run. :func:`block_step` is its
one-block case and returns the per-replica halted mask. Block ``c``'s
uniforms are JAX's stream, ``uniform(fold_in(key, c), (macro, n_draws),
1e-12, 1.0)`` per replica. For CUDA tensors they launch the hand-written
kernel in ``csrc/event_step.cu`` (or raise), which draws each uniform
itself (``csrc/threefry.cuh``) where a step's branch reads it and holds
the rows a step scans in shared memory (:func:`support.stage_plan`); for
CPU tensors they run :func:`plain_block_steps` / :func:`plain_block_step`,
the engine's torch-op step applied ``macro`` times to each block drawn by
the torch-op threefry (:func:`block_uniforms`), which is also the
kernel's yardstick on the card. Lines of
servers joined by free edges ("mm1", "chain", and a source wired
straight to the sink) launch the kernel's line instantiation; every model
with a router, a limiter or a latency edge launches its graph
instantiation, which walks the topology tables in its arguments. Either
comes in an extended form, launched when a server draws from a family
beyond constant and exponential or a source follows a rate profile:
the family sampler and the profile lookup, with the profile tables
passed as device tensors and staged in shared memory. Every model with a
chaos feature (deadlines, retries, hedges, brownouts, fault schedules,
packet loss) launches the chaos instantiation, the extended graph code
plus the chaos branches, whatever its shape: a line with backoff
retries needs the transit registers, which only the graph code has.
Every model with a telemetry spec launches a telemetry instantiation:
the extended graph code, with the chaos branches where the model has
chaos, plus the windowed telemetry sites. Every model with a circuit
breaker, load shedding or a retry budget launches a resilience
instantiation: the chaos code plus the defenses' gates, with or without
the telemetry sites. Every model with network partitions or a quorum
launches a consensus instantiation: the chaos code plus the partition
consult and the quorum gate, with or without the telemetry sites and the
defenses. Every model with several sources or sinks launches an
instantiation for them, by feature set (the library's
``hs_event_step_code`` names it), each with or without the telemetry
sites: without chaos, the extended graph code;
with chaos but neither the defenses nor the consensus tier, the chaos
code without their sites; with either, the chaos code with every
feature's sites, each taken where the model has the feature. Nodes no
source reaches run on any of them. A model with a traced source runs
:func:`trace_steps`, one launch of the trace instantiations a stream
step: the extended graph code with the trace's fire and stall gate for
a single-source model without chaos, else the code for several sources
or sinks that its features pick, with the trace; its plain version is
:func:`plain_trace_steps`.
A model past one of the lean instantiations' tables in the argument
struct (:func:`support.wide_reasons`) launches the wide code instead, with
or without the trace: the code for several sources or sinks (chaos-free
for a model without chaos) with the per-server registers in device
scratch laid out in warp tiles and the model's tables in one device
buffer (:class:`_Wide`), uploaded once per model and device.
A window of the partitioned executor (:mod:`happysim_tpu_torch.partitioned`)
runs :func:`window_steps`, one launch of the partitioned instantiations:
the graph code (transit always on) in its lean, several-source and wide
forms, each lane running up to the window's event budget before the
window's end, each event's draws keyed by the lane's event count, each
delivery to a remote egress node queued in the outbox, each transit row
scanned only up to its occupancy bound (:func:`occupancy_bound`, kept
beside the state across windows, tied to its ``tr_time`` tensor and
shared with the barrier); its plain version is
:func:`plain_window_steps`, which needs no bound.

The kernel is compiled on first use with ``nvcc`` (:mod:`.build`) into
``build/`` at the repository root, one library per source
(``csrc/event_step.cu`` without telemetry or resilience,
``csrc/event_step_telemetry.cu`` with telemetry,
``csrc/event_step_resilience.cu`` with the defenses,
``csrc/event_step_consensus.cu`` with partitions or a quorum,
``csrc/event_step_multi.cu`` with several sources or sinks (three codes
by feature set),
``csrc/event_step_trace.cu`` with a traced source,
``csrc/event_step_wide.cu`` past a lean table,
``csrc/event_step_partitioned.cu`` for a window of a partitioned run),
all built at once,
each bound through a plain C launcher loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from happysim_tpu_torch import rng
from happysim_tpu_torch.kernels import build, support
from happysim_tpu_torch.kernels.build import CSRC  # noqa: F401  (the sources' directory)
from happysim_tpu_torch.model import LIMITER, REMOTE, ROUTER, SERVER, SINK

# The libraries of the event-step kernel (kernels/build.py builds them).
EVENT_STEP_STEMS = (
    "event_step", "event_step_telemetry", "event_step_resilience", "event_step_consensus",
    "event_step_multi", "event_step_trace", "event_step_wide", "event_step_partitioned",
)

# The lean instantiations' tables in the argument struct.
_MAX_NV = support.LEAN_MAX_SERVERS
_MAX_R = support.LEAN_MAX_ROUTERS
_MAX_T = support.LEAN_MAX_TARGETS
_MAX_L = support.LEAN_MAX_LIMITERS
_MAX_S = support.LEAN_MAX_SOURCES
_MAX_P = support.LEAN_MAX_PARTITIONS
_MAX_H = support.LEAN_MAX_HOPS
_MAX_RM = support.KERNEL_MAX_REMOTES
_loaded: dict = {}

# Struct fields holding state-leaf pointers, in EventStepArgs order,
# paired with the leaves they point at: the leaves of every model, then
# the chaos leaves, then (in the HsTel sub-struct) the telemetry leaves,
# then (in the HsRes sub-struct) the resilience leaves, then (in the HsCon
# sub-struct) the consensus leaves, then (in the HsTrc sub-struct) the
# trace leaves.
_BASE_FIELDS = (
    "t", "src_next", "events", "slot_done", "slot_created",
    "q_created", "q_enq", "q_head", "q_len", "started", "completed",
    "dropped", "wait_n", "busy_int", "depth_int", "wait_sum",
    "sink_count", "sink_sum", "sink_sq", "sink_hist",
    "rr_next", "lim_tokens", "lim_last", "lim_admitted", "lim_dropped",
    "tr_time", "tr_created", "tr_dropped",
)
_CHAOS_FIELDS = (
    "slot_attempt", "q_attempt", "tr_attempt",
    "flt_start", "flt_end", "flt_sh_start", "flt_sh_end",
    "timed_out", "retried", "outage_dropped",
    "fault_dropped", "fault_retried", "hedged", "hedge_wins", "net_lost",
)
_TEL_FIELDS = (
    "sink_count", "sink_sum", "sink_hist", "depth_int", "busy_int",
    "completed", "dropped", "timed_out", "retried",
    "outage_dropped", "fault_dropped", "fault_retried",
    "hedged", "hedge_wins", "tr_dropped",
    "lim_admitted", "lim_dropped", "net_lost",
)
_RES_FIELDS = (
    "brk_state", "brk_fail_t", "brk_fail_idx", "brk_open_t", "brk_probes",
    "brk_tripped", "brk_open_time", "breaker_dropped", "shed_dropped",
    "bud_tokens", "bud_last", "budget_dropped",
    "tel_breaker_dropped", "tel_brk_tripped", "tel_brk_open_int",
    "tel_shed_dropped", "tel_budget_dropped",
)
_CON_FIELDS = (
    "prt_start", "prt_end", "net_partitioned", "qrm_dropped",
    "tel_net_partitioned", "tel_qrm_dropped",
)
_TRC_FIELDS = ("cursor", "blocks", "arrivals", "tel_arrivals")
assert len(
    _BASE_FIELDS + _CHAOS_FIELDS + _TEL_FIELDS + _RES_FIELDS + _CON_FIELDS + _TRC_FIELDS
) == len(support.KERNEL_LEAVES)
# (sub-struct or None, field, leaf)
_LEAF_FIELDS = tuple(
    zip(
        (None,) * (len(_BASE_FIELDS) + len(_CHAOS_FIELDS))
        + ("tel",) * len(_TEL_FIELDS)
        + ("res",) * len(_RES_FIELDS)
        + ("con",) * len(_CON_FIELDS)
        + ("trc",) * len(_TRC_FIELDS),
        _BASE_FIELDS + _CHAOS_FIELDS + _TEL_FIELDS + _RES_FIELDS + _CON_FIELDS + _TRC_FIELDS,
        support.KERNEL_LEAVES,
    )
)

_KIND_IDS = {SINK: 0, SERVER: 1, ROUTER: 2, LIMITER: 3, REMOTE: 4}
_POLICY_IDS = {"random": 0, "round_robin": 1, "weighted": 2, "least_outstanding": 3}


class _Ref(ctypes.Structure):
    """Mirror of ``HsRef``: a downstream node and the edge leading to it."""

    _fields_ = [
        ("kind", ctypes.c_int),
        ("index", ctypes.c_int),
        ("lat_mean", ctypes.c_float),
        ("lat_kind", ctypes.c_int),
    ]


class _Loss(ctypes.Structure):
    """Mirror of ``HsLoss``: an edge's packet loss."""

    _fields_ = [(name, ctypes.c_float) for name in ("p", "start", "end")]


class _Src(ctypes.Structure):
    """Mirror of ``HsSrc``: one source's downstream edge, its loss, its
    arrivals and its profile row."""

    _fields_ = [
        ("ref", _Ref),
        ("loss", _Loss),
        ("poisson", ctypes.c_int),
        ("stop_after", ctypes.c_float),
        ("prof_row", ctypes.c_int),
        ("prof_end_rate", ctypes.c_float),
    ]


class _Con(ctypes.Structure):
    """Mirror of ``HsCon``: the consensus leaves and the groups'
    constants."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in _CON_FIELDS]
        + [(name, ctypes.c_int) for name in ("on", "nP", "Wp")]
        + [
            ("prt_member", ctypes.c_int * _MAX_P),
            ("prt_drop", ctypes.c_int * _MAX_P),
            ("prt_delay", ctypes.c_float * _MAX_P),
        ]
        + [
            (name, ctypes.c_int)
            for name in ("touched", "quorum", "qrm_member", "qrm_n", "qrm_write", "qrm_retry")
        ]
    )


class _Trc(ctypes.Structure):
    """Mirror of ``HsTrc``: the trace leaves, the two resident pages and
    the window's constants."""

    _fields_ = [
        (name, ctypes.c_void_p) for name in _TRC_FIELDS + ("t0", "g0", "t1", "g1")
    ] + [(name, ctypes.c_int) for name in ("on", "src", "base", "P", "nT", "n_chunks")]


class _Tel(ctypes.Structure):
    """Mirror of ``HsTel``: the telemetry window buffers and the grid."""

    _fields_ = [(name, ctypes.c_void_p) for name in _TEL_FIELDS] + [
        ("nW", ctypes.c_int),
        ("window_s", ctypes.c_float),
        ("inv_window_s", ctypes.c_float),
    ]


class _Res(ctypes.Structure):
    """Mirror of ``HsRes``: the resilience leaves and the defenses'
    constants."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in _RES_FIELDS]
        + [(name, ctypes.c_int) for name in ("on", "breaker", "shed", "budget", "F")]
        + [(name, ctypes.c_float) for name in ("brk_window", "brk_cooldown")]
        + [(name, ctypes.c_int) for name in ("brk_max_probes", "shed_policy", "shed_depth", "u_shed")]
        + [("shed_priority", ctypes.c_float), ("shed_busy_thr", ctypes.c_float * _MAX_NV)]
        + [(name, ctypes.c_float) for name in ("bud_ratio", "bud_min_per_s", "bud_burst")]
    )


# The wide code's tables (HsWide), in its field order: each a pointer
# into one device buffer, then its scratch.
_WIDE_TABLES = (
    "src", "srv_ref", "svc_kind", "conc", "qcap", "erlang_k",
    "hyp_p1", "hyp_f1", "hyp_f2", "ln_sigma", "par_alpha", "par_xmf",
    "srv_flags", "max_retries", "cap_slots",
    "deadline", "outage_start", "outage_end", "backoff", "jitter", "hedge", "lat_factor",
    "srv_loss", "u_route", "rt_policy", "rt_n", "rt_park", "rt_target", "rt_cum", "rt_loss",
    "lim_rate", "lim_cap", "lim_ref", "lim_loss", "shed_busy_thr",
    "prt_member", "prt_drop", "prt_delay", "touched", "qrm_member", "qrm_retry",
    "rm_latency", "rm_ingress",
)
# The wide code's scratch (HsWide), over the replicas rounded up to whole
# warps: the earliest times (nV, lanes) each and the per-server registers
# (HS_WIDE_REGS, nV, lanes), every array in warp tiles (csrc/event_step.cuh's
# wide set-up).
_WIDE_SCRATCH = ("smin", "tmin", "regs")
_WIDE_REGS = 10


class _Wide(ctypes.Structure):
    """Mirror of ``HsWide``: the wide code's tables, its scratch, the
    router tables' row length and its switch."""

    _fields_ = [(name, ctypes.c_void_p) for name in _WIDE_TABLES + _WIDE_SCRATCH] + [
        ("nT", ctypes.c_int), ("on", ctypes.c_int),
    ]


def _wide_table_type(compiled) -> type:
    """A ctypes struct of the wide code's tables sized for ``compiled``,
    with the names (and the indexing) of the argument struct's tables, so
    that :func:`_static_args` fills either; the group and quorum sets are
    (nP, nV) and (nV,) tables of 0 or 1 instead of bit masks, and the
    remote tables have a row for each remote egress node."""
    nV, nS, nR, nL = compiled.nV, compiled.nS, compiled.nR, compiled.nL
    nT = _wide_row(compiled)
    nP = compiled.partitions.nP if compiled.has_partitions else 0
    nRm = len(getattr(compiled.model, "remotes", ()))
    hops = max(len(compiled.U_ROUTE_HOPS), 1)
    i32, f32 = ctypes.c_int, ctypes.c_float
    fields = [("src", _Src * nS), ("srv_ref", _Ref * nV)]
    fields += [(name, i32 * nV) for name in ("svc_kind", "conc", "qcap", "erlang_k")]
    fields += [
        (name, f32 * nV)
        for name in ("hyp_p1", "hyp_f1", "hyp_f2", "ln_sigma", "par_alpha", "par_xmf")
    ]
    fields += [(name, i32 * nV) for name in ("srv_flags", "max_retries", "cap_slots")]
    fields += [
        (name, f32 * nV)
        for name in ("deadline", "outage_start", "outage_end", "backoff", "jitter", "hedge",
                     "lat_factor")
    ]
    fields += [("srv_loss", _Loss * nV), ("u_route", i32 * hops)]
    fields += [(name, i32 * nR) for name in ("rt_policy", "rt_n", "rt_park")]
    fields += [
        ("rt_target", (_Ref * nT) * nR), ("rt_cum", (f32 * nT) * nR),
        ("rt_loss", (_Loss * nT) * nR),
        ("lim_rate", f32 * nL), ("lim_cap", f32 * nL), ("lim_ref", _Ref * nL),
        ("lim_loss", _Loss * nL), ("shed_busy_thr", f32 * nV),
        ("prt_member", (i32 * nV) * nP), ("prt_drop", i32 * nP), ("prt_delay", f32 * nP),
    ]
    fields += [(name, i32 * nV) for name in ("touched", "qrm_member", "qrm_retry")]
    fields += [("rm_latency", f32 * nRm), ("rm_ingress", i32 * nRm)]
    assert tuple(name for name, _ in fields) == _WIDE_TABLES
    return type("_WideTables", (ctypes.Structure,), {"_fields_": fields})


def _wide_row(compiled) -> int:
    """The row length of the wide code's router tables: the most targets
    of any router (at least 1)."""
    return max([len(r.targets) for r in compiled.model.routers] + [1])


# The partitioned executor's leaves, in HsPrt's order.
_PRT_FIELDS = (
    ("ob_arrival", "ob_arrival"), ("ob_created", "ob_created"), ("ob_ingress", "ob_ingress"),
    ("ob_len", "ob_len"), ("ob_sent", "ob_sent"), ("ob_dropped", "ob_dropped"),
    ("truncated", "truncated_windows"),
)


class _BarrierArgs(ctypes.Structure):
    """Mirror of ``BarrierArgs`` in csrc/partition_barrier.cuh: the window
    barrier's arguments (kernels/partition_barrier.py), which a window
    launch also carries when the previous window's barrier is folded into
    it (``_Prt.bar``)."""

    _fields_ = (
        [
            (name, ctypes.c_void_p)
            for name in (
                "t", "depth_int", "q_len", "tr_time", "tr_created", "tr_attempt", "tr_dropped",
                "tr_hi", "ob_arrival", "ob_created", "ob_ingress", "ob_len",
                "in_arrival", "in_created", "in_ingress", "in_len",
            )
        ]
        + [(name, ctypes.c_int) for name in ("P", "R", "nV", "TR", "OB")]
        + [(name, ctypes.c_float) for name in ("window_end", "warmup")]
    )


class _Prt(ctypes.Structure):
    """Mirror of ``HsPrt``: the outbox leaves, the truncated-window
    counter, the transit rows' occupancy bounds, the window's end and
    budget, the remotes' tables, and the folded barrier."""

    _fields_ = [(field, ctypes.c_void_p) for field, _leaf in _PRT_FIELDS] + [
        ("tr_hi", ctypes.c_void_p),
        ("on", ctypes.c_int), ("OB", ctypes.c_int), ("budget", ctypes.c_int),
        ("limit", ctypes.c_float), ("nRm", ctypes.c_int),
        ("rm_latency", ctypes.c_float * _MAX_RM), ("rm_ingress", ctypes.c_int * _MAX_RM),
        ("fold", ctypes.c_int), ("bar", _BarrierArgs),
    ]


class _Stage(ctypes.Structure):
    """Mirror of ``HsStage``: each staged leaf's word offset in a lane's
    column of the shared tile (-1: in device memory), and the column's
    words."""

    _fields_ = [("off", ctypes.c_int * len(support.STAGE_LEAVES)), ("words", ctypes.c_int)]


class _Args(ctypes.Structure):
    """Mirror of ``EventStepArgs`` in csrc/event_step.cuh."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in _BASE_FIELDS]
        + [
            (name, ctypes.c_void_p)
            for name in ("halted", "keys", "draws", "blocks", "src_rate", "srv_mean")
        ]
        + [(name, ctypes.c_int) for name in ("R", "nV", "C", "K", "macro", "n_draws")]
        + [("block", ctypes.c_uint), ("n_blocks", ctypes.c_int)]
        + [(name, ctypes.c_int) for name in ("nS", "nK")]
        + [
            (name, ctypes.c_int)
            for name in ("svc_fused", "degrade_lat", "hedge_any", "u_gap", "u_svc1", "u_svc2")
        ]
        + [(name, ctypes.c_float) for name in ("horizon", "warmup")]
        + [(name, ctypes.c_int * _MAX_NV) for name in ("svc_kind", "conc", "qcap")]
        + [("src", _Src * _MAX_S), ("srv_ref", _Ref * _MAX_NV)]
        + [
            (name, ctypes.c_int)
            for name in ("graph", "nR", "nL", "TR", "u_lat", "n_route_slots", "max_walk")
        ]
        + [
            ("u_route", ctypes.c_int * _MAX_H),
            ("rt_policy", ctypes.c_int * _MAX_R),
            ("rt_n", ctypes.c_int * _MAX_R),
            ("rt_park", ctypes.c_int * _MAX_R),
            ("rt_target", (_Ref * _MAX_T) * _MAX_R),
            ("rt_cum", (ctypes.c_float * _MAX_T) * _MAX_R),
            ("lim_rate", ctypes.c_float * _MAX_L),
            ("lim_cap", ctypes.c_float * _MAX_L),
            ("lim_ref", _Ref * _MAX_L),
        ]
        + [(name, ctypes.c_int) for name in ("ext", "has_profile", "prof_n")]
        + [(name, ctypes.c_void_p) for name in ("prof_times", "prof_cum")]
        + [("erlang_k", ctypes.c_int * _MAX_NV)]
        + [
            (name, ctypes.c_float * _MAX_NV)
            for name in (
                "hyp_p1", "hyp_f1", "hyp_f2", "ln_sigma", "par_alpha", "par_xmf"
            )
        ]
        + [("chaos", ctypes.c_int)]
        + [(name, ctypes.c_void_p) for name in _CHAOS_FIELDS]
        + [
            (name, ctypes.c_int)
            for name in ("W", "W_sh", "u_hed1", "u_hed2", "u_loss", "u_jit")
        ]
        + [(name, ctypes.c_int * _MAX_NV) for name in ("srv_flags", "max_retries", "cap_slots")]
        + [
            (name, ctypes.c_float * _MAX_NV)
            for name in (
                "deadline", "outage_start", "outage_end", "backoff", "jitter",
                "hedge", "lat_factor",
            )
        ]
        + [
            ("srv_loss", _Loss * _MAX_NV),
            ("lim_loss", _Loss * _MAX_L),
            ("rt_loss", (_Loss * _MAX_T) * _MAX_R),
        ]
        + [("tel", _Tel)]
        + [("res", _Res)]
        + [("con", _Con)]
        + [("trc", _Trc)]
        + [("wide", _Wide)]
        + [("stage", _Stage)]
        + [("prt", _Prt)]
    )


# Per-server chaos flags (HS_F_* in csrc/event_step.cuh).
_F_FAULTED, _F_DROP, _F_SHARED, _F_FAULT_RETRY = 1, 2, 4, 8
_F_BACKOFF, _F_HEDGE, _F_OUTAGE, _F_DEADLINE = 16, 32, 64, 128


def load_library() -> dict:
    """Build (first use) and load the kernel libraries, once per process;
    returns ``{source stem: ctypes library}`` of the event-step ones."""
    if "libs" not in _loaded:
        libs = {}
        for stem, lib in build.libraries().items():
            if stem not in EVENT_STEP_STEMS:
                continue
            lib.hs_event_step.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
            lib.hs_event_step.restype = ctypes.c_int
            if stem in _CODED:
                lib.hs_event_step_code.argtypes = [ctypes.POINTER(_Args)]
                lib.hs_event_step_code.restype = ctypes.c_char_p
            for probe in (
                "hs_event_step_max_servers", "hs_event_step_max_sources",
                "hs_event_step_max_profile_grid", "hs_event_step_args_size",
                "hs_event_step_threads", "hs_event_step_max_remotes",
            ):
                getattr(lib, probe).argtypes = []
                getattr(lib, probe).restype = ctypes.c_int
            if lib.hs_event_step_max_servers() != _MAX_NV:
                raise RuntimeError(f"{stem} library and wrapper disagree on the server bound")
            if lib.hs_event_step_max_sources() != _MAX_S:
                raise RuntimeError(f"{stem} library and wrapper disagree on the source bound")
            if lib.hs_event_step_max_profile_grid() != support.KERNEL_MAX_PROFILE_GRID:
                raise RuntimeError(f"{stem} library and wrapper disagree on the profile grid bound")
            if lib.hs_event_step_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError(f"{stem} library and wrapper disagree on the argument layout")
            if lib.hs_event_step_threads() != support.KERNEL_THREADS:
                raise RuntimeError(f"{stem} library and wrapper disagree on the block size")
            if lib.hs_event_step_max_remotes() != _MAX_RM:
                raise RuntimeError(f"{stem} library and wrapper disagree on the remote bound")
            libs[stem] = lib
        _loaded["libs"] = libs
    return _loaded["libs"]


def _ref(ref, edge) -> _Ref:
    lat_kind = 0 if edge.mean_s <= 0 else (2 if edge.kind == "exponential" else 1)
    return _Ref(_KIND_IDS[ref.kind], ref.index, float(np.float32(edge.mean_s)), lat_kind)


def _slot(value) -> int:
    return -1 if value is None else int(value)


def _loss(edge) -> _Loss:
    return _Loss(*(float(np.float32(x)) for x in (edge.loss_p, edge.loss_start_s, edge.loss_end_s)))


def _chaos_args(compiled, args: _Args, tab) -> None:
    """The chaos code's per-server constants, flags, draw slots and loss
    tables (the tables into ``tab``: the arguments, or the wide code's
    tables), and its switch: set where the model has chaos (a model with
    several sources or sinks, or past a lean table, takes its constants
    either way, and the chaos-free code where the switch is unset)."""
    model, faults = compiled.model, compiled.faults
    args.chaos = int(compiled.has_chaos)
    args.W, args.W_sh = faults.W, faults.W_sh
    args.u_hed1, args.u_hed2 = _slot(compiled.U_HED1), _slot(compiled.U_HED2)
    args.u_loss, args.u_jit = _slot(compiled.U_LOSS), _slot(compiled.U_JIT)
    for v, spec in enumerate(model.servers):
        flags = 0
        if faults.faulted[v]:
            flags |= _F_FAULTED | (_F_DROP if faults.drop_mode[v] else 0)
            flags |= _F_SHARED if faults.has_shared and faults.participates[v] else 0
        flags |= _F_FAULT_RETRY if compiled.flt_can_retry[v] else 0
        flags |= _F_BACKOFF if spec.retry_backoff_s is not None else 0
        flags |= _F_HEDGE if spec.hedge_delay_s is not None else 0
        flags |= _F_OUTAGE if spec.outage_start_s is not None else 0
        flags |= _F_DEADLINE if spec.deadline_s is not None else 0
        tab.srv_flags[v] = flags
        tab.max_retries[v] = int(compiled.srv_max_retries[v])
        tab.cap_slots[v] = int(faults.cap_slots[v])
        for name, table in (
            ("deadline", compiled.srv_deadline), ("outage_start", compiled.srv_outage_start),
            ("outage_end", compiled.srv_outage_end), ("backoff", compiled.srv_backoff),
            ("jitter", compiled.srv_jitter), ("hedge", compiled.srv_hedge),
            ("lat_factor", faults.lat_factor),
        ):
            getattr(tab, name)[v] = float(table[v])
        tab.srv_loss[v] = _loss(spec.latency)
    for i, source in enumerate(model.sources):
        tab.src[i].loss = _loss(source.latency)
    for l, limiter in enumerate(model.limiters):
        tab.lim_loss[l] = _loss(limiter.latency)
    for r, router in enumerate(model.routers):
        for i, edge in enumerate(router.target_latencies):
            tab.rt_loss[r][i] = _loss(edge)


def _static_args(compiled) -> _Args:
    """The launch arguments that depend only on the model: sizes, draw
    slots, per-server constants and the topology tables (the wide code's
    tables are :func:`_model_args`'s)."""
    return _model_args(compiled)[0]


def _model_args(compiled) -> tuple:
    """:func:`_static_args` and the wide code's tables: ``(args,
    tables)``, ``tables`` None for a model the lean instantiations run
    (its tables sit in ``args``), else a :func:`_wide_table_type`
    struct, uploaded per device by :func:`launch_args`."""
    model = compiled.model
    args = _Args()
    wide = bool(support.wide_reasons(compiled))
    tables = _wide_table_type(compiled)() if wide else None
    tab = tables if wide else args
    args.nV, args.C, args.K, args.n_draws = compiled.nV, compiled.C, compiled.K, compiled.n_draws
    args.nS, args.nK = compiled.nS, compiled.nK
    # Where the JAX step's t + x * y is one multiply-add (engine._fused).
    args.svc_fused = int(len(compiled.families_present) == 1)
    args.degrade_lat = int(compiled.has_faults and compiled.faults.has_degrade_lat)
    args.hedge_any = int(compiled.has_hedge)
    args.u_gap, args.u_svc1, args.u_svc2 = (
        _slot(compiled.U_GAP), _slot(compiled.U_SVC1), _slot(compiled.U_SVC2)
    )
    args.horizon = compiled.horizon
    args.warmup = compiled.warmup
    for v in range(compiled.nV):
        tab.svc_kind[v] = int(compiled.service_kind[v])
        tab.conc[v] = int(compiled.srv_concurrency[v])
        tab.qcap[v] = int(compiled.queue_cap[v])
    # Each source's edge and arrivals; a profiled one's row of the tables
    # a thread block stages, in source order.
    rows = np.cumsum(compiled.has_profile) - 1
    for i, source in enumerate(model.sources):
        src = tab.src[i]
        src.ref = _ref(source.downstream, source.latency)
        src.poisson = int(compiled.arrival_is_poisson[i])
        src.stop_after = float(compiled.stop_after[i])
        src.prof_row = int(rows[i]) if compiled.has_profile[i] else -1
        src.prof_end_rate = float(compiled.profile_end_rate[i])
    for v, spec in enumerate(model.servers):
        tab.srv_ref[v] = _ref(spec.downstream, spec.latency)
    # The line instantiation follows free edges to a server or the sink;
    # anything else walks the tables below.
    args.graph = int(
        bool(model.routers or model.limiters)
        or any(edge.mean_s > 0 for edge, _dest in compiled._edges())
    )
    args.nR, args.nL = compiled.nR, compiled.nL
    args.TR = compiled.TR if compiled.has_transit else 0
    args.u_lat = _slot(compiled.U_LAT)
    args.n_route_slots = len(compiled.U_ROUTE_HOPS)
    for depth, slot in enumerate(compiled.U_ROUTE_HOPS):
        tab.u_route[depth] = slot
    # At most one limiter (limiters never chain) and hop_depth routers
    # per delivery, then its end.
    args.max_walk = len(model.limiters) + compiled.hop_depth + 1
    for r, router in enumerate(model.routers):
        tab.rt_policy[r] = _POLICY_IDS[router.policy]
        tab.rt_n[r] = len(router.targets)
        tab.rt_park[r] = int(any(e.mean_s > 0 for e in router.target_latencies))
        for i, (target, edge) in enumerate(zip(router.targets, router.target_latencies)):
            tab.rt_target[r][i] = _ref(target, edge)
        if router.policy == "weighted":
            # Formed in float64 and cast once, as the JAX engine does.
            weights = np.asarray(router.weights, np.float64)
            cum = (np.cumsum(weights) / weights.sum()).astype(np.float32)
            for i, value in enumerate(cum):
                tab.rt_cum[r][i] = float(value)
    for l, limiter in enumerate(model.limiters):
        tab.lim_rate[l] = float(compiled.lim_rate[l])
        tab.lim_cap[l] = float(compiled.lim_cap[l])
        tab.lim_ref[l] = _ref(limiter.downstream, limiter.latency)
    # The extended instantiation: the family constants per server, and the
    # profiled sources' count and grid size (the tables' pointers are set
    # per device in launch_args).
    args.has_profile = int(compiled.has_profile.sum())
    args.ext = int(bool(args.has_profile) or max(compiled.families_present) > 1)
    args.prof_n = compiled.profile_times.shape[1] if args.has_profile else 0
    for v in range(compiled.nV):
        tab.erlang_k[v] = int(compiled.srv_erlang_k[v])
        tab.hyp_p1[v] = float(compiled.srv_hyp_p1[v])
        tab.hyp_f1[v] = float(compiled.srv_hyp_f1[v])
        tab.hyp_f2[v] = float(compiled.srv_hyp_f2[v])
        tab.ln_sigma[v] = float(compiled.srv_ln_sigma[v])
        tab.par_alpha[v] = float(compiled.srv_par_alpha[v])
        tab.par_xmf[v] = float(compiled.srv_par_xmf[v])
    if compiled.has_chaos or _multi_code(compiled):
        # The chaos instantiation is the extended graph code plus the
        # chaos branches, whatever the model's shape; the code for several
        # sources or sinks and the wide code are the extended graph code,
        # with the chaos branches where the model has chaos.
        args.graph = args.ext = 1
        _chaos_args(compiled, args, tab)
    if compiled.has_telemetry:
        # So are the telemetry instantiations, with or without chaos.
        args.graph = args.ext = 1
        args.tel.nW = compiled.nW
        args.tel.window_s = float(np.float32(compiled.telemetry.window_s))
        args.tel.inv_window_s = float(compiled.tel_inv_window)
    if compiled.has_resilience:
        _res_args(compiled, args.res, tables)
    if compiled.has_partitions or compiled.has_quorum:
        _con_args(compiled, args.con, tables)
    if compiled.has_trace:
        # The trace instantiations are the extended graph code too; the
        # pages, their base and the budget are set per launch.
        args.graph = args.ext = 1
        args.trc.on = 1
        args.trc.src = compiled.trace_src
        args.trc.P = compiled.trace_chunk_len
        args.trc.nT = compiled.n_tenants
    if wide:
        args.wide.on = 1
        args.wide.nT = _wide_row(compiled)
    if getattr(compiled, "OB", 0):
        _prt_args(compiled, args.prt, tables)
        # A window runs the graph code: remote arrivals land in the
        # transit registers.
        args.graph = 1
    return args, tables


def _prt_args(compiled, prt: _Prt, tables=None) -> None:
    """The partitioned instantiation's switch, outbox size and remote
    tables (the window's end and budget are set per launch): in ``prt``,
    or, for the wide code (past the lean table of
    :data:`support.KERNEL_MAX_REMOTES` remotes among others), in its
    ``tables``."""
    remotes = compiled.model.remotes
    prt.on = 1
    prt.OB = compiled.OB
    prt.nRm = len(remotes)
    tab = prt if tables is None else tables
    for i in range(len(remotes)):
        tab.rm_latency[i] = float(compiled.remote_latency[i])
        tab.rm_ingress[i] = int(compiled.remote_ingress[i])


def _several(compiled) -> bool:
    """Whether the model has several sources or sinks (the MULTI
    instantiation's models)."""
    return compiled.nS > 1 or compiled.nK > 1


def _multi_code(compiled) -> bool:
    """Whether the model runs the MULTI code: several sources or sinks, or
    past a lean table (the wide code is the MULTI code)."""
    return _several(compiled) or bool(support.wide_reasons(compiled))


def _mask(flags) -> int:
    """A bit mask over the servers: bit v set where ``flags[v]``."""
    return sum(1 << v for v, on in enumerate(flags) if on)


def _con_args(compiled, con: _Con, tables=None) -> None:
    """The consensus instantiation's switches and the groups' constants
    (partition groups and a quorum ride the chaos code: has_chaos holds
    for every such model): bit masks over the servers in ``con``, or, for
    the wide code, rows of 0 or 1 in its ``tables``."""
    con.on = 1
    table = compiled.partitions
    con.nP, con.Wp = table.nP, table.Wp
    tab = con if tables is None else tables
    for p in range(table.nP):
        if tables is None:
            con.prt_member[p] = _mask(table.member[p])
        else:
            for v, on in enumerate(table.member[p]):
                tables.prt_member[p][v] = int(bool(on))
        tab.prt_drop[p] = int(table.drop_mode[p])
        tab.prt_delay[p] = float(table.delay_s[p])
    sets = {"touched": table.touched if compiled.has_partitions else ()}
    if compiled.has_quorum:
        con.quorum = 1
        con.qrm_n = len(compiled.quorum.group)
        con.qrm_write = compiled.qrm_write
        sets.update(qrm_member=compiled.qrm_member, qrm_retry=compiled.qrm_can_retry)
    for name, flags in sets.items():
        if tables is None:
            setattr(con, name, _mask(flags))
        else:
            for v, on in enumerate(flags):
                getattr(tables, name)[v] = int(bool(on))


def _res_args(compiled, res: _Res, tables=None) -> None:
    """The resilience instantiation's switches and constants (the
    defenses ride the chaos code: has_chaos holds for every such model)."""
    res.on = 1
    res.breaker, res.shed, res.budget = (
        int(compiled.has_breaker), int(compiled.has_shed), int(compiled.has_budget)
    )
    if compiled.has_breaker:
        breaker = compiled.breaker
        res.F = compiled.brk_F
        res.brk_window = float(np.float32(breaker.window_s))
        res.brk_cooldown = float(np.float32(breaker.cooldown_s))
        res.brk_max_probes = int(breaker.half_open_probes)
    if compiled.has_shed:
        res.shed_policy = int(compiled.shed.policy == "utilization")
        res.shed_depth = int(compiled.shed.threshold)
        res.shed_priority = float(np.float32(compiled.shed.priority_fraction))
        res.u_shed = _slot(compiled.U_SHED)
        for v in range(compiled.nV):
            (res if tables is None else tables).shed_busy_thr[v] = float(
                compiled.shed_busy_thr[v]
            )
    if compiled.has_budget:
        budget = compiled.budget
        res.bud_ratio = float(np.float32(budget.ratio))
        res.bud_min_per_s = float(np.float32(budget.min_per_s))
        res.bud_burst = float(np.float32(budget.burst))


class _Checked:
    """A compiled model's last checked launch layout: the replica count,
    block length and device it was checked for, weak references to the
    state and parameter tensors it was checked on, and the argument
    struct holding their pointers."""

    __slots__ = ("key", "refs", "args", "scratch")

    def __init__(self, key: tuple, bound: list, args: _Args, scratch=None):
        self.key = key
        self.refs = tuple(None if x is None else weakref.ref(x) for x in bound)
        self.args = args
        self.scratch = scratch  # the wide code's scratch, kept alive

    def holds(self, key: tuple, bound: list) -> bool:
        return key == self.key and all(
            x is None if ref is None else ref() is x for ref, x in zip(self.refs, bound)
        )


# compiled model -> [its static argument struct, the wide code's tables or
# None, {device: the tables uploaded there}, {(device, the state's first
# leaf's address): the last _Checked of that state}] (one entry a shard
# of a replica mesh)
_LAYOUTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


# The states a compiled model keeps checked layouts of (a mesh's shards).
_CHECKED_STATES = 64


def _bound_tensors(state: dict, params: dict) -> list:
    """The tensors the struct points at besides the keys, the draw count
    and halted, in field order (None for a leaf the model has not got)."""
    return [state.get(leaf) for _holder, _field, leaf in _LEAF_FIELDS] + [
        params.get("src_rate"),
        params.get("srv_mean"),
    ]


def launch_args(
    compiled, state: dict, keys: torch.Tensor, block: int, params: dict,
    halted: torch.Tensor, draws=None, n_blocks: int = 1, blocks=None,
) -> _Args:
    """The kernel's argument struct for one launch, after checking the
    device, dtype, shape and contiguity of every tensor it points at, and
    the launch bounds; raises on any mismatch. ``keys`` are the ``(R, 2)``
    uint32 replica keys; the launch runs blocks ``block, ..., block +
    n_blocks - 1``, each keyed by its absolute index. ``draws``, an
    optional ``(R,)`` int32 tensor, receives each lane's threefry
    evaluations; ``blocks``, an optional ``(R,)`` int32 tensor, has the
    blocks each lane ran added to it. The state and parameter tensors,
    and the staging plan (:func:`_stage`), are checked and made once: a
    call with the very same tensor objects, replica count and device as
    the last checked call reuses that call's pointers and plan, and only
    the keys and the per-call tensors are checked again (a layout is kept
    for each state, as for each shard of a replica mesh)."""
    device = state["t"].device
    R, macro = state["t"].shape[0], compiled.macro
    layout = _LAYOUTS.get(compiled)
    if layout is None:
        layout = _LAYOUTS[compiled] = [*_model_args(compiled), {}, {}]
    key = (R, macro, device)
    bound = _bound_tensors(state, params)
    slot = (str(device), state["t"].data_ptr())
    checked = layout[3].get(slot)
    if checked is None or not checked.holds(key, bound):
        support.check_kernel_bounds(compiled, macro)
        tensors = {**state, **params}
        expected = _expected_shapes(compiled, R)
        for name, shape in expected.items():
            if name not in tensors:
                raise ValueError(f"event-step kernel: {name} is missing")
            _check(name, tensors[name], shape, device)
        args = _Args.from_buffer_copy(layout[0])
        for (holder, field, leaf), x in zip(_LEAF_FIELDS, bound):
            if leaf in expected:
                setattr(getattr(args, holder) if holder else args, field, x.data_ptr())
        args.src_rate = params["src_rate"].data_ptr()
        args.srv_mean = params["srv_mean"].data_ptr()
        if args.has_profile:
            # Kept alive by the compiled model, one copy per device.
            times, cum = compiled.profile_tensors(device)
            args.prof_times, args.prof_cum = times.data_ptr(), cum.data_ptr()
        args.R, args.macro = R, macro
        args.stage = _stage(expected, args, R, device)
        scratch = None
        if args.wide.on:
            lanes = -(-R // 32) * 32  # whole warps
            scratch = torch.empty(
                (2 + _WIDE_REGS, compiled.nV, lanes), dtype=torch.float32, device=device
            )
            _wide_pointers(args.wide, layout[1], layout[2], device, scratch)
        if len(layout[3]) >= _CHECKED_STATES:
            layout[3].clear()
        checked = layout[3][slot] = _Checked(key, bound, args, scratch)
    _check_keys(keys, R, device)
    if int(n_blocks) < 1:
        raise ValueError(f"event-step kernel: {n_blocks} blocks to run")
    if not 0 <= int(block) <= (1 << 32) - int(n_blocks):
        raise ValueError(
            f"event-step kernel: blocks {block}..{int(block) + int(n_blocks) - 1} are not uint32 indices"
        )
    args = _Args.from_buffer_copy(checked.args)
    args.keys = keys.data_ptr()
    args.block, args.n_blocks = int(block), int(n_blocks)
    if draws is not None:
        _check("draws", draws, (R,), device)
        args.draws = draws.data_ptr()
    if blocks is not None:
        _check("blocks", blocks, (R,), device)
        args.blocks = blocks.data_ptr()
    args.halted = halted.data_ptr()
    return args


def _wide_pointers(wide: _Wide, tables, uploaded: dict, device, scratch: torch.Tensor) -> None:
    """Point the wide code's tables into their device buffer (uploaded
    once per device and kept in ``uploaded``) and its scratch into
    ``scratch``: the earliest times, then the registers."""
    key = str(device)
    if key not in uploaded:
        raw = torch.frombuffer(bytearray(bytes(tables)), dtype=torch.uint8)
        uploaded[key] = raw.to(device)
    base = uploaded[key].data_ptr()
    table_type = type(tables)
    for name in _WIDE_TABLES:
        setattr(wide, name, base + getattr(table_type, name).offset)
    wide.smin, wide.tmin, wide.regs = (scratch[i].data_ptr() for i in range(3))


def _stage(expected: dict, args: _Args, R: int, device) -> _Stage:
    """The launch's staging plan: the leaves of :data:`support.STAGE_LEAVES`
    the model has, sized per replica from their checked shapes, within the
    per-lane budget that keeps a launch over ``R`` replicas one wave on
    ``device`` (on the CPU, for the card the kernels are built for), after
    the profile tables."""
    sms = (
        torch.cuda.get_device_properties(device).multi_processor_count
        if device.type == "cuda"
        else support.CARD_SMS
    )
    table_bytes = 2 * args.prof_n * 4 * args.has_profile
    rows = {
        leaf: int(np.prod(expected[leaf][1:]))
        for leaf in support.STAGE_LEAVES
        if leaf in expected
    }
    if window_cached(args):
        rows.update(tenant_pairs=args.trc.nT, hist_pairs=80)
    offsets, words = support.stage_plan(rows, support.stage_budget(R, table_bytes, sms=sms))
    return _Stage((ctypes.c_int * len(offsets))(*offsets), words)


def window_cached(args: _Args) -> bool:
    """Whether a launch takes the trace branch's lean code with the
    telemetry sites, which caches its telemetry window (csrc/event_step.cuh's
    WC): one traced source, one sink, no chaos, a spec, a lean table."""
    return bool(args.trc.on and not args.chaos and args.nS == 1 and args.nK == 1 and args.tel.nW
                and not args.wide.on and not args.prt.on)


def _check_keys(keys: torch.Tensor, R: int, device) -> None:
    if keys.device != device:
        raise ValueError(f"event-step kernel: keys are on {keys.device}, not {device}")
    if keys.dtype != torch.uint32:
        raise ValueError(f"event-step kernel: keys are {keys.dtype}, expected torch.uint32")
    if tuple(keys.shape) != (R, 2):
        raise ValueError(f"event-step kernel: keys have shape {tuple(keys.shape)}, expected {(R, 2)}")
    if not keys.is_contiguous():
        raise ValueError("event-step kernel: keys are not contiguous")


def _expected_shapes(compiled, R: int) -> dict:
    nS, nV, C, K, nK = compiled.nS, compiled.nV, compiled.C, compiled.K, compiled.nK
    per_server = (R, nV)
    shapes = {
        "t": (R,), "src_next": (R, nS), "events": (R,),
        "srv_slot_done": (R, nV, C), "srv_slot_created": (R, nV, C),
        "srv_q_created": (R, nV, K), "srv_q_enq": (R, nV, K),
        "srv_q_head": per_server, "srv_q_len": per_server,
        "srv_started": per_server, "srv_completed": per_server,
        "srv_dropped": per_server, "srv_wait_n": per_server,
        "srv_busy_int": per_server, "srv_depth_int": per_server,
        "srv_wait_sum": per_server,
        "sink_count": (R, nK), "sink_sum": (R, nK), "sink_sq": (R, nK),
        "sink_hist": (R, nK, 80),
        "rr_next": (R, compiled.nR),
        "lim_tokens": (R, compiled.nL), "lim_last": (R, compiled.nL),
        "lim_admitted": (R, compiled.nL), "lim_dropped": (R, compiled.nL),
        "src_rate": (R, nS), "srv_mean": (R, nV),
    }
    if compiled.has_transit:
        shapes.update({
            "tr_time": (R, nV, compiled.TR), "tr_created": (R, nV, compiled.TR),
            "tr_dropped": per_server,
        })
        if compiled.has_backoff:
            shapes["tr_attempt"] = (R, nV, compiled.TR)
    nW, nL = compiled.nW, compiled.nL
    tel_shapes = {
        "tel_sink_count": (R, nW, nK), "tel_sink_sum": (R, nW, nK),
        "tel_sink_hist": (R, nW, nK, 80),
        "tel_lim_admitted": (R, nW, nL), "tel_lim_dropped": (R, nW, nL),
        "tel_net_lost": (R, nW), "tel_net_partitioned": (R, nW),
        "tel_trc_arrivals": (R, nW, compiled.n_tenants),
    }
    if compiled.has_trace:
        shapes.update({
            "trc_cursor": (R,), "trc_blocks": (R,), "trc_arrivals": (R, compiled.n_tenants),
        })
    for key in compiled.tel_keys:
        shapes[key] = tel_shapes.get(key, (R, nW, nV))
    if not (compiled.has_chaos or _multi_code(compiled)):
        return shapes
    shapes.update({"srv_timed_out": per_server, "srv_retried": per_server,
                   "srv_outage_dropped": per_server})
    if compiled.has_attempts:
        shapes.update({"srv_slot_attempt": (R, nV, C), "srv_q_attempt": (R, nV, K)})
    faults = compiled.faults
    if compiled.has_faults:
        shapes.update({
            "flt_start": (R, nV, faults.W), "flt_end": (R, nV, faults.W),
            "srv_fault_dropped": per_server,
        })
        if faults.has_shared:
            shapes.update({"flt_sh_start": (R, faults.W_sh), "flt_sh_end": (R, faults.W_sh)})
    if compiled.has_fault_retries:
        shapes["srv_fault_retried"] = per_server
    if compiled.has_hedge:
        shapes.update({"srv_hedged": per_server, "srv_hedge_wins": per_server})
    if compiled.has_loss:
        shapes["net_lost"] = (R,)
    if compiled.has_breaker:
        for key in ("brk_state", "brk_fail_idx", "brk_open_t", "brk_probes", "brk_tripped",
                    "brk_open_time", "srv_breaker_dropped"):
            shapes[key] = per_server
        shapes["brk_fail_t"] = (R, nV, compiled.brk_F)
    if compiled.has_shed:
        shapes["srv_shed_dropped"] = per_server
    if compiled.has_budget:
        shapes.update({"bud_tokens": per_server, "bud_last": per_server,
                       "srv_budget_dropped": per_server})
    if compiled.has_partitions:
        windows = (R, compiled.partitions.nP, compiled.partitions.Wp)
        shapes.update({"prt_start": windows, "prt_end": windows, "net_partitioned": (R,)})
    if compiled.has_quorum:
        shapes["qrm_dropped"] = per_server
    return shapes


_TEL_FLOAT_LEAVES = ("tel_sink_sum", "tel_srv_depth_int", "tel_srv_busy_int")
_INT_LEAVES = frozenset({
    "draws", "blocks", "events", "srv_q_head", "srv_q_len", "srv_started", "srv_completed",
    "srv_dropped", "srv_wait_n", "sink_count", "sink_hist",
    "rr_next", "lim_admitted", "lim_dropped", "tr_dropped",
    "srv_slot_attempt", "srv_q_attempt", "tr_attempt",
    "srv_timed_out", "srv_retried", "srv_outage_dropped", "srv_fault_dropped",
    "srv_fault_retried", "srv_hedged", "srv_hedge_wins", "net_lost",
    *(k for k in support.TEL_LEAVES if k not in _TEL_FLOAT_LEAVES),
    "brk_state", "brk_fail_idx", "brk_probes", "brk_tripped", "srv_breaker_dropped",
    "srv_shed_dropped", "srv_budget_dropped",
    "tel_srv_breaker_dropped", "tel_brk_tripped", "tel_srv_shed_dropped",
    "tel_srv_budget_dropped",
    "net_partitioned", "qrm_dropped", "tel_net_partitioned", "tel_qrm_dropped",
    "trc_blocks", "trc_arrivals", "tel_trc_arrivals", "trace tenants",
    "ob_ingress", "ob_len", "ob_sent", "ob_dropped", "truncated_windows", "tr_hi",
})
_UINT_LEAVES = frozenset({"trc_cursor"})


def _check(name: str, tensor: torch.Tensor, shape: tuple, device) -> None:
    if name in _UINT_LEAVES:
        dtype = torch.uint32
    else:
        dtype = torch.int32 if name in _INT_LEAVES else torch.float32
    if tensor.device != device:
        raise ValueError(f"event-step kernel: {name} is on {tensor.device}, not {device}")
    if tensor.dtype != dtype:
        raise ValueError(f"event-step kernel: {name} is {tensor.dtype}, expected {dtype}")
    if tuple(tensor.shape) != shape:
        raise ValueError(
            f"event-step kernel: {name} has shape {tuple(tensor.shape)}, expected {shape}"
        )
    if not tensor.is_contiguous():
        raise ValueError(f"event-step kernel: {name} is not contiguous")


def block_uniforms(compiled, keys: torch.Tensor, block: int) -> torch.Tensor:
    """The block's ``(R, macro, n_draws)`` uniforms as the torch-op
    threefry draws them: ``uniform(fold_in(key, block), (macro, n_draws),
    1e-12, 1.0)`` per replica (the JAX engine's stream)."""
    return rng.uniform(
        rng.fold_in(keys, block), (compiled.macro, compiled.n_draws), minval=1e-12, maxval=1.0
    )


def plain_block_step(compiled, state: dict, U: torch.Tensor, params: dict) -> torch.Tensor:
    """The plain torch-op version: ``compiled``'s one-event step applied
    ``U.shape[1]`` times with the block's uniforms ``U`` (from
    :func:`block_uniforms`), updating ``state`` in place. Returns the
    ``(R,)`` bool halted mask. A traced model's blocks read trace pages:
    they run :func:`plain_trace_steps`, and this raises."""
    _refuse_trace(compiled)
    step = compiled.make_step()
    for k in range(U.shape[1]):
        step(state, params, U[:, k, :])
    return compiled.replica_halted(state)


def plain_block_steps(
    compiled, state: dict, keys: torch.Tensor, first: int, n: int, params: dict,
    blocks=None,
) -> torch.Tensor:
    """The plain version of :func:`block_steps`: :func:`plain_block_step`
    on each block's torch-op draw in turn, from block ``first``, until
    ``n`` blocks ran or every replica halted (a halted replica's steps are
    no-ops); a replica adds one to ``blocks``, where given, for each block
    it was live at the start of. Returns the ``(R,)`` bool halted mask."""
    halted = compiled.replica_halted(state)
    for c in range(n):
        if bool(halted.all()):
            break
        if blocks is not None:
            blocks += (~halted).to(torch.int32)
        halted = plain_block_step(compiled, state, block_uniforms(compiled, keys, first + c), params)
    return halted


def block_steps(
    compiled, state: dict, keys: torch.Tensor, first: int, n: int, params: dict,
    blocks=None,
) -> torch.Tensor:
    """Run macro-blocks ``first, ..., first + n - 1`` of every replica, in
    place, each replica until it halts (its next event past the horizon,
    tested before each block), adding the blocks each ran to the ``(R,)``
    int32 ``blocks`` where given; returns the ``(R,)`` bool halted mask.
    The JAX engine's ``replica_chunks``.

    ``keys`` are the ``(R, 2)`` uint32 replica keys. CPU tensors run
    :func:`plain_block_steps`; CUDA tensors make one kernel launch on
    torch's current stream, which draws each block's uniforms itself,
    after the checks of :func:`launch_args`, and raise on any mismatch or
    launch error. Nothing waits for the device.
    """
    device = state["t"].device
    _refuse_trace(compiled)
    if device.type == "cpu":
        return plain_block_steps(compiled, state, keys, first, n, params, blocks)
    if device.type != "cuda":
        raise ValueError(f"event-step kernel: unsupported device {device}")
    halted = torch.empty((state["t"].shape[0],), dtype=torch.uint8, device=device)
    launch(launch_args(compiled, state, keys, first, params, halted, n_blocks=n, blocks=blocks), device)
    return halted.view(torch.bool)


def block_step(compiled, state: dict, keys: torch.Tensor, block: int, params: dict) -> torch.Tensor:
    """Advance every replica by macro-block ``block``, in place; returns
    the ``(R,)`` bool halted mask (True: next event past the horizon): the
    one-block case of :func:`block_steps`, its plain version
    :func:`plain_block_step` on :func:`block_uniforms`."""
    return block_steps(compiled, state, keys, block, 1, params)


def _refuse_trace(compiled) -> None:
    if compiled.has_trace:
        raise ValueError(
            "event-step kernel: a model with a traced source runs trace_steps, "
            "whose blocks read the resident trace pages"
        )


def plain_trace_steps(
    compiled, state: dict, keys: torch.Tensor, params: dict, pages: tuple, base: int,
    n_chunks: int,
) -> torch.Tensor:
    """The plain version of :func:`trace_steps`: the stall-gated block
    loop of the JAX engine's traced stream step, in place. A lane enters a
    block while its ``trc_blocks`` is under ``n_chunks``, it has not
    halted, and it is not stalled: it stalls where its traced source is
    live and the block could read past the two resident pages
    (``trc_cursor + macro >= base + 2P``). Each lane keys its block by its
    own count, ``fold_in(key, trc_blocks)``, so a stall never shifts a
    draw. A stalled lane is left as it is, unhalted. ``pages`` are the
    resident pages' ``(t0, g0, t1, g1)``, times and tenants of ``P``
    arrivals each, ``base`` the absolute index of ``t0[0]``. Returns the
    ``(R,)`` bool halted mask."""
    t0, g0, t1, g1 = pages
    resident_t, resident_g = torch.cat([t0, t1]), torch.cat([g0, g1])
    span = resident_t.shape[0]
    step = compiled.make_step(trace_ctx=(resident_t, resident_g, int(base)))
    ti, macro = compiled.trace_src, compiled.macro
    while True:
        halted = compiled.replica_halted(state)
        stalled = torch.isfinite(state["src_next"][:, ti]) & (
            state["trc_cursor"].to(torch.int64) + macro >= int(base) + span
        )
        live = (state["trc_blocks"] < n_chunks) & ~halted & ~stalled
        if not bool(live.any()):
            return halted
        U = rng.uniform(
            rng.fold_in(keys, state["trc_blocks"].to(torch.int64)),
            (macro, compiled.n_draws), minval=1e-12, maxval=1.0,
        )
        state["trc_blocks"] += live.to(torch.int32)
        for k in range(macro):
            step(state, params, U[:, k, :], live)


def trace_steps(
    compiled, state: dict, keys: torch.Tensor, params: dict, pages: tuple, base: int,
    n_chunks: int,
) -> torch.Tensor:
    """One stream step of a traced model, in place: every replica runs
    stall-gated macro-blocks against the resident pages until its budget
    of ``n_chunks`` blocks is spent, it halts, or it stalls at the
    window's edge (:func:`plain_trace_steps` says how). Returns the
    ``(R,)`` bool halted mask. CPU tensors run :func:`plain_trace_steps`;
    CUDA tensors make one launch of the trace library on torch's current
    stream, which reads the pages in place, after the checks of
    :func:`launch_args`, and raise on any mismatch or launch error.
    Nothing waits for the device."""
    device = state["t"].device
    if device.type == "cpu":
        return plain_trace_steps(compiled, state, keys, params, pages, base, n_chunks)
    if device.type != "cuda":
        raise ValueError(f"event-step kernel: unsupported device {device}")
    halted = torch.empty((state["t"].shape[0],), dtype=torch.uint8, device=device)
    launch(trace_launch_args(compiled, state, keys, params, pages, base, n_chunks, halted), device)
    return halted.view(torch.bool)


def trace_launch_args(
    compiled, state: dict, keys: torch.Tensor, params: dict, pages: tuple, base: int,
    n_chunks: int, halted: torch.Tensor, draws=None,
) -> _Args:
    """The argument struct of one :func:`trace_steps` launch: that of
    :func:`launch_args` (block budget ``n_chunks``, the blocks keyed by
    each lane's ``trc_blocks``), with the resident pages ``(t0, g0, t1,
    g1)`` checked and their window start ``base``."""
    device = state["t"].device
    args = launch_args(
        compiled, state, keys, 0, params, halted, draws, n_blocks=max(int(n_chunks), 1)
    )
    P = compiled.trace_chunk_len
    for name, page in zip(("trace times", "trace tenants") * 2, pages):
        _check(name, page, (P,), device)
    if not 0 <= int(base) <= (1 << 31) - 1 - 2 * P:
        raise ValueError(f"event-step kernel: trace base {base} is not an int32 window start")
    args.trc.t0, args.trc.g0, args.trc.t1, args.trc.g1 = (p.data_ptr() for p in pages)
    args.trc.base, args.trc.n_chunks = int(base), int(n_chunks)
    return args


def library_of(args: _Args) -> str:
    """The library whose instantiations take these arguments: the
    partitioned one for a window of a partitioned run, else the wide
    code's for a model past one of the lean tables (with or without a
    traced source), else the trace
    one for a model with a traced source, else the one for several
    sources or sinks (its code by feature set), else the consensus one
    for
    a model with partitions or a quorum, else the resilience one for a
    model with a defense, else the telemetry one for a model with a spec,
    else the kernel without any of them."""
    if args.prt.on:
        return "event_step_partitioned"
    if args.wide.on:
        return "event_step_wide"
    if args.trc.on:
        return "event_step_trace"
    if args.nS > 1 or args.nK > 1:
        return "event_step_multi"
    if args.con.on:
        return "event_step_consensus"
    if args.res.on:
        return "event_step_resilience"
    return "event_step_telemetry" if args.tel.nW else "event_step"


# The libraries that pick a code by feature set and name it
# (hs_event_step_code, csrc/event_step.cuh's hs_code).
_CODED = ("event_step_multi", "event_step_trace")


def launch(args: _Args, device) -> None:
    """Launch the kernel with ready arguments (:func:`launch_args`) on
    torch's current stream of ``device``, from :func:`library_of`'s
    library; raise on a launch error. Every launch, of one block or of
    many, adds one to ``block_step.launches``, for a traced model to
    ``trace_steps.launches``, for a window of a partitioned run to
    ``window_steps.launches``; a launch of the library for several
    sources or sinks or of the trace library also adds one to
    ``launches_by_code[(library, code, telemetry)]``, the code as the
    library names it (``hs_event_step_code``: "line", "lean", "chaos" or
    "full")."""
    library = library_of(args)
    lib = load_library()[library]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.hs_event_step(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"event-step kernel launch failed: cudaError {rc}")
    if library in _CODED:
        key = (library, lib.hs_event_step_code(ctypes.byref(args)).decode(), bool(args.tel.nW))
        launches_by_code[key] = launches_by_code.get(key, 0) + 1
    if args.prt.on:
        window_steps.launches += 1
    elif args.trc.on:
        trace_steps.launches += 1
    else:
        block_step.launches += 1


def plain_window_steps(compiled, state: dict, params: dict, limit, budget: int) -> None:
    """The plain version of :func:`window_steps`: ``compiled``'s windowed
    step (``make_step(windowed=True)``, which draws each event's row from
    the lane's key and event count) up to ``budget`` times, each lane until
    its next event lies past ``limit``, in place; then every lane whose
    next event is still at or before ``limit`` adds one to
    ``truncated_windows`` (JAX's budget-exhaustion test)."""
    step = compiled.make_step(windowed=True)
    bound = torch.tensor(np.float32(limit), device=state["t"].device)
    for _ in range(int(budget)):
        if not bool((torch.amin(compiled.next_candidates(state), dim=1) <= bound).any()):
            break
        step(state, params, limit)
    pending = torch.amin(compiled.next_candidates(state), dim=1)
    state["truncated_windows"] += (pending <= bound).to(torch.int32)


def transit_bound(state: dict) -> torch.Tensor:
    """``(lanes, nV)`` int32: 1 + the highest occupied (not +inf) slot of
    each transit row of ``state["tr_time"]``, 0 for an empty row. Every
    slot from the bound on is free, so the partitioned window kernel and
    the barrier scan a row only up to it."""
    rows = state["tr_time"]
    slots = torch.arange(1, rows.shape[-1] + 1, dtype=torch.int32, device=rows.device)
    return torch.amax(~torch.isinf(rows) * slots, dim=-1).to(torch.int32).contiguous()


# The occupancy bounds the kernels keep, keyed by the ``tr_time`` tensor
# they bound (compared by identity; an entry goes with its tensor):
# [bounds, ``tr_time``'s version counter when they were last rebuilt].
_BOUNDS = WeakIdKeyDictionary()


def occupancy_bound(state: dict) -> torch.Tensor:
    """The occupancy bounds of ``state``'s transit rows
    (:func:`transit_bound`) that the partitioned window kernel and the
    barrier keep across windows, tied to the ``tr_time`` tensor itself, so
    every wrapper call on that tensor (through any ``prepared`` dict, or
    none) reads and updates the same bounds: scratch beside the state,
    never a leaf of it, of a snapshot or of a result. Built from
    ``tr_time`` the first time, and rebuilt in place (launch arguments
    keep its address) whenever a torch op changed ``tr_time`` since (its
    version counter moved; the kernels' own writes do not move it): a
    resume holds other tensors and builds its own."""
    rows = state["tr_time"]
    kept = _BOUNDS.get(rows)
    if kept is None:
        kept = _BOUNDS[rows] = [transit_bound(state), rows._version]
    elif kept[1] != rows._version:
        kept[0].copy_(transit_bound(state))
        kept[1] = rows._version
    return kept[0]


def kept_bound(state: dict):
    """The occupancy bounds kept for ``state``'s ``tr_time`` as the last
    launch left them (None before the first), without a rebuild: what a
    check holds against :func:`transit_bound`."""
    kept = _BOUNDS.get(state["tr_time"])
    return None if kept is None else kept[0]


def window_launch_args(
    compiled, state: dict, keys: torch.Tensor, params: dict, limit, budget: int,
    halted: torch.Tensor, tr_hi: torch.Tensor, draws=None, outbox=None,
) -> _Args:
    """The argument struct of one :func:`window_steps` launch: that of
    :func:`launch_args` (one block; the draws keyed per event), with the
    outbox leaves, ``truncated_windows`` and the transit rows' occupancy
    bounds ``tr_hi`` (:func:`transit_bound`, which the kernel keeps up to
    date) checked and pointed at, the window's end ``limit`` and the event
    ``budget``. ``outbox``, a slab ``(arrival, created, ingress, length)``
    shaped as the outbox leaves, takes the window's outbox instead of the
    state's leaves (a folded ring's scratch)."""
    if not getattr(compiled, "OB", 0):
        raise ValueError("event-step kernel: a window launch needs a partitioned model")
    device = state["t"].device
    R = state["t"].shape[0]
    args = launch_args(compiled, state, keys, 0, params, halted, draws)
    shapes = {
        "ob_arrival": (R, compiled.OB), "ob_created": (R, compiled.OB),
        "ob_ingress": (R, compiled.OB),
        "ob_len": (R,), "ob_sent": (R,), "ob_dropped": (R,), "truncated_windows": (R,),
    }
    rows = dict(zip(("ob_arrival", "ob_created", "ob_ingress", "ob_len"), outbox or ()))
    for field, leaf in _PRT_FIELDS:
        x = rows.get(leaf, state.get(leaf))
        if x is None:
            raise ValueError(f"event-step kernel: {leaf} is missing")
        _check(leaf, x, shapes[leaf], device)
        setattr(args.prt, field, x.data_ptr())
    _check("tr_hi", tr_hi, (R, compiled.nV), device)
    args.prt.tr_hi = tr_hi.data_ptr()
    _set_window(args, limit, budget)
    return args


def _set_window(args: _Args, limit, budget: int) -> None:
    """A window launch's end and event budget (at least one event)."""
    if int(budget) < 1:
        raise ValueError(f"event-step kernel: an event budget of {budget} a window")
    args.prt.budget = int(budget)
    args.prt.limit = float(np.float32(limit))


def window_steps(
    compiled, state: dict, keys: torch.Tensor, params: dict, limit, budget: int,
    prepared: dict | None = None,
) -> None:
    """One window of a partitioned run, in place: every lane runs up to
    ``budget`` events while its next event lies at or before ``limit`` (a
    sink still measures up to the model's horizon), each event's uniforms
    drawn from ``fold_in(key, events)``, each delivery to a remote queued
    in the lane's outbox; a lane whose budget ran out with an event still
    due adds one to ``truncated_windows``. ``keys`` are the lanes' ``(R,
    2)`` uint32 keys (the state's ``key``). CPU tensors run
    :func:`plain_window_steps`; CUDA tensors make one launch of the
    partitioned library on torch's current stream, after the checks of
    :func:`window_launch_args`, and raise on any mismatch or launch
    error. Nothing waits for the device.

    ``prepared``, a dict the caller keeps for one ``state`` whose tensors
    stay in place (it may share it with the barrier's calls), holds the
    checked arguments from the first call on (``prepared["window"]``:
    later calls on the same ``state`` change only the window's end and
    budget). The transit rows' occupancy bounds both kernels keep are
    tied to ``state["tr_time"]`` (:func:`occupancy_bound`), not to the
    dict, so a call with or without one reads the bounds the last launch
    left. The plain version neither reads nor keeps them."""
    device = state["t"].device
    if device.type == "cpu":
        plain_window_steps(compiled, state, params, limit, budget)
        return
    if device.type != "cuda":
        raise ValueError(f"event-step kernel: unsupported device {device}")
    tr_hi = occupancy_bound(state)
    mine = None if prepared is None else prepared.setdefault("window", {})
    if mine is None or mine.get("state") is not state:
        halted = torch.empty((state["t"].shape[0],), dtype=torch.uint8, device=device)
        args = window_launch_args(compiled, state, keys, params, limit, budget, halted, tr_hi)
        if mine is not None:
            mine.update(state=state, args=args, halted=halted)
    else:
        args = mine["args"]
        _set_window(args, limit, budget)
        args.prt.tr_hi = tr_hi.data_ptr()
    launch(args, device)


#: Kernel launches since the count was last set to 0 (the trace library's
#: in ``trace_steps.launches``, the partitioned library's in
#: ``window_steps.launches``).
block_step.launches = 0
trace_steps.launches = 0
window_steps.launches = 0
#: Launches of each code of the library for several sources or sinks and
#: of the trace library since the dict was last cleared: {(library, code,
#: telemetry sites): launches}.
launches_by_code: dict = {}
