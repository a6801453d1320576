"""Per-replica fault and partition schedules (own copy of ``FaultTable``,
``PartitionTable`` and ``duty_cycle`` from ``happysim_tpu/tpu/faults.py``,
with their device draws in torch).

Every replica draws its own fault timeline from its key at init:
``(nV, W)`` window start/end registers per server (inter-window gaps ~
Exp(rate) measured from the previous window's end, durations ~ Exp(mean)
or constant) and, with :class:`~happysim_tpu_torch.model.CorrelatedOutages`,
one shared ``(W_sh,)`` candidate sequence whose windows fire by
independent Bernoulli(trigger_p) draws. Pinned ``FaultSpec.windows`` give
the same registers in every replica. The registers never change after
init, so a fault adds no events: the step asks :meth:`dark_vector`
whether a server is inside a window at an arrival or a queue pull.
"""

from __future__ import annotations

import numpy as np
import torch

from happysim_tpu_torch import rng

# fold_in salt separating the fault-schedule stream from the per-block
# streams and from the initial-gap draw (JAX's FAULT_KEY_SALT).
FAULT_KEY_SALT = 0x7A057A57
# The network-partition schedule's own salt (JAX's PARTITION_KEY_SALT): a
# model with faults and partitions draws independent windows, and adding
# a partition group leaves a fault schedule as it was.
PARTITION_KEY_SALT = 0x9A2717E5
# Block length of XLA's prefix sum: jnp.cumsum lowers to a reduce-window
# that XLA's CPU backend rewrites into running sums inside blocks of 16
# and a running sum of the block totals.
_SCAN_BLOCK = 16


def duty_cycle(rate: float, mean_duration_s: float) -> float:
    """Stationary fraction of time inside a fault window: with gaps ~
    Exp(rate) between windows of mean length d, the renewal cycle is
    1/rate + d, of which d is dark."""
    if rate <= 0.0 or mean_duration_s <= 0.0:
        return 0.0
    return mean_duration_s / (1.0 / rate + mean_duration_s)


def _running_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right running sum over the last axis, one add per entry."""
    out = x.clone()
    for k in range(1, x.shape[-1]):
        out[..., k] = out[..., k - 1] + x[..., k]
    return out


def cumsum_like_xla(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum(x, axis=-1)`` in XLA's CPU order: a running sum up to
    16 entries; past that, running sums inside blocks of 16 plus the
    running sum (in the same order, recursively) of the earlier blocks'
    totals. ``torch.cumsum`` adds in another order and differs in the
    last bit on some inputs."""
    W = x.shape[-1]
    if W <= _SCAN_BLOCK:
        return _running_sum(x)
    n_blocks = -(-W // _SCAN_BLOCK)
    padded = torch.cat(
        [x, x.new_zeros(x.shape[:-1] + (n_blocks * _SCAN_BLOCK - W,))], dim=-1
    ).reshape(x.shape[:-1] + (n_blocks, _SCAN_BLOCK))
    inner = _running_sum(padded)
    totals = cumsum_like_xla(inner[..., -1])
    before = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]], dim=-1)
    out = (inner + before[..., None]).reshape(x.shape[:-1] + (n_blocks * _SCAN_BLOCK,))
    return out[..., :W]


def windows_from(gaps: torch.Tensor, durs: torch.Tensor):
    """Window registers from gaps and durations along the last axis:
    ``start_k`` = the gaps through k plus the durations before k, written
    as JAX writes it (``cumsum(gaps) + (cumsum(durs) - durs)``, not an
    exclusive sum), and ``end_k = start_k + dur_k``."""
    start = cumsum_like_xla(gaps) + (cumsum_like_xla(durs) - durs)
    return start, start + durs


class FaultTable:
    """Static view of a model's fault config: per-server rates,
    durations, modes, degradation factors and participation flags, and
    the window budget ``W`` (``W_sh`` for the shared schedule)."""

    def __init__(self, model):
        servers = model.servers
        self.nV = max(len(servers), 1)
        specs = [s.fault for s in servers]
        self.has_faults = any(spec is not None for spec in specs)
        self.shared = model.correlated_faults
        self.has_shared = self.shared is not None and any(
            spec is not None and spec.correlated for spec in specs
        )
        # Window budget: the widest requirement (pinned schedules need
        # exactly their own length).
        widths = [1]
        for spec in specs:
            if spec is None:
                continue
            if spec.windows is not None:
                widths.append(len(spec.windows))
            elif spec.rate > 0.0:
                widths.append(spec.max_windows)
        self.W = max(widths)
        self.W_sh = self.shared.max_windows if self.has_shared else 0

        nV, W = self.nV, self.W
        self.faulted = np.zeros((nV,), np.bool_)
        self.stochastic = np.zeros((nV,), np.bool_)
        self.rate = np.ones((nV,), np.float32)  # 1.0 keeps unused rows finite
        self.mean_dur = np.ones((nV,), np.float32)
        self.dur_const = np.zeros((nV,), np.bool_)
        self.det_start = np.full((nV, W), np.inf, np.float32)
        self.det_end = np.full((nV, W), np.inf, np.float32)
        # drop_mode: in-window arrivals are rejected; otherwise (degrade)
        # the window caps new starts at cap_slots and inflates service.
        self.drop_mode = np.zeros((nV,), np.bool_)
        self.cap_slots = np.zeros((nV,), np.int32)
        self.lat_factor = np.ones((nV,), np.float32)
        self.participates = np.zeros((nV,), np.bool_)
        for v, spec in enumerate(specs):
            if spec is None:
                continue
            self.faulted[v] = True
            self.drop_mode[v] = spec.mode == "outage"
            self.lat_factor[v] = spec.latency_factor
            self.cap_slots[v] = int(np.floor(servers[v].concurrency * spec.capacity_factor))
            self.participates[v] = spec.correlated
            if spec.windows is not None:
                for w, (start, end) in enumerate(spec.windows):
                    self.det_start[v, w] = start
                    self.det_end[v, w] = end
            elif spec.rate > 0.0:
                self.stochastic[v] = True
                self.rate[v] = spec.rate
                self.mean_dur[v] = spec.mean_duration_s
                self.dur_const[v] = spec.duration == "constant"
        self.degrade = self.faulted & ~self.drop_mode
        # Some server's degrade windows inflate its service.
        self.has_degrade_lat = bool(np.any(self.degrade & (self.lat_factor > 1.0)))

    def draw_uniforms(self, keys: torch.Tensor) -> dict:
        """The schedule's uniforms for keys ``(R, 2)``: ``"servers"``
        ``(R, nV, W, 2)`` (gap, duration) when a server samples its own
        windows, ``"shared"`` ``(R, W_sh, 3)`` (gap, duration, trigger)
        with a correlated schedule."""
        fkey = rng.fold_in(keys, FAULT_KEY_SALT)
        out = {}
        if self.stochastic.any():
            out["servers"] = rng.uniform(
                rng.fold_in(fkey, 0), (self.nV, self.W, 2), minval=1e-12, maxval=1.0
            )
        if self.has_shared:
            out["shared"] = rng.uniform(
                rng.fold_in(fkey, 1), (self.W_sh, 3), minval=1e-12, maxval=1.0
            )
        return out

    def sample_state(self, keys: torch.Tensor, draw: bool = True) -> dict:
        """Each replica's window registers: ``flt_start`` / ``flt_end``
        ``(R, nV, W)`` (+inf rows for unfaulted servers) and, with a
        correlated schedule, ``flt_sh_start`` / ``flt_sh_end`` ``(R,
        W_sh)`` holding only the candidates the trigger fired.
        ``draw=False``: the same leaves without a draw, the sampled
        windows left at their pinned values and no shared one fired."""
        R, dev = keys.shape[0], keys.device
        u = self.draw_uniforms(keys) if draw else {}
        starts = torch.from_numpy(self.det_start).to(dev).expand(R, -1, -1).clone()
        ends = torch.from_numpy(self.det_end).to(dev).expand(R, -1, -1).clone()
        if "servers" in u:
            rate = torch.from_numpy(self.rate).to(dev)[:, None]
            mean = torch.from_numpy(self.mean_dur).to(dev)[:, None]
            gaps = -torch.log(u["servers"][..., 0]) / rate
            durs = torch.where(
                torch.from_numpy(self.dur_const).to(dev)[:, None],
                mean.expand(-1, self.W),
                -torch.log(u["servers"][..., 1]) * mean,
            )
            sampled_start, sampled_end = windows_from(gaps, durs)
            stoch = torch.from_numpy(self.stochastic).to(dev)[:, None]
            starts = torch.where(stoch, sampled_start, starts)
            ends = torch.where(stoch, sampled_end, ends)
        state = {"flt_start": starts, "flt_end": ends}
        if "shared" in u:
            shared = u["shared"]
            rate = torch.tensor(np.float32(self.shared.rate), device=dev)
            mean = torch.tensor(np.float32(self.shared.mean_duration_s), device=dev)
            start, end = windows_from(
                -torch.log(shared[..., 0]) / rate, -torch.log(shared[..., 1]) * mean
            )
            # Candidates keep their slot on the timeline whether or not
            # they fire: trigger_p thins the visible windows.
            fired = shared[..., 2] < float(np.float32(self.shared.trigger_p))
            inf = torch.full_like(start, float("inf"))
            state["flt_sh_start"] = torch.where(fired, start, inf)
            state["flt_sh_end"] = torch.where(fired, end, inf)
        elif self.has_shared:
            inf = torch.full((R, self.W_sh), float("inf"), device=dev)
            state["flt_sh_start"], state["flt_sh_end"] = inf, inf.clone()
        return state

    def dark(self, state: dict, v: int, t: torch.Tensor) -> torch.Tensor:
        """``(R,)`` bool: is server ``v`` inside one of its fault windows
        (or, subscribed, a fired shared window) at ``t``?"""
        tt = t[:, None]
        dark = ((tt >= state["flt_start"][:, v, :]) & (tt < state["flt_end"][:, v, :])).any(dim=1)
        if self.has_shared and self.participates[v]:
            shared = (tt >= state["flt_sh_start"]) & (tt < state["flt_sh_end"])
            dark = dark | shared.any(dim=1)
        return dark


class PartitionTable:
    """Static view of a model's network-partition groups (own copy of the
    JAX package's ``PartitionTable``): each group's member servers, mode
    and delay, and its window schedule, drawn as a fault schedule is
    (gaps ~ Exp(rate), Exp or constant durations), each candidate kept
    with probability ``trigger_p``, or pinned in every replica. A server
    in several groups is cut under the OR; drop wins over delay."""

    def __init__(self, model):
        specs = list(model.network_partitions)
        self.has_partitions = bool(specs)
        self.nP = max(len(specs), 1)
        self.nV = max(len(model.servers), 1)
        widths = [1]
        for spec in specs:
            if spec.windows is not None:
                widths.append(len(spec.windows))
            elif spec.rate > 0.0:
                widths.append(spec.max_windows)
        self.Wp = max(widths)
        nP, Wp = self.nP, self.Wp
        self.member = np.zeros((nP, self.nV), np.bool_)
        self.stochastic = np.zeros((nP,), np.bool_)
        self.rate = np.ones((nP,), np.float32)  # 1.0 keeps unused rows finite
        self.mean_dur = np.ones((nP,), np.float32)
        self.dur_const = np.zeros((nP,), np.bool_)
        self.trigger_p = np.ones((nP,), np.float32)
        self.det_start = np.full((nP, Wp), np.inf, np.float32)
        self.det_end = np.full((nP, Wp), np.inf, np.float32)
        self.drop_mode = np.zeros((nP,), np.bool_)
        self.delay_s = np.zeros((nP,), np.float32)
        for p, spec in enumerate(specs):
            for v in spec.group:
                self.member[p, v] = True
            self.drop_mode[p] = spec.mode == "drop"
            self.delay_s[p] = spec.delay_s
            if spec.windows is not None:
                for w, (start, end) in enumerate(spec.windows):
                    self.det_start[p, w] = start
                    self.det_end[p, w] = end
            elif spec.rate > 0.0:
                self.stochastic[p] = True
                self.rate[p] = spec.rate
                self.mean_dur[p] = spec.mean_duration_s
                self.dur_const[p] = spec.duration == "constant"
                self.trigger_p[p] = spec.trigger_p
        self.has_delay = self.has_partitions and bool(np.any(~self.drop_mode))
        # Servers in at least one group: deliveries into them consult.
        self.touched = self.member.any(axis=0)

    def draw_uniforms(self, keys: torch.Tensor) -> torch.Tensor:
        """The schedule's ``(R, nP, Wp, 3)`` uniforms (gap, duration,
        trigger) for keys ``(R, 2)``, on the stream salted by
        :data:`PARTITION_KEY_SALT`."""
        pkey = rng.fold_in(keys, PARTITION_KEY_SALT)
        return rng.uniform(rng.fold_in(pkey, 0), (self.nP, self.Wp, 3), minval=1e-12, maxval=1.0)

    def sample_state(self, keys: torch.Tensor, draw: bool = True) -> dict:
        """Each replica's ``prt_start`` / ``prt_end`` ``(R, nP, Wp)``
        registers: windows the trigger left unfired, and a pinned row's
        unused tail, at +inf (``draw=False``: the same leaves without a
        draw, the stochastic rows at their pinned values)."""
        R, dev = keys.shape[0], keys.device
        starts = torch.from_numpy(self.det_start).to(dev).expand(R, -1, -1).clone()
        ends = torch.from_numpy(self.det_end).to(dev).expand(R, -1, -1).clone()
        if draw and self.stochastic.any():
            u = self.draw_uniforms(keys)
            rate = torch.from_numpy(self.rate).to(dev)[:, None]
            mean = torch.from_numpy(self.mean_dur).to(dev)[:, None]
            gaps = -torch.log(u[..., 0]) / rate
            durs = torch.where(
                torch.from_numpy(self.dur_const).to(dev)[:, None],
                mean.expand(-1, self.Wp),
                -torch.log(u[..., 1]) * mean,
            )
            start, end = windows_from(gaps, durs)
            # Candidates keep their timeline slot whether or not they
            # fire: the whole group cuts together when its candidate does.
            fired = u[..., 2] < torch.from_numpy(self.trigger_p).to(dev)[:, None]
            inf = torch.full_like(start, float("inf"))
            stoch = torch.from_numpy(self.stochastic).to(dev)[:, None]
            starts = torch.where(stoch, torch.where(fired, start, inf), starts)
            ends = torch.where(stoch, torch.where(fired, end, inf), ends)
        return {"prt_start": starts, "prt_end": ends}

    def group_cut(self, state: dict, t: torch.Tensor) -> torch.Tensor:
        """``(R, nP)`` bool: which groups are cut at ``t``."""
        tt = t[:, None, None]
        return ((tt >= state["prt_start"]) & (tt < state["prt_end"])).any(dim=2)

    def consult(self, state: dict, v: int, t: torch.Tensor) -> tuple:
        """Server ``v``'s partition status at ``t``, per lane: ``(dark,
        drop, delay)``, whether a group holding it is cut, whether one of
        those is drop-mode, and the largest delay of the cut ones."""
        cut = self.group_cut(state, t) & torch.from_numpy(self.member[:, v]).to(t.device)
        dark = cut.any(dim=1)
        drop = (cut & torch.from_numpy(self.drop_mode).to(t.device)).any(dim=1)
        delay = torch.where(cut, torch.from_numpy(self.delay_s).to(t.device), 0.0).amax(dim=1)
        return dark, drop, delay
