"""The plain reference of a queueing-network ensemble: sources, one level
of routers over servers, servers with a FIFO queue, deadlines and
immediate retries, lossy and latency-carrying edges, and sinks, each
replica simulated event by event in plain torch ops over the replica
axis.

It reads the benchmark's resolved cell (:func:`benchmark.cells.resolve`):
the configuration's graph and sizes with the traffic's rates, sweeps and
edge losses, and derives every key, uniform and state from them and the
seed; it imports nothing of the program. Its semantics are the
simulation's definition: one event a step per replica (the earliest of
its sources' next arrivals, its servers' earliest completions and its
edges' earliest transit arrivals, ties to the first in that order), the
step's row of uniforms from the replica's key folded with the
macro-block's index, a job's latency measured at its sink inside
[warmup, horizon], and the totals over replicas in exact integer and
fixed-point sums. Each server's own index rides per lane, so one step
handles every server's completions with the same ops.

``dtype`` is the float type of the times and sums: float32 as the
configuration states, or a lower one for the control.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import threefry

INF = float("inf")
HIST_BINS = 80
HIST_LO_LOG10 = -5.0
HIST_DECADES = 8.0
# The totals the comparison reads (``benchmark/compare.py``): integer
# totals compared exactly, float statistics by their relative gap.
FIELDS = {
    "exact": (
        "simulated_events", "truncated_replicas", "blocks_total", "sink_count", "sink_hist",
        "server_completed", "server_dropped", "server_timed_out", "server_retried",
        "transit_dropped", "network_lost",
    ),
    "float": (
        "sink_mean_latency_s", "server_mean_wait_s", "server_utilization",
        "server_mean_queue_len",
    ),
}
FEATURES = "poisson and constant sources; round_robin, least_outstanding and random routers over servers; exponential servers with queues, deadlines and immediate retries; edges with constant or exponential latency and loss; sinks"


def _node(text: str) -> tuple:
    kind, index = text.split(":")
    return kind, int(index)


class Graph:
    """The cell's graph as tables the step reads, and the uniform-row
    layout it implies: the arrival gap (any Poisson source), a route draw
    (any random router), the edge latency (any exponential edge), two
    service draws (an arrival's start and a completion's queue pull),
    then the loss Bernoulli (any lossy edge)."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.horizon = float(spec["horizon_s"])
        self.warmup = float(spec["warmup_s"])
        self.macro = int(spec["macro_block"])
        self.TR = int(spec["transit_capacity"])
        self.sources = spec["sources"]
        self.servers = spec["servers"]
        self.routers = spec["routers"]
        self.nS, self.nV, self.nR, self.nK = (
            len(self.sources), len(self.servers), len(self.routers), int(spec["sinks"])
        )
        for v in self.servers:
            if v.get("service", "exponential") != "exponential":
                raise ValueError(f"the reference supports {FEATURES}")
        self.C = max(int(v["concurrency"]) for v in self.servers)
        self.K = max(int(v["queue_capacity"]) for v in self.servers)
        self.src_down = [None] * self.nS
        self.srv_down = [None] * self.nV
        self.targets = [[] for _ in range(self.nR)]
        for e in spec["edges"]:
            (fk, fi), to = _node(e["from"]), _node(e["to"])
            edge = {
                "mean": float(e.get("latency_s", 0.0)),
                "exp": e.get("latency_kind", "constant") == "exponential",
                "loss": float(e.get("loss_p", 0.0)),
            }
            if fk == "source":
                self.src_down[fi] = (to, edge)
            elif fk == "server":
                if to[0] != "sink" or edge["mean"] > 0 or edge["loss"] > 0:
                    raise ValueError(f"the reference supports {FEATURES}")
                self.srv_down[fi] = (to, edge)
            elif fk == "router":
                if to[0] != "server":
                    raise ValueError(f"the reference supports {FEATURES}")
                self.targets[fi].append((to, edge))
            else:
                raise ValueError(f"the reference supports {FEATURES}")
        edges = [d[1] for d in self.src_down if d] + [t[1] for ts in self.targets for t in ts]
        for to, edge in (d for d in self.src_down if d):
            if to[0] == "router" and (edge["mean"] > 0 or edge["loss"] > 0):
                raise ValueError("edges into a router carry no latency or loss")
        poisson = [s.get("kind", "poisson") == "poisson" for s in self.sources]
        self.has_transit = any(
            e["mean"] > 0 for (to, e) in (d for d in self.src_down if d) if to[0] == "server"
        ) or any(any(e["mean"] > 0 for _, e in ts) for ts in self.targets)
        self.has_loss = any(e["loss"] > 0 for e in edges)
        self.has_attempts = any(v.get("deadline_s") is not None for v in self.servers)
        slot = 0
        self.U_GAP = self.U_ROUTE = self.U_LAT = self.U_LOSS = None
        if any(poisson):
            self.U_GAP, slot = slot, slot + 1
        if any(r["policy"] == "random" for r in self.routers):
            self.U_ROUTE, slot = slot, slot + 1
        if any(e["mean"] > 0 and e["exp"] for e in edges):
            self.U_LAT, slot = slot, slot + 1
        self.U_SVC1, self.U_SVC2, slot = slot, slot + 1, slot + 2
        if self.has_loss:
            self.U_LOSS, slot = slot, slot + 1
        self.n_draws = slot
        self.poisson = poisson

    def tables(self, device, ft) -> dict:
        """Per-server and per-router-target constants on ``device``."""
        f32 = lambda xs: torch.tensor(np.asarray(xs, np.float32), device=device).to(ft)  # noqa: E731
        i32 = lambda xs: torch.tensor(np.asarray(xs, np.int32), device=device)  # noqa: E731
        valid = np.zeros((self.nV, self.C), bool)
        for v, s in enumerate(self.servers):
            valid[v, : int(s["concurrency"])] = True
        tab = {
            "valid": torch.tensor(valid, device=device),
            "cap": i32([int(s["queue_capacity"]) for s in self.servers]),
            "deadline": f32([
                INF if s.get("deadline_s") is None else s["deadline_s"] for s in self.servers
            ]),
            "max_retries": i32([int(s.get("max_retries", 0)) for s in self.servers]),
            "sink_of": i32([self.srv_down[v][0][1] for v in range(self.nV)]),
        }
        for i, down in enumerate(self.src_down):
            tab[f"s{i}_mean"] = f32(down[1]["mean"] if down else 0.0)
        for r, ts in enumerate(self.targets):
            tab[f"r{r}_server"] = torch.tensor([t[0][1] for t in ts], device=device)
            tab[f"r{r}_mean"] = f32([t[1]["mean"] for t in ts])
            tab[f"r{r}_exp"] = torch.tensor([t[1]["exp"] for t in ts], device=device)
            tab[f"r{r}_loss"] = f32([t[1]["loss"] for t in ts])
        return tab


def _fma(a, b, c, ft):
    """``c + a * b`` rounded once (the product is exact in float64)."""
    return (c.double() + a.double() * b.double()).to(ft)


def _hist_bin(latency, ft):
    logv = torch.log10(torch.clamp_min(latency, float(np.float32(1e-12))))
    frac = (logv - HIST_LO_LOG10) / HIST_DECADES
    return torch.clamp((frac * float(HIST_BINS)).to(torch.int32), 0, HIST_BINS - 1)


class Reference:
    """One ensemble of the cell, simulated in plain torch ops."""

    def __init__(self, spec: dict, seed: int, device, dtype=torch.float32):
        self.g = Graph(spec)
        self.seed = int(seed)
        self.dev = torch.device(device)
        self.ft = dtype
        self.R = int(spec["replicas"])
        self.max_events = int(spec["max_events"])
        rate = np.broadcast_to(
            np.asarray([s["rate"] for s in self.g.sources], np.float32), (self.R, self.g.nS)
        ).copy()
        sweep = spec.get("sweeps", {}).get("source_rate")
        if sweep is not None:
            rate[:] = np.asarray(sweep, np.float32).reshape(self.R, -1)
        self.rate = torch.from_numpy(rate).to(self.dev).to(dtype)
        self.mean = torch.tensor(
            np.asarray([s["service_mean"] for s in self.g.servers], np.float32), device=self.dev
        ).to(dtype).expand(self.R, self.g.nV)
        self.tab = self.g.tables(self.dev, dtype)
        self.ar = torch.arange(self.R, device=self.dev)

    # -- state -------------------------------------------------------------
    def init_state(self) -> dict:
        g, R, dev, ft, i32 = self.g, self.R, self.dev, self.ft, torch.int32
        self.keys = threefry.split(threefry.PRNGKey(self.seed, dev), R)
        u = threefry.uniform(self.keys, (g.nS,)).to(ft)
        poisson = torch.tensor(g.poisson, device=dev)
        gaps = torch.where(poisson, -torch.log(u) / self.rate, torch.ones_like(self.rate) / self.rate)
        stop = torch.tensor(
            np.asarray([s.get("stop_after_s") or INF for s in g.sources], np.float32), device=dev
        ).to(ft)
        z = lambda *shape, dt=ft: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
        s = {
            "t": z(R), "src_next": torch.where(gaps > stop, INF, gaps),
            "done": torch.full((R, g.nV, g.C), INF, dtype=ft, device=dev),
            "slot_created": z(R, g.nV, g.C), "slot_attempt": z(R, g.nV, g.C, dt=i32),
            "q_created": z(R, g.nV, g.K), "q_enq": z(R, g.nV, g.K),
            "q_attempt": z(R, g.nV, g.K, dt=i32),
            "q_head": z(R, g.nV, dt=i32), "q_len": z(R, g.nV, dt=i32),
            "events": z(R, dt=i32), "rr_next": z(R, max(g.nR, 1), dt=i32),
            "sink_count": z(R, g.nK, dt=i32), "sink_sum": z(R, g.nK), "sink_sq": z(R, g.nK),
            "sink_hist": z(R, g.nK * HIST_BINS, dt=i32),
            "tr_time": torch.full((R, g.nV, g.TR), INF, dtype=ft, device=dev),
            "tr_created": z(R, g.nV, g.TR), "tr_dropped": z(R, g.nV, dt=i32),
            "net_lost": z(R, dt=i32),
        }
        for key in ("dropped", "started", "completed", "timed_out", "retried", "wait_n"):
            s[key] = z(R, g.nV, dt=i32)
        for key in ("busy_int", "depth_int", "wait_sum"):
            s[key] = z(R, g.nV)
        return s

    def candidates(self, s) -> torch.Tensor:
        """Each lane's next-event times: sources, servers, transit rows."""
        g = self.g
        srv = torch.amin(torch.where(self.tab["valid"], s["done"], INF), dim=2)
        parts = [s["src_next"], srv]
        if g.has_transit:
            parts.append(torch.amin(s["tr_time"], dim=2))
        return torch.cat(parts, dim=1)

    def halted(self, s) -> torch.Tensor:
        t_min = torch.amin(self.candidates(s), dim=1)
        return torch.isinf(t_min) | (t_min > self.g.horizon)

    # -- branches ------------------------------------------------------------
    def _into_transit(self, s, lanes, v, arrival, created) -> None:
        row = s["tr_time"][self.ar, v]
        free = torch.isinf(row)
        has_free = free.any(dim=1)
        k = torch.argmax(free.to(torch.int32), dim=1)
        parked = lanes & has_free
        s["tr_time"][self.ar, v, k] = torch.where(parked, arrival, row[self.ar, k])
        tc = s["tr_created"][self.ar, v, k]
        s["tr_created"][self.ar, v, k] = torch.where(parked, created, tc)
        s["tr_dropped"][self.ar, v] += (lanes & ~has_free).to(torch.int32)

    def _arrive(self, s, lanes, v, t, created, attempt, u) -> None:
        """A job reaching server ``v`` (per lane): start in the first free
        slot, else join the queue's tail, else drop."""
        g, ft, ar = self.g, self.ft, self.ar
        row = s["done"][ar, v]
        free = self.tab["valid"][v] & torch.isinf(row)
        has_free = free.any(dim=1)
        k = torch.argmax(free.to(torch.int32), dim=1)
        x = -torch.log(u[:, g.U_SVC1])
        mean = self.mean[ar, v]
        service = x * mean
        done_at = _fma(x, mean, t, ft)
        q_len = s["q_len"][ar, v]
        has_room = q_len < self.tab["cap"][v]
        head = s["q_head"][ar, v]
        tail = torch.remainder(head + q_len, g.K)
        start = lanes & has_free
        enq = lanes & ~has_free & has_room
        drop = lanes & ~has_free & ~has_room
        measured = start & (t >= g.warmup)
        s["done"][ar, v, k] = torch.where(start, done_at, row[ar, k])
        s["slot_created"][ar, v, k] = torch.where(start, created, s["slot_created"][ar, v, k])
        s["slot_attempt"][ar, v, k] = torch.where(start, attempt, s["slot_attempt"][ar, v, k])
        s["started"][ar, v] += start.to(torch.int32)
        s["wait_n"][ar, v] += measured.to(torch.int32)
        busy = s["busy_int"][ar, v]
        s["busy_int"][ar, v] = torch.where(measured, busy + service, busy)
        self._push(s, enq, v, tail, created, t, attempt)
        s["q_len"][ar, v] = q_len + enq.to(torch.int32)
        s["dropped"][ar, v] += drop.to(torch.int32)

    def _push(self, s, lanes, v, slot, created, t, attempt) -> None:
        ar = self.ar
        for key, value in (("q_created", created), ("q_enq", t), ("q_attempt", attempt)):
            current = s[key][ar, v, slot]
            s[key][ar, v, slot] = torch.where(lanes, value, current)

    def _deliver_sink(self, s, lanes, k, arrival, created) -> None:
        g, ft, ar = self.g, self.ft, self.ar
        measure = lanes & (arrival >= g.warmup) & (arrival <= g.horizon)
        latency = torch.where(measure, arrival - created, torch.zeros_like(created))
        s["sink_count"][ar, k] += measure.to(torch.int32)
        total = s["sink_sum"][ar, k]
        s["sink_sum"][ar, k] = torch.where(measure, total + latency, total)
        sq = s["sink_sq"][ar, k]
        s["sink_sq"][ar, k] = torch.where(measure, _fma(latency, latency, sq, ft), sq)
        s["sink_hist"][ar, k * HIST_BINS + _hist_bin(latency, ft)] += measure.to(torch.int32)

    def _lost(self, s, lanes, u, t, p) -> torch.Tensor:
        """The crossings a lossy edge of probability ``p`` loses."""
        lost = lanes & (u[:, self.g.U_LOSS] < p) & (t >= 0.0)
        s["net_lost"] += lost.to(torch.int32)
        return lost

    def _fire(self, s, i, lanes, t, u) -> None:
        g, ft, ar = self.g, self.ft, self.ar
        rate = self.rate[:, i]
        if g.poisson[i]:
            gap = -torch.log(u[:, g.U_GAP]) / rate
        else:
            gap = torch.ones_like(rate) / rate
        nxt = t + gap
        stop = g.sources[i].get("stop_after_s") or INF
        fired = torch.where(nxt > float(np.float32(stop)), INF, nxt)
        s["src_next"][:, i] = torch.where(lanes, fired, s["src_next"][:, i])
        (kind, index), edge = g.src_down[i]
        zero = torch.zeros_like(s["q_len"][:, 0])
        if kind == "sink":
            self._deliver_sink(s, lanes, torch.full_like(zero, index), t, t)
        elif kind == "server":
            if edge["loss"] > 0:
                lanes = lanes & ~self._lost(s, lanes, u, t, float(np.float32(edge["loss"])))
            v = torch.full_like(zero, index).long()
            if edge["mean"] > 0:
                mean = self.tab[f"s{i}_mean"]
                if edge["exp"]:
                    arrival = _fma(-torch.log(u[:, g.U_LAT]), mean.expand_as(t), t, ft)
                else:
                    arrival = t + mean
                self._into_transit(s, lanes, v, arrival, t)
            else:
                self._arrive(s, lanes, v, t, t, zero, u)
        else:
            self._route(s, index, lanes, t, u)

    def _route(self, s, r, lanes, t, u) -> None:
        g, ft, ar, tab = self.g, self.ft, self.ar, self.tab
        policy = g.routers[r]["policy"]
        n = len(g.targets[r])
        servers = tab[f"r{r}_server"]
        if policy == "round_robin":
            choice = torch.remainder(s["rr_next"][:, r], n).long()
            s["rr_next"][:, r] += lanes.to(torch.int32)
        elif policy == "random":
            choice = torch.clamp_max((u[:, g.U_ROUTE] * n).to(torch.int32), n - 1).long()
        elif policy == "least_outstanding":
            valid = tab["valid"][servers]
            busy = (torch.isfinite(s["done"][:, servers, :]) & valid).sum(dim=2)
            choice = torch.argmin(busy + s["q_len"][:, servers], dim=1)
        else:
            raise ValueError(f"the reference supports {FEATURES}")
        if any(e["loss"] > 0 for _, e in g.targets[r]):
            lanes = lanes & ~self._lost(s, lanes, u, t, tab[f"r{r}_loss"][choice])
        v = servers[choice]
        zero = torch.zeros_like(s["q_len"][:, 0])
        if any(e["mean"] > 0 for _, e in g.targets[r]):
            mean = tab[f"r{r}_mean"][choice]
            arrival = t + mean
            if g.U_LAT is not None:
                drawn = t + (-torch.log(u[:, g.U_LAT])) * mean
                arrival = torch.where(tab[f"r{r}_exp"][choice], drawn, arrival)
            self._into_transit(s, lanes, v, arrival, t)
        else:
            self._arrive(s, lanes, v, t, t, zero, u)

    def _complete(self, s, lanes, v, t, u) -> None:
        """The earliest completion of server ``v`` (per lane): a job past
        its deadline is retried at the queue's tail while attempts last,
        else timed out; any other goes to the sink; the freed slot then
        takes the queue's head."""
        g, ft, ar, tab = self.g, self.ft, self.ar, self.tab
        row = s["done"][ar, v]
        k = torch.argmin(torch.where(tab["valid"][v], row, INF), dim=1)
        created = s["slot_created"][ar, v, k]
        attempt = s["slot_attempt"][ar, v, k]
        s["done"][ar, v, k] = torch.where(lanes, INF, row[ar, k])
        s["completed"][ar, v] += lanes.to(torch.int32)
        forward = lanes
        if g.has_attempts:
            expired = lanes & ((t - created) > tab["deadline"][v])
            retry = expired & (attempt < tab["max_retries"][v])
            s["timed_out"][ar, v] += (expired & ~retry).to(torch.int32)
            q_len = s["q_len"][ar, v]
            has_room = q_len < tab["cap"][v]
            tail = torch.remainder(s["q_head"][ar, v] + q_len, g.K)
            pushed = retry & has_room
            self._push(s, pushed, v, tail, created, t, attempt + 1)
            s["q_len"][ar, v] = q_len + pushed.to(torch.int32)
            s["retried"][ar, v] += pushed.to(torch.int32)
            s["dropped"][ar, v] += (retry & ~has_room).to(torch.int32)
            forward = lanes & ~expired
        self._deliver_sink(s, forward, tab["sink_of"][v].long(), t, created)
        q_len = s["q_len"][ar, v]
        still_free = torch.isinf(s["done"][ar, v, k])
        pull = lanes & (q_len > 0) & still_free
        head = s["q_head"][ar, v]
        q_created = s["q_created"][ar, v, head.long()]
        q_enq = s["q_enq"][ar, v, head.long()]
        q_attempt = s["q_attempt"][ar, v, head.long()]
        x = -torch.log(u[:, g.U_SVC2])
        mean = self.mean[ar, v]
        service = x * mean
        done_at = _fma(x, mean, t, ft)
        measured = pull & (t >= g.warmup)
        s["done"][ar, v, k] = torch.where(pull, done_at, s["done"][ar, v, k])
        s["slot_created"][ar, v, k] = torch.where(pull, q_created, s["slot_created"][ar, v, k])
        s["slot_attempt"][ar, v, k] = torch.where(pull, q_attempt, s["slot_attempt"][ar, v, k])
        s["q_head"][ar, v] = torch.where(pull, torch.remainder(head + 1, g.K), head)
        s["q_len"][ar, v] = q_len - pull.to(torch.int32)
        s["started"][ar, v] += pull.to(torch.int32)
        busy = s["busy_int"][ar, v]
        s["busy_int"][ar, v] = torch.where(measured, busy + service, busy)
        wait = s["wait_sum"][ar, v]
        s["wait_sum"][ar, v] = torch.where(measured, wait + (t - q_enq), wait)
        s["wait_n"][ar, v] += measured.to(torch.int32)

    def _transit_arrive(self, s, lanes, v, t, u) -> None:
        ar = self.ar
        row = s["tr_time"][ar, v]
        k = torch.argmin(row, dim=1)
        created = s["tr_created"][ar, v, k]
        s["tr_time"][ar, v, k] = torch.where(lanes, INF, row[ar, k])
        self._arrive(s, lanes, v, t, created, torch.zeros_like(k, dtype=torch.int32), u)

    def step(self, s, u) -> None:
        """One event in every live replica, with its row ``u`` of uniforms."""
        g, ft = self.g, self.ft
        cand = self.candidates(s)
        idx = torch.argmin(cand, dim=1)
        t_next = cand.gather(1, idx[:, None])[:, 0]
        live = ~(torch.isinf(t_next) | (t_next > g.horizon))
        lo = torch.clamp_min(s["t"], g.warmup)
        dt = torch.clamp_min(t_next - lo, 0.0)
        q_len = s["q_len"].to(ft)
        depth = s["depth_int"]
        depth.copy_(torch.where(live[:, None], _fma(q_len, dt[:, None].expand_as(q_len), depth, ft), depth))
        s["t"].copy_(torch.where(live, t_next, s["t"]))
        s["events"] += live.to(torch.int32)
        t = s["t"]
        for i in range(g.nS):
            self._fire(s, i, live & (idx == i), t, u)
        v = torch.clamp(idx - g.nS, 0, g.nV - 1)
        self._complete(s, live & (idx >= g.nS) & (idx < g.nS + g.nV), v, t, u)
        if g.has_transit:
            v = torch.clamp(idx - g.nS - g.nV, 0, g.nV - 1)
            self._transit_arrive(s, live & (idx >= g.nS + g.nV), v, t, u)

    # -- the run -------------------------------------------------------------
    def run(self) -> dict:
        """Every macro-block of every replica until all halt or the event
        budget is spent; returns the totals (:func:`totals`). On a CUDA
        device a block's steps are captured once as a CUDA graph and
        replayed for each block on its uniforms: the same kernels, without
        the host's cost of issuing each."""
        g = self.g
        s = self.init_state()
        blocks = torch.zeros((self.R,), dtype=torch.int32, device=self.dev)
        n_chunks = -(-self.max_events // g.macro)

        def block(U):
            for j in range(g.macro):
                self.step(s, U[:, j, :])

        graph = None
        if self.dev.type == "cuda":
            rows = torch.zeros((self.R, g.macro, g.n_draws), dtype=self.ft, device=self.dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                block(rows)
        halted = self.halted(s)
        for index in range(n_chunks):
            if bool(halted.all()):
                break
            blocks += (~halted).to(torch.int32)
            U = threefry.uniform(threefry.fold_in(self.keys, index), (g.macro, g.n_draws)).to(self.ft)
            if graph is None:
                block(U)
            else:
                rows.copy_(U)
                graph.replay()
            halted = self.halted(s)
        s["blocks"] = blocks
        return totals(g, s, self.R)


def _fixed_sum(x: np.ndarray) -> np.ndarray:
    """The order-free sum over replicas of non-negative float32 columns:
    each value quantised against its column's maximum at a power-of-two
    scale (2**(29 - floor(log2(max)))), the integer quanta summed exactly,
    rescaled in float64."""
    x = np.asarray(x, np.float32)
    m = x.max(axis=0)
    biased = (m.view(np.int32) >> 23) & 0xFF
    scale = (np.clip(283 - biased, 1, 254).astype(np.int32) << 23).view(np.float32)
    scale = np.where(m > 0, scale, np.float32(0.0)).astype(np.float32)
    q = np.rint(x * scale[None]).astype(np.int32).astype(np.int64).sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(scale > 0, q / np.maximum(scale.astype(np.float64), 1e-300), 0.0)


def totals(g: Graph, s: dict, R: int) -> dict:
    """The ensemble's result from the final per-replica state: integer
    counts summed exactly, float sums by :func:`_fixed_sum`, and the
    means, utilisations and queue lengths formed from them."""
    host = {k: v.cpu() for k, v in s.items()}
    isum = lambda key: host[key].to(torch.int64).sum(dim=0).numpy()  # noqa: E731
    fsum = lambda key: _fixed_sum(host[key].to(torch.float32).numpy())  # noqa: E731
    count = isum("sink_count")
    wait_n = isum("wait_n")
    with np.errstate(divide="ignore", invalid="ignore"):
        sink_mean = np.where(count > 0, fsum("sink_sum") / count, 0.0)
        wait_mean = np.where(wait_n > 0, fsum("wait_sum") / wait_n, 0.0)
    denom = R * (g.horizon - g.warmup)
    pending = torch.minimum(
        torch.amin(host["src_next"], dim=1), torch.amin(host["done"], dim=(1, 2))
    )
    if g.has_transit:
        pending = torch.minimum(pending, torch.amin(host["tr_time"], dim=(1, 2)))
    busy, depth = fsum("busy_int"), fsum("depth_int")
    return {
        "simulated_events": int(isum("events")),
        "truncated_replicas": int((pending < g.horizon).sum()),
        "blocks_total": int(isum("blocks")),
        "sink_count": [int(c) for c in count],
        "sink_hist": isum("sink_hist").reshape(g.nK, HIST_BINS),
        "sink_mean_latency_s": [float(m) for m in sink_mean],
        "server_completed": [int(c) for c in isum("completed")],
        "server_dropped": [int(c) for c in isum("dropped")],
        "server_timed_out": [int(c) for c in isum("timed_out")],
        "server_retried": [int(c) for c in isum("retried")],
        "transit_dropped": [int(c) for c in isum("tr_dropped")] if g.has_transit else [0] * g.nV,
        "network_lost": int(isum("net_lost")) if g.has_loss else 0,
        "server_mean_wait_s": [float(w) for w in wait_mean],
        "server_utilization": [
            float(busy[v]) / (denom * int(g.servers[v]["concurrency"])) for v in range(g.nV)
        ],
        "server_mean_queue_len": [float(d) / denom for d in depth],
    }


def simulate(spec: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The totals of one ensemble of ``spec`` keyed by ``seed``."""
    with torch.no_grad():
        return Reference(spec, seed, device, dtype).run()
