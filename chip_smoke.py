#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (happysim_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits nonzero):

1. the device: torch's name for it, and nvidia-smi's name and power limit;
2. the build: the kernels compiled with nvcc for sm_90a from this
   checkout's sources, one nvcc per source (the event-step kernel without
   telemetry or resilience, its telemetry instantiations, its resilience
   instantiations, its consensus instantiations, its instantiations for
   several sources or sinks (three codes by feature set), its
   trace-driven instantiations, its wide code, its partitioned instantiations, the draw
   kernel, the M/M/1 Lindley kernel and the window barrier) started together,
   with ptxas' register and spill report;
   then the draw kernel (csrc/uniform.cu) against rng.uniform, bit for
   bit, on the M/M/1 chain form's gap block (65,536 x 1,514 uniforms),
   timed against its plain version and its bound;
3. block checks at full size, 65,536 replicas and macro_block 32: the
   kernel, drawing its block's uniforms itself from the replica keys and
   the block index, and its plain torch-op version, fed the same block
   drawn by the torch-op threefry, advance identical copies of the state
   and every leaf is compared, on
   - mm1: the M/M/1 (lambda=8, mu=10, horizon 160 s, warmup 40 s),
     blocks 0-3 and 78-81;
   - chain: the 3-stage pipeline, blocks 0 and 40;
   - router: bench.py's bench_kernel_router fan-out (a source swept over
     linspace(4, 38, R) req/s, round_robin over 4 servers with mu=10 and
     queue 256, per-target 5 ms edges alternating constant and
     exponential, transit_capacity 16, horizon 40 s, warmup 10 s),
     blocks 0-3 and 100-101;
   - fanout: the same fan-out under the random policy at a fixed
     lambda=32, horizon 160 s, warmup 40 s (the main path's router run),
     blocks 0-3 and 250-251;
   - graph: bench.py's bench_kernel_graph two-tier least_outstanding DAG
     with a 30 req/s Poisson source in place of its ramp and service
     means swept over linspace(0.1, 0.95, R) / 15, blocks 0-1 and 60;
   - mix: limiter -> random router over [weighted router over s0, s1;
     s2], every server exiting through a weighted router over [sink
     behind a 2 ms exponential edge, s2], blocks 0-1 and 40;
   - mg1-<family>: the M/G/1 of tests/integration/test_tpu_mg1.py
     (lambda=8, mean 0.1, rho=0.8, queue 512, horizon 160 s, warmup
     40 s) once per family: erlang k=2 and k=3, hyperexp service_scv=4,
     lognormal service_scv=2, pareto pareto_alpha=3; blocks 0-3 and 80;
   - families: the chain erlang-3 -> lognormal -> pareto (means 0.05,
     0.08, 0.06 s, lambda=8, horizon 160 s), 3-wide service windows,
     blocks 0 and 40;
   - profile: bench_kernel_graph as bench.py defines it, its 20 -> 40
     req/s ramp over 20 s included, blocks 0-1 and 60;
   - spike: a spike of 20/s over a base of 2/s in [10, 20) wired
     straight to the sink, horizon 30 s, blocks 0-1 and 6;
   - chaos: bench.py's bench_kernel_chaos without its telemetry (a
     limiter before a round-robin over 4 servers with correlated
     outage-mode faults, backoff 0.02 s with jitter 0.5 and 2 retries,
     hedges on the even servers, 5 ms edges with 5% loss on the even
     ones, transit capacity 16, horizon 40 s, the source swept over
     linspace(4, 38, R)), blocks 0-3 and 150;
   - deadline: bench.py's _hetero_model (deadline 8 s, 2 immediate
     retries, horizon 120 s, warmup 20 s, the source swept over
     linspace(1, 9.5, R)), blocks 0-3 and 60;
   - backoff: a 2-server chain with deadline 0.3 s, 3 retries after a
     0.05 s backoff with jitter 0.5, blocks 0-3 and 30;
   - hedged-erlang2: an erlang-2 M/G/1 (lambda=4, mean 0.1) hedged at
     0.2 s, blocks 0-3 and 30;
   - degrade: pinned outage windows and a brownout on one server, then
     pinned degrade windows (half the slots, 3x service) on the next,
     blocks 0-3 and 10;
   - lossy: a lossy line edge with a loss window and lossy router
     targets, blocks 0-3 and 10;
   - telemetry: bench.py's bench_kernel_telemetry model as defined (a
     faulted deadline M/M/1, horizon 40 s, warmup 10 s, 64 windows of
     0.625 s, the source swept over linspace(1, 9.5, R), max_events
     1,584), blocks 0-3 and 24 (the run's last live replicas);
   - chaos-telemetry: the chaos model with bench_kernel_chaos's
     telemetry line (64 windows), blocks 0-3 and 150;
   - hetero-telemetry: bench.py's _hetero_model(telemetry_windows=64),
     blocks 0-3 and 60;
   - mm1-telemetry: the M/M/1 with every metric group, 64 windows of
     2.5 s, blocks 0-3 and 80;
   - pareto-telemetry: the pareto M/G/1 with the same windows, blocks
     0-3 and 80;
   - resilience-fanout: tests/unit/test_kernel_event_step.py's
     _resilience_fanout (the chaos fan-out with 0.5 s windows, a breaker,
     a queue-depth shed with priorities and a retry budget), blocks 0-3
     (the whole run: every replica halts within two blocks);
   - resilience: bench.py's bench_resilience defended arm with its
     telemetry (the deadline M/M/1 at mu=25 behind a pinned outage over
     [12, 18) s, 3 retries after a 1 s backoff, a breaker and a budget,
     16 windows over 40 s, the source swept over linspace(0.45, 0.7, R)
     x mu), blocks 0-3 and 40 (the run's last live replicas);
   - storm: test_tpu_resilience.py's defended retry storm, blocks 0-3 and
     24;
   - shed-mm1: the M/M/1 (lambda=8, mu=10, horizon 160 s, warmup 40 s)
     with utilisation shedding at 1.0, blocks 0-3 and 60;
   - breaker-trip-on-first: the breaker matrix's trip-on-first corner on
     the faulted telemetry chain with a 0.3 s deadline, blocks 0-3 (the
     whole run);
   - two-class: a two-tenant service, two sources into two sinks (source
     0 Poisson 30/s -> least_outstanding over servers 0-3, mu=10, queue
     256 -> sink 0; source 1 a constant 4/s batch job over a 5 ms edge ->
     server 4, mu=8, queue 64 -> sink 1; server 5 wired to sink 1 and fed
     by nothing), horizon 160 s, warmup 40 s, blocks 0-3 and 100, and
     with telemetry (64 windows of 2.5 s), both on the chaos-free code for
     several sources or sinks, two-class-chaos, its chaos arm (1% loss on
     the batch edge, a 0.5 s deadline with one immediate retry on server
     4) on the chaos code without the defenses' and the consensus tier's
     sites, the chaos arm with telemetry (the same code with the
     telemetry sites), and two-class-defended, the chaos arm with a retry
     budget (0.2 tokens a second, bursts of one) on the chaos code with
     every feature's sites, all three codes in csrc/event_step_multi.cu;
   - superpose: two Poisson sources at 5/s and 3/s into one server (mu=10,
     queue 512) -> one sink, horizon 160 s, warmup 40 s, blocks 0-3 and
     80, and superpose-tie: the same with two constant sources at 4/s
     each, which fire at the same times (the kernel breaks the tie to the
     lower source, as JAX's argmin);
   - quorum-defended and quorum-undefended:
     tests/integration/test_tpu_consensus.py's scenario A (a write quorum
     of 2 of 3 servers, servers 1 and 2 cut over [4, 6), backoff retries,
     macro_block 8; the defended arm with a breaker and a retry budget),
     blocks 0-3, 16 and 20 (in and after the cut);
   - flapping-cuts: the undefended arm with 32 cuts of 0.1 s (one every
     0.35 s from 0.5 s) in place of its one, blocks 0-3, 8, 12, 16 and 20;
   - election-bully: its scenario B (flapping cuts under a bully
     election, macro_block 8), blocks 0-3;
   - stochastic-partitions: stochastic cuts of two of three servers drawn
     on the partition stream's salted key, a drop-mode fault schedule on
     the third, a quorum and an election over all three, blocks 0-3.
   Integer leaves must be equal and float leaves are expected bitwise
   equal; a float difference is printed and must stay within rel 1e-6;
   then the whole runs: each model timed below, and the fan-out with
   transit_capacity 64 (its transit rows exceed the shared tile and stay
   in device memory), run at the main path's budget in one launch and by
   chained one-block launches with every row in device memory (the
   previous slice's structure, a host loop stopping once every replica
   halted), and every leaf, the blocks each replica ran and the halted
   mask must be equal bit for bit; each whole-run launch is timed (CUDA
   events) beside its bound: the dense state moved once, the float
   operations of the events it ran, the threefry it counted;
4. timing: the kernel's time per block running blocks 2-21 in one launch
   (as a run's launch runs them), and one block a launch (launched with
   prebuilt arguments), the wrapper's (block_step, tensor checks
   included), the plain version's and the plain version's torch-op
   draw's time per block for mm1, chain, fanout, graph and router (CUDA
   events, after warm-up, every replica live), beside the kernel's bound
   (the bytes a launch must move over 3.35 TB/s: every dense state leaf
   read and written once, the keys and the parameters, and the profile
   tables once, shared by the launch's 20 blocks; ring, transit,
   histogram and router/limiter traffic left out, so a lower bound; the
   operations bound is the larger of the float operations a step needs,
   each service draw's by its family and each profiled source fire's two
   table searches, a transcendental call counted as one operation, over
   67 TFLOP/s, and the 32-bit integer operations of the threefry
   evaluations the kernel counted in the same blocks: their rotates and
   xors over the 64 INT32 lanes an SM (16.7 Tops/s), all of them over
   those and the FMA pipe's IMAD together (33.5 Tops/s)), and
   the same for the lognormal and pareto M/G/1, the profile graph, and
   the chaos and deadline models; the telemetry model with and without
   its spec, and their ratio; and bench_resilience's defended arm (the
   resilience kernel) against its undefended arm (the chaos+telemetry
   kernel), and the same model with inert defenses (the resilience kernel
   on the undefended simulation: the defenses' own cost) against it;
   and the two-tenant service (several sources and sinks), the defended
   quorum arm (the consensus instantiation) and the flapping cuts (the
   same code's consults, at 32 cuts of one group);
5. the main path, run_ensemble on cuda at 65,536 replicas through the
   entry point a user calls, with the launch counts set to 0 just before
   each run and read just after. The event-scan runs name their budget
   (the one the scan takes by default unless stated), so the models the
   chain form takes stay on the scan; each must run its whole budget in
   one kernel launch (timed with CUDA events around it), launch no draw
   kernel and truncate no replica;
   the default calls of the M/M/1, the pipeline and a constant-edge
   random fan-out take the chain form, must launch the draw kernel and
   no event step, and hold the M/M/1 gates, the pipeline's waits within
   1% of its scan run's, the fan-out's gates; every scan run prints its
   kernel share (its launch's device time over its wall time) and the
   host's time, in all and per block:
   - mm1: within 1% of the analytic mean wait rho/(mu-lam) = 0.4 s and
     mean sojourn 1/(mu-lam) = 0.5 s;
   - chain: the 3-stage pipeline, horizon 160 s;
   - fanout: the router model under the random policy at lambda=32,
     horizon 160 s, warmup 40 s; a random split of a Poisson stream is
     four M/M/1 queues at lambda/4=8, mu=10, and a constant or
     exponential edge delay keeps each stream Poisson, so every server's
     mean wait must be within 1% of 0.4 s and the sink's mean latency
     within 1% of 0.5 + 0.005 = 0.505 s, with no transit drop;
   - graph: the graph model above;
   - mg1-<family>: each M/G/1 above, its mean wait within a gate of the
     Pollaczek-Khinchine value rho E[S] (1 + cv^2) / (2 (1 - rho)): 1%
     for erlang-2 and erlang-3, 2% for hyperexp and lognormal, 5% for
     pareto(3), whose wait has no finite variance; no drop, but for
     pareto at most 1e-4 of its jobs (see MG1_FAMILIES);
   - profile: bench_kernel_graph at its max_events, no transit drop;
   - arrivals: a source wired straight to the sink (the models of
     tests/integration/test_tpu_widened.py): a ramp 2 -> 10 over 30 s,
     a spike of 20 over a base of 2 in [10, 20), and the constant-kind
     ramp; the mean arrivals per replica within 0.5% of the tables'
     Lambda(horizon) and within 1% of the analytic integral (180, 240,
     180), and for the constant-kind ramp every replica within 3 of 180
     (read from the state of a block loop of the same model);
   - chaos: the chaos model above at its bench budget (max_events 9,184):
     hedge wins at most the hedges, fault retries booked, and the
     packet losses within 3 sigma of 5% of the crossings on the lossy
     targets (round-robin sends servers 0 and 2 every other delivery from
     the router: ceil(admitted / 2) per replica);
   - deadline-mm1: lambda=8, mu=10, deadline 0.5 s, no retries, horizon
     640 s, warmup 40 s: the sojourn is Exp(mu - lam), so timed out over
     completed within 2% of e^-1, and the mean wait within 1% of 0.4 s;
   - hedged-mm1: lambda=4, mean 0.1, hedge 0.2 s, horizon 160 s: hedged
     over completed within 1% of P(S > 0.2) = e^-2, and hedge wins over
     hedges within 1% of 1/2 (memoryless service);
   - the analytic models of tests/integration/test_tpu_faults.py at this
     script's replica count: the fault drops of Exp(0.2)-gap /
     Exp(1)-duration outages within 3 sigma of the two-state Markov
     closed form, the packet losses of a 20% lossy edge within 3 sigma,
     and a whole-horizon outage's exact retry accounting (fault retries
     = 2 x fault drops);
   - telemetry: the telemetry model at its bench budget: every windowed
     counter sums exactly to its whole-run counter, the windowed
     integrals to within rel 1e-5 of the whole-run ones, and every
     whole-run number equals the same model's run without its spec;
   - mm1-telemetry: averaged over the windows after the warmup, the
     per-replica throughput within 1% of lambda = 8/s, the utilisation
     within 1% of rho = 0.8 and the mean latency within 1% of 0.5 s, and
     p10 <= mean <= p90 of the throughput in every such window;
   - chaos-telemetry: every counter family partitions exactly over the
     windows, packet losses, fault retries and limiter drops all happen,
     fault occupancy lies in [0, 1], and the whole-run counters equal
     the chaos run's without telemetry;
   - duty-cycle-telemetry: the duty-cycle model with only the "faults"
     group and 3 s windows: the mean fault occupancy of windows 1-4
     within 2% of the duty cycle 1/6 (the born-up start lowers the closed
     form there by 0.2%; the statistical spread at this replica count is
     about 0.3%), and the fault drops equal the run without telemetry;
   - resilience: both bench_resilience arms at their bench budget
     (max_events 8,464): the defended arm's goodput recovery (the last
     three windows over windows 1-3) at least 0.9 and above the
     undefended arm's, breaker trips and budget drops above 0, and every
     windowed counter summing exactly to its whole-run counter; with
     inert defenses, every whole-run number equal to the undefended
     arm's and no trip or budget drop;
   - storm: test_tpu_resilience.py's storm pair: the undefended goodput
     of the last three windows below 0.1 of the first two, the defended
     one at least 0.9 of them;
   - cascade: test_tpu_resilience.py's breaker-protected cascade: trips
     at server 1 only, its open fraction 0 in the last two windows;
   - shed-mm1: a mean wait of exactly 0, and the shed share of arrivals
     within 1% of the Erlang loss probability rho / (1 + rho) = 4/9;
   - superpose: the superposed Poisson pair is the M/M/1 at lambda=8, its
     mean wait within 1% of 0.4 s and its sojourn of 0.5 s;
   - two-class, with and without telemetry: server 5 completes nothing,
     sink 1 counts exactly server 4's completions after the warmup (its
     windows from 40 s on; the batch job's last edge is free), the
     windowed counts of both sinks sum exactly to their whole-run counts,
     sink 0's throughput is 30/s a replica within 1%, and the run with
     telemetry equals the run without on every whole-run number;
   - two-class-chaos and two-class-defended: the batch edge's losses
     within 5% of 1% of the batch jobs sent, timeouts and retries at
     server 4 and none at the front servers, and sink 0's throughput
     still 30/s a replica within 1%; the defended arm's budget drops at
     server 4 alone, and fewer retries than the chaos arm's; each run of
     several sources or sinks all on its code of the multi library
     (event_step.launches_by_code);
   - quorum-undefended and quorum-defended (their max_events 1,024): the
     quorum is dark for exactly the cut, quorum_dark_fraction within 1e-6
     of 2/12, partition drops and quorum rejections booked, and the
     defended arm recovers at least 0.9 of its goodput after the heal;
   - election-bully and election-phi_accrual (max_events 256): 6
     elections in every replica (the first and one per flap), exactly,
     and the time without a leader within rel 1e-4 of 6 detection delays
     over the 12 s;
   then the consensus sweeps' set-up time at 65,536 replicas (the
   quorum's, the election's and the stochastic model's);
6. checkpoint and resume at 65,536 replicas on the M/M/1's scan, the
   fan-out, the chaos bench, the telemetry bench model and the defended
   resilience arm, each at the budget above: run_ensemble in
   CHECKPOINT_SEGMENTS segments (one kernel launch each) with no snapshot
   due, then with a snapshot every segment (checkpoint_every_s=0), each
   equal to the one-launch run on every result field but timing, route and
   block counts; the middle snapshot taken while a replica was live,
   through save and load (one npz under build/), resumed and equal again;
   each run's wall beside the one-launch run's;
7. trace-driven arrivals at 65,536 replicas (bench.py's _trace_measure:
   the diurnal trace, 200/s with amplitude 0.6 and period 8 s, and the
   flash crowd, 100/s with 500/s over [4, 6) s, both over 16 s, seed 11,
   in pages of 64 arrivals, into a four-slot server of 4 ms with queue 64
   and a sink, macro_block 16, 2 s windows of throughput, latency and
   rates, max_events 16,384): the trace branch (csrc/event_step_trace.cu)
   against plain_trace_steps from the same state and pages, bit for bit,
   over a whole flash-crowd run (every stream step; every lane stalls at
   the window's edge and ends past the trace's end), a diurnal run, a
   run of the flash crowd beside a Poisson source at 50/s (trace-poisson:
   the chaos-free MULTI code with the trace; every 8th stream step) and
   beside it with a 10 ms deadline and one retry at the server
   (trace-chaos: the MULTI chaos code with the trace; every 8th stream
   step) and with a retry budget besides (trace-defended, 2 tokens a
   second, bursts of two: the whole MULTI chaos code with the trace;
   every 8th stream step); the time per block of the flash crowd, the
   diurnal trace, trace-poisson, trace-chaos and trace-defended in a
   20-block launch with pages of 2,048 (no lane stalls) beside its bound
   and the plain version's; then trace-poisson, trace-chaos and
   trace-defended through run_ensemble, the trace library's launches
   counted by code and timed, the tenants' arrivals exactly 65,536 x the
   trace's, each window's exactly 65,536 x the trace's instants in it,
   timeouts and retries in trace-chaos and trace-defended, budget drops
   in trace-defended and fewer retries than in trace-chaos, each run's
   bound; then both scenarios through
   run_ensemble in pages of 2,048 (the process's first traced runs, which
   pay the pinned allocator's and the side stream's first use) and of 64,
   the trace library's launches counted and timed: the
   tenants' arrivals exactly 65,536 x the trace's, each window's exactly
   65,536 x the trace's instants in it, at most 2 pages resident, pages
   of 64 and of 2,048 giving the same counters, histograms and window
   series, and a snapshot after the fifth stream step (lanes frozen
   mid-page) saved, loaded and resumed equal to the uninterrupted run;
   each run's wall, kernel and host time, stream steps, buffer stall and
   events/s;
8. the M/M/1 ensemble: the Lindley kernel (csrc/mm1_scan.cu) against
   plain_mm1_scan bit for bit on 65,536 replicas over 512 customers; its
   time and the plain version's at 65,536 x 4,096 beside its bound; then
   run_mm1_ensemble(8, 10, 65536, 4096), bench.py's bench_kernel call, in
   one launch, its mean wait within 1% of rho / (mu - lambda) = 0.4 s and
   its mean sojourn within 1% of 0.5 s;
9. the opinion rounds (torch.matmul in full float32, no kernel of the
   port) on 32 populations of 2,048 agents: DeGroot on the card against
   the CPU within rtol 1e-5 and atol 1e-6, bounded confidence a round at
   a time on the same opinions within the same, and the voter model's
   picks at 2,048 agents equal to the CPU's;
10. the wide code (csrc/event_step_wide.cu) at 65,536 replicas, on the
   models past a lean table of the argument struct: wide-fleet (one
   random router over 32 servers, mu = 6, rho = 0.8 each, queue 256,
   horizon 40 s, warmup 10 s), wide-chain (16 exponential stages of mean
   0.1 s at lambda = 8, horizon 160 s, warmup 40 s), wide-tenants (12
   Poisson sources at 1..12/s round-robin over 8 servers of mean 1/15 s,
   horizon 40 s) and wide-quorum (quorum_model's undefended arm over 9
   servers, a write quorum of 5, one partition group a server cut over
   [1 + i, 2 + i)), and wide-draws (the 17-draw hedged erlang-3 fleet, on
   the lean chaos code now that no draw count bounds the kernel), each
   launching the library its tables pick (the wide code's chaos-free
   instantiation for the fleet, the chain and the tenants, its chaos
   code for the quorum): block checks (blocks 0-3 and a
   third of the budget), the whole run in one launch against chained
   one-block launches, and run_ensemble with the port's default budget
   named; the fleet's pooled mean wait within 1% of a numpy Lindley
   reference of its M/M/1 over [10, 40) s (each server within 3%), each
   chain stage's within 1% of the chain form's run of the same model,
   each tenant server's utilization within 1% of 0.65, the quorum's dark
   fraction within rel 1e-6 of the CPU's init sweep, hedges and losses in
   the 17-draw run; the chaos-free wide code's time a block on the fleet
   and the chaos code's on the quorum;
11. the replica mesh: meshes of cuda:0 repeated 1 and 4 times at full
   width, one launch a shard: bench.py's _multichip_measure workload (a
   faulted, telemetered rho-sweep M/M/1, mu = 10, queue 256, deadline 8
   s, 2 retries, FaultSpec(rate 0.05, mean 0.5 s), horizon 30 s, warmup
   5 s, 32 windows, max_events 640, 65,536 replicas, seed 0) with the same
   counters, histogram and every window series on both (bench.py's
   assertion, and every other result field but the mesh's provenance);
   run_mm1_ensemble(8, 10, 65536, 4096) the same on both; a snapshot of
   the 1-shard run resumed on 4 shards and of the 4-shard run on 1, each
   landing on the uninterrupted bits; and the flash crowd of
   _trace_measure the same on both; each wall and redistribution_seconds
   printed;
12. the partitioned executor (run_partitioned) on 8 partitions of cuda:0:
   the window kernel (csrc/event_step_partitioned.cu) and the barrier
   (csrc/partition_barrier.cu) against plain_window_steps and
   plain_barrier after each launch of the first 16 windows at the main
   path's 8 x 8,192 lanes, and over whole runs of 3 s (60 windows) at
   8 x 128 lanes, on
   the JAX package's example ring (examples/tpu/partitioned_ring.py:
   lambda 5, mu 20, queue 256, a random router over the sink and a remote
   of 50 ms), a chaos ring (a brownout, a deadline with backoff retries),
   a two-tenant ring (the code for several sources and sinks) and a ring
   whose two transit registers a server fill (a remote of 200 ms: full
   rows drop, the highest slot pops), each whole run's totals also
   through run_partitioned, and the window checks alone on a ring of nine
   remote egress nodes (past the lean code's table of eight: the wide
   code's remote tables); after every checked launch the transit rows'
   occupancy bound both kernels share and keep (tied to the state's
   tr_time) equals its recomputation; a ring run at 8 x
   8,192 lanes snapshotted every 75 windows, equal to the uninterrupted
   run, and resumed from an npz; the ring at 8 x 8,192 lanes over 30 s
   (600 windows, outboxes of 128) through run_partitioned with both launch
   counts set to 0 just before, one window launch a window, each running
   the previous window's barrier first, and one barrier launch for the
   last window, its pooled sink latency within 2% of the product form's
   0.25 s, no remote or transit drop and no truncated window; the ring's
   600 windows folded and unfolded in turns, four runs each, every run in
   the same state bit for bit, their walls and spread; the run
   again with every launch timed (CUDA events), and each kernel's device
   time a window over windows 100-119, and the gap between the barrier's
   end and the next window's start, both in the window loop and the
   device alone, unfolded and folded, beside their bounds and the plain
   versions' time a window, their state after window 100 equal to the
   kernels'; the folded launches also against the plain versions window
   by window in each window check;
13. the result surface: summary() of the main path's mm1, chaos,
   resilience (defended), quorum (defended), election (bully),
   two-class-defended and telemetry runs, each entity's extras equal bit
   for bit to the result's fields by the JAX engine's rules (names,
   kinds, order, the conditional extras), with the result's event count,
   truncated replicas, replicas and horizon, and backend "cuda"; the
   telemetry run's to_data(), every column of series() but the window
   starts, sampled at the window starts with the column's values; then
   the M/M/1 scan and the flash crowd's traced run (after a warm-up run
   in pages of 2,048) under torch.profiler (CPU and CUDA), their Chrome
   traces under chiprun_out/traces/: one hs.reduce range, one hs.kernel
   and one hs.macro_block range a launch (1, and one a stream step: 38),
   every launch of the event-step kernel in the trace under an hs.kernel
   range (by its launching call's correlation id), and the device ms
   under each scope beside the launches' CUDA-event ms; and the host
   microseconds a record_function range costs with no profiler running,
   times the ranges of each of the two runs.

The last lines are the kernel table as one JSON object, nvidia-smi's name
and power limit, and {"ok": true, "device": {...}}. The table lists the
event-step kernel once per shape or extension, every number of an entry
from one model: mm1, chain, fanout (the router shape), graph, the
lognormal M/G/1 (the family sampler), the profile graph (the profile
tables), the chaos model (the chaos branches) and the telemetry model
(the window buffers), bench_resilience's defended arm (the defenses),
the two-tenant service (several sources and sinks without chaos:
multi-lean), its chaos arm (with chaos: multi) and its defended arm
(the code with every feature's sites: multi-defended), the defended
quorum arm (the consensus tier), the flash crowd (the trace branch),
trace-poisson (the trace library's chaos-free MULTI code:
trace-multi-lean), trace-chaos (its MULTI chaos code: trace-multi) and
trace-defended (its code with every feature's sites:
trace-multi-defended),
the wide fleet (the chaos-free wide code: wide-lean), the wide quorum
(the wide chaos code: wide) and the partitioned ring (the partitioned
instantiation, its launches the run's windows, its time that of a
window's launch with the previous window's barrier folded in, its plain
time that of the window and the barrier together, its bound the window's
bytes and the barrier's merged jobs and outbox lengths, or its
operations),
the models the main path runs, its ms the time per block of a 20-block
launch and its bound that of the same blocks, its launches those of the
main path's run (one a run; for the trace branch one a stream step of
the flash crowd's, trace-poisson's, trace-chaos's or trace-defended's
run); the draw kernel, its
launches those of the M/M/1's chain-form run; the window barrier, its
launches those of the partitioned ring's run (one: the last window's
barrier, the others folded), its time a window as a launch of its own;
and the
Lindley kernel, its launches those of the run_mm1_ensemble call, its
times at 65,536 x 4,096. Every number printed
carries the card's name and power limit.
Details, the router and mix models' included, also go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from happysim_tpu_torch import (
    EnsembleCheckpoint,
    EnsembleModel,
    PartitionedCheckpoint,
    TraceSpec,
    diurnal_trace,
    flash_crowd_trace,
    host_f64,
    mm1_model,
    model_fingerprint,
    opinion,
    partition_mesh,
    pipeline_model,
    rng,
    run_ensemble,
    run_mm1_ensemble,
    run_partitioned,
    sum_f32_fixed,
)
from happysim_tpu_torch.chain import fast_plan
from happysim_tpu_torch.faults import duty_cycle
from happysim_tpu_torch.model import FaultSpec, LeaderElectionSpec
from happysim_tpu_torch.engine import (
    CHECKPOINT_SEGMENTS,
    PROFILER_SCOPES,
    TRACE_PAGING_FIELDS,
    resume_mismatches,
    _Compiled,
    _default_max_events,
    _resolve_params,
)
from happysim_tpu_torch.kernels import (
    build,
    event_step,
    mm1_scan,
    partition_barrier,
    support,
    uniform,
)
from happysim_tpu_torch.partitioned import (
    _PartitionCompiled,
    default_max_events_per_window,
    init_partitions,
    partitioned_result,
    window_end,
)

REPLICAS = 65536
MACRO = 32
LAM, MU = 8.0, 10.0
HORIZON_S, WARMUP_S = 160.0, 40.0
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 rate
# outside the tensor cores; 32-bit integer work at the 1.98 GHz boost
# clock: 64 INT32 lanes an SM issue every add, logic op and shift, and
# the FMA pipe also issues integer adds as IMAD at 64 lanes an SM (CUDA's
# throughput table, compute capability 9.0), so a threefry's rotates and
# xors take the INT32 lanes alone and its adds may share the load.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_INT32_ALU_OPS_PER_S = 132 * 64 * 1.98e9
PEAK_INT32_OPS_PER_S = 132 * 128 * 1.98e9
# Float operations one event step needs per replica, counted low (a log,
# a multiply or divide and an add for the draw, a subtract and a max for
# the interval, a multiply-add per server for the depth integral), so the
# operations bound stays a lower bound.
OPS_PER_STEP_BASE = 5
OPS_PER_STEP_PER_SERVER = 2
# Float operations of one service draw by family id (constant,
# exponential, erlang, hyperexp, lognormal, pareto), a transcendental
# call counted as one: erlang-3 takes one more multiply than erlang-2,
# and lognormal's erfinv is log1p, a root, nine multiply-adds and the
# scaling around them.
OPS_PER_DRAW = {0: 0, 1: 2, 2: 4, 3: 4, 4: 29, 5: 4}
OPS_PER_ERLANG3_DRAW = 5
# Float operations of one profiled source fire: two 9-probe searches of
# the 512-point tables, two lerps and the gap.
OPS_PER_PROFILE_FIRE = 35
FLOAT_RTOL = 1e-6
TIMED_BLOCKS = 20
# Kernel times per block of the previous slice's run (NVIDIA H100 80GB
# HBM3, 700 W), one block a launch with every row in device memory,
# printed beside this run's.
EARLIER_KERNEL_MS = {
    "mm1": 0.0799, "chain": 0.1593, "router": 0.2627, "graph": 0.1349,
    "router-bench": 0.2434, "families": 0.0951, "pareto": 0.0853, "profile": 0.1820,
    "chaos": 0.8014, "deadline": 0.1255, "telemetry": 0.4258,
    "telemetry-off": 0.1364, "resilience": 0.6090, "resilience-off": 1.0401,
    "resilience-inert": 1.2193,
}
# bench.py's Pallas benches: horizon and fan-out width.
BENCH_HORIZON_S = 40.0
N_FANOUT = 4
FANOUT_EDGE_S = 0.005
FANOUT_LAM = 32.0
LIBRARY_NOTE = "none: no single PyTorch call computes an event step"
# The chaos-free code for several sources or sinks without telemetry (a
# key of event_step.launches_by_code).
MULTI_LEAN = ("event_step_multi", "lean", False)
# The M/G/1 families: (server shape, the service's cv^2, the P-K gate,
# the largest share of jobs dropped). Only pareto drops: a uniform at
# its floor (1e-12, one draw in 2^23 of the 23-bit uniform) makes a
# 667 s service, and the 512-slot queue behind it overflows; the JAX
# package drops the same 165 jobs at 8,192 replicas (seed 0).
MG1_MEAN_S = 0.1
MG1_FAMILIES = {
    "erlang2": ({"service": "erlang", "service_k": 2}, 0.5, 0.01, 0.0),
    "erlang3": ({"service": "erlang", "service_k": 3}, 1.0 / 3.0, 0.01, 0.0),
    "hyperexp": ({"service": "hyperexp", "service_scv": 4.0}, 4.0, 0.02, 0.0),
    "lognormal": ({"service": "lognormal", "service_scv": 2.0}, 2.0, 0.02, 0.0),
    # mean-matched pareto(a): cv^2 = (a-1)^2 / (a (a-2)) - 1
    "pareto": ({"service": "pareto", "pareto_alpha": 3.0}, 2.0**2 / (3.0 * 1.0) - 1.0, 0.05, 1e-4),
}
# bench.py's bench_kernel_graph: the ramp's peak rate and its budget.
PEAK_RATE = 40.0
PROFILE_MAX_EVENTS = int(4.0 * PEAK_RATE * BENCH_HORIZON_S) + 64
ARRIVALS_HORIZON_S = 30.0
# Kernels-line entries whose main-path run has another name.
RUN_OF_ENTRY = {
    "families": "mg1-lognormal", "resilience": "resilience-defended", "multi": "two-class-chaos",
    "multi-lean": "two-class", "multi-defended": "two-class-defended",
    "consensus": "quorum-defended",
}
# bench.py's bench_kernel_chaos: servers, their mu, its budget.
CHAOS_SERVERS, CHAOS_MU = 4, 10.0
CHAOS_MAX_EVENTS = int(6.0 * 0.95 * CHAOS_SERVERS * CHAOS_MU * BENCH_HORIZON_S) + 64
CHAOS_LOSS_P = 0.05
# bench.py's _hetero_model: horizon and mu.
HETERO_HORIZON_S, HETERO_MU = 120.0, 10.0
# The deadline M/M/1 gate: sojourn ~ Exp(MU - LAM), so P(T > 0.5 s) = e^-1.
DEADLINE_S, DEADLINE_HORIZON_S = 0.5, 640.0
# The hedged M/M/1: P(S > 0.2 s) = e^-2 of starts hedge, half of those win.
HEDGE_LAM, HEDGE_MEAN_S, HEDGE_DELAY_S = 4.0, 0.1, 0.2
# bench.py's bench_kernel_telemetry: its windows and budget.
TEL_WINDOWS = 64
TEL_MAX_EVENTS = int(4.0 * 9.5 * BENCH_HORIZON_S) + 64
# The M/M/1 and pareto telemetry models' windows: 64 over 160 s.
MM1_WINDOW_S = HORIZON_S / TEL_WINDOWS
# The duty-cycle occupancy gate: windows 1-4 of 3 s against 1/6.
DUTY_WINDOW_S, DUTY_GATE = 3.0, 0.02
# bench.py's bench_resilience: mu, windows, the outage over [0.3, 0.45)
# of the horizon, its budget and its recovery gate (the 0.9 of
# tests/integration/test_tpu_resilience.py).
RES_MU, RES_WINDOWS = 25.0, 16
RES_OUTAGE = (0.3 * BENCH_HORIZON_S, 0.45 * BENCH_HORIZON_S)
RES_MAX_EVENTS = int(12.0 * 0.7 * RES_MU * BENCH_HORIZON_S) + 64
RECOVERY_GATE = 0.9
# test_tpu_resilience.py's storm: mu=50, lambda=32, the outage [2, 4),
# horizon 12 s, and its budget; and its cascade's budget.
STORM_MU, STORM_LAM, STORM_HORIZON_S, STORM_MAX_EVENTS = 50.0, 32.0, 12.0, 6144
CASCADE_MAX_EVENTS = 2048
# The two-tenant service: the web tenant's rate over its 4 servers, the
# batch job's constant rate, its 5 ms edge, and the telemetry windows.
WEB_RATE, BATCH_RATE, BATCH_EDGE_S, TWO_CLASS_WINDOW_S = 30.0, 4.0, 0.005, 2.5
# Its chaos arm: the batch server's deadline and the batch edge's loss;
# its defended arm adds a retry budget of 0.2 tokens a second, bursts of
# one (the whole chaos code for several sources or sinks).
TWO_CLASS_DEADLINE_S, TWO_CLASS_LOSS_P = 0.5, 0.01
TWO_CLASS_BUDGET = {"ratio": 0.0, "min_per_s": 0.2, "burst": 1.0}
# tests/integration/test_tpu_consensus.py's scenarios: the quorum's
# horizon, its cut over [4, 6) and budget; the election's flapping cuts,
# timeout, heartbeat and budget.
CONSENSUS_HORIZON_S = 12.0
QUORUM_CUT = (4.0, 6.0)
QUORUM_MAX_EVENTS, ELECTION_MAX_EVENTS = 1024, 256
# The flapping cuts: 32 cuts of 0.1 s, one every 0.35 s from 0.5 s.
FLAP_CUTS = tuple((0.5 + 0.35 * k, 0.6 + 0.35 * k) for k in range(32))
CUT_HIGH = ((2.0, 4.0), (6.0, 8.0), (10.0, 12.0))
CUT_MID = ((4.0, 6.0), (8.0, 10.0))
ELECTION_HEARTBEAT_S, ELECTION_TIMEOUT_S = 0.4, 1.5


class SmokeFailure(RuntimeError):
    pass


def ptxas_summary(log: str) -> dict:
    """Registers, spill stores and loads and stack of each event-step
    instantiation, from nvcc's -Xptxas -v log, keyed by its template
    arguments ("<4, true, true, true, false, false>")."""
    summary, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '_Z17event_step_kernelI(.*)EEv13EventStepArgs'", line)
        if found:
            args = re.findall(r"L([ib])(\d+)E?", found.group(1))
            name = "<" + ", ".join(
                v if kind == "i" else ("true" if v == "1" else "false") for kind, v in args
            ) + ">"
            summary[name] = {}
        elif "Compiling entry" in line:
            name = None
        elif name and "spill stores" in line and "spill_stores" not in summary[name]:
            numbers = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            summary[name].update(stack=numbers[0], spill_stores=numbers[1], spill_loads=numbers[2])
        elif name and "registers" in line and "registers" not in summary[name]:
            summary[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return summary


def require(condition: bool, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


# -- models ----------------------------------------------------------------
def router_model(policy: str = "round_robin", horizon_s: float = BENCH_HORIZON_S,
                 warmup_s: float = BENCH_HORIZON_S / 4, constant_edges: bool = False,
                 transit_capacity: int = 16) -> EnsembleModel:
    """bench.py's bench_kernel_router fan-out: one source, a router over
    4 servers (mu=10, queue 256) behind 5 ms per-target edges alternating
    constant and exponential (all constant with ``constant_edges``: the
    chain form's fan-out), each server draining to the sink."""
    model = EnsembleModel(
        horizon_s=horizon_s, warmup_s=warmup_s, transit_capacity=transit_capacity,
        macro_block=MACRO,
    )
    src = model.source(rate=FANOUT_LAM)
    servers = [
        model.server(concurrency=1, service_mean=1.0 / MU, queue_capacity=256)
        for _ in range(N_FANOUT)
    ]
    router = model.router(policy=policy)
    snk = model.sink()
    model.connect(src, router)
    for index, server in enumerate(servers):
        model.connect(
            router, server, latency_s=FANOUT_EDGE_S,
            latency_kind="exponential" if index % 2 and not constant_edges else "constant",
        )
        model.connect(server, snk)
    return model


def graph_model(ramp: bool = False) -> EnsembleModel:
    """bench.py's bench_kernel_graph two-tier DAG (least_outstanding front
    tier of 2 servers -> a second least_outstanding router -> shared back
    tier of 2 -> sink) behind its ramp from 20 to 40 req/s over 20 s, or
    (``ramp=False``) a constant 30 req/s Poisson source, the earlier
    stand-in whose time stays comparable."""
    model = EnsembleModel(
        horizon_s=BENCH_HORIZON_S, warmup_s=BENCH_HORIZON_S / 4,
        transit_capacity=16, macro_block=MACRO,
    )
    if ramp:
        src = model.ramp_source(PEAK_RATE / 2, PEAK_RATE, BENCH_HORIZON_S / 2)
    else:
        src = model.source(rate=30.0)
    front = [model.server(concurrency=1, service_mean=0.02, queue_capacity=256) for _ in range(2)]
    back = [model.server(concurrency=1, service_mean=0.02, queue_capacity=256) for _ in range(2)]
    front_lb = model.router(policy="least_outstanding", targets=front)
    back_lb = model.router(policy="least_outstanding", targets=back)
    snk = model.sink()
    model.connect(src, front_lb)
    for server in front:
        model.connect(server, back_lb)
    for server in back:
        model.connect(server, snk)
    return model


def mix_model() -> EnsembleModel:
    """Source 20/s -> limiter (18/s, capacity 8) -> random router over
    [weighted (0.7, 0.3) router over s0, s1; s2]; s0, s1, s2 (service
    0.05 s, concurrency 1, 2, 1) -> weighted (0.8, 0.2) exit router over
    [sink behind a 2 ms exponential edge, s2]."""
    model = EnsembleModel(
        horizon_s=BENCH_HORIZON_S, warmup_s=BENCH_HORIZON_S / 4,
        transit_capacity=16, macro_block=MACRO,
    )
    src = model.source(rate=20.0)
    lim = model.limiter(refill_rate=18.0, capacity=8.0)
    s0 = model.server(service_mean=0.05, concurrency=1)
    s1 = model.server(service_mean=0.05, concurrency=2)
    s2 = model.server(service_mean=0.05, concurrency=1)
    inner = model.router(policy="weighted", targets=[s0, s1], weights=(0.7, 0.3))
    front = model.router(policy="random", targets=[inner, s2])
    snk = model.sink()
    exit_router = model.router(policy="weighted", weights=(0.8, 0.2))
    model.connect(src, lim)
    model.connect(lim, front)
    model.connect(exit_router, snk, latency_s=0.002, latency_kind="exponential")
    model.connect(exit_router, s2)
    for server in (s0, s1, s2):
        model.connect(server, exit_router)
    return model


def mg1_model(family: str) -> EnsembleModel:
    """tests/integration/test_tpu_mg1.py's M/G/1 at this script's size."""
    model = EnsembleModel(horizon_s=HORIZON_S, warmup_s=WARMUP_S, macro_block=MACRO)
    src = model.source(rate=LAM)
    srv = model.server(
        concurrency=1, service_mean=MG1_MEAN_S, queue_capacity=512,
        **MG1_FAMILIES[family][0],
    )
    model.connect(src, srv)
    model.connect(srv, model.sink())
    return model


def families_model() -> EnsembleModel:
    """erlang-3 -> lognormal -> pareto, means 0.05 / 0.08 / 0.06 s."""
    model = EnsembleModel(horizon_s=HORIZON_S, macro_block=MACRO)
    src = model.source(rate=LAM)
    stages = [
        model.server(service_mean=0.05, service="erlang", service_k=3, queue_capacity=512),
        model.server(service_mean=0.08, service="lognormal", service_scv=2.0, queue_capacity=512),
        model.server(service_mean=0.06, service="pareto", pareto_alpha=3.0, queue_capacity=512),
    ]
    model.connect(src, stages[0])
    for upstream, downstream in zip(stages, stages[1:]):
        model.connect(upstream, downstream)
    model.connect(stages[-1], model.sink())
    return model


# Sources wired straight to the sink: (source constructor, analytic Lambda(horizon)).
ARRIVALS = {
    "ramp": (lambda m: m.ramp_source(2.0, 10.0, 30.0), (2.0 + 10.0) / 2 * 30.0),
    "spike": (lambda m: m.spike_source(2.0, 20.0, 10.0, 20.0), 2.0 * 20.0 + 20.0 * 10.0),
    "ramp-constant": (
        lambda m: m.ramp_source(2.0, 10.0, 30.0, kind="constant"), (2.0 + 10.0) / 2 * 30.0
    ),
}


def arrivals_model(kind: str) -> EnsembleModel:
    model = EnsembleModel(horizon_s=ARRIVALS_HORIZON_S, macro_block=MACRO)
    model.connect(ARRIVALS[kind][0](model), model.sink())
    return model


def chaos_model() -> EnsembleModel:
    """bench.py:855 bench_kernel_chaos as defined, without its
    model.telemetry(...) line: source (swept) -> limiter -> round-robin
    over 4 servers (mu=10, queue 256) with correlated outage-mode faults,
    backoff 0.02 s with jitter 0.5 and 2 retries, hedges at 0.03 s on the
    even servers, 5 ms edges alternating constant and exponential with
    5% loss on the even ones, transit capacity 16."""
    model = EnsembleModel(horizon_s=BENCH_HORIZON_S, transit_capacity=16, macro_block=MACRO)
    src = model.source(rate=9.5)
    lim = model.limiter(refill_rate=1.3 * 0.95 * CHAOS_SERVERS * CHAOS_MU, capacity=16.0)
    servers = [
        model.server(
            concurrency=1, service_mean=1.0 / CHAOS_MU, queue_capacity=256, max_retries=2,
            retry_backoff_s=0.02, retry_jitter=0.5,
            hedge_delay_s=0.3 / CHAOS_MU if index % 2 == 0 else None,
            fault=FaultSpec(rate=0.05, mean_duration_s=0.5, correlated=True),
        )
        for index in range(CHAOS_SERVERS)
    ]
    model.correlated_outages(rate=0.02, mean_duration_s=0.5, trigger_p=0.5)
    router = model.router(policy="round_robin")
    snk = model.sink()
    model.connect(src, lim)
    model.connect(lim, router)
    for index, server in enumerate(servers):
        model.connect(
            router, server, latency_s=0.005,
            latency_kind="exponential" if index % 2 else "constant",
            loss_p=CHAOS_LOSS_P if index % 2 == 0 else 0.0,
        )
        model.connect(server, snk)
    return model


def hetero_model() -> EnsembleModel:
    """bench.py:357 _hetero_model: the deadline M/M/1 (deadline 8 s, 2
    immediate retries) of the rho sweep, horizon 120 s, warmup 20 s."""
    model = EnsembleModel(horizon_s=HETERO_HORIZON_S, warmup_s=20.0, macro_block=MACRO)
    src = model.source(rate=9.5)
    srv = model.server(
        concurrency=1, service_mean=1.0 / HETERO_MU, queue_capacity=256,
        deadline_s=8.0, max_retries=2,
    )
    model.connect(src, srv)
    model.connect(srv, model.sink())
    return model


def backoff_model() -> EnsembleModel:
    """Two servers (means 0.08, 0.06 s, queue 64), each with deadline
    0.3 s and 3 retries after a 0.05 s backoff with jitter 0.5."""
    model = EnsembleModel(horizon_s=BENCH_HORIZON_S, warmup_s=10.0, transit_capacity=16, macro_block=MACRO)
    src = model.source(rate=LAM)
    kw = dict(queue_capacity=64, deadline_s=0.3, max_retries=3, retry_backoff_s=0.05, retry_jitter=0.5)
    a = model.server(service_mean=0.08, **kw)
    b = model.server(service_mean=0.06, **kw)
    model.connect(src, a)
    model.connect(a, b)
    model.connect(b, model.sink())
    return model


def hedged_model(service: str = "exponential", horizon_s: float = HORIZON_S, **shape) -> EnsembleModel:
    """tests/integration/test_tpu_faults.py's hedged M/M/1 (lambda=4,
    mean 0.1, hedge 0.2 s), or its server with another family."""
    model = EnsembleModel(horizon_s=horizon_s, macro_block=MACRO)
    src = model.source(rate=HEDGE_LAM)
    srv = model.server(
        service_mean=HEDGE_MEAN_S, service=service, queue_capacity=256,
        hedge_delay_s=HEDGE_DELAY_S, **shape,
    )
    model.connect(src, srv)
    model.connect(srv, model.sink())
    return model


def degrade_model() -> EnsembleModel:
    """An outage-mode server with pinned windows and a brownout over its
    first window, then a 2-slot server pinned to 1 slot and 3x service
    inside its windows, lambda=8, horizon 20 s."""
    model = EnsembleModel(horizon_s=20.0, warmup_s=1.0, macro_block=MACRO)
    src = model.source(rate=LAM)
    a = model.server(
        service_mean=0.05, queue_capacity=64, outage=(4.0, 6.0),
        fault=FaultSpec(windows=((3.0, 5.0), (9.0, 11.0)), mode="outage"),
    )
    b = model.server(
        concurrency=2, service_mean=0.15, queue_capacity=64,
        fault=FaultSpec(
            windows=((2.0, 6.0), (12.0, 15.0)), mode="degrade",
            capacity_factor=0.5, latency_factor=3.0,
        ),
    )
    model.connect(src, a)
    model.connect(a, b)
    model.connect(b, model.sink())
    return model


def lossy_model() -> EnsembleModel:
    """A 20% lossy edge open over [4, 12) into a server, a random router
    over a 10% lossy 5 ms edge to a second server and a 30% lossy edge to
    the sink, and a 5% lossy exit, lambda=8, horizon 20 s."""
    model = EnsembleModel(horizon_s=20.0, transit_capacity=8, macro_block=MACRO)
    src = model.source(rate=LAM)
    a = model.server(service_mean=0.05, queue_capacity=64)
    b = model.server(service_mean=0.05, queue_capacity=64)
    router = model.router(policy="random")
    snk = model.sink()
    model.connect(src, a, loss_p=0.2, loss_window=(4.0, 12.0))
    model.connect(a, router)
    model.connect(router, b, latency_s=0.005, loss_p=0.1)
    model.connect(router, snk, loss_p=0.3)
    model.connect(b, snk, loss_p=0.05)
    return model


def deadline_mm1_model() -> EnsembleModel:
    """The M/M/1 (lambda=8, mu=10) with a 0.5 s deadline and no retries,
    horizon 640 s, warmup 40 s."""
    model = EnsembleModel(horizon_s=DEADLINE_HORIZON_S, warmup_s=WARMUP_S, macro_block=MACRO)
    src = model.source(rate=LAM)
    srv = model.server(service_mean=1.0 / MU, queue_capacity=256, deadline_s=DEADLINE_S)
    model.connect(src, srv)
    model.connect(srv, model.sink())
    return model


def duty_model() -> EnsembleModel:
    """test_tpu_faults.py's duty-cycle model: lambda=4, Exp(0.2) gaps
    between Exp(1) outages (up to 24 windows), horizon 30 s."""
    model = EnsembleModel(horizon_s=30.0, macro_block=MACRO)
    src = model.source(rate=4.0)
    srv = model.server(
        service_mean=0.02, queue_capacity=512,
        fault=FaultSpec(rate=0.2, mean_duration_s=1.0, max_windows=24),
    )
    model.connect(src, srv)
    model.connect(srv, model.sink())
    return model


def loss_model() -> EnsembleModel:
    """test_tpu_faults.py's packet-loss model: 10/s constant arrivals
    until 28 s across a 20% lossy edge, horizon 30 s."""
    model = EnsembleModel(horizon_s=30.0, macro_block=MACRO)
    src = model.source(rate=10.0, kind="constant", stop_after_s=28.0)
    srv = model.server(service_mean=0.001, service="constant", queue_capacity=256)
    model.connect(src, srv, loss_p=0.2)
    model.connect(srv, model.sink())
    return model


def retry_accounting_model() -> EnsembleModel:
    """test_tpu_faults.py's exact retry accounting: a whole-horizon
    outage, 2 retries after a 0.01 s backoff, 10/s constant arrivals
    until 28 s, horizon 30 s."""
    model = EnsembleModel(horizon_s=30.0, macro_block=MACRO)
    src = model.source(rate=10.0, kind="constant", stop_after_s=28.0)
    srv = model.server(
        service_mean=0.05, queue_capacity=256,
        fault=FaultSpec(windows=((0.0, 31.0),), mode="outage"),
        retry_backoff_s=0.01, max_retries=2,
    )
    model.connect(src, srv)
    model.connect(srv, model.sink())
    return model


def telemetry_model(windows: int = TEL_WINDOWS) -> EnsembleModel:
    """bench.py:454 bench_kernel_telemetry's model: the faulted deadline
    M/M/1 (mu=10, queue 256, deadline 8 s, 2 immediate retries, outage
    windows at rate 0.05 lasting 0.5 s), horizon 40 s, warmup 10 s, with
    ``windows`` windows (0: without telemetry)."""
    model = EnsembleModel(horizon_s=BENCH_HORIZON_S, warmup_s=BENCH_HORIZON_S / 4, macro_block=MACRO)
    src = model.source(rate=9.5)
    srv = model.server(
        concurrency=1, service_mean=1.0 / HETERO_MU, queue_capacity=256, deadline_s=8.0,
        max_retries=2, fault=FaultSpec(rate=0.05, mean_duration_s=0.5),
    )
    model.connect(src, srv)
    model.connect(srv, model.sink())
    if windows:
        model.telemetry(window_s=BENCH_HORIZON_S / windows)
    return model


def resilience_bench_model(defended: bool) -> EnsembleModel:
    """bench.py:1084 bench_resilience's model: the deadline M/M/1 at mu=25
    (queue 512, deadline 0.5 s, 3 retries after a 1 s backoff) behind an
    outage pinned over [12, 18) s in every replica, transit capacity 64,
    16 windows of throughput and rates over 40 s; defended, a breaker (5
    failures in 1 s, cooldown 0.5 s, 2 probes) and a retry budget (0.1
    per request, 0.5/s, burst 4)."""
    model = EnsembleModel(horizon_s=BENCH_HORIZON_S, transit_capacity=64, macro_block=MACRO)
    src = model.source(rate=0.6 * RES_MU)
    srv = model.server(
        concurrency=1, service_mean=1.0 / RES_MU, queue_capacity=512, deadline_s=0.5,
        max_retries=3, retry_backoff_s=1.0, fault=FaultSpec(windows=(RES_OUTAGE,)),
    )
    model.connect(src, srv)
    model.connect(srv, model.sink())
    model.telemetry(window_s=BENCH_HORIZON_S / RES_WINDOWS, metrics=("throughput", "rates"))
    if defended:
        model.circuit_breaker(failure_threshold=5, window_s=1.0, cooldown_s=0.5, half_open_probes=2)
        model.retry_budget(ratio=0.1, min_per_s=0.5, burst=4.0)
    return model


def inert_defenses(model: EnsembleModel) -> EnsembleModel:
    """Install a breaker and a retry budget that can never act on
    bench_resilience's model: 1,000 failures within 1 ms never happen
    there, and a bucket born at 1e9 tokens never runs dry. The defenses
    keep their books, but the simulation is the undefended one, so its
    kernel time against the undefended arm's is the defenses' own cost."""
    model.circuit_breaker(failure_threshold=1000, window_s=1e-3, cooldown_s=0.5, half_open_probes=2)
    model.retry_budget(ratio=0.1, min_per_s=0.5, burst=1e9)
    return model


def storm_model(defended: bool) -> EnsembleModel:
    """tests/integration/test_tpu_resilience.py:48's storm: the M/M/1 at
    rho=0.64 (mu=50, lambda=32, queue 512) with a 0.25 s deadline and 3
    retries after a 0.5 s backoff, an outage pinned over [2, 4), 1 s
    windows; defended as bench_resilience is."""
    model = EnsembleModel(horizon_s=STORM_HORIZON_S, transit_capacity=64, macro_block=MACRO)
    src = model.source(rate=STORM_LAM)
    srv = model.server(
        service_mean=1.0 / STORM_MU, queue_capacity=512, deadline_s=0.25, max_retries=3,
        retry_backoff_s=0.5, fault=FaultSpec(windows=((2.0, 4.0),)),
    )
    model.connect(src, srv)
    model.connect(srv, model.sink())
    model.telemetry(window_s=1.0, metrics=("throughput", "rates"))
    if defended:
        model.circuit_breaker(failure_threshold=5, window_s=1.0, cooldown_s=0.5, half_open_probes=2)
        model.retry_budget(ratio=0.1, min_per_s=0.5, burst=4.0)
    return model


def cascade_model() -> EnsembleModel:
    """test_tpu_resilience.py:191's cascade: source (20/s) -> A -> B ->
    sink (mu=50, queue 128), B browned out over [3, 4), a breaker of 4
    failures in 0.5 s, cooldown 0.4 s, 1 probe, 1 s windows over 10 s."""
    model = EnsembleModel(horizon_s=10.0, macro_block=MACRO)
    src = model.source(rate=20.0)
    first = model.server(service_mean=1.0 / STORM_MU, queue_capacity=128)
    second = model.server(service_mean=1.0 / STORM_MU, queue_capacity=128, outage=(3.0, 4.0))
    model.connect(src, first)
    model.connect(first, second)
    model.connect(second, model.sink())
    model.telemetry(window_s=1.0, metrics=("throughput", "rates"))
    model.circuit_breaker(failure_threshold=4, window_s=0.5, cooldown_s=0.4, half_open_probes=1)
    return model


def shed_mm1_model() -> EnsembleModel:
    """The M/M/1 (lambda=8, mu=10, horizon 160 s, warmup 40 s) with
    utilisation shedding at 1.0: an arrival that finds the server busy is
    shed, so no job waits (an M/M/1/1 loss system)."""
    model = mm1_model(LAM, MU, HORIZON_S, warmup_s=WARMUP_S)
    model.macro_block = MACRO
    model.load_shed(policy="utilization", threshold=1.0)
    return model


def resilience_fanout_model() -> EnsembleModel:
    """tests/unit/test_kernel_event_step.py:161 _resilience_fanout: the
    chaos fan-out (a limiter, a round-robin over 4 servers with deadline
    0.6 s and 2 backoff retries with jitter 0.5, hedges on the even
    servers, correlated faults on the first two, a brownout on the last,
    lossy even edges, 0.5 s windows over 2 s) with a breaker (2 in 0.5 s,
    cooldown 0.3 s, 1 probe), a queue-depth shed at 2 exempting a quarter
    of the traffic and a budget (0.2 per request, 0.5/s, burst 2)."""
    model = EnsembleModel(horizon_s=2.0, transit_capacity=8, macro_block=MACRO)
    src = model.source(rate=6.0)
    lim = model.limiter(refill_rate=8.0, capacity=4.0)
    servers = [
        model.server(
            service_mean=0.05, queue_capacity=8, deadline_s=0.6, max_retries=2,
            retry_backoff_s=0.05, retry_jitter=0.5,
            hedge_delay_s=0.15 if index % 2 == 0 else None,
            fault=FaultSpec(rate=0.4, mean_duration_s=0.3, correlated=True) if index < 2 else None,
            outage=(0.8, 1.1) if index == 3 else None,
        )
        for index in range(4)
    ]
    model.correlated_outages(rate=0.3, mean_duration_s=0.3, trigger_p=0.5)
    router = model.router(policy="round_robin")
    snk = model.sink()
    model.connect(src, lim)
    model.connect(lim, router)
    edge_mix = [(0.01, "constant"), (0.02, "exponential"), (0.0, "constant")]
    for index, server in enumerate(servers):
        latency_s, kind = edge_mix[index % len(edge_mix)]
        model.connect(
            router, server, latency_s=latency_s, latency_kind=kind,
            loss_p=0.05 if index % 2 == 0 else 0.0,
        )
        model.connect(server, snk)
    model.telemetry(window_s=0.5)
    model.circuit_breaker(failure_threshold=2, window_s=0.5, cooldown_s=0.3, half_open_probes=1)
    model.load_shed(policy="queue_depth", threshold=2, priority_fraction=0.25)
    model.retry_budget(ratio=0.2, min_per_s=0.5, burst=2.0)
    return model


def breaker_corner_model() -> EnsembleModel:
    """test_kernel_event_step.py:344's breaker matrix, its trip-on-first
    corner (threshold 1, window 0.2 s, cooldown 0.2 s, 1 probe), on the
    faulted telemetry chain (a 20 ms exponential edge into a server with
    outage faults and a 0.3 s deadline, a 10 ms edge into an erlang-2
    server with degrade faults, 0.5 s windows over 2 s)."""
    model = EnsembleModel(horizon_s=2.0, macro_block=MACRO)
    src = model.source(rate=4.0)
    first = model.server(
        service_mean=0.05, queue_capacity=8, deadline_s=0.3,
        fault=FaultSpec(rate=0.8, mean_duration_s=0.2),
    )
    second = model.server(
        service_mean=0.07, queue_capacity=8, service="erlang",
        fault=FaultSpec(rate=0.5, mean_duration_s=0.3, mode="degrade", latency_factor=2.0),
    )
    model.connect(src, first, latency_s=0.02, latency_kind="exponential")
    model.connect(first, second, latency_s=0.01)
    model.connect(second, model.sink())
    model.telemetry(window_s=0.5)
    model.circuit_breaker(failure_threshold=1, window_s=0.2, cooldown_s=0.2, half_open_probes=1)
    return model


def superpose_model(kind: str = "poisson", rates=(5.0, 3.0)) -> EnsembleModel:
    """Two sources superposed on one server (mu = 10, queue 512) -> one
    sink, horizon 160 s, warmup 40 s: at 5/s and 3/s Poisson the M/M/1 at
    lambda = 8; two constant sources at one rate fire at the same times
    (the tie the kernel breaks to the lower source, as JAX's argmin)."""
    model = EnsembleModel(horizon_s=HORIZON_S, warmup_s=WARMUP_S, macro_block=MACRO)
    srv = model.server(service_mean=1.0 / MU, queue_capacity=512)
    for rate in rates:
        model.connect(model.source(rate=rate, kind=kind), srv)
    model.connect(srv, model.sink())
    return model


def two_class_model(window_s=None, chaos: bool = False, defended: bool = False) -> EnsembleModel:
    """A two-tenant service, horizon 160 s, warmup 40 s: source 0 (Poisson
    30/s) -> least_outstanding over servers 0-3 (mu = 10, queue 256) ->
    sink 0; source 1 (a constant 4/s batch job) over a 5 ms constant edge
    -> server 4 (mu = 8, queue 64) -> sink 1; server 5, wired to sink 1,
    fed by nothing. ``chaos``: the batch edge loses 1% of its jobs and
    server 4 times a job out after 0.5 s and retries it once at its
    queue's tail (the chaos code for several sources or sinks without
    the defenses' sites); ``defended`` (with chaos): a retry budget
    (TWO_CLASS_BUDGET) holds the retries back (the whole chaos code)."""
    model = EnsembleModel(horizon_s=HORIZON_S, warmup_s=WARMUP_S, macro_block=MACRO)
    web = model.source(rate=WEB_RATE)
    batch = model.source(rate=BATCH_RATE, kind="constant")
    router = model.router(policy="least_outstanding")
    front = [model.server(service_mean=0.1, queue_capacity=256) for _ in range(N_FANOUT)]
    retry = dict(deadline_s=TWO_CLASS_DEADLINE_S, max_retries=1) if chaos else {}
    back = model.server(service_mean=0.125, queue_capacity=64, **retry)
    spare = model.server(service_mean=0.125, queue_capacity=64)
    web_sink, batch_sink = model.sink(), model.sink()
    model.connect(web, router)
    for server in front:
        model.connect(router, server)
        model.connect(server, web_sink)
    loss = dict(loss_p=TWO_CLASS_LOSS_P) if chaos else {}
    model.connect(batch, back, latency_s=BATCH_EDGE_S, **loss)
    model.connect(back, batch_sink)
    model.connect(spare, batch_sink)
    if window_s is not None:
        model.telemetry(window_s=window_s)
    if defended:
        model.retry_budget(**TWO_CLASS_BUDGET)
    return model


def quorum_model(defended: bool) -> EnsembleModel:
    """TestQuorumLossUnderPartition._build (tests/integration/
    test_tpu_consensus.py:83): a constant 6/s source round-robin over 3
    servers behind 10 ms edges (mean 0.1 s, queue 16, 3 retries after a
    0.1 s backoff with jitter 0.5), 1 s windows over 12 s, macro_block 8,
    servers 1 and 2 cut together over [4, 6), a write quorum of 2 of 3;
    the defended arm adds a breaker and a retry budget."""
    model = EnsembleModel(horizon_s=CONSENSUS_HORIZON_S, macro_block=8, transit_capacity=16)
    src = model.source(rate=6.0, kind="constant")
    servers = [
        model.server(service_mean=0.1, queue_capacity=16, max_retries=3, retry_backoff_s=0.1,
                     retry_jitter=0.5)
        for _ in range(3)
    ]
    router = model.router(policy="round_robin")
    snk = model.sink()
    model.connect(src, router)
    for server in servers:
        model.connect(router, server, latency_s=0.01, latency_kind="constant")
        model.connect(server, snk)
    model.telemetry(window_s=1.0)
    model.network_partition(group=[servers[1], servers[2]], windows=(QUORUM_CUT,))
    model.quorum(servers, write=2, read=2)
    if defended:
        model.circuit_breaker(failure_threshold=3, window_s=0.5, cooldown_s=0.5, half_open_probes=1)
        model.retry_budget(ratio=0.1, min_per_s=0.5, burst=2.0)
    return model


def flapping_cuts_model() -> EnsembleModel:
    """quorum_model's undefended arm with its one cut replaced by
    FLAP_CUTS, 32 cuts of 0.1 s of servers 1 and 2 (the quorum lost in
    each), macro_block 8: a group of many short windows, which the
    consensus code's consults scan at every arrival and delivery."""
    model = quorum_model(False)
    model.network_partitions[0] = dataclasses.replace(model.network_partitions[0], windows=FLAP_CUTS)
    return model


def election_model(strategy: str) -> EnsembleModel:
    """TestElectionStormUnderFlappingPartitions._build (:223): a constant
    2/s source round-robin over 3 servers, 1 s windows over 12 s,
    macro_block 8, back-to-back 2 s cuts alternating between servers 2
    and 1, an election over the three (heartbeat 0.4 s, timeout 1.5 s)."""
    model = EnsembleModel(horizon_s=CONSENSUS_HORIZON_S, macro_block=8)
    src = model.source(rate=2.0, kind="constant")
    servers = [model.server(service_mean=0.05, queue_capacity=8) for _ in range(3)]
    router = model.router(policy="round_robin")
    snk = model.sink()
    model.connect(src, router)
    for server in servers:
        model.connect(router, server)
        model.connect(server, snk)
    model.telemetry(window_s=1.0)
    model.network_partition(group=[servers[2]], windows=CUT_HIGH)
    model.network_partition(group=[servers[1]], windows=CUT_MID)
    model.leader_election(servers, heartbeat_s=ELECTION_HEARTBEAT_S, timeout_s=ELECTION_TIMEOUT_S,
                          strategy=strategy)
    return model


def stochastic_partition_model() -> EnsembleModel:
    """Stochastic cuts drawn on the salted stream: servers 0 and 1 of a
    Poisson 8/s random fan-out over 3 servers cut together (Exp gaps at
    0.3/s, Exp durations of mean 1 s, each candidate firing with
    probability 0.7, 6 windows), a drop-mode fault schedule on server 2,
    and over all three a write quorum of 2 and a bully election (heartbeat
    0.2 s, timeout 0.5 s), horizon 12 s, macro_block 16."""
    model = EnsembleModel(horizon_s=CONSENSUS_HORIZON_S, macro_block=16)
    src = model.source(rate=8.0)
    servers = [model.server(service_mean=0.08, queue_capacity=16) for _ in range(2)] + [
        model.server(service_mean=0.08, queue_capacity=16,
                     fault=FaultSpec(rate=0.2, mean_duration_s=0.5, max_windows=6))
    ]
    router = model.router(policy="random")
    snk = model.sink()
    model.connect(src, router)
    for server in servers:
        model.connect(router, server)
        model.connect(server, snk)
    model.network_partition(group=servers[:2], rate=0.3, mean_duration_s=1.0, trigger_p=0.7,
                            max_windows=6)
    model.quorum(servers, write=2, read=2)
    model.leader_election(servers, heartbeat_s=0.2, timeout_s=0.5)
    return model


# The wide code's models, each past a lean table of the argument struct
# (kernels/support.py::wide_reasons) but the draws' (past the old bound of
# 16 uniforms a step, which bounds nothing now). Each function takes the
# EnsembleModel class, so the CPU tests build the same model in the JAX
# package. The fleet: test_tpu_widened.py's fleet (mu = 6) widened to 32
# servers behind one random router at rho = 0.8 each; the chain: 16
# exponential stages of mean 0.1 s at lambda = 8; the tenants: 12 Poisson
# sources at 1, 2, ..., 12/s round-robin over 8 servers of mean 1/15 s
# (rho = 0.65); the quorum: quorum_model widened to 9 servers and a write
# quorum of 5, a group a server, group i cut over [1 + i, 2 + i).
WIDE_SERVERS, WIDE_FLEET_MU, WIDE_RHO = 32, 6.0, 0.8
WIDE_STAGES = 16
WIDE_TENANTS, WIDE_TENANT_SERVERS, WIDE_TENANT_MU = 12, 8, 15.0
WIDE_QUORUM_SERVERS, WIDE_QUORUM_WRITE = 9, 5
WIDE_HORIZON_S = 40.0


def wide_fleet_model(cls=EnsembleModel, servers: int = WIDE_SERVERS,
                     horizon_s: float = WIDE_HORIZON_S) -> EnsembleModel:
    """A Poisson source at 0.8 * servers * 6/s -> one random router ->
    ``servers`` servers (mu = 6, queue 256) -> the sink, warmup a quarter
    of the horizon (10 s):
    each server an M/M/1 at rho = 0.8, its mean wait 0.8 / (6 - 4.8)."""
    model = cls(horizon_s=horizon_s, warmup_s=horizon_s / 4.0, macro_block=MACRO)
    src = model.source(rate=WIDE_RHO * servers * WIDE_FLEET_MU)
    router = model.router(policy="random")
    snk = model.sink()
    model.connect(src, router)
    for _ in range(servers):
        srv = model.server(service_mean=1.0 / WIDE_FLEET_MU, queue_capacity=256)
        model.connect(router, srv)
        model.connect(srv, snk)
    return model


def wide_chain_model(cls=EnsembleModel, stages: int = WIDE_STAGES,
                     horizon_s: float = HORIZON_S) -> EnsembleModel:
    """A Poisson 8/s source through ``stages`` FIFO servers of
    exponential mean 0.1 s (queue 512) to the sink, warmup a quarter of
    the horizon: each stage an M/M/1 at rho = 0.8, its mean wait 0.4 s."""
    model = cls(horizon_s=horizon_s, warmup_s=horizon_s / 4.0, macro_block=MACRO)
    node = model.source(rate=LAM)
    for _ in range(stages):
        srv = model.server(service_mean=1.0 / MU, queue_capacity=512)
        model.connect(node, srv)
        node = srv
    model.connect(node, model.sink())
    return model


def wide_draws_model(cls=EnsembleModel, horizon_s: float = WIDE_HORIZON_S) -> EnsembleModel:
    """tests/test_torch_chaos.py's _wide_draws: erlang-3 hedged servers
    behind two levels of random routers with exponential, lossy edges,
    1 + 2 + 2*3 + 2*3 + 1 + 1 = 17 uniforms a step."""
    model = cls(horizon_s=horizon_s, macro_block=MACRO)
    src = model.source(rate=5.0)
    inner = model.router(policy="random")
    outer = model.router(policy="random")
    snk = model.sink()
    model.connect(src, outer)
    model.connect(outer, inner)
    for _ in range(2):
        srv = model.server(service="erlang", service_k=3, hedge_delay_s=0.1)
        model.connect(inner, srv, latency_s=0.01, latency_kind="exponential", loss_p=0.1)
        model.connect(srv, snk)
    return model


def wide_tenants_model(cls=EnsembleModel, tenants: int = WIDE_TENANTS,
                       horizon_s: float = WIDE_HORIZON_S) -> EnsembleModel:
    """``tenants`` Poisson sources at 1, 2, ..., tenants/s -> one
    round-robin router -> 8 servers (mu = 15, queue 256) -> one sink: 78/s
    in all at 12 tenants, each server at rho = 78 / 8 / 15 = 0.65."""
    model = cls(horizon_s=horizon_s, macro_block=MACRO)
    router = model.router(policy="round_robin")
    for rate in range(1, tenants + 1):
        model.connect(model.source(rate=float(rate)), router)
    snk = model.sink()
    for _ in range(WIDE_TENANT_SERVERS):
        srv = model.server(service_mean=1.0 / WIDE_TENANT_MU, queue_capacity=256)
        model.connect(router, srv)
        model.connect(srv, snk)
    return model


def wide_quorum_model(cls=EnsembleModel, servers: int = WIDE_QUORUM_SERVERS,
                      write: int = WIDE_QUORUM_WRITE) -> EnsembleModel:
    """quorum_model's undefended arm widened: a constant 2 * servers/s
    source round-robin over ``servers`` servers behind 10 ms edges (each
    still sees 2/s), a write quorum of ``write``, and one partition group
    a server, group i cutting server i off over [1 + i, 2 + i)."""
    model = cls(horizon_s=CONSENSUS_HORIZON_S, macro_block=8, transit_capacity=16)
    src = model.source(rate=2.0 * servers, kind="constant")
    members = [
        model.server(service_mean=0.1, queue_capacity=16, max_retries=3, retry_backoff_s=0.1,
                     retry_jitter=0.5)
        for _ in range(servers)
    ]
    router = model.router(policy="round_robin")
    snk = model.sink()
    model.connect(src, router)
    for server in members:
        model.connect(router, server, latency_s=0.01, latency_kind="constant")
        model.connect(server, snk)
    model.telemetry(window_s=1.0)
    for i, server in enumerate(members):
        model.network_partition(group=[server], windows=((1.0 + i, 2.0 + i),))
    model.quorum(members, write=write, read=write)
    return model


def with_telemetry(model: EnsembleModel, window_s: float, **kw) -> EnsembleModel:
    model.telemetry(window_s=window_s, **kw)
    return model


def pk_wait(scv: float) -> float:
    """Pollaczek-Khinchine mean wait of the M/G/1 at lambda=LAM."""
    rho = LAM * MG1_MEAN_S
    return rho * MG1_MEAN_S * (1.0 + scv) / (2.0 * (1.0 - rho))


ROUTER_SWEEPS = {
    "source_rate": np.linspace(0.1 * N_FANOUT * MU, 0.95 * N_FANOUT * MU, REPLICAS).astype(np.float32)
}
# The ramp averages 0.75 * 40 req/s over 2 servers per tier.
GRAPH_SWEEPS = {
    "service_mean": (np.linspace(0.1, 0.95, REPLICAS) / (0.75 * 40.0 / 2)).astype(np.float32)
}
# bench_kernel_chaos's and _hetero_model's rho sweeps.
CHAOS_SWEEPS = {
    "source_rate": np.linspace(
        0.1 * CHAOS_SERVERS * CHAOS_MU, 0.95 * CHAOS_SERVERS * CHAOS_MU, REPLICAS
    ).astype(np.float32)
}
HETERO_SWEEPS = {
    "source_rate": np.linspace(0.1 * HETERO_MU, 0.95 * HETERO_MU, REPLICAS).astype(np.float32)
}
# bench_resilience's sweep, confined to the metastable band.
RES_SWEEPS = {
    "source_rate": np.linspace(0.45 * RES_MU, 0.7 * RES_MU, REPLICAS).astype(np.float32)
}


# -- block checks and timing -------------------------------------------------
def int_ms(int_ops: float, alu_ops: float) -> float:
    """Least milliseconds for ``int_ops`` 32-bit integer operations of
    which ``alu_ops`` only the INT32 lanes issue (the rest may also go to
    the FMA pipe as IMAD)."""
    return max(alu_ops / PEAK_INT32_ALU_OPS_PER_S, int_ops / PEAK_INT32_OPS_PER_S) * 1e3


def fresh_run(model, sweeps=None, seed: int = 0):
    """(compiled, keys, params, state) for REPLICAS replicas on cuda."""
    compiled = _Compiled(model)
    params = {
        k: torch.from_numpy(v).cuda()
        for k, v in _resolve_params(model, compiled, REPLICAS, sweeps).items()
    }
    keys = rng.split(rng.PRNGKey(seed, device="cuda"), REPLICAS)
    return compiled, keys, params, compiled.init_state(keys, params)


def draw(compiled, keys, block: int) -> torch.Tensor:
    """The block's uniforms by the torch-op threefry: the plain step's
    input (the kernel draws the same bits itself)."""
    return event_step.block_uniforms(compiled, keys, block)


def compare_states(kernel: dict, plain: dict, label: str) -> float:
    """Every leaf equal (ints) or within FLOAT_RTOL (floats); returns the
    largest absolute float difference."""
    max_abs = 0.0
    for name in sorted(plain):
        a, b = kernel[name], plain[name]
        require(a.dtype == b.dtype and a.shape == b.shape, f"{label}: {name} layout differs")
        if not a.is_floating_point():
            differ = a != b
            if bool(differ.any()):
                first = int(differ.reshape(a.shape[0], -1).any(dim=1).nonzero()[0, 0])
                raise SmokeFailure(f"{label}: integer leaf {name} differs first at replica {first}")
            continue
        same_bits = a.view(torch.int32) == b.view(torch.int32)
        if bool(same_bits.all()):
            continue
        finite = torch.isfinite(b)
        require(bool((torch.isinf(a) == torch.isinf(b)).all()), f"{label}: {name} inf pattern differs")
        diff = torch.where(finite, (a - b).abs(), torch.zeros_like(a))
        first = int((~same_bits).reshape(a.shape[0], -1).any(dim=1).nonzero()[0, 0])
        rel = float((diff / b.abs().clamp_min(1e-30)).max())
        max_abs = max(max_abs, float(diff.max()))
        print(f"  {label}: float leaf {name} not bitwise equal (first at replica {first}, max rel {rel:.3e})")
        require(rel <= FLOAT_RTOL, f"{label}: {name} rel difference {rel} > {FLOAT_RTOL}")
    return max_abs


def check_blocks(name: str, model, compare_at: list[int], sweeps=None) -> float:
    """Advance one full-size ensemble with the kernel; at each block in
    ``compare_at`` also run the plain version on a copy and compare."""
    compiled, keys, params, state = fresh_run(model, sweeps)
    max_abs = 0.0
    for block in range(max(compare_at) + 1):
        if block in compare_at:
            plain_state = {k: v.clone() for k, v in state.items()}
            plain_halted = event_step.plain_block_step(
                compiled, plain_state, draw(compiled, keys, block), params
            )
            halted = event_step.block_step(compiled, state, keys, block, params)
            torch.cuda.synchronize()
            err = compare_states(state, plain_state, f"{name} block {block}")
            require(bool((halted == plain_halted).all()), f"{name} block {block}: halted differs")
            live = int((~halted).sum())
            print(f"  {name} block {block}: kernel == plain on every leaf ({live} replicas live after)")
            max_abs = max(max_abs, err)
        else:
            event_step.block_step(compiled, state, keys, block, params)
    torch.cuda.synchronize()
    return max_abs


def elapsed_ms(fn, n: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def launch_ms(args: list) -> float:
    """Device time of each launch of ``args`` (on states made
    beforehand), summed."""
    total = 0.0
    for a in args:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        event_step.launch(a, torch.device("cuda"))
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total


def time_blocks(model, label: str, sweeps=None) -> dict:
    """Per-block times at full size, from the first blocks (every replica
    live), and the bound for the same blocks: the kernel running blocks
    2 to 21 in one launch, as a run's launch runs them (its time per
    block), and one block a launch."""
    compiled, keys, params, state = fresh_run(model, sweeps)
    macro = compiled.macro
    for b in range(2):  # warm-up
        event_step.block_step(compiled, state, keys, b, params)
    start = {k: v.clone() for k, v in state.items()}
    plain_state = {k: v.clone() for k, v in state.items()}
    wrapper_state = {k: v.clone() for k, v in state.items()}
    count_state = {k: v.clone() for k, v in state.items()}
    halted = torch.empty((REPLICAS,), dtype=torch.uint8, device="cuda")
    # The design's time per block: TIMED_BLOCKS blocks in one launch,
    # twice, each on its own copy of the state.
    loop_states = [{k: v.clone() for k, v in state.items()} for _ in range(2)]
    loop_args = [
        event_step.launch_args(compiled, st, keys, 2, params, halted, n_blocks=TIMED_BLOCKS)
        for st in loop_states
    ]
    kernel_ms = launch_ms(loop_args) / (2 * TIMED_BLOCKS)
    # One block a launch, with arguments built beforehand, so the
    # wrapper's per-call checks stay out of the device time.
    ready = [
        event_step.launch_args(compiled, state, keys, i + 2, params, halted)
        for i in range(TIMED_BLOCKS)
    ]
    single_ms = elapsed_ms(lambda i: event_step.launch(ready[i], state["t"].device), TIMED_BLOCKS)
    # The same blocks through the wrapper, as run_ensemble's blocks after
    # its first: the state's tensors checked once beforehand, the keys at
    # every call.
    event_step.launch_args(compiled, wrapper_state, keys, 2, params, halted)
    wrapper_ms = elapsed_ms(
        lambda i: event_step.block_step(compiled, wrapper_state, keys, i + 2, params),
        TIMED_BLOCKS,
    )
    # The threefry the blocks needed: the same blocks again in one launch
    # with the kernel counting each lane's draws and blocks (not timed).
    drawn = torch.zeros((REPLICAS,), dtype=torch.int32, device="cuda")
    ran = torch.zeros((REPLICAS,), dtype=torch.int32, device="cuda")
    event_step.launch(
        event_step.launch_args(
            compiled, count_state, keys, 2, params, halted, drawn, TIMED_BLOCKS, ran
        ),
        count_state["t"].device,
    )
    total_drawn, folds = int(drawn.sum()), int(ran.sum())
    plain_blocks = [draw(compiled, keys, b) for b in range(2, 6)]
    event_step.plain_block_step(compiled, plain_state, plain_blocks[0], params)  # warm-up
    plain_ms = elapsed_ms(
        lambda i: event_step.plain_block_step(compiled, plain_state, plain_blocks[i + 1], params), 3
    )
    draw(compiled, keys, 0)  # warm-up
    draw_ms = elapsed_ms(lambda i: draw(compiled, keys, i), TIMED_BLOCKS)
    per_replica = support.replica_working_set_bytes(compiled, state)
    # A launch moves the dense state once, whatever its block count.
    bytes_per_launch = support.launch_bytes(compiled, state)
    bytes_per_block = bytes_per_launch / TIMED_BLOCKS
    float_ops_per_block = (
        REPLICAS * macro * (OPS_PER_STEP_BASE + OPS_PER_STEP_PER_SERVER * compiled.nV)
        + extension_ops(compiled, start, state) / TIMED_BLOCKS
    )
    drawn_per_block = total_drawn / TIMED_BLOCKS
    int_ops_per_block = support.draw_int_ops(folds, total_drawn) / TIMED_BLOCKS
    alu_ops_per_block = support.draw_alu_ops(folds, total_drawn) / TIMED_BLOCKS
    bytes_ms = bytes_per_block / PEAK_BYTES_PER_S * 1e3
    ops_ms = max(
        float_ops_per_block / PEAK_F32_OPS_PER_S * 1e3, int_ms(int_ops_per_block, alu_ops_per_block)
    )
    single_bound_ms = max(bytes_per_launch / PEAK_BYTES_PER_S * 1e3, ops_ms)
    return {
        "model": label,
        "kernel_ms": kernel_ms,
        "single_ms": single_ms,
        "single_bound_ms": single_bound_ms,
        "stage": staged_leaves(loop_args[0]),
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "draw_ms": draw_ms,
        "bytes_per_replica": per_replica,
        "bytes_per_launch": bytes_per_launch,
        "bytes_per_block": bytes_per_block,
        "float_ops_per_block": float_ops_per_block,
        "threefry_per_block": drawn_per_block,
        "int_ops_per_block": int_ops_per_block,
        "bytes_ms": bytes_ms,
        "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def staged_leaves(args) -> dict:
    """The leaves a launch's plan stages in shared memory, and the bytes
    of a lane's column."""
    leaves = [leaf for leaf, off in zip(support.STAGE_LEAVES, args.stage.off) if off >= 0]
    return {"leaves": leaves, "bytes_per_lane": 4 * args.stage.words}


def same_state(a: dict, b: dict, label: str) -> None:
    """Every leaf bit for bit."""
    for leaf in sorted(b):
        x, y = a[leaf], b[leaf]
        if y.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            first = int((x != y).reshape(x.shape[0], -1).any(dim=1).nonzero()[0, 0])
            raise SmokeFailure(f"{label}: {leaf} differs first at replica {first}")


def check_whole_run(label: str, model, sweeps=None, max_events=None, global_rows=False) -> dict:
    """A whole run of ``model`` at the main path's budget in one launch
    against the per-block structure: chained one-block launches with every row in
    device memory, driven by a host loop that stops once every replica
    halted and counts a replica's block iff it was live when the block
    began. Every leaf, the blocks each replica ran and the halted mask
    bit for bit. Returns the whole-run launch's device time and the
    chained loop's (host wall, its syncs included), the blocks and the
    run's bound: the dense state moved once, the float operations of the
    events it ran and the threefry it counted. ``global_rows`` requires
    the plan to leave tr_time in device memory (the rows-in-global
    branch)."""
    if max_events is None:
        max_events = _default_max_events(model, sweeps)
    compiled, keys, params, state = fresh_run(model, sweeps)
    n = -(-max_events // compiled.macro)
    initial = {k: v.clone() for k, v in state.items()}
    chained = {k: v.clone() for k, v in state.items()}
    blocks = torch.zeros((REPLICAS,), dtype=torch.int32, device="cuda")
    drawn = torch.zeros((REPLICAS,), dtype=torch.int32, device="cuda")
    halted = torch.empty((REPLICAS,), dtype=torch.uint8, device="cuda")
    args = event_step.launch_args(compiled, state, keys, 0, params, halted, drawn, n, blocks)
    plan = staged_leaves(args)
    if global_rows:
        require("tr_time" not in plan["leaves"] and plan["leaves"], f"{label}: plan {plan}")
    run_ms = launch_ms([args])
    empty = event_step._Stage((ctypes.c_int * len(support.STAGE_LEAVES))(*[-1] * len(support.STAGE_LEAVES)), 0)
    chained_blocks = torch.zeros((REPLICAS,), dtype=torch.int32, device="cuda")
    out = torch.empty((REPLICAS,), dtype=torch.uint8, device="cuda")
    live = ~compiled.replica_halted(chained)
    torch.cuda.synchronize()
    wall = time.perf_counter()
    for c in range(n):
        if not bool(live.any()):
            break
        chained_blocks += live.to(torch.int32)
        one = event_step.launch_args(compiled, chained, keys, c, params, out)
        one.stage = empty
        event_step.launch(one, torch.device("cuda"))
        live = out == 0
    torch.cuda.synchronize()
    chained_ms = (time.perf_counter() - wall) * 1e3
    same_state(state, chained, f"{label} whole run")
    require(torch.equal(blocks, chained_blocks), f"{label} whole run: blocks differ")
    require(torch.equal(halted, out), f"{label} whole run: halted differs")
    folds, events = int(blocks.sum()), int(state["events"].long().sum() - initial["events"].long().sum())
    float_ops = events * (OPS_PER_STEP_BASE + OPS_PER_STEP_PER_SERVER * compiled.nV) + extension_ops(
        compiled, initial, state
    )
    int_ops = support.draw_int_ops(folds, int(drawn.sum()))
    alu_ops = support.draw_alu_ops(folds, int(drawn.sum()))
    bytes_ms = support.launch_bytes(compiled, state) / PEAK_BYTES_PER_S * 1e3
    ops_ms = max(float_ops / PEAK_F32_OPS_PER_S * 1e3, int_ms(int_ops, alu_ops))
    max_blocks = int(blocks.max())
    print(
        f"  {label}: one launch of {n} blocks == {max_blocks} chained one-block launches with the "
        f"rows in device memory, on every leaf, blocks and halted; launch {run_ms:.3f} ms, chained "
        f"{chained_ms:.3f} ms; staged {plan['leaves'] or 'nothing'} ({plan['bytes_per_lane']} B a lane)"
    )
    return {
        "run_ms": run_ms, "chained_ms": chained_ms, "blocks": max_blocks, "lane_blocks": folds,
        "events": events, "plan": plan, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def extension_ops(compiled, before: dict, after: dict) -> int:
    """Float operations the family draws and profile lookups of the
    blocks between ``before`` and ``after`` needed, from the work those
    blocks did: one draw per service started, one lookup pair per
    source fire (the events that completed no server, on a model
    without transit)."""

    def grew(leaf: str) -> torch.Tensor:
        return (after[leaf].long() - before[leaf].long()).sum(dim=0)

    started = grew("srv_started")
    ops = 0
    for v, spec in enumerate(compiled.model.servers):
        kind = int(compiled.service_kind[v])
        per_draw = OPS_PER_DRAW[kind]
        if kind == 2 and compiled.srv_erlang_k[v] == 3.0:
            per_draw = OPS_PER_ERLANG3_DRAW
        # A hedged server draws a second service at every start.
        draws = 2 if spec.hedge_delay_s is not None else 1
        ops += draws * per_draw * int(started[v])
    if compiled.has_profile.any():
        require(not compiled.has_transit, "profile fire count assumes no transit events")
        ops += OPS_PER_PROFILE_FIRE * int(grew("events") - grew("srv_completed").sum())
    return ops


def check_uniform(tag: str) -> dict:
    """The draw kernel against rng.uniform, bit for bit, on the M/M/1's
    chain-form gap block: REPLICAS x n_customers uniforms of purpose 0
    (about 10^8, 2^26 and more); its time, the plain version's and the
    bound (4 bytes written per element; one threefry per element and one
    fold per replica at the 32-bit integer rate)."""
    lam = HORIZON_S * LAM
    n = int(lam + 6.0 * math.sqrt(lam) + 20.0)  # chain.run_chain's budget
    keys = rng.split(rng.PRNGKey(0, device="cuda"), REPLICAS)
    got = uniform.replica_uniform(keys, 0, (n,))
    want = uniform.plain_replica_uniform(keys, 0, (n,))
    torch.cuda.synchronize()
    elements = REPLICAS * n
    require(elements >= 1 << 26, f"uniform check: {elements} elements")
    same = bool((got.view(torch.int32) == want.view(torch.int32)).all())
    require(same, "uniform kernel differs from rng.uniform")
    max_abs_err = float((got - want).abs().max())
    del got, want
    kernel_ms = elapsed_ms(lambda i: uniform.replica_uniform(keys, i, (n,)), 10)
    plain_ms = elapsed_ms(lambda i: uniform.plain_replica_uniform(keys, i, (n,)), 2)
    bytes_ms = (REPLICAS * 8 + elements * 4) / PEAK_BYTES_PER_S * 1e3
    int_ops = REPLICAS * support.THREEFRY_OPS + elements * support.UNIFORM_INT_OPS
    ops_ms = int_ms(int_ops, REPLICAS * support.THREEFRY_ALU_OPS + elements * support.UNIFORM_ALU_OPS)
    print(
        f"uniform kernel == rng.uniform bit for bit on {REPLICAS} x {n} = {elements} uniforms; "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({'bytes' if bytes_ms >= ops_ms else 'operations'}: {int_ops / 1e9:.2f} G int ops, "
        f"{elements * 4 / 1e6:.0f} MB) {tag}"
    )
    return {
        "elements": elements, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "max_abs_err": max_abs_err,
        "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


# Each scan run of the main path by its label: (the device time of its
# kernel launch, its result, its launches) (main_path_run).
RUN_KERNEL_MS: dict = {}


def print_shares(tag: str, runs=None) -> dict:
    """Each scan run's kernel share of its wall time (of ``runs``' labels
    where given), from the device time of its one launch, and the host's
    time: the rest of the wall (set-up, the launch's checks, the reduce),
    in all and per block."""
    shares = {}
    for run, (kernel_ms, result, launches) in RUN_KERNEL_MS.items():
        if runs is not None and run not in runs:
            continue
        wall_ms = result.wall_seconds * 1e3
        blocks = max(result.block_occupancy)
        host_ms = wall_ms - kernel_ms
        shares[run] = {"wall_ms": wall_ms, "launches": launches, "blocks": blocks,
                       "kernel_ms": kernel_ms, "kernel_share": kernel_ms / wall_ms,
                       "host_ms": host_ms, "host_ms_per_block": host_ms / blocks}
        print(
            f"share {run}: {blocks} blocks in {launches} launch, {wall_ms:.1f} ms, kernel "
            f"{kernel_ms:.2f} ms ({100 * kernel_ms / wall_ms:.1f}%), host {host_ms:.2f} ms "
            f"({host_ms / blocks:.4f} ms/block) {tag}"
        )
    return shares


# -- the main path -------------------------------------------------------------
def main_path_run(label: str, model, tag: str, shape: str, sweeps=None, max_events=None,
                  code=None) -> tuple:
    """run_ensemble's event scan on cuda with the launch counts set to 0
    just before and read just after; returns (result, launches). The
    budget is explicit, the one the scan takes by default unless given,
    so a model the chain form takes stays on the scan. ``code``, a key of
    event_step.launches_by_code ((library, code, telemetry sites)): every
    launch of the run must have taken that code."""
    if max_events is None:
        max_events = _default_max_events(model, sweeps)
    # CUDA events around the kernel's launch time its device time.
    timed = []
    launch = event_step.launch

    def timed_launch(args, device):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(args, device)
        end.record()
        timed.append((start, end))

    event_step.launch = timed_launch
    try:
        event_step.block_step.launches = 0
        uniform.replica_uniform.launches = 0
        event_step.launches_by_code.clear()
        result = run_ensemble(model, n_replicas=REPLICAS, sweeps=sweeps, max_events=max_events)
        launches = event_step.block_step.launches
        by_code = dict(event_step.launches_by_code)
    finally:
        event_step.launch = launch
    require(uniform.replica_uniform.launches == 0, f"{label}: the scan launched the draw kernel")
    if code is not None:
        require(by_code == {code: launches}, f"{label}: launches by code {by_code}, not all {code}")
    RUN_KERNEL_MS[label] = (sum(start.elapsed_time(end) for start, end in timed), result, launches)
    blocks_run = max(result.block_occupancy)
    print(
        f"run_ensemble {label} x{REPLICAS}: engine_path {result.engine_path}, shape "
        f"{result.kernel_shape}, {launches} kernel launch for {blocks_run} blocks, "
        f"{result.simulated_events} events in {result.wall_seconds:.3f} s = "
        f"{result.events_per_second:.4g} events/s {tag}"
    )
    require(result.engine_path == "scan+cuda", f"{label}: engine_path {result.engine_path}")
    require(result.kernel_shape == shape, f"{label}: kernel_shape {result.kernel_shape}")
    # The whole budget in one launch, however many blocks the replicas ran.
    require(launches == 1 and blocks_run > 0, f"{label}: {launches} launches for {blocks_run} blocks")
    require(result.truncated_replicas == 0, f"{label}: {result.truncated_replicas} truncated replicas")
    require(
        all(np.isfinite(result.server_mean_wait_s)) and all(np.isfinite(result.sink_mean_latency_s)),
        f"{label}: non-finite statistics",
    )
    return result, launches


def chain_run(label: str, model, tag: str) -> tuple:
    """run_ensemble's default call, which takes the chain form, on cuda
    with the launch counts set to 0 just before and read just after;
    returns (result, draw kernel launches): for each block of replicas
    the chain form draws at once, one for the gaps, one for a random
    router's choice and one per server's service draws."""
    require(fast_plan(model) is not None, f"{label}: no chain plan")
    event_step.block_step.launches = 0
    uniform.replica_uniform.launches = 0
    result = run_ensemble(model, n_replicas=REPLICAS)
    launches = uniform.replica_uniform.launches
    print(
        f"run_ensemble {label} x{REPLICAS} (default call): engine_path {result.engine_path}, "
        f"{launches} draw kernel launches, {result.simulated_events} events in "
        f"{result.wall_seconds:.3f} s = {result.events_per_second:.4g} events/s, draw kernel "
        f"build and load {result.compile_seconds:.2f} s {tag}"
    )
    require(result.engine_path == "chain", f"{label}: engine_path {result.engine_path}")
    require(event_step.block_step.launches == 0, f"{label}: the chain form launched the event step")
    per_block = 1 + any(r.policy == "random" for r in model.routers) + len(model.servers)
    require(launches > 0 and launches % per_block == 0, f"{label}: {launches} draw launches")
    require(result.truncated_replicas == 0, f"{label}: {result.truncated_replicas} truncated replicas")
    require(sum(result.server_dropped) == 0, f"{label}: drops in a certified run")
    return result, launches


def within(value: float, ref: float, label: str, rel: float = 0.01, unit: str = " s") -> None:
    print(
        f"  {label} {value:.6f}{unit} (reference {ref:.6f}, "
        f"{100 * (value / ref - 1):+.3f}%, gate {100 * rel:g}%)"
    )
    require(abs(value / ref - 1.0) <= rel, f"{label} {value} not within {100 * rel:g}% of {ref}")


def per_replica_sink_counts(model) -> torch.Tensor:
    """Each replica's sink count after a block loop of ``model`` to its
    horizon (the kernel, as run_ensemble drives it)."""
    compiled, keys, params, state = fresh_run(model)
    blocks = torch.zeros((REPLICAS,), dtype=torch.int32, device="cuda")
    halted = event_step.block_steps(
        compiled, state, keys, 0, -(-_default_max_events(model, None) // compiled.macro), params, blocks
    )
    require(bool(halted.all()), "ramp-constant: a replica did not halt")
    return state["sink_count"][:, 0]


def report(result, launches: int) -> dict:
    return {
        **result.engine_report(),
        "simulated_events": result.simulated_events,
        "server_mean_wait_s": result.server_mean_wait_s,
        "sink_mean_latency_s": result.sink_mean_latency_s,
        "server_completed": result.server_completed,
        "transit_dropped": result.transit_dropped,
        "truncated_replicas": result.truncated_replicas,
        "server_timed_out": result.server_timed_out,
        "server_retried": result.server_retried,
        "server_fault_dropped": result.server_fault_dropped,
        "server_fault_retried": result.server_fault_retried,
        "server_hedged": result.server_hedged,
        "server_hedge_wins": result.server_hedge_wins,
        "network_lost": result.network_lost,
        "server_breaker_dropped": result.server_breaker_dropped,
        "breaker_tripped": result.breaker_tripped,
        "breaker_open_fraction": result.breaker_open_fraction,
        "server_shed_dropped": result.server_shed_dropped,
        "server_budget_dropped": result.server_budget_dropped,
        "network_partitioned": result.network_partitioned,
        "server_quorum_dropped": result.server_quorum_dropped,
        "quorum_dark_fraction": result.quorum_dark_fraction,
        "leader_changes": result.leader_changes,
        "time_without_leader_fraction": result.time_without_leader_fraction,
        "launches": launches,
    }


def chaos_main_path(tag: str) -> dict:
    """The chaos runs of the main path and their gates; returns
    {run name: (result, launches)}."""
    runs = {}
    result, launches = main_path_run(
        "chaos", chaos_model(), tag, "router", CHAOS_SWEEPS, CHAOS_MAX_EVENTS
    )
    require(result.kernel_chaos == chaos_model().chaos_features(), f"chaos: {result.kernel_chaos}")
    hedged, wins = sum(result.server_hedged), sum(result.server_hedge_wins)
    print(
        f"  chaos: {hedged} hedges, {wins} won; fault retries {result.server_fault_retried}, "
        f"fault drops {result.server_fault_dropped}, transit drops {result.transit_dropped}"
    )
    require(0 < wins <= hedged, f"chaos: {wins} hedge wins of {hedged} hedges")
    require(sum(result.server_fault_retried) > 0, "chaos: no fault retry")
    # Servers 0 and 2 take deliveries 0, 2, 4, ... of each replica's
    # router: ceil(admitted / 2), which is admitted / 2 plus a half for
    # each replica with an odd count; that parity is unknown, so the
    # expected losses carry +-R/4 crossings on top of 3 sigma.
    crossings = result.limiter_admitted[0] / 2 + REPLICAS / 4
    expected = CHAOS_LOSS_P * crossings
    sigma = math.sqrt(crossings * CHAOS_LOSS_P * (1 - CHAOS_LOSS_P))
    slack = 3 * sigma + CHAOS_LOSS_P * REPLICAS / 4
    print(
        f"  chaos packet losses {result.network_lost} (expected {expected:.0f} of "
        f"{crossings:.0f} lossy crossings, gate +-{slack:.0f}: 3 sigma + the parity term)"
    )
    require(abs(result.network_lost - expected) <= slack, "chaos: packet losses off their rate")
    runs["chaos"] = (result, launches)

    result, launches = main_path_run("deadline-mm1", deadline_mm1_model(), tag, "mm1")
    within(result.server_timed_out[0] / result.server_completed[0], math.exp(-1.0),
           "deadline-mm1 timed out / completed", 0.02, unit="")
    within(result.server_mean_wait_s[0], LAM / MU / (MU - LAM), "deadline-mm1 mean wait")
    runs["deadline-mm1"] = (result, launches)

    result, launches = main_path_run("hedged-mm1", hedged_model(), tag, "mm1")
    hedged, wins = result.server_hedged[0], result.server_hedge_wins[0]
    within(hedged / result.server_completed[0], math.exp(-HEDGE_DELAY_S / HEDGE_MEAN_S),
           "hedged-mm1 hedged / completed", 0.01, unit="")
    within(wins / hedged, 0.5, "hedged-mm1 wins / hedged", 0.01, unit="")
    runs["hedged-mm1"] = (result, launches)

    # test_tpu_faults.py's drop-rate test: two-state Markov occupation
    # time, up rate r, down rate m, born up.
    result, launches = main_path_run("duty-cycle", duty_model(), tag, "mm1")
    r_up, m_down, lam, horizon = 0.2, 1.0, 4.0, 30.0
    d = duty_cycle(r_up, 1.0 / m_down)
    rates = r_up + m_down
    dark = d * horizon - d / rates * (1.0 - math.exp(-rates * horizon))
    var_dark = 2.0 * r_up * m_down / rates**3 * horizon
    mean_drops = REPLICAS * lam * dark
    sigma = math.sqrt(REPLICAS * (lam**2 * var_dark + lam * dark))
    drops = result.server_fault_dropped[0]
    print(f"  duty-cycle fault drops {drops} (expected {mean_drops:.0f}, {(drops - mean_drops) / sigma:+.2f} sigma)")
    require(abs(drops - mean_drops) < 3 * sigma, "duty-cycle: fault drops off the closed form")
    runs["duty-cycle"] = (result, launches)

    result, launches = main_path_run("packet-loss", loss_model(), tag, "mm1")
    crossings = result.network_lost + result.sink_count[0]
    require(abs(crossings / REPLICAS - 280.0) <= 2.0, f"packet-loss: {crossings} crossings")
    sigma = math.sqrt(crossings * 0.2 * 0.8)
    print(
        f"  packet-loss lost {result.network_lost} of {crossings} crossings "
        f"({(result.network_lost - 0.2 * crossings) / sigma:+.2f} sigma)"
    )
    require(abs(result.network_lost - 0.2 * crossings) < 3 * sigma, "packet-loss: losses off p=0.2")
    runs["packet-loss"] = (result, launches)

    result, launches = main_path_run("retry-accounting", retry_accounting_model(), tag, "mm1")
    retried, dropped = result.server_fault_retried[0], result.server_fault_dropped[0]
    print(f"  retry-accounting: {retried} fault retries = 2 x {dropped} fault drops, sink {result.sink_count[0]}")
    require(dropped > 0 and retried == 2 * dropped and result.sink_count[0] == 0,
            "retry-accounting: retries are not exactly 2 x drops")
    runs["retry-accounting"] = (result, launches)
    return runs


def partition_check(label: str, result, pairs) -> None:
    """Every windowed counter sums over the windows exactly to its
    whole-run counter."""
    ts = result.timeseries
    for series, whole in pairs:
        got, want = getattr(ts, series).sum(axis=0).tolist(), getattr(result, whole)
        require(got == want, f"{label}: {series} sums to {got}, whole run {want}")
    families = len(pairs)
    if ts.sink_hist is not None:
        require(np.array_equal(ts.sink_hist.sum(axis=0), result.sink_hist), f"{label}: sink_hist")
        families += 1
    print(f"  {label}: {families} counter families partition exactly over {ts.n_windows} windows")


def same_simulation(label: str, a, b, other: str = "without telemetry") -> None:
    """Every whole-run number of two runs of one model equal."""
    for field in (
        "simulated_events", "sink_count", "sink_mean_latency_s", "server_completed",
        "server_dropped", "server_timed_out", "server_retried", "server_fault_dropped",
        "server_fault_retried", "server_hedged", "server_hedge_wins", "network_lost",
        "limiter_admitted", "limiter_dropped", "transit_dropped", "server_mean_wait_s",
        "server_utilization", "server_mean_queue_len",
    ):
        require(getattr(a, field) == getattr(b, field), f"{label}: {field} differs from the run {other}")
    require(np.array_equal(a.sink_hist, b.sink_hist), f"{label}: sink_hist differs from the run {other}")
    print(f"  {label}: every whole-run number equals the run {other}")


def telemetry_main_path(tag: str, earlier: dict) -> dict:
    """The telemetry runs of the main path and their gates; ``earlier``
    holds the runs without telemetry they are compared with."""
    runs = {}
    result, launches = main_path_run(
        "telemetry", telemetry_model(), tag, "mm1", HETERO_SWEEPS, TEL_MAX_EVENTS
    )
    off, off_launches = main_path_run(
        "telemetry-off", telemetry_model(0), tag, "mm1", HETERO_SWEEPS, TEL_MAX_EVENTS
    )
    require(result.timeseries is not None and off.timeseries is None, "telemetry: timeseries")
    partition_check("telemetry", result, [
        ("sink_count", "sink_count"), ("server_completed", "server_completed"),
        ("server_dropped", "server_dropped"), ("server_timed_out", "server_timed_out"),
        ("server_retried", "server_retried"), ("server_fault_dropped", "server_fault_dropped"),
    ])
    ts = result.timeseries
    denominator = REPLICAS * ts.measured_len_s
    for series, whole in (("server_mean_queue_len", "depth"), ("server_utilization", "busy")):
        windowed = float((getattr(ts, series)[:, 0] * denominator).sum())
        total = getattr(result, series)[0] * denominator.sum()
        print(f"  telemetry windowed {whole} integral {windowed:.6f} vs whole run {total:.6f} "
              f"({windowed / total - 1:+.3e}, gate 1e-5)")
        require(abs(windowed / total - 1) <= 1e-5, f"telemetry: windowed {whole} integral")
    same_simulation("telemetry", result, off)
    require(launches == off_launches, "telemetry: launches differ with the spec")
    runs["telemetry"] = (result, launches)
    runs["telemetry-off"] = (off, off_launches)

    result, launches = main_path_run(
        "mm1-telemetry",
        with_telemetry(mm1_model(LAM, MU, HORIZON_S, warmup_s=WARMUP_S), MM1_WINDOW_S), tag, "mm1",
    )
    ts = result.timeseries
    post = ts.window_start_s >= WARMUP_S
    within(float(ts.replica_throughput_mean[post, 0].mean()), LAM,
           f"mm1-telemetry per-replica throughput over {int(post.sum())} windows", 0.01, unit=" /s")
    within(float(ts.server_utilization[post, 0].mean()), LAM / MU, "mm1-telemetry utilisation", 0.01, unit="")
    within(float(ts.sink_mean_latency_s[post, 0].mean()), 1.0 / (MU - LAM), "mm1-telemetry mean latency")
    low, mean, high = (ts.replica_throughput_p10[post, 0], ts.replica_throughput_mean[post, 0],
                       ts.replica_throughput_p90[post, 0])
    print(f"  mm1-telemetry throughput p10 {low.min():.3f}..{low.max():.3f}, mean "
          f"{mean.min():.4f}..{mean.max():.4f}, p90 {high.min():.3f}..{high.max():.3f} /s")
    require(bool(((low <= mean) & (mean <= high)).all()), "mm1-telemetry: p10 <= mean <= p90 fails")
    same_simulation("mm1-telemetry", result, earlier["mm1"][0])
    runs["mm1-telemetry"] = (result, launches)

    result, launches = main_path_run(
        "chaos-telemetry", with_telemetry(chaos_model(), BENCH_HORIZON_S / TEL_WINDOWS), tag,
        "router", CHAOS_SWEEPS, CHAOS_MAX_EVENTS,
    )
    partition_check("chaos-telemetry", result, [
        ("sink_count", "sink_count"), ("server_completed", "server_completed"),
        ("server_dropped", "server_dropped"), ("server_fault_dropped", "server_fault_dropped"),
        ("server_fault_retried", "server_fault_retried"), ("server_hedged", "server_hedged"),
        ("server_hedge_wins", "server_hedge_wins"), ("transit_dropped", "transit_dropped"),
        ("limiter_admitted", "limiter_admitted"), ("limiter_dropped", "limiter_dropped"),
        ("network_lost", "network_lost"),
    ])
    ts = result.timeseries
    occupancy = ts.fault_occupancy
    print(f"  chaos-telemetry: packet losses {result.network_lost}, fault retries "
          f"{sum(result.server_fault_retried)}, limiter drops {result.limiter_dropped[0]}, fault "
          f"occupancy {occupancy.min():.5f}..{occupancy.max():.5f}")
    require(result.network_lost > 0 and sum(result.server_fault_retried) > 0
            and result.limiter_dropped[0] > 0, "chaos-telemetry: a chaos family never fired")
    require(bool(((occupancy >= 0.0) & (occupancy <= 1.0)).all()), "chaos-telemetry: occupancy outside [0, 1]")
    same_simulation("chaos-telemetry", result, earlier["chaos"][0])
    runs["chaos-telemetry"] = (result, launches)

    result, launches = main_path_run(
        "duty-cycle-telemetry", with_telemetry(duty_model(), DUTY_WINDOW_S, metrics=("faults",)),
        tag, "mm1",
    )
    occupancy = result.timeseries.fault_occupancy[:, 0]
    require(result.timeseries.sink_count is None, "duty-cycle-telemetry: unrequested series")
    require(bool(((occupancy >= 0.0) & (occupancy <= 1.0)).all()), "duty-cycle-telemetry: occupancy")
    within(float(occupancy[1:5].mean()), duty_cycle(0.2, 1.0),
           "duty-cycle-telemetry occupancy of windows 1-4", DUTY_GATE, unit="")
    require(result.server_fault_dropped == earlier["duty-cycle"][0].server_fault_dropped,
            "duty-cycle-telemetry: fault drops differ with telemetry")
    runs["duty-cycle-telemetry"] = (result, launches)
    return runs


def multi_main_path(tag: str) -> dict:
    """The runs of several sources and sinks on the main path, and their
    gates; returns {run name: (result, launches)}."""
    runs = {}
    result, launches = main_path_run("superpose", superpose_model(), tag, "multi", code=MULTI_LEAN)
    within(result.server_mean_wait_s[0], LAM / MU / (MU - LAM), "superpose mean wait (M/M/1 at lambda=8)")
    within(result.sink_mean_latency_s[0], 1.0 / (MU - LAM), "superpose mean sojourn")
    runs["superpose"] = (result, launches)
    plain, launches = main_path_run("two-class", two_class_model(), tag, "multi", code=MULTI_LEAN)
    runs["two-class"] = (plain, launches)
    result, launches = main_path_run(
        "two-class-telemetry", two_class_model(TWO_CLASS_WINDOW_S), tag, "multi",
        code=("event_step_multi", "lean", True),
    )
    runs["two-class-telemetry"] = (result, launches)
    for run in (plain, result):
        require(run.server_completed[5] == 0, f"two-class: the spare server completed {run.server_completed[5]}")
    partition_check("two-class-telemetry", result, [
        ("sink_count", "sink_count"), ("server_completed", "server_completed"),
        ("server_dropped", "server_dropped"),
    ])
    # The batch job's deliveries from server 4 to sink 1 are instantaneous,
    # so sink 1 counts exactly server 4's completions after the warmup
    # (its windows from 40 s on).
    ts = result.timeseries
    after = int(ts.server_completed[ts.window_start_s >= WARMUP_S, 4].sum())
    print(f"  two-class: sink 1 {result.sink_count[1]}, server 4's completions after the warmup "
          f"{after}, server 5 {result.server_completed[5]}")
    require(after == result.sink_count[1], "two-class: sink 1 differs from server 4's completions")
    within(plain.sink_count[0] / (REPLICAS * (HORIZON_S - WARMUP_S)), WEB_RATE,
           "two-class sink 0 throughput per replica", 0.01, unit=" /s")
    same_simulation("two-class-telemetry", result, plain)
    # The chaos arm (the chaos code for several sources or sinks without
    # the defenses' sites), and its defended arm (the whole chaos code):
    # the web tenant is untouched, so its throughput holds; the batch edge
    # loses about 1% of the batch job's jobs, and its server times jobs
    # out; in the defended arm the budget suppresses retries.
    for label, model, code in (
        ("two-class-chaos", two_class_model(chaos=True), ("event_step_multi", "chaos", False)),
        ("two-class-defended", two_class_model(chaos=True, defended=True),
         ("event_step_multi", "full", False)),
    ):
        result, launches = main_path_run(label, model, tag, "multi", code=code)
        runs[label] = (result, launches)
        lost = result.network_lost / (REPLICAS * BATCH_RATE * HORIZON_S)
        print(f"  {label}: {result.network_lost} batch jobs lost ({lost:.5f} of those sent), "
              f"server 4 timed out {result.server_timed_out[4]}, retried {result.server_retried[4]}, "
              f"budget drops {result.server_budget_dropped or 'none'}")
        require(abs(lost - TWO_CLASS_LOSS_P) <= 0.05 * TWO_CLASS_LOSS_P, f"{label}: loss share")
        require(result.server_timed_out[4] > 0 and result.server_retried[4] > 0,
                f"{label}: no timeout or retry")
        require(result.server_timed_out[:4] == [0] * 4 and result.server_retried[:4] == [0] * 4,
                f"{label}: a front server timed out or retried")
        within(result.sink_count[0] / (REPLICAS * (HORIZON_S - WARMUP_S)), WEB_RATE,
               f"{label} sink 0 throughput per replica", 0.01, unit=" /s")
    chaos, defended = runs["two-class-chaos"][0], runs["two-class-defended"][0]
    require(defended.server_budget_dropped[4] > 0 and sum(defended.server_budget_dropped[:4]) == 0,
            f"two-class-defended: budget drops {defended.server_budget_dropped}")
    require(defended.server_retried[4] < chaos.server_retried[4],
            "two-class-defended: the budget held no retry back")
    return runs


def consensus_main_path(tag: str) -> dict:
    """The consensus runs of the main path and the gates of
    tests/integration/test_tpu_consensus.py; returns {run name: (result,
    launches)}."""
    runs = {}
    for arm in ("undefended", "defended"):
        result, launches = main_path_run(
            f"quorum-{arm}", quorum_model(arm == "defended"), tag, "router",
            max_events=QUORUM_MAX_EVENTS,
        )
        span = (QUORUM_CUT[1] - QUORUM_CUT[0]) / CONSENSUS_HORIZON_S
        print(f"  quorum-{arm}: quorum dark fraction {result.quorum_dark_fraction:.9f} (cut {span:.9f}), "
              f"partition drops {result.network_partitioned}, quorum rejections "
              f"{result.server_quorum_dropped}, trips {result.breaker_tripped}")
        require(abs(result.quorum_dark_fraction - span) <= 1e-6, f"quorum-{arm}: dark fraction")
        require(result.network_partitioned > 0 and sum(result.server_quorum_dropped) > 0,
                f"quorum-{arm}: no partition drop or quorum rejection")
        runs[f"quorum-{arm}"] = (result, launches)
    windows = goodput_windows(runs["quorum-defended"][0])
    pre, post = float(windows[1:4].mean()), float(windows[8:].mean())
    print(f"  quorum-defended goodput recovery {post / pre:.4f} (gate {RECOVERY_GATE})")
    require(post >= RECOVERY_GATE * pre, "quorum-defended: goodput not recovered")
    for strategy in ("bully", "phi_accrual"):
        label = f"election-{strategy}"
        result, launches = main_path_run(
            label, election_model(strategy), tag, "router", max_events=ELECTION_MAX_EVENTS
        )
        changes = REPLICAS * (1 + len(CUT_HIGH) + len(CUT_MID))
        print(f"  {label}: leader changes {result.leader_changes} (expected {changes})")
        require(result.leader_changes == changes, f"{label}: {result.leader_changes} leader changes")
        delay = LeaderElectionSpec(
            group=(0, 1, 2), heartbeat_s=ELECTION_HEARTBEAT_S, timeout_s=ELECTION_TIMEOUT_S,
            strategy=strategy,
        ).detection_delay_s()
        within(result.time_without_leader_fraction, 6 * delay / CONSENSUS_HORIZON_S,
               f"{label} time without a leader", 1e-4, unit="")
        runs[label] = (result, launches)
    return runs


def sweep_ms(model) -> float:
    """Device time of a consensus model's init sweeps at REPLICAS replicas,
    timed alone after the state they read is made."""
    compiled, _keys, _params, state = fresh_run(model)
    torch.cuda.synchronize()
    start = time.perf_counter()
    compiled._consensus_sweeps(state)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3


def goodput_windows(result) -> np.ndarray:
    return result.timeseries.sink_count[:, 0].astype(np.float64)


def resilience_main_path(tag: str) -> dict:
    """The resilience runs of the main path and their gates."""
    runs = {}
    ratios = {}
    for arm in ("undefended", "defended"):
        result, launches = main_path_run(
            f"resilience-{arm}", resilience_bench_model(arm == "defended"), tag, "mm1",
            RES_SWEEPS, RES_MAX_EVENTS,
        )
        windows = goodput_windows(result)
        first_dark = int(RES_OUTAGE[0] / (BENCH_HORIZON_S / RES_WINDOWS))
        ratios[arm] = float(windows[-3:].mean() / windows[1:first_dark].mean())
        print(
            f"  resilience-{arm}: goodput recovery {ratios[arm]:.4f} (last three windows over "
            f"windows 1-{first_dark - 1}), trips {result.breaker_tripped}, breaker drops "
            f"{result.server_breaker_dropped}, budget drops {result.server_budget_dropped}, "
            f"open fraction {result.breaker_open_fraction}"
        )
        runs[f"resilience-{arm}"] = (result, launches)
    defended = runs["resilience-defended"][0]
    require(ratios["defended"] >= RECOVERY_GATE, f"resilience: defended recovery {ratios['defended']}")
    require(ratios["defended"] > ratios["undefended"], "resilience: the defenses bought no goodput")
    require(sum(defended.breaker_tripped) > 0 and sum(defended.server_budget_dropped) > 0,
            "resilience: a defense never fired")
    for arm in ("undefended", "defended"):
        families = [
            ("sink_count", "sink_count"), ("server_completed", "server_completed"),
            ("server_dropped", "server_dropped"), ("server_timed_out", "server_timed_out"),
            ("server_retried", "server_retried"), ("server_fault_dropped", "server_fault_dropped"),
            ("server_fault_retried", "server_fault_retried"), ("transit_dropped", "transit_dropped"),
        ]
        if arm == "defended":
            families += [
                ("server_breaker_dropped", "server_breaker_dropped"),
                ("breaker_tripped", "breaker_tripped"),
                ("server_budget_dropped", "server_budget_dropped"),
            ]
        partition_check(f"resilience-{arm}", runs[f"resilience-{arm}"][0], families)
    result, launches = main_path_run(
        "resilience-inert", inert_defenses(resilience_bench_model(False)), tag, "mm1",
        RES_SWEEPS, RES_MAX_EVENTS,
    )
    same_simulation("resilience-inert", result, runs["resilience-undefended"][0], "without defenses")
    require(sum(result.breaker_tripped) == 0 and sum(result.server_budget_dropped) == 0,
            "resilience-inert: an inert defense acted")
    runs["resilience-inert"] = (result, launches)
    ts = defended.timeseries
    windowed = float((ts.breaker_open_fraction[:, 0] * ts.window_len_s).sum() / BENCH_HORIZON_S)
    print(f"  resilience-defended open fraction {defended.breaker_open_fraction[0]:.8f}, windowed "
          f"{windowed:.8f}")
    require(abs(windowed / defended.breaker_open_fraction[0] - 1) <= 1e-5,
            "resilience: the windowed open time misses the whole-run one")

    for arm in ("undefended", "defended"):
        result, launches = main_path_run(
            f"storm-{arm}", storm_model(arm == "defended"), tag, "mm1", max_events=STORM_MAX_EVENTS
        )
        windows = goodput_windows(result)
        ratio = float(windows[-3:].mean() / windows[:2].mean())
        print(f"  storm-{arm}: post / pre-outage goodput {ratio:.4f}")
        if arm == "undefended":
            require(ratio < 0.1, f"storm: the undefended storm recovered ({ratio})")
        else:
            require(ratio >= RECOVERY_GATE, f"storm: the defended storm did not recover ({ratio})")
        runs[f"storm-{arm}"] = (result, launches)

    result, launches = main_path_run(
        "cascade", cascade_model(), tag, "chain", max_events=CASCADE_MAX_EVENTS
    )
    open_frac = result.timeseries.breaker_open_fraction[:, 1]
    print(f"  cascade: trips {result.breaker_tripped}, open fraction of server 1 by window "
          f"{np.round(open_frac, 4).tolist()}")
    require(result.breaker_tripped[0] == 0 and result.breaker_tripped[1] > 0, "cascade: trips")
    require(open_frac[-1] == 0.0 and open_frac[-2] == 0.0, "cascade: the breaker stayed open")
    runs["cascade"] = (result, launches)

    result, launches = main_path_run("shed-mm1", shed_mm1_model(), tag, "mm1")
    shed, started = result.server_shed_dropped[0], result.server_completed[0]
    print(f"  shed-mm1: mean wait {result.server_mean_wait_s[0]!r}, {shed} shed")
    require(result.server_mean_wait_s[0] == 0.0, "shed-mm1: a job waited")
    rho = LAM / MU
    within(shed / (shed + started), rho / (1 + rho), "shed-mm1 shed share (Erlang loss)", 0.01, unit="")
    runs["shed-mm1"] = (result, launches)
    return runs


# -- checkpoint and resume, the M/M/1 ensemble, the opinion rounds ------------
# The one npz each checkpoint run writes, in the build directory.
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoints"


class _SnapshotKept(Exception):
    """Raised by a checkpoint callback to end a run once it holds the
    snapshot it was waiting for."""


def same_result(label: str, a, b) -> None:
    """Every field of two results equal but those of the port's
    RESUME_EXCLUDED_FIELDS, the window series field by field."""
    diff = resume_mismatches(a, b)
    require(not diff, f"{label}: {diff} differ from the one-launch run")


def checkpoint_run(label: str, model, tag: str, sweeps=None, max_events=None,
                   every_segment: bool = False) -> dict:
    """The checkpointing path against the one-launch run at the main path's
    budget: run_ensemble in CHECKPOINT_SEGMENTS segments with no snapshot
    due (one launch a segment), equal to the one-launch run on every field
    outside RESUME_EXCLUDED_FIELDS. Then a snapshot (checkpoint_every_s=0):
    with ``every_segment`` the run takes one at every boundary, keeps the
    middle one of those taken while a replica was live and must equal the
    one-launch run again; otherwise the run ends at its first boundary, a
    replica live, with that one snapshot (one copy of the state to the
    host). The kept snapshot goes through save and load, and the run
    resumed from it equals the one-launch run. The launch counts are set
    to 0 just before each run and read just after."""
    if max_events is None:
        max_events = _default_max_events(model, sweeps)
    kw = dict(n_replicas=REPLICAS, sweeps=sweeps, max_events=max_events)
    event_step.block_step.launches = 0
    one = run_ensemble(model, **kw)
    require(event_step.block_step.launches == 1, f"{label}: the one-launch run launched more")
    n_chunks = one.max_blocks
    per_segment = -(-n_chunks // CHECKPOINT_SEGMENTS)
    boundaries = list(range(per_segment, n_chunks, per_segment))
    event_step.block_step.launches = 0
    quiet = run_ensemble(model, **kw, checkpoint_every_s=3600.0, checkpoint_callback=lambda s: None)
    quiet_launches = event_step.block_step.launches
    require(quiet_launches == len(boundaries) + 1, f"{label}: {quiet_launches} segment launches")
    require(quiet.engine_path == "scan+cuda", f"{label}: engine_path {quiet.engine_path}")
    same_result(f"{label} in segments", one, quiet)
    require(quiet.blocks_total == one.blocks_total, f"{label}: the segments ran other blocks")

    live = [c for c in boundaries if c < max(one.block_occupancy)]
    require(bool(live), f"{label}: no segment boundary while a replica was live")
    target = live[len(live) // 2] if every_segment else live[0]
    kept, taken = [], []

    def keep(snapshot):
        taken.append(snapshot.chunk_index)
        if snapshot.chunk_index == target:
            kept.append(snapshot)
            if not every_segment:
                raise _SnapshotKept

    event_step.block_step.launches = 0
    t0 = time.perf_counter()
    try:
        snapped = run_ensemble(model, **kw, checkpoint_every_s=0.0, checkpoint_callback=keep)
    except _SnapshotKept:
        snapped = None
    snapped_ms = (time.perf_counter() - t0) * 1e3
    snapped_launches = event_step.block_step.launches
    require(taken == (boundaries if every_segment else [target]) and len(kept) == 1,
            f"{label}: snapshots at {taken}")
    if every_segment:
        same_result(f"{label} with a snapshot every segment", one, snapped)
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = CKPT_DIR / f"{label}.npz"
    t0 = time.perf_counter()
    kept[0].save(str(path))
    save_s = time.perf_counter() - t0
    npz_bytes = path.stat().st_size
    t0 = time.perf_counter()
    loaded = EnsembleCheckpoint.load(str(path))
    load_s = time.perf_counter() - t0
    path.unlink()
    require(loaded.model_fingerprint == model_fingerprint(model), f"{label}: fingerprint")
    event_step.block_step.launches = 0
    resumed = run_ensemble(model, **kw, resume_from=loaded)
    resumed_launches = event_step.block_step.launches
    require(resumed_launches == -(-(n_chunks - target) // per_segment),
            f"{label}: {resumed_launches} launches resuming at block {target}")
    same_result(f"{label} resumed at block {target}", one, resumed)
    require(0 < resumed.blocks_total < one.blocks_total, f"{label}: resumed blocks {resumed.blocks_total}")
    walls = {k: r.wall_seconds * 1e3 for k, r in
             (("one_launch", one), ("segments", quiet), ("resumed", resumed))}
    walls["snapshots"] = snapped_ms
    snap_note = (f"snapshotted every segment ({len(taken)} snapshots, run equal too)"
                 if every_segment else f"ended at its first boundary with one snapshot")
    print(
        f"checkpoint {label} x{REPLICAS}: {n_chunks} blocks in {quiet_launches} segments of "
        f"{per_segment}; segmented run equals the one-launch run; {snap_note} of "
        f"{npz_bytes / 1e9:.3f} GB; resumed at block {target} ({resumed_launches} launches) "
        f"equals it too; wall ms: one launch {walls['one_launch']:.1f}, segments "
        f"{walls['segments']:.1f}, snapshot run {snapped_ms:.1f} ({snapped_launches} launches), "
        f"resumed {walls['resumed']:.1f}; npz write {save_s:.2f} s, read {load_s:.2f} s {tag}"
    )
    return {"blocks": n_chunks, "segments": quiet_launches, "per_segment": per_segment,
            "snapshots": len(taken), "snapshot_launches": snapped_launches,
            "resumed_at": target, "resumed_launches": resumed_launches,
            "npz_bytes": npz_bytes, "npz_write_s": save_s, "npz_read_s": load_s,
            "wall_ms": walls}


def checkpoint_phase(tag: str) -> dict:
    """checkpoint_run on the M/M/1's scan (a snapshot every segment: its
    state is the smallest), the fan-out (its slot and transit rows
    staged), the chaos bench, the telemetry bench model and the defended
    resilience arm."""
    print(f"checkpoint and resume at {REPLICAS} replicas, {CHECKPOINT_SEGMENTS} segments:")
    t0 = time.perf_counter()
    runs = {
        "mm1": checkpoint_run("mm1", mm1_model(LAM, MU, HORIZON_S, warmup_s=WARMUP_S), tag,
                              every_segment=True),
        "fanout": checkpoint_run("fanout", router_model("random", HORIZON_S, WARMUP_S), tag),
        "chaos": checkpoint_run("chaos", chaos_model(), tag, CHAOS_SWEEPS, CHAOS_MAX_EVENTS),
        "telemetry": checkpoint_run("telemetry", telemetry_model(), tag, HETERO_SWEEPS,
                                    TEL_MAX_EVENTS),
        "resilience-defended": checkpoint_run(
            "resilience-defended", resilience_bench_model(True), tag, RES_SWEEPS, RES_MAX_EVENTS
        ),
    }
    print(f"checkpoint phase: {time.perf_counter() - t0:.1f} s {tag}")
    return runs


# -- trace-driven arrivals -------------------------------------------------------
# bench.py's _trace_measure: its horizon, page length and budget, and the
# telemetry window of its model.
TRACE_HORIZON_S, TRACE_CHUNK_LEN, TRACE_MAX_EVENTS, TRACE_WINDOW_S = 16.0, 64, 16384, 2.0
# The page length of the paging-independence run: a page of 2,048 covers
# more than a block loop of 20 blocks reads, so the timed launches of
# time_trace_blocks never stall.
TRACE_LONG_CHUNK = 2048
# The stream step whose snapshot the checkpointed traced run keeps.
TRACE_SNAPSHOT_STEP = 5
# The traced chaos model: the flash crowd beside a Poisson source at 50/s
# into the server, which times a job out after 10 ms and retries it once
# (about 8% of the 4 ms services outlast the deadline).
TRACE_CHAOS = {"poisson_rate": 50.0, "deadline_s": 0.01}
# The traced defended model: the traced chaos model with a retry budget
# of 2 tokens a second, bursts of two, which holds most retries back.
TRACE_DEFENDED = {**TRACE_CHAOS, "budget": {"ratio": 0.0, "min_per_s": 2.0, "burst": 2.0}}


def bench_trace(kind: str, chunk_len: int = TRACE_CHUNK_LEN) -> TraceSpec:
    """_trace_measure's traces: the diurnal sinusoid (200/s, amplitude
    0.6, period 8 s) and the flash crowd (100/s, 500/s over [4, 6) s),
    over 16 s, seed 11."""
    if kind == "diurnal":
        return diurnal_trace(200.0, 0.6, TRACE_HORIZON_S / 2, TRACE_HORIZON_S, seed=11,
                             chunk_len=chunk_len)
    return flash_crowd_trace(100.0, 500.0, TRACE_HORIZON_S / 4, TRACE_HORIZON_S * 3 / 8,
                             TRACE_HORIZON_S, seed=11, chunk_len=chunk_len)


def trace_model(kind: str, chunk_len: int = TRACE_CHUNK_LEN, poisson_rate: float = 0.0,
                deadline_s=None, budget=None) -> EnsembleModel:
    """_trace_measure's model: the trace into a four-slot server (4 ms,
    queue 64) -> sink, macro_block 16, 2 s windows of throughput, latency
    and rates; with ``poisson_rate``, a Poisson source at that rate
    superposed on the server ahead of the trace (several sources: the
    trace library's chaos-free MULTI code); with ``deadline_s``, the
    server times a job out after it and retries it once at its queue's
    tail (the trace library's MULTI chaos code without the defenses'
    sites); with ``budget``, a retry budget of those arguments (its whole
    MULTI chaos code)."""
    model = EnsembleModel(horizon_s=TRACE_HORIZON_S, macro_block=16)
    retry = {} if deadline_s is None else {"deadline_s": deadline_s, "max_retries": 1}
    srv = model.server(concurrency=4, service_mean=0.004, queue_capacity=64, **retry)
    if poisson_rate:
        model.connect(model.source(rate=poisson_rate), srv)
    model.connect(model.trace_arrivals(bench_trace(kind, chunk_len)), srv)
    model.connect(srv, model.sink())
    model.telemetry(window_s=TRACE_WINDOW_S, metrics=("throughput", "latency", "rates"))
    if budget is not None:
        model.retry_budget(**budget)
    return model


def trace_pages(compiled, base_page: int) -> tuple:
    """The resident pages base_page and base_page + 1 on the card, +inf
    padded past the trace's end."""
    P = compiled.trace_chunk_len
    out = []
    for page in (base_page, base_page + 1):
        times, tenants = np.full(P, np.inf, np.float32), np.zeros(P, np.int32)
        if page < compiled.trace_pages:
            times = compiled.trace_times[page * P : (page + 1) * P]
            tenants = compiled.trace_tenants[page * P : (page + 1) * P]
        out += [torch.from_numpy(np.ascontiguousarray(times)).cuda(),
                torch.from_numpy(np.ascontiguousarray(tenants)).cuda()]
    return tuple(out)


def check_trace_stream(name: str, model, every: int = 1) -> float:
    """The trace branch against plain_trace_steps over a whole traced run
    at REPLICAS replicas and TRACE_MAX_EVENTS: every ``every``-th stream
    step (and the first two) runs the plain version on a copy of the state
    and the same pages, and every leaf and the halted mask are compared;
    the window moves on as the engine moves it. The run must stall lanes
    at the window's edge and end with every lane past the trace's end."""
    compiled, keys, params, state = fresh_run(model)
    P, macro, ti = compiled.trace_chunk_len, compiled.macro, compiled.trace_src
    n_chunks = -(-TRACE_MAX_EVENTS // macro)
    n_arrivals = compiled.trace.n_arrivals
    base_page, step, max_abs, compared, stalled_seen = 0, 0, 0.0, 0, 0
    while True:
        pages = trace_pages(compiled, base_page)
        compare = step < 2 or step % every == 0
        if compare:
            plain = {k: v.clone() for k, v in state.items()}
            plain_halted = event_step.plain_trace_steps(
                compiled, plain, keys, params, pages, base_page * P, n_chunks
            )
        halted = event_step.trace_steps(compiled, state, keys, params, pages, base_page * P, n_chunks)
        torch.cuda.synchronize()
        cursor = state["trc_cursor"].to(torch.int64)
        reads = torch.isfinite(state["src_next"][:, ti]) & (state["trc_blocks"] < n_chunks) & ~halted
        stalled = int((reads & (cursor + macro >= base_page * P + 2 * P)).sum())
        require(stalled == int(reads.sum()), f"{name} step {step}: a reading lane is not stalled")
        stalled_seen = max(stalled_seen, stalled)
        past_end = int((~torch.isfinite(state["src_next"][:, ti]) & (cursor >= n_arrivals)).sum())
        if compare:
            max_abs = max(max_abs, compare_states(state, plain, f"{name} stream step {step}"))
            require(bool((halted == plain_halted).all()), f"{name} stream step {step}: halted differs")
            compared += 1
            print(
                f"  {name} stream step {step} (window from arrival {base_page * P}): kernel == plain "
                f"on every leaf; {stalled} lanes stalled at the window's edge, {past_end} past the "
                f"trace's end"
            )
        if not bool(reads.any()):
            break
        base_page = max(int(cursor[reads].min()) // P, base_page + 1)
        step += 1
    require(stalled_seen > 0, f"{name}: no lane stalled")
    require(past_end == REPLICAS, f"{name}: {past_end} lanes read past the trace's end")
    print(f"  {name}: {compared} of {step + 1} stream steps compared, every lane past the "
          f"trace's end ({n_arrivals} arrivals) at the last")
    return max_abs


def time_trace_blocks(kind: str, **model_kw) -> dict:
    """The trace branch's time per block at REPLICAS replicas, every lane
    live: from the first two blocks of the model (trace_model's, with
    ``model_kw``) with pages of TRACE_LONG_CHUNK arrivals (20 blocks never
    reach the window's edge), a launch with a budget of 20 more blocks,
    twice, each on its own copy of the state; its bound, reckoned as
    time_blocks reckons it (the dense state moved once, the float
    operations of the steps, the threefry the kernel counted); and the
    plain version's time per block."""
    model = trace_model(kind, TRACE_LONG_CHUNK, **model_kw)
    compiled, keys, params, state = fresh_run(model)
    pages = trace_pages(compiled, 0)
    halted = torch.empty((REPLICAS,), dtype=torch.uint8, device="cuda")
    event_step.trace_steps(compiled, state, keys, params, pages, 0, 2)  # warm-up
    budget = 2 + TIMED_BLOCKS
    states = [{k: v.clone() for k, v in state.items()} for _ in range(3)]
    args = [
        event_step.trace_launch_args(compiled, st, keys, params, pages, 0, budget, halted)
        for st in states[:2]
    ]
    kernel_ms = launch_ms(args) / (2 * TIMED_BLOCKS)
    require(bool((states[0]["trc_blocks"] == budget).all()), f"trace {kind}: a lane stopped early")
    drawn = torch.zeros((REPLICAS,), dtype=torch.int32, device="cuda")
    event_step.launch(
        event_step.trace_launch_args(compiled, states[2], keys, params, pages, 0, budget, halted, drawn),
        torch.device("cuda"),
    )
    folds = TIMED_BLOCKS * REPLICAS
    total_drawn = int(drawn.sum())
    plain = {k: v.clone() for k, v in state.items()}
    event_step.plain_trace_steps(compiled, plain, keys, params, pages, 0, 3)  # warm-up
    plain_ms = elapsed_ms(
        lambda i: event_step.plain_trace_steps(compiled, plain, keys, params, pages, 0, 4 + i), 3
    )
    # The two resident pages, 4-byte times and tenants, read once.
    bytes_per_block = (support.launch_bytes(compiled, state) + 2 * 8 * compiled.trace_chunk_len) / TIMED_BLOCKS
    float_ops_per_block = (
        REPLICAS * compiled.macro * (OPS_PER_STEP_BASE + OPS_PER_STEP_PER_SERVER * compiled.nV)
        + extension_ops(compiled, state, states[0]) / TIMED_BLOCKS
    )
    bytes_ms = bytes_per_block / PEAK_BYTES_PER_S * 1e3
    ops_ms = max(
        float_ops_per_block / PEAK_F32_OPS_PER_S * 1e3,
        int_ms(support.draw_int_ops(folds, total_drawn) / TIMED_BLOCKS,
               support.draw_alu_ops(folds, total_drawn) / TIMED_BLOCKS),
    )
    return {
        "model": f"trace-{kind}, pages of {TRACE_LONG_CHUNK}",
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "threefry_per_lane_block": total_drawn / folds,
        "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "int_ops_per_lane_block": support.draw_int_ops(folds, total_drawn) / folds,
        "alu_ops_per_lane_block": support.draw_alu_ops(folds, total_drawn) / folds,
        "float_ops_per_block": float_ops_per_block,
    }


def launch_bytes_of(model) -> int:
    """support.launch_bytes of a launch over REPLICAS replicas of
    ``model``, from one replica's state on the host."""
    compiled = _Compiled(model)
    params = {k: torch.from_numpy(v) for k, v in _resolve_params(model, compiled, 1, None).items()}
    state = compiled.init_state(rng.split(rng.PRNGKey(0), 1), params)
    return REPLICAS * support.replica_working_set_bytes(compiled, state) + support.shared_const_bytes(compiled)


def traced_run(label: str, model, tag: str, code=None, **kw) -> tuple:
    """run_ensemble on cuda for a traced model at REPLICAS replicas and
    TRACE_MAX_EVENTS, with the launch counts set to 0 just before and read
    just after, each launch timed with CUDA events; returns (result,
    launches, kernel ms). ``code``, a key of event_step.launches_by_code:
    every launch must have taken that code of the trace library."""
    timed_launches = []
    launch = event_step.launch

    def timed_launch(args, device):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(args, device)
        end.record()
        timed_launches.append((start, end))

    event_step.launch = timed_launch
    try:
        event_step.block_step.launches = 0
        event_step.trace_steps.launches = 0
        uniform.replica_uniform.launches = 0
        event_step.launches_by_code.clear()
        result = run_ensemble(model, n_replicas=REPLICAS, max_events=TRACE_MAX_EVENTS, **kw)
        launches = event_step.trace_steps.launches
        by_code = dict(event_step.launches_by_code)
    finally:
        event_step.launch = launch
    if code is not None:
        require(by_code == {code: launches}, f"{label}: launches by code {by_code}, not all {code}")
    require(event_step.block_step.launches == 0 and uniform.replica_uniform.launches == 0,
            f"{label}: a launch off the trace library")
    torch.cuda.synchronize()
    kernel_ms = sum(start.elapsed_time(end) for start, end in timed_launches)
    require(result.engine_path == "scan+cuda" and result.kernel_decline == "",
            f"{label}: engine_path {result.engine_path}, decline {result.kernel_decline!r}")
    report = result.engine_report()["trace"]
    require(launches == result.trace_stream_steps > 0, f"{label}: {launches} launches")
    require(result.trace_max_resident_chunks <= 2, f"{label}: {report}")
    require(result.truncated_replicas == 0, f"{label}: {result.truncated_replicas} truncated replicas")
    return result, launches, kernel_ms


def trace_run_gates(label: str, result, trace) -> None:
    """Every replica replays the whole trace: its arrivals per tenant are
    REPLICAS x the trace's, and each window's are REPLICAS x the trace's
    instants in that window (the window of t as the step computes it)."""
    want = REPLICAS * np.bincount(trace.tenants, minlength=trace.n_tenants)
    require(result.trace_tenant_arrivals == want.tolist(),
            f"{label}: tenant arrivals {result.trace_tenant_arrivals} != {want.tolist()}")
    ts = result.timeseries
    inv = np.float32(1.0) / np.float32(TRACE_WINDOW_S)
    windows = np.clip((trace.times * inv).astype(np.int32), 0, ts.n_windows - 1)
    per_window = REPLICAS * np.bincount(windows, minlength=ts.n_windows)
    require(np.array_equal(ts.trace_tenant_arrivals[:, 0], per_window),
            f"{label}: window arrivals {ts.trace_tenant_arrivals[:, 0]} != {per_window}")
    require(ts.trace_tenant_arrivals.sum(axis=0).tolist() == result.trace_tenant_arrivals,
            f"{label}: the windows do not sum to the whole run")
    print(f"  {label}: tenant arrivals {result.trace_tenant_arrivals} = {REPLICAS} x "
          f"{trace.n_arrivals}; each of {ts.n_windows} windows = {REPLICAS} x the trace's "
          f"instants in it")


def trace_checkpoint(label: str, kind: str, one, tag: str) -> dict:
    """A snapshot after stream step TRACE_SNAPSHOT_STEP (lanes frozen
    mid-page), through save and load, resumed: equal to the
    uninterrupted run on every field but RESUME_EXCLUDED_FIELDS and the
    paging counts."""
    kept = []

    def keep(snapshot):
        kept.append(snapshot)
        if len(kept) == TRACE_SNAPSHOT_STEP:
            raise _SnapshotKept

    try:
        run_ensemble(trace_model(kind), n_replicas=REPLICAS, max_events=TRACE_MAX_EVENTS,
                     checkpoint_every_s=0.0, checkpoint_callback=keep)
    except _SnapshotKept:
        pass
    require(len(kept) == TRACE_SNAPSHOT_STEP, f"{label}: {len(kept)} snapshots")
    snap = kept[-1]
    cursors = snap.state["trc_cursor"].astype(np.int64)
    mid_page = int((cursors % TRACE_CHUNK_LEN != 0).sum())
    require(mid_page > 0, f"{label}: no lane frozen mid-page")
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = CKPT_DIR / f"{label}.npz"
    snap.save(str(path))
    loaded = EnsembleCheckpoint.load(str(path))
    path.unlink()
    resumed, launches, _ms = traced_run(f"{label} resumed", trace_model(kind), tag, resume_from=loaded)
    diff = resume_mismatches(one, resumed, TRACE_PAGING_FIELDS)
    require(not diff, f"{label}: the resumed run differs on {diff}")
    print(f"  {label}: snapshot after stream step {TRACE_SNAPSHOT_STEP} (chunk_index "
          f"{snap.chunk_index}, {mid_page} lanes frozen mid-page, cursors "
          f"{int(cursors.min())}..{int(cursors.max())}), saved, loaded and resumed in {launches} "
          f"launches: equal to the uninterrupted run {tag}")
    return {"chunk_index": snap.chunk_index, "mid_page_lanes": mid_page, "resumed_launches": launches}


def trace_phase(tag: str) -> dict:
    """The trace branch: block checks over whole traced runs, its time
    per block, then _trace_measure's two scenarios through run_ensemble
    with their exact gates, paging independence and a mid-chunk resume."""
    t0 = time.perf_counter()
    print(f"trace branch against plain_trace_steps at {REPLICAS} replicas, pages of {TRACE_CHUNK_LEN}:")
    max_abs = max(
        check_trace_stream("trace-flash", trace_model("flash")),
        check_trace_stream("trace-diurnal", trace_model("diurnal"), every=8),
        check_trace_stream("trace-poisson", trace_model("flash", poisson_rate=50.0), every=8),
        check_trace_stream("trace-chaos", trace_model("flash", **TRACE_CHAOS), every=8),
        check_trace_stream("trace-defended", trace_model("flash", **TRACE_DEFENDED), every=8),
    )
    timing = {kind: time_trace_blocks(kind) for kind in ("flash", "diurnal")}
    timing["poisson"] = time_trace_blocks("flash", poisson_rate=50.0)
    timing["chaos"] = time_trace_blocks("flash", **TRACE_CHAOS)
    timing["defended"] = time_trace_blocks("flash", **TRACE_DEFENDED)
    out = {"max_abs_err": max_abs, "timing": timing, "runs": {}}
    for kind, t in timing.items():
        print(
            f"timing trace-{kind} ({t['model']}): kernel {t['kernel_ms']:.4f} ms/block in a "
            f"{TIMED_BLOCKS}-block launch, {100 * t['bound_ms'] / t['kernel_ms']:.1f}% of its bound "
            f"{t['bound_ms']:.4f} ms/block ({t['bound_by']}, {t['threefry_per_lane_block']:.1f} "
            f"threefry/lane/block); plain {t['plain_ms']:.3f} ms/block {tag}"
        )
    for kind in ("diurnal", "flash"):
        label = f"trace-{kind}"
        trace = bench_trace(kind)
        # Pages of 2,048 first: the process's first traced run pays the
        # pinned allocator's and the side stream's first use, and the
        # timed run below finds them warm.
        long_pages, _launches, _ms = traced_run(f"{label} pages of {TRACE_LONG_CHUNK}",
                                                trace_model(kind, TRACE_LONG_CHUNK), tag)
        result, launches, kernel_ms = traced_run(
            label, trace_model(kind), tag, code=("event_step_trace", "line", True)
        )
        report = trace_run_report(kind, trace_model(kind), result, launches, kernel_ms,
                                  timing[kind], tag)
        trace_run_gates(label, result, trace)
        diff = resume_mismatches(result, long_pages, TRACE_PAGING_FIELDS)
        require(not diff, f"{label}: pages of {TRACE_CHUNK_LEN} and {TRACE_LONG_CHUNK} differ on {diff}")
        print(f"  {label}: pages of {TRACE_CHUNK_LEN} and {TRACE_LONG_CHUNK} give the same counters, "
              f"histograms and window series (the run in pages of {TRACE_LONG_CHUNK}, before it: "
              f"{long_pages.trace_stream_steps} stream step, wall "
              f"{long_pages.wall_seconds * 1e3:.1f} ms) {tag}")
        out["runs"][label] = {
            **report, "long_pages_wall_ms": long_pages.wall_seconds * 1e3,
            "checkpoint": trace_checkpoint(label, kind, result, tag),
        }
    # The flash crowd beside a Poisson source (the chaos-free MULTI code
    # with the trace), beside it with a deadline and a retry at the server
    # (the MULTI chaos code with the trace), and with a retry budget
    # besides (the whole MULTI chaos code with the trace): the trace's
    # gates, timeouts and retries at the server, and the budget's drops.
    for name, model_kw, code in (
        ("poisson", {"poisson_rate": 50.0}, ("event_step_trace", "lean", True)),
        ("chaos", TRACE_CHAOS, ("event_step_trace", "chaos", True)),
        ("defended", TRACE_DEFENDED, ("event_step_trace", "full", True)),
    ):
        label = f"trace-{name}"
        result, launches, kernel_ms = traced_run(label, trace_model("flash", **model_kw), tag,
                                                 code=code)
        out["runs"][label] = trace_run_report(
            label, trace_model("flash", **model_kw), result, launches, kernel_ms, timing[name], tag
        )
        trace_run_gates(label, result, bench_trace("flash"))
        if name != "poisson":
            print(f"  {label}: timed out {result.server_timed_out[0]}, retried "
                  f"{result.server_retried[0]}, budget drops {result.server_budget_dropped or 'none'}")
            require(result.server_timed_out[0] > 0 and result.server_retried[0] > 0,
                    f"{label}: no timeout or retry")
            out["runs"][label]["retried"] = result.server_retried[0]
        if name == "defended":
            require(result.server_budget_dropped[0] > 0, f"{label}: no budget drop")
            require(result.server_retried[0] < out["runs"]["trace-chaos"]["retried"],
                    f"{label}: the budget held no retry back")
    print(f"trace phase: {time.perf_counter() - t0:.1f} s {tag}")
    return out


def trace_run_report(kind: str, model, result, launches: int, kernel_ms: float, t: dict,
                     tag: str) -> dict:
    """Prints a traced run's line and returns its numbers: its wall,
    kernel and host time, stream steps, blocks, the run's bound (each
    launch moves the dense state once, the float operations of its
    events, and the threefry of its lane-blocks at the timed launch's rate
    per lane-block, ``t``), paging and events/s."""
    wall_ms = result.wall_seconds * 1e3
    blocks = max(result.block_occupancy)
    report = result.engine_report()["trace"]
    run_bound_ms = max(
        launch_bytes_of(model) * launches / PEAK_BYTES_PER_S * 1e3,
        result.simulated_events * (OPS_PER_STEP_BASE + OPS_PER_STEP_PER_SERVER)
        / PEAK_F32_OPS_PER_S * 1e3,
        int_ms(t["int_ops_per_lane_block"] * result.blocks_total,
               t["alu_ops_per_lane_block"] * result.blocks_total),
    )
    print(
        f"trace {kind} x{REPLICAS}: engine_path {result.engine_path}; wall {wall_ms:.1f} ms, "
        f"kernel {kernel_ms:.2f} ms ({100 * kernel_ms / wall_ms:.1f}%) in {launches} launches = "
        f"stream steps, host {wall_ms - kernel_ms:.2f} ms; {blocks} blocks (the most a lane "
        f"ran), kernel {kernel_ms / blocks:.4f} ms a block against a bound of "
        f"{run_bound_ms / blocks:.4f} (the run's {run_bound_ms:.4f} ms, "
        f"{100 * run_bound_ms / kernel_ms:.2f}%); buffer stall "
        f"{report['buffer_stall_seconds']:.6f} s (fraction {report['stall_fraction']:.6f}), "
        f"{report['chunks_streamed']} pages uploaded, at most {report['max_resident_chunks']} "
        f"resident; {result.simulated_events} events = {result.events_per_second:.4g} events/s {tag}"
    )
    return {
        "wall_ms": wall_ms, "kernel_ms": kernel_ms, "host_ms": wall_ms - kernel_ms,
        "launches": launches, "blocks": blocks, "run_bound_ms": run_bound_ms,
        "events_per_second": result.events_per_second, **report,
    }


# run_mm1_ensemble as bench.py's bench_kernel calls it: 4,096 customers a
# replica, a quarter of them warmup.
MM1_CUSTOMERS = 4096
# Float operations of one customer of the scan, a log counted as one: two
# logs and negations, the two multiply-adds of the wait and its max; and
# of a live customer: the sum, two more multiply-adds.
MM1_OPS_PER_CUSTOMER, MM1_OPS_PER_LIVE = 9, 5


def timed(fn) -> tuple:
    """``fn()``'s result and its time in ms, from CUDA events around it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_mm1_scan(tag: str) -> dict:
    """The Lindley kernel against plain_mm1_scan, bit for bit, at the main
    path's call (REPLICAS x MM1_CUSTOMERS, a quarter warmup): the plain
    version's one timed run is the reference, held against one kernel
    call on the same key; then the kernel's time over 5 calls, beside the
    bound: the threefry evaluations the kernel makes (two uniforms a
    customer, each block's step keys folded once) at the 32-bit integer
    rate, its float operations, and 12 bytes written a replica."""
    key = rng.PRNGKey(0, device="cuda")
    n, warmup = MM1_CUSTOMERS, MM1_CUSTOMERS // 4
    want, plain_ms = timed(lambda: mm1_scan.plain_mm1_scan(key, REPLICAS, LAM, MU, n, warmup))
    got = mm1_scan.mm1_scan(key, REPLICAS, LAM, MU, n, warmup)
    torch.cuda.synchronize()
    max_abs_err = 0.0
    for label, g, w in zip(("sum_w", "sum_sq", "sum_s"), got, want):
        max_abs_err = max(max_abs_err, float((g.double() - w.double()).abs().max()))
        require(torch.equal(g.view(torch.int32), w.view(torch.int32)),
                f"mm1 scan kernel differs from plain_mm1_scan on {label}")
        require(bool((g > 0).all()), f"mm1 scan: a replica's {label} is not positive")
    kernel_ms = elapsed_ms(lambda i: mm1_scan.mm1_scan(key, REPLICAS, LAM, MU, n, warmup), 5)
    threads = mm1_scan.load_library().hs_mm1_scan_threads()
    folds = -(-REPLICAS // threads) * n
    int_ops = REPLICAS * n * 2 * support.UNIFORM_INT_OPS + folds * support.THREEFRY_OPS
    alu_ops = REPLICAS * n * 2 * support.UNIFORM_ALU_OPS + folds * support.THREEFRY_ALU_OPS
    float_ops = REPLICAS * (MM1_OPS_PER_CUSTOMER * n + MM1_OPS_PER_LIVE * (n - warmup))
    ops_ms = max(int_ms(int_ops, alu_ops), float_ops / PEAK_F32_OPS_PER_S * 1e3)
    bytes_ms = (REPLICAS * 12 + 8) / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(
        f"mm1 scan kernel == plain_mm1_scan bit for bit on {REPLICAS} replicas x {n} customers "
        f"(warmup {warmup}; max abs err {max_abs_err}): kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms, {100 * bound_ms / kernel_ms:.1f}% of its bound {bound_ms:.4f} ms "
        f"({'bytes' if bytes_ms >= ops_ms else 'operations'}: {int_ops / 1e9:.2f} G int ops, "
        f"{float_ops / 1e9:.2f} G float ops) {tag}"
    )
    return {"kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": max_abs_err, "int_ops": int_ops, "float_ops": float_ops}


def mm1_main_path(tag: str) -> tuple:
    """run_mm1_ensemble(8, 10, REPLICAS, MM1_CUSTOMERS) on cuda with the
    launch count set to 0 just before and read just after: one launch,
    the mean wait within 1% of rho / (mu - lambda) = 0.4 s and the mean
    sojourn within 1% of 1 / (mu - lambda). A first call before it loads
    torch's kernels for the statistics (lazily, on first use); both walls
    are printed."""
    first = run_mm1_ensemble(LAM, MU, REPLICAS, MM1_CUSTOMERS, seed=0)
    mm1_scan.mm1_scan.launches = 0
    result = run_mm1_ensemble(LAM, MU, REPLICAS, MM1_CUSTOMERS, seed=0)
    launches = mm1_scan.mm1_scan.launches
    print(
        f"run_mm1_ensemble x{REPLICAS} x {MM1_CUSTOMERS} customers: {launches} kernel launch, "
        f"{result.simulated_events} events in {result.wall_seconds * 1e3:.3f} ms = "
        f"{result.events_per_second:.4g} events/s (the process's first call "
        f"{first.wall_seconds * 1e3:.3f} ms), library load {result.compile_seconds:.2f} s, "
        f"device {result.device_name} {tag}"
    )
    require(first.mean_wait_s == result.mean_wait_s, "run_mm1_ensemble: two calls differ")
    require(launches == 1, f"run_mm1_ensemble: {launches} kernel launches")
    require(result.device_name == torch.cuda.get_device_name(0), "run_mm1_ensemble: device")
    within(result.mean_wait_s, LAM / MU / (MU - LAM), "mm1-ensemble mean wait")
    within(result.mean_sojourn_s, 1.0 / (MU - LAM), "mm1-ensemble mean sojourn")
    require(math.isfinite(result.std_wait_s) and result.std_wait_s > 0, "mm1-ensemble std")
    return result, launches


# The opinion rounds: a batch of populations on one random graph, about
# 16 influencers an agent, weights in [0.1, 2).
OPINION_BATCH, OPINION_AGENTS, OPINION_DEGREE = 32, 2048, 16


def opinion_phase(tag: str) -> dict:
    """The DeGroot rounds of a (OPINION_BATCH, OPINION_AGENTS) batch on the
    card against the same call on the CPU (rtol 1e-5, atol 1e-6, the CPU
    tests' tolerance; float32 products in full precision on both sides);
    the bounded-confidence rounds one call a round, the card and the CPU
    fed the CPU's opinions each round (a confidence mask flips on an ulp
    of the product once the two drift, so only same-input rounds compare);
    the voter model's picks at OPINION_AGENTS agents equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    draw = np.random.default_rng(11)
    n = OPINION_AGENTS
    mask = draw.random((n, n)) < OPINION_DEGREE / n
    np.fill_diagonal(mask, False)
    weights = np.where(mask, draw.uniform(0.1, 2.0, (n, n)), 0.0).astype(np.float32)
    x = draw.uniform(-1.0, 1.0, (OPINION_BATCH, n)).astype(np.float32)
    w_cpu, x_cpu = torch.from_numpy(weights), torch.from_numpy(x)
    w_gpu, x_gpu = w_cpu.cuda(), x_cpu.cuda()
    out = {}

    def close(label, card, cpu):
        err = float((card.cpu() - cpu).abs().max())
        require(np.allclose(card.cpu().numpy(), cpu.numpy(), rtol=1e-5, atol=1e-6),
                f"{label}: the card differs from the CPU by {err}")
        return err

    card = opinion.degroot_rounds(x_cpu, w_cpu, 0.4, 16)  # no device named: the card
    require(card.device.type == "cuda", f"degroot ran on {card.device}, not the card")
    cpu = opinion.degroot_rounds(x_cpu, w_cpu, 0.4, 16, device="cpu")
    out["degroot_max_abs"] = close("degroot", card, cpu)
    out["degroot_ms"] = elapsed_ms(lambda i: opinion.degroot_rounds(x_gpu, w_gpu, 0.4, 16), 3)
    worst, state = 0.0, x_cpu
    for r in range(8):
        cpu = opinion.bounded_confidence_rounds(state, w_cpu, 0.3, 0.5, 1, device="cpu")
        card = opinion.bounded_confidence_rounds(state, w_gpu, 0.3, 0.5, 1)
        worst = max(worst, close(f"bounded confidence round {r}", card, cpu))
        state = cpu
    out["bounded_confidence_max_abs"] = worst
    out["bounded_confidence_ms"] = elapsed_ms(
        lambda i: opinion.bounded_confidence_rounds(x_gpu, w_gpu, 0.3, 0.5, 8), 3
    )
    key_gpu, key_cpu = rng.PRNGKey(5, device="cuda"), rng.PRNGKey(5)
    picks_card = opinion.voter_rounds(key_gpu, x_gpu[0], w_gpu, 8).cpu()
    picks_cpu = opinion.voter_rounds(key_cpu, x_cpu[0], w_cpu, 8, device="cpu")
    require(torch.equal(picks_card, picks_cpu), "voter: the card's picks differ from the CPU's")
    out["voter_ms"] = elapsed_ms(lambda i: opinion.voter_rounds(key_gpu, x_gpu[0], w_gpu, 8), 3)
    print(
        f"opinion x{OPINION_BATCH} populations of {n} agents (~{OPINION_DEGREE} influencers): "
        f"degroot 16 rounds == the CPU within rtol 1e-5 (max abs {out['degroot_max_abs']:.3g}), "
        f"{out['degroot_ms']:.3f} ms; bounded confidence 8 rounds, each == the CPU's on the same "
        f"opinions (max abs {worst:.3g}), {out['bounded_confidence_ms']:.3f} ms; voter 8 rounds "
        f"at {n} agents: picks == the CPU's, {out['voter_ms']:.3f} ms {tag}"
    )
    return out


# -- the wide code (lifted bounds) -------------------------------------------------
def wide_models() -> dict:
    """The five wide models at full width, each with the kernel shape its
    plan reports and the library its launches take."""
    models = {
        "wide-fleet": wide_fleet_model(),
        "wide-chain": wide_chain_model(),
        "wide-draws": wide_draws_model(),
        "wide-tenants": wide_tenants_model(),
        "wide-quorum": wide_quorum_model(),
    }
    out = {}
    for name, model in models.items():
        compiled = _Compiled(model)
        library = "event_step_wide" if support.wide_reasons(compiled) else "event_step"
        out[name] = (model, compiled.plan["shape"], library)
    return out


def mm1_window_wait(lam: float, mu: float, warmup: float, horizon: float, replicas: int,
                    seed: int = 12) -> float:
    """The mean queue wait of an M/M/1 started empty, over the customers
    whose service starts in [warmup, horizon], as run_ensemble books it:
    numpy's own Lindley recursion over ``replicas`` replicas, in chunks."""
    rng_np = np.random.default_rng(seed)
    n = int(lam * horizon + 8 * math.sqrt(lam * horizon) + 20)
    total, count = 0.0, 0
    for first in range(0, replicas, 1 << 16):
        r = min(1 << 16, replicas - first)
        arrivals = np.cumsum(rng_np.exponential(1.0 / lam, (r, n)), axis=1)
        service = rng_np.exponential(1.0 / mu, (r, n))
        free = np.zeros(r)
        for k in range(n):
            start = np.maximum(arrivals[:, k], free)
            free = start + service[:, k]
            measured = (start >= warmup) & (start <= horizon)
            total += float((start - arrivals[:, k])[measured].sum())
            count += int(measured.sum())
    return total / count


def wide_phase(tag: str) -> dict:
    """The wide code (csrc/event_step_wide.cu) and the 17-draw model, at
    65,536 replicas: each model's block checks (blocks 0-3 and one near
    the middle of its budget), its whole run in one launch against chained
    one-block launches, its run through run_ensemble with an explicit
    budget (the port's default, so a chain-form model stays on the scan)
    and its gate; the wide code's time a block on the fleet."""
    t0 = time.perf_counter()
    models = wide_models()
    out = {"max_abs_err": 0.0, "runs": {}, "whole": {}}
    print(f"wide code at {REPLICAS} replicas (the lean tables each model is past):")
    for name, (model, shape, library) in models.items():
        compiled = _Compiled(model)
        state_args = fresh_run(model)
        halted = torch.empty((REPLICAS,), dtype=torch.uint8, device="cuda")
        args = event_step.launch_args(compiled, state_args[3], state_args[1], 0, state_args[2], halted)
        got = event_step.library_of(args)
        chaos = bool(args.chaos or args.res.on or args.con.on)
        code = ("the chaos code" if chaos else "the chaos-free code") + (
            " with telemetry" if args.tel.nW else "")
        print(f"  {name}: {support.wide_reasons(compiled) or 'no lean table'}, "
              f"{compiled.n_draws} draws a step, library {got}, {code}")
        require(got == library, f"{name}: library {got}, expected {library}")
        n = -(-_default_max_events(model, None) // compiled.macro)
        out["max_abs_err"] = max(out["max_abs_err"], check_blocks(name, model, [0, 1, 2, 3, n // 3]))
        out["whole"][name] = check_whole_run(name, model)
        out["runs"][name] = main_path_run(name, model, tag, shape)
    runs = out["runs"]
    # The fleet's servers, each an M/M/1 at rho = 0.8 on its way from
    # empty over [0, 40) s, against an independent numpy Lindley reference
    # of that M/M/1 over the same window at 4 x 65,536 replicas (the
    # steady-state wait, 0.667 s, is some 4% above what a 10 s warmup
    # leaves); one server's mean over 65,536 replicas is good to about
    # 0.35%, the pooled mean of the 32 to about 0.07%, the reference to 0.17%.
    scan = runs["wide-fleet"][0].server_mean_wait_s
    lam = WIDE_RHO * WIDE_FLEET_MU
    ref = mm1_window_wait(lam, WIDE_FLEET_MU, WIDE_HORIZON_S / 4, WIDE_HORIZON_S, 4 * REPLICAS)
    print(f"  wide-fleet: steady-state M/M/1 wait {WIDE_RHO / (WIDE_FLEET_MU - lam):.6f} s; "
          f"the numpy reference over [10, 40) s {ref:.6f} s; the servers {min(scan):.6f}..{max(scan):.6f}")
    within(float(np.mean(scan)), ref, "wide-fleet pooled mean wait vs the reference")
    for v, wait in enumerate(scan):
        require(abs(wait - ref) <= 0.03 * ref, f"wide-fleet server[{v}] wait {wait} vs {ref}")
    # The chain against the chain form of the same model (an independent
    # algorithm and draw): its later stages fill from empty too.
    chain_form, _launches = chain_run("wide-chain-chain", models["wide-chain"][0], tag)
    print(f"  wide-chain: steady-state M/M/1 wait {LAM / MU / (MU - LAM):.6f} s")
    for v, (a, b) in enumerate(zip(runs["wide-chain"][0].server_mean_wait_s,
                                   chain_form.server_mean_wait_s)):
        within(a, b, f"wide-chain stage[{v}] mean wait vs the chain form")
    tenants = runs["wide-tenants"][0]
    rho = sum(range(1, WIDE_TENANTS + 1)) / WIDE_TENANT_SERVERS / WIDE_TENANT_MU
    for v, util in enumerate(tenants.server_utilization):
        within(util, rho, f"wide-tenants server[{v}] utilization", unit="")
    quorum = runs["wide-quorum"][0]
    compiled = _Compiled(models["wide-quorum"][0])
    keys = rng.split(rng.PRNGKey(0), REPLICAS)
    params = {k: torch.from_numpy(v) for k, v in _resolve_params(
        compiled.model, compiled, REPLICAS, None).items()}
    cpu_dark = compiled.init_state(keys, params)["qrm_dark_time"]
    cpu_fraction = float(host_f64(sum_f32_fixed(cpu_dark))) / (REPLICAS * CONSENSUS_HORIZON_S)
    print(f"  wide-quorum dark fraction {quorum.quorum_dark_fraction:.9f} (the CPU path "
          f"{cpu_fraction:.9f}), quorum drops {sum(quorum.server_quorum_dropped)}, partition "
          f"drops {quorum.network_partitioned}")
    require(abs(quorum.quorum_dark_fraction - cpu_fraction) <= 1e-6 * max(cpu_fraction, 1e-30),
            "wide-quorum dark fraction")
    draws = runs["wide-draws"][0]
    require(sum(draws.server_hedged) > 0 and draws.network_lost > 0, "wide-draws: no hedge or loss")
    # The chaos-free wide code on the fleet, the chaos code (with the
    # telemetry and consensus sites) on the quorum.
    out["timing"] = {}
    for variant, name in (("wide-lean", "wide-fleet"), ("wide", "wide-quorum")):
        t = out["timing"][name] = time_blocks(models[name][0], name)
        w = out["whole"][name]
        print(
            f"timing {variant} ({name}): kernel {t['kernel_ms']:.4f} ms/block in a "
            f"{TIMED_BLOCKS}-block launch, {100 * t['bound_ms'] / t['kernel_ms']:.2f}% of its bound "
            f"{t['bound_ms']:.4f} ms/block ({t['bound_by']}); the whole run {w['run_ms']:.3f} ms for "
            f"{w['blocks']} blocks (bound {w['bound_ms']:.4f} ms); plain {t['plain_ms']:.3f} "
            f"ms/block {tag}"
        )
    # Each whole run beside its bound (the dense state moved once, the
    # float operations of its events, the threefry it counted).
    for name, w in out["whole"].items():
        print(f"  {name} whole run: {w['run_ms']:.3f} ms for {w['blocks']} blocks, "
              f"{100 * w['bound_ms'] / w['run_ms']:.2f}% of its bound {w['bound_ms']:.4f} ms "
              f"({w['bound_by']}) {tag}")
    out["seconds"] = time.perf_counter() - t0
    print(f"wide phase: {out['seconds']:.1f} s {tag}")
    return out


# -- the replica mesh ----------------------------------------------------------------
# bench.py's _multichip_measure: replicas, horizon, windows and budget.
MESH_REPLICAS, MESH_HORIZON_S, MESH_WINDOWS, MESH_MAX_EVENTS = 65536, 30.0, 32, 640
# The shard counts of the one card's virtual meshes.
MESH_SHARDS = (1, 4)


def multichip_model() -> EnsembleModel:
    """_multichip_measure's workload: a faulted, telemetered rho-sweep
    M/M/1 (mu = 10, queue 256, deadline 8 s, 2 retries, FaultSpec(rate
    0.05, mean 0.5 s)), horizon 30 s, warmup 5 s, 32 windows."""
    model = EnsembleModel(horizon_s=MESH_HORIZON_S, warmup_s=MESH_HORIZON_S / 6)
    srv = model.server(service_mean=1.0 / MU, queue_capacity=256, deadline_s=8.0, max_retries=2,
                       fault=FaultSpec(rate=0.05, mean_duration_s=0.5))
    model.connect(model.source(rate=0.95 * MU), srv)
    model.connect(srv, model.sink())
    model.telemetry(window_s=MESH_HORIZON_S / MESH_WINDOWS)
    return model


MESH_SWEEPS = {"source_rate": np.linspace(0.1 * MU, 0.95 * MU, MESH_REPLICAS).astype(np.float32)}
# The mesh's own provenance, which differs between shard counts by design.
MESH_FIELDS = frozenset({"mesh_devices", "mesh_shape", "per_shard_replicas"})


def card_mesh(shards: int):
    """``shards`` shards of cuda:0 (the one card's virtual mesh)."""
    from happysim_tpu_torch.mesh import replica_mesh

    return replica_mesh(["cuda:0"] * shards)


def mesh_same(label: str, a, b) -> None:
    """bench.py's assertion (counters, histogram and every window
    series) and every other result field but the mesh's provenance."""
    require(
        a.sink_count == b.sink_count and a.simulated_events == b.simulated_events
        and a.server_fault_dropped == b.server_fault_dropped
        and a.server_timed_out == b.server_timed_out
        and a.sink_mean_latency_s == b.sink_mean_latency_s
        and np.array_equal(a.sink_hist, b.sink_hist),
        f"{label}: the counters differ",
    )
    require(a.timeseries == b.timeseries, f"{label}: a window series differs")
    bad = resume_mismatches(a, b, MESH_FIELDS)
    require(not bad, f"{label}: {bad} differ")


def mesh_phase(tag: str) -> dict:
    """run_ensemble and run_mm1_ensemble on meshes of cuda:0 repeated 1 and
    4 times at full width: _multichip_measure's workload, the M/M/1
    ensemble, checkpoints resumed 1 -> 4 and 4 -> 1 shards, and the flash
    crowd of _trace_measure; every pair the same bits, one launch a shard."""
    t0 = time.perf_counter()
    print(f"replica mesh of cuda:0 at {MESH_REPLICAS} replicas, {MESH_SHARDS} shards:")
    out = {"walls": {}, "launches": {}}
    runs = {}
    for shards in MESH_SHARDS:
        event_step.block_step.launches = 0
        result = run_ensemble(multichip_model(), n_replicas=MESH_REPLICAS, seed=0,
                              mesh=card_mesh(shards), max_events=MESH_MAX_EVENTS, sweeps=MESH_SWEEPS)
        launches = event_step.block_step.launches
        require(result.engine_path == "scan+cuda" and launches == shards,
                f"multichip x{shards}: {result.engine_path}, {launches} launches")
        runs[shards] = result
        out["walls"][f"multichip x{shards}"] = result.wall_seconds
        out["launches"][f"multichip x{shards}"] = launches
        print(f"  multichip {shards} shard(s): wall {result.wall_seconds * 1e3:.3f} ms, {launches} "
              f"launches, {result.simulated_events} events, {result.events_per_second:.4g} events/s, "
              f"reduce {result.reduce_path} {tag}")
    mesh_same("multichip 1 vs 4 shards", runs[1], runs[4])
    print("  multichip 1 vs 4 shards: counters, histogram and every window series identical")

    mm1 = {}
    for shards in MESH_SHARDS:
        mm1_scan.mm1_scan.launches = 0
        mm1[shards] = run_mm1_ensemble(LAM, MU, REPLICAS, 4096, mesh=card_mesh(shards))
        require(mm1_scan.mm1_scan.launches == shards, f"mm1 x{shards}: launches")
        out["walls"][f"mm1 x{shards}"] = mm1[shards].wall_seconds
        print(f"  run_mm1_ensemble {shards} shard(s): wall {mm1[shards].wall_seconds * 1e3:.3f} ms, "
              f"mean wait {mm1[shards].mean_wait_s:.9f} s {tag}")
    fields = ("mean_wait_s", "std_wait_s", "mean_sojourn_s", "n_replicas", "simulated_events")
    require([getattr(mm1[1], f) for f in fields] == [getattr(mm1[4], f) for f in fields],
            "run_mm1_ensemble: 1 vs 4 shards differ")
    print("  run_mm1_ensemble 1 vs 4 shards: identical")

    for source, target in ((1, 4), (4, 1)):
        snaps = []

        def keep(snapshot, snaps=snaps):
            snaps.append(snapshot)
            if len(snaps) >= 3:
                raise _SnapshotKept

        try:
            run_ensemble(multichip_model(), n_replicas=MESH_REPLICAS, seed=0,
                         mesh=card_mesh(source), max_events=MESH_MAX_EVENTS, sweeps=MESH_SWEEPS,
                         checkpoint_every_s=0.0, checkpoint_callback=keep)
        except _SnapshotKept:
            pass
        snapshot = snaps[-1]
        require(snapshot.mesh_devices == source, f"snapshot of {source} shards: {snapshot.mesh_devices}")
        resumed = run_ensemble(multichip_model(), n_replicas=MESH_REPLICAS, seed=0,
                               mesh=card_mesh(target), max_events=MESH_MAX_EVENTS,
                               sweeps=MESH_SWEEPS, resume_from=snapshot)
        mesh_same(f"resume {source} -> {target} shards", runs[1], resumed)
        out["walls"][f"resume {source}->{target}"] = resumed.wall_seconds
        out[f"redistribution {source}->{target}"] = resumed.redistribution_seconds
        print(f"  resume {source} -> {target} shards from chunk {snapshot.chunk_index} of "
              f"{snapshot.n_chunks}: the uninterrupted bits; wall {resumed.wall_seconds * 1e3:.3f} ms, "
              f"redistribution_seconds {resumed.redistribution_seconds:.6f} {tag}")

    traced = {}
    for shards in MESH_SHARDS:
        trace_steps_launches = event_step.trace_steps.launches
        traced[shards] = run_ensemble(trace_model("flash"), n_replicas=MESH_REPLICAS,
                                      mesh=card_mesh(shards), max_events=TRACE_MAX_EVENTS)
        launches = event_step.trace_steps.launches - trace_steps_launches
        result = traced[shards]
        require(launches == shards * result.trace_stream_steps, f"trace x{shards}: launches")
        require(result.trace_max_resident_chunks <= 2, f"trace x{shards}: pages resident")
        out["walls"][f"trace-flash x{shards}"] = result.wall_seconds
        print(f"  trace-flash {shards} shard(s): wall {result.wall_seconds * 1e3:.3f} ms, "
              f"{result.trace_stream_steps} stream steps, {launches} launches {tag}")
    mesh_same("trace-flash 1 vs 4 shards", traced[1], traced[4])
    print("  trace-flash 1 vs 4 shards: identical")
    out["seconds"] = time.perf_counter() - t0
    print(f"mesh phase: {out['seconds']:.1f} s {tag}")
    return out


# -- the partitioned executor -------------------------------------------------------
# The JAX package's example ring (examples/tpu/partitioned_ring.py): lambda
# 5, mu 20, queue 256, hop latency 50 ms, a random router over [sink,
# remote]; 8 partitions on cuda:0, 8,192 replicas each (65,536 lanes),
# horizon 30 s in windows of the hop (600), outboxes of 128 entries.
PART_P, PART_R = 8, REPLICAS // 8
PART_LAM, PART_MU, PART_HOP_S, PART_HORIZON_S, PART_OUTBOX = 5.0, 20.0, 0.05, 30.0, 128
# Jackson's product form: two visits of 1 / (mu - 2 lam) and one hop.
PART_PRODUCT_FORM_S = 2.0 / (PART_MU - 2.0 * PART_LAM) + PART_HOP_S
# The bit checks: the first 16 windows at the main path's 8 x 8,192 lanes
# (and window 100 of the timed ring, in time_partitioned); the whole runs
# over 3 s (60 windows) at 8 x 128 lanes, where the plain versions' torch
# ops keep the phase inside its minute.
PART_CHECK_WINDOWS = 16
PART_RUN_R, PART_RUN_HORIZON_S = 128, 3.0
# Windows before the timed ones (the ring near its steady state), and the
# timed windows.
PART_WARM_WINDOWS, PART_TIMED_WINDOWS = 100, 20
PART_LIBRARY_NOTE = "none: no single PyTorch call computes a window or its barrier"
# Cycles the device sleeps before held timings (about 20 ms at 1.98 GHz),
# longer than the host takes to queue the timed windows behind it.
PART_HOLD_CYCLES = 40_000_000
# Folded and unfolded runs of the ring, in turns, for its walls.
PART_WALL_PAIRS = 4


def partitioned_ring_model(horizon_s: float = PART_HORIZON_S) -> EnsembleModel:
    """examples/tpu/partitioned_ring.py's ring, a partition's topology."""
    m = EnsembleModel(horizon_s=horizon_s)
    src = m.source(rate=PART_LAM)
    srv = m.server(service_mean=1.0 / PART_MU, queue_capacity=256)
    snk = m.sink()
    remote = m.remote(ingress=srv, latency_s=PART_HOP_S)
    router = m.router(policy="random")
    m.connect(src, srv)
    m.connect(srv, router)
    m.connect(router, snk)
    m.connect(router, remote)
    return m


def partitioned_chaos_model(horizon_s: float = PART_HORIZON_S) -> EnsembleModel:
    """The ring at lambda 8 with chaos on its server: a brownout over the
    second fifth of the horizon, a 0.3 s deadline with two retries after a
    20 ms backoff (retries park in the transit registers beside the jobs
    the neighbour sends)."""
    m = EnsembleModel(horizon_s=horizon_s)
    src = m.source(rate=8.0)
    srv = m.server(service_mean=1.0 / PART_MU, queue_capacity=256, deadline_s=0.3,
                   max_retries=2, retry_backoff_s=0.02, outage=(horizon_s / 5, 2 * horizon_s / 5))
    snk = m.sink()
    remote = m.remote(ingress=srv, latency_s=PART_HOP_S)
    router = m.router(policy="random")
    m.connect(src, srv)
    m.connect(srv, router)
    m.connect(router, snk)
    m.connect(router, remote)
    return m


def partitioned_two_sink_model(horizon_s: float = PART_HORIZON_S) -> EnsembleModel:
    """Two tenants a partition (the code for several sources and sinks): a
    Poisson 4/s source -> server 0 -> random over [sink 0, remote into the
    neighbour's server 0], and a constant 3/s source -> server 1 -> random
    over [sink 1 behind a 10 ms exponential edge, remote into the
    neighbour's server 1 after 80 ms]."""
    m = EnsembleModel(horizon_s=horizon_s)
    sources = (m.source(rate=4.0), m.source(rate=3.0, kind="constant"))
    servers = (m.server(service_mean=0.04, queue_capacity=128),
               m.server(service_mean=0.05, queue_capacity=128))
    sinks = (m.sink(), m.sink())
    remotes = (m.remote(ingress=servers[0], latency_s=PART_HOP_S),
               m.remote(ingress=servers[1], latency_s=0.08))
    for i, (src, srv, snk, remote) in enumerate(zip(sources, servers, sinks, remotes)):
        router = m.router(policy="random")
        m.connect(src, srv)
        m.connect(srv, router)
        if i == 0:
            m.connect(router, snk)
        else:
            m.connect(router, snk, latency_s=0.01, latency_kind="exponential")
        m.connect(router, remote)
    return m


def partitioned_full_row_model(horizon_s: float = PART_HORIZON_S) -> EnsembleModel:
    """The ring at lambda 8 with two transit registers a server and a
    remote of four windows (200 ms): about 1.6 jobs in flight into each
    server fill its registers, so full rows drop into tr_dropped and pops
    of the highest occupied slot lower the row's occupancy bound."""
    m = EnsembleModel(horizon_s=horizon_s, transit_capacity=2)
    src = m.source(rate=8.0)
    srv = m.server(service_mean=1.0 / PART_MU, queue_capacity=256)
    snk = m.sink()
    remote = m.remote(ingress=srv, latency_s=4 * PART_HOP_S)
    router = m.router(policy="random")
    m.connect(src, srv)
    m.connect(srv, router)
    m.connect(router, snk)
    m.connect(router, remote)
    return m


def partitioned_nine_remote_model(horizon_s: float = PART_HORIZON_S) -> EnsembleModel:
    """Nine remote egress nodes, past the lean code's table of eight (the
    wide code's device tables hold them): a Poisson 6/s source -> server
    0; server i (mu = 20, queue 128) -> a random router over [the sink,
    three remotes into the neighbour's servers 0, 1 and 2], the remotes'
    latencies the hop plus 5 ms a remote."""
    m = EnsembleModel(horizon_s=horizon_s)
    src = m.source(rate=6.0)
    servers = [m.server(service_mean=1.0 / PART_MU, queue_capacity=128) for _ in range(3)]
    snk = m.sink()
    m.connect(src, servers[0])
    for i, srv in enumerate(servers):
        router = m.router(policy="random")
        m.connect(srv, router)
        m.connect(router, snk)
        for j in range(3):
            rm = 3 * i + j
            m.connect(router, m.remote(ingress=servers[j], latency_s=PART_HOP_S + 0.005 * rm))
    return m


def card_partitions(partitions: int = PART_P):
    """``partitions`` partitions of cuda:0."""
    return partition_mesh(["cuda:0"] * partitions)


def partitioned_setup(model, replicas: int) -> tuple:
    """(compiled, state, params, budget) of PART_P partitions of
    ``replicas`` replicas on cuda, seed 0 (run_partitioned's lanes)."""
    compiled = _PartitionCompiled(model, PART_OUTBOX)
    state, params = init_partitions(compiled, 0, PART_P, replicas, 0, "cuda")
    return compiled, state, params, default_max_events_per_window(model, PART_HOP_S)


def partitioned_window(compiled, state, params, budget: int, w: int, plain: bool = False,
                       prepared=None) -> None:
    """Window ``w`` and its barrier: the kernels (through run_partitioned's
    wrappers, with its ``prepared`` dict, shared by both, where given), or
    their plain versions."""
    limit = window_end(w, PART_HOP_S)
    if plain:
        event_step.plain_window_steps(compiled, state, params, limit, budget)
        partition_barrier.plain_barrier(compiled, state, PART_P, limit)
    else:
        event_step.window_steps(compiled, state, state["key"], params, limit, budget, prepared)
        partition_barrier.barrier(compiled, state, PART_P, limit, prepared=prepared)


def check_bound(state: dict, context: str) -> int:
    """The occupancy bound the kernels keep for ``state``'s tr_time against
    its recomputation; returns its largest entry."""
    kept = event_step.kept_bound(state)
    require(torch.equal(kept, event_step.transit_bound(state)),
            f"{context}: the kept occupancy bound differs from tr_time's")
    return int(kept.max())


PART_OUTBOX_LEAVES = ("ob_arrival", "ob_created", "ob_ingress", "ob_len")


def check_windows(name: str, model) -> float:
    """The first PART_CHECK_WINDOWS windows at the main path's PART_P x
    PART_R lanes: after each window launch and after each barrier launch,
    the kernel's state against the plain versions' on every leaf, and the
    occupancy bound the kernels keep against its recomputation; and on a
    copy, the folded ring's launches (each window's launch running the
    previous window's barrier first, as run_partitioned runs a ring on
    one card): after folded launch w, every leaf but the outbox against
    the plain state after window w, the window's outbox (in the scratch
    slab of its parity) against the plain outbox leaves, and after the
    flush every leaf against the plain state after the last barrier. The
    kernels go through the wrappers as run_partitioned calls them, their
    arguments checked once and the bound shared."""
    compiled, state, params, budget = partitioned_setup(model, PART_R)
    plain = {k: v.clone() for k, v in state.items()}
    folded = {k: v.clone() for k, v in state.items()}
    ring = partition_barrier.folded_ring(compiled, folded, folded["key"], params, PART_P, budget, {})
    max_abs = 0.0
    prepared: dict = {}
    highest = 0
    for w in range(PART_CHECK_WINDOWS):
        limit = window_end(w, PART_HOP_S)
        event_step.window_steps(compiled, state, state["key"], params, limit, budget, prepared)
        ring.window(limit)
        event_step.plain_window_steps(compiled, plain, params, limit, budget)
        torch.cuda.synchronize()
        max_abs = max(max_abs, compare_states(state, plain, f"{name} window {w}"))
        highest = max(highest, check_bound(state, f"{name} window {w}"))
        slab = dict(zip(PART_OUTBOX_LEAVES, ring.outboxes[ring.pending[1]]))
        max_abs = max(max_abs, compare_states(
            {**folded, **slab}, plain, f"{name} folded window {w}"))
        check_bound(folded, f"{name} folded window {w}")
        queued = int(state["ob_len"].sum())
        partition_barrier.barrier(compiled, state, PART_P, limit, prepared=prepared)
        partition_barrier.plain_barrier(compiled, plain, PART_P, limit)
        torch.cuda.synchronize()
        max_abs = max(max_abs, compare_states(state, plain, f"{name} barrier {w}"))
        highest = max(highest, check_bound(state, f"{name} barrier {w}"))
        require(all(int(folded[leaf].abs().sum()) == 0 for leaf in PART_OUTBOX_LEAVES[1:]),
                f"{name} folded window {w}: the state's own outbox was written")
        if w in (0, PART_CHECK_WINDOWS - 1):
            print(f"  {name} window {w} at {PART_P} x {PART_R} lanes: kernel == plain on every leaf "
                  f"after the window and after the barrier, the kept occupancy bound == tr_time's "
                  f"({queued} jobs crossed, {int(state['events'].sum())} events, "
                  f"{int(state['tr_dropped'].sum())} transit drops so far; highest bound {highest} "
                  f"of {compiled.TR}); the folded launch == plain too")
    ring.flush()
    torch.cuda.synchronize()
    max_abs = max(max_abs, compare_states(folded, plain, f"{name} folded, flushed"))
    check_bound(folded, f"{name} folded, flushed")
    require(int(state["ob_sent"].sum()) > 0, f"{name}: nothing crossed")
    return max_abs


def check_partitioned_run(name: str, model) -> float:
    """A whole run of PART_RUN_HORIZON_S at PART_P x PART_RUN_R lanes: the
    kernels' window loop against the plain versions' on every leaf, and
    run_partitioned on the same model and seed reporting the loop's
    totals."""
    compiled, state, params, budget = partitioned_setup(model, PART_RUN_R)
    plain = {k: v.clone() for k, v in state.items()}
    n_windows = int(np.ceil(model.horizon_s / PART_HOP_S))
    for w in range(n_windows):
        partitioned_window(compiled, state, params, budget, w)
        partitioned_window(compiled, plain, params, budget, w, plain=True)
    torch.cuda.synchronize()
    max_abs = compare_states(state, plain, f"{name} whole run")
    result = run_partitioned(model, PART_HOP_S, mesh=card_partitions(), n_replicas=PART_RUN_R)
    host = {k: v.cpu().numpy().reshape((PART_P, PART_RUN_R) + tuple(v.shape[1:]))
            for k, v in state.items()}
    want = partitioned_result(model, compiled, host, PART_P, PART_RUN_R, n_windows, PART_HOP_S,
                              result.wall_seconds, budget)
    bad = [f.name for f in dataclasses.fields(result)
           if f.name not in ("wall_seconds", "events_per_second", "per_partition_sink_count")
           and getattr(result, f.name) != getattr(want, f.name)]
    require(not bad and np.array_equal(result.per_partition_sink_count, want.per_partition_sink_count),
            f"{name}: run_partitioned differs from the checked loop on {bad}")
    print(f"  {name}: {n_windows} windows at {PART_P} x {PART_RUN_R} lanes, kernel == plain on "
          f"every leaf; run_partitioned's totals equal the loop's ({result.simulated_events} events, "
          f"{result.remote_sent} crossed, sinks {result.sink_count})")
    return max_abs


def timed_partitioned_run(model, tag: str) -> tuple:
    """run_partitioned at full width with CUDA events around every launch:
    (result, window kernel ms, barrier ms), the device times summed."""
    times = {"window": [], "barrier": []}
    launches = {"window": event_step.launch, "barrier": partition_barrier.launch}

    def timed(kind):
        def launch(args, device):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            launches[kind](args, device)
            end.record()
            times[kind].append((start, end))
        return launch

    event_step.launch, partition_barrier.launch = timed("window"), timed("barrier")
    try:
        result = run_partitioned(model, PART_HOP_S, mesh=card_partitions(), n_replicas=PART_R)
    finally:
        event_step.launch, partition_barrier.launch = launches["window"], launches["barrier"]
    return result, *(sum(a.elapsed_time(b) for a, b in times[k]) for k in ("window", "barrier"))


def _window_marks(windows, launches, held: bool) -> tuple:
    """Each window's launches (``launches(w)``: callables of one launch
    each) with a CUDA event before the first and after each. ``held``:
    behind a torch.cuda._sleep that keeps the device busy until the host
    has queued every window, so the events time the device alone; else
    as a window loop issues them, the device waiting on the host where
    the host is slower. Returns (each window's events, the host's seconds
    to issue them)."""
    if held:
        torch.cuda._sleep(PART_HOLD_CYCLES)
    marks = []
    start = time.perf_counter()
    for w in windows:
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()
        for launch_one in launches(w):
            launch_one()
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        marks.append(events)
    host = time.perf_counter() - start
    torch.cuda.synchronize()
    return marks, host


def _mark_ms(marks: list) -> tuple:
    """(each launch's device ms a window, the gap's ms a window: from a
    window's last launch to the next window's first)."""
    n = len(marks)
    per_launch = [sum(m[k].elapsed_time(m[k + 1]) for m in marks) / n
                  for k in range(len(marks[0]) - 1)]
    gap = sum(a[-1].elapsed_time(b[0]) for a, b in zip(marks, marks[1:])) / (n - 1)
    return per_launch, gap


def ring_walls(model) -> dict:
    """The ring's whole run (PART_HORIZON_S in windows of PART_HOP_S) on
    PART_P x PART_R lanes of the card, from one initial state, in turns
    folded (partition_barrier.FoldedRing: a launch a window with the
    previous window's barrier folded in, then one barrier launch, as
    run_partitioned runs a ring that one card holds) and unfolded (a
    window_steps and a barrier launch a window, the loop of a ring across
    devices), PART_WALL_PAIRS pairs in the order folded, unfolded,
    unfolded, folded, ...: each wall from the first launch (its arguments
    checked and its occupancy bound built there, as in run_partitioned) to
    the sync after the last. Every run must end in the first folded run's state, bit for bit,
    and launch what its form launches."""
    compiled, initial, params, budget = partitioned_setup(model, PART_R)
    n_windows = int(np.ceil(model.horizon_s / PART_HOP_S))
    walls = {"folded": [], "unfolded": []}
    first = None
    for k in range(2 * PART_WALL_PAIRS):
        folded = (k % 4) in (0, 3)
        st = {leaf: v.clone() for leaf, v in initial.items()}
        torch.cuda.synchronize()
        event_step.window_steps.launches = partition_barrier.barrier.launches = 0
        t0 = time.perf_counter()
        if folded:
            ring = partition_barrier.folded_ring(compiled, st, st["key"], params, PART_P, budget, {})
            for w in range(n_windows):
                ring.window(window_end(w, PART_HOP_S))
            ring.flush()
        else:
            prepared: dict = {}
            for w in range(n_windows):
                partitioned_window(compiled, st, params, budget, w, prepared=prepared)
        torch.cuda.synchronize()
        walls["folded" if folded else "unfolded"].append((time.perf_counter() - t0) * 1e3)
        launches = (event_step.window_steps.launches, partition_barrier.barrier.launches)
        require(launches == (n_windows, 1 if folded else n_windows),
                f"ring walls, {'folded' if folded else 'unfolded'}: launches {launches}")
        if first is None:
            first = st
        else:
            same_state(first, st, f"ring walls, run {k} against the first")
    return {"windows": n_windows, **walls}


def time_partitioned(model) -> dict:
    """The window kernel's and the barrier's device time a window at full
    width over windows PART_WARM_WINDOWS.. + PART_TIMED_WINDOWS, CUDA
    events around each launch (the wrappers' arguments checked once, in
    the last warm window, as run_partitioned's window loop checks them; no
    sync until the last), each timed from a copy of the state after the
    warm windows in four ways: the window then the barrier launch, and the
    folded ring's one launch a window (partition_barrier.FoldedRing, then
    its flush), each as the window loop issues them (``loop_*``) and held
    behind a sleep so that the device runs them back to back (the device
    alone); and the host's ms to issue a window. Beside them the bounds
    for the same windows (counted on a copy of the state, launch by
    launch) and the plain versions' time a window, whose state after
    window PART_WARM_WINDOWS must equal the kernels'; every timed copy
    must end in the counted copy's state. The kernel's bound: the dense
    state moved once a launch (support.launch_bytes, 3.35 TB/s) and the
    float operations of the events run and the threefry the kernel
    counted (a fold an event); the barrier's: its bytes, the clock, the
    depth integrals, the queue lengths and the outbox lengths, each
    merged job read, parked and reset; the folded launch's: the window's
    bytes, to which the barrier adds only the merged jobs and the scratch
    outbox's lengths read and reset, or its operations."""
    compiled, state, params, budget = partitioned_setup(model, PART_R)
    prepared: dict = {}
    for w in range(PART_WARM_WINDOWS):
        partitioned_window(compiled, state, params, budget, w, prepared=prepared)
    lanes, n = PART_P * PART_R, PART_TIMED_WINDOWS
    windows = range(PART_WARM_WINDOWS, PART_WARM_WINDOWS + n)
    copies = {kind: {k: v.clone() for k, v in state.items()}
              for kind in ("counted", "plain", "held", "folded", "folded held")}
    times = {}
    for kind, st, held in (("loop", state, False), ("held", copies["held"], True)):
        prep = prepared if st is state else {}

        def split(w, st=st, prep=prep):
            limit = window_end(w, PART_HOP_S)
            return (
                lambda: event_step.window_steps(compiled, st, st["key"], params, limit, budget, prep),
                lambda: partition_barrier.barrier(compiled, st, PART_P, limit, prepared=prep),
            )

        if held:  # the bound built before the clock
            event_step.occupancy_bound(st)
        marks, host = _window_marks(windows, split, held)
        (window_ms, barrier_ms), gap_ms = _mark_ms(marks)
        times[kind] = {"kernel_ms": window_ms, "barrier_ms": barrier_ms, "gap_ms": gap_ms,
                       "host_ms": host * 1e3 / n}
    for kind, held in (("folded", False), ("folded held", True)):
        st = copies[kind]
        ring = partition_barrier.folded_ring(compiled, st, st["key"], params, PART_P, budget, {})
        marks, host = _window_marks(windows, lambda w, ring=ring: (
            lambda: ring.window(window_end(w, PART_HOP_S)),), held)
        ring.flush()
        (fold_ms,), gap_ms = _mark_ms(marks)
        times[kind] = {"kernel_ms": fold_ms, "gap_ms": gap_ms, "host_ms": host * 1e3 / n}
    counted, plain = copies["counted"], copies["plain"]
    limit = window_end(PART_WARM_WINDOWS, PART_HOP_S)
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    start.record()
    event_step.plain_window_steps(compiled, plain, params, limit, budget)
    mid.record()
    partition_barrier.plain_barrier(compiled, plain, PART_P, limit)
    end.record()
    torch.cuda.synchronize()
    halted = torch.empty((lanes,), dtype=torch.uint8, device="cuda")
    drawn = torch.zeros((lanes,), dtype=torch.int32, device="cuda")
    events = merged = draws = 0
    max_abs = None
    cprep: dict = {}
    for w in windows:
        limit = window_end(w, PART_HOP_S)
        before = int(counted["events"].to(torch.int64).sum())
        event_step.launch(event_step.window_launch_args(
            compiled, counted, counted["key"], params, limit, budget, halted,
            event_step.occupancy_bound(counted), drawn,
        ), torch.device("cuda"))
        events += int(counted["events"].to(torch.int64).sum()) - before
        draws += int(drawn.to(torch.int64).sum())
        merged += int(counted["ob_len"].to(torch.int64).sum())
        partition_barrier.barrier(compiled, counted, PART_P, limit, prepared=cprep)
        if max_abs is None:
            torch.cuda.synchronize()
            max_abs = compare_states(counted, plain, f"ring window {w} at {PART_P} x {PART_R} lanes")
    for kind, st in (("loop", state), *((k, copies[k]) for k in ("held", "folded", "folded held"))):
        same_state(counted, st, f"the timed windows ({kind}) against the counted ones")
    float_ops = events * (OPS_PER_STEP_BASE + OPS_PER_STEP_PER_SERVER * compiled.nV)
    int_ops, alu_ops = support.draw_int_ops(events, draws), support.draw_alu_ops(events, draws)
    bytes_ms = n * support.launch_bytes(compiled, state) / PEAK_BYTES_PER_S * 1e3
    ops_ms = max(float_ops / PEAK_F32_OPS_PER_S * 1e3, int_ms(int_ops, alu_ops))
    lane_bytes = 4 * (2 + 3 * compiled.nV + 2)
    job_bytes = merged * 4 * (3 + 2 + 3)
    barrier_bytes = n * lanes * lane_bytes + job_bytes
    # Folded, the barrier's clock, depth integrals and queue lengths are
    # the window's own dense leaves, moved once by the launch: it adds the
    # merged jobs and the scratch outbox's length read and reset.
    fold_bytes_ms = (n * support.launch_bytes(compiled, state) + n * lanes * 4 * 2
                     + job_bytes) / PEAK_BYTES_PER_S * 1e3
    held, loop = times["held"], times["loop"]
    return {
        "kernel_ms": held["kernel_ms"], "barrier_ms": held["barrier_ms"], "gap_ms": held["gap_ms"],
        "host_ms": held["host_ms"],
        "loop_kernel_ms": loop["kernel_ms"], "loop_barrier_ms": loop["barrier_ms"],
        "loop_gap_ms": loop["gap_ms"], "loop_host_ms": loop["host_ms"],
        "fold_ms": times["folded held"]["kernel_ms"], "fold_gap_ms": times["folded held"]["gap_ms"],
        "fold_host_ms": times["folded held"]["host_ms"],
        "loop_fold_ms": times["folded"]["kernel_ms"], "loop_fold_gap_ms": times["folded"]["gap_ms"],
        "plain_ms": start.elapsed_time(mid), "plain_barrier_ms": mid.elapsed_time(end),
        "plain_max_abs_err": max_abs,
        "bound_ms": max(bytes_ms, ops_ms) / n, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "barrier_bound_ms": barrier_bytes / PEAK_BYTES_PER_S * 1e3 / n, "barrier_bound_by": "bytes",
        "fold_bound_ms": max(fold_bytes_ms, ops_ms) / n,
        "fold_bound_by": "bytes" if fold_bytes_ms >= ops_ms else "operations",
        "events_per_window": events / n, "jobs_crossed_per_window": merged / n,
        "threefry_per_window": draws / n,
    }


def partitioned_phase(tag: str) -> dict:
    """run_partitioned (happysim_tpu_torch/partitioned.py) on 8 partitions
    of cuda:0: the window kernel (csrc/event_step_partitioned.cu) and the
    barrier (csrc/partition_barrier.cu) against their plain versions on
    the ring, a chaos ring, a two-tenant ring and a ring of full transit
    rows (window by window, then whole runs), and the nine-remote ring
    (window by window); a checkpointed ring run against the uninterrupted
    one; the timed ring at 65,536 lanes with its gates; each kernel's
    time a window, and the gap between them, beside its bound."""
    t0 = time.perf_counter()
    out = {"max_abs_err": {}, "whole_max_abs_err": {}}
    print(f"partitioned executor: {PART_P} partitions of cuda:0, window {PART_HOP_S} s:")
    models = {
        "ring": partitioned_ring_model,
        "chaos-ring": partitioned_chaos_model,
        "two-sink-ring": partitioned_two_sink_model,
        "full-row-ring": partitioned_full_row_model,
    }
    for name, build_model in {**models, "nine-remote-ring": partitioned_nine_remote_model}.items():
        model = build_model()
        compiled = _PartitionCompiled(model, PART_OUTBOX)
        state, params = init_partitions(compiled, 0, 1, 64, 0, "cuda")
        halted = torch.empty((64,), dtype=torch.uint8, device="cuda")
        args = event_step.window_launch_args(compiled, state, state["key"], params,
                                             window_end(0, PART_HOP_S), 8, halted,
                                             event_step.transit_bound(state))
        require(event_step.library_of(args) == "event_step_partitioned", f"{name}: library")
        # More than the lean table's 8 remotes run the wide code.
        require(bool(args.wide.on) == (name == "nine-remote-ring"), f"{name}: wide {args.wide.on}")
        out["max_abs_err"][name] = check_windows(name, model)
        if name in models:
            out["whole_max_abs_err"][name] = check_partitioned_run(name, build_model(PART_RUN_HORIZON_S))

    # A checkpointed ring run at the main path's 8 x 8,192 lanes over the
    # full horizon: a snapshot every 75 windows, equal to the uninterrupted
    # run, and the middle snapshot saved, loaded and resumed to the same
    # totals.
    kw = dict(mesh=card_partitions(), n_replicas=PART_R)
    one = run_partitioned(partitioned_ring_model(), PART_HOP_S, **kw)
    snaps = []
    event_step.window_steps.launches = partition_barrier.barrier.launches = 0
    checkpointed = run_partitioned(partitioned_ring_model(), PART_HOP_S, **kw,
                                   checkpoint_every_windows=75, checkpoint_callback=snaps.append)
    # One card holds the ring: a folded launch a window, and a barrier
    # launch at the end of each of the 8 runs of windows.
    require((event_step.window_steps.launches, partition_barrier.barrier.launches) == (600, 8),
            "checkpointed ring: launches")
    fields = [f.name for f in dataclasses.fields(one)
              if f.name not in ("wall_seconds", "events_per_second", "per_partition_sink_count")]
    require([getattr(one, f) for f in fields] == [getattr(checkpointed, f) for f in fields]
            and np.array_equal(one.per_partition_sink_count, checkpointed.per_partition_sink_count),
            "checkpointed ring differs from the uninterrupted run")
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    path = CKPT_DIR / "partitioned.npz"
    snaps[len(snaps) // 2].save(str(path))
    loaded = PartitionedCheckpoint.load(str(path))
    path.unlink()
    resumed = run_partitioned(partitioned_ring_model(), PART_HOP_S, **kw, resume_from=loaded)
    require([getattr(one, f) for f in fields] == [getattr(resumed, f) for f in fields],
            "resumed ring differs from the uninterrupted run")
    print(f"  ring at {PART_P} x {PART_R} lanes: {len(snaps)} snapshots every 75 windows, the "
          f"run equal to the uninterrupted one; resumed at window {loaded.window_index} from an npz "
          f"equal too; walls {one.wall_seconds * 1e3:.1f} / {checkpointed.wall_seconds * 1e3:.1f} / "
          f"{resumed.wall_seconds * 1e3:.1f} ms {tag}")

    # The main path: the ring at full width through run_partitioned.
    event_step.window_steps.launches = partition_barrier.barrier.launches = 0
    ring = run_partitioned(partitioned_ring_model(), PART_HOP_S, mesh=card_partitions(),
                           n_replicas=PART_R)
    out["launches"] = {"window": event_step.window_steps.launches,
                       "barrier": partition_barrier.barrier.launches}
    require(out["launches"] == {"window": ring.n_windows, "barrier": 1},
            f"ring: launches {out['launches']} for {ring.n_windows} windows")
    print(f"run_partitioned ring {PART_P} x {PART_R}: {ring.n_windows} windows, "
          f"{out['launches']['window']} window launches (each with the previous window's barrier "
          f"folded in) and {out['launches']['barrier']} barrier launch (the last window's), "
          f"{ring.simulated_events} events in {ring.wall_seconds * 1e3:.3f} ms = "
          f"{ring.events_per_second:.4g} events/s, {ring.remote_sent} jobs crossed {tag}")
    within(ring.sink_mean_latency_s[0], PART_PRODUCT_FORM_S, "ring pooled sink latency (product form)",
           0.02)
    require(ring.remote_dropped == 0 and ring.transit_dropped == 0 and ring.truncated_windows == 0,
            f"ring: remote_dropped {ring.remote_dropped}, transit_dropped {ring.transit_dropped}, "
            f"truncated_windows {ring.truncated_windows}")
    counts = ring.per_partition_sink_count[:, 0]
    require(counts.min() > 0.9 * counts.max(), f"ring: partitions unbalanced {counts.tolist()}")
    walls = out["ring_walls"] = ring_walls(partitioned_ring_model())
    spread = {k: (min(walls[k]), max(walls[k]), sum(walls[k]) / len(walls[k]))
              for k in ("folded", "unfolded")}
    for k in ("folded", "unfolded"):
        print(f"  ring walls in turns, {k}: " + ", ".join(f"{x:.3f}" for x in walls[k])
              + f" ms for {walls['windows']} windows (mean {spread[k][2]:.3f}, range "
              f"{spread[k][0]:.3f}-{spread[k][1]:.3f}) {tag}")
    print(f"  ring walls: folded over unfolded {spread['folded'][2] / spread['unfolded'][2]:.3f}x by "
          f"their means; the slowest folded run {spread['folded'][1]:.3f} ms against the fastest "
          f"unfolded {spread['unfolded'][0]:.3f}; every run in the same state, bit for bit {tag}")
    timed_result, window_ms, barrier_ms = timed_partitioned_run(partitioned_ring_model(), tag)
    require(timed_result.sink_count == ring.sink_count, "ring: the timed run differs")
    out["walls_ms"] = {"ring": ring.wall_seconds * 1e3, "ring, each launch timed": timed_result.wall_seconds * 1e3,
                       "ring, folded in turns": spread["folded"][2],
                       "ring, unfolded in turns": spread["unfolded"][2],
                       "checkpoint one run": one.wall_seconds * 1e3,
                       "checkpointed": checkpointed.wall_seconds * 1e3}
    out["run"] = {
        "events": ring.simulated_events, "events_per_second": ring.events_per_second,
        "sink_mean_latency_s": ring.sink_mean_latency_s[0], "remote_sent": ring.remote_sent,
        "window_kernel_ms_per_window": window_ms / ring.n_windows,
        "barrier_ms_per_window": barrier_ms / ring.n_windows,
    }
    print(f"  ring device time: folded window launches {window_ms:.3f} ms "
          f"({window_ms / ring.n_windows * 1e3:.2f} us a window), barrier {barrier_ms:.3f} ms (the "
          f"last window's), of a {timed_result.wall_seconds * 1e3:.3f} ms wall with every launch "
          f"timed, {100 * (window_ms + barrier_ms) / (timed_result.wall_seconds * 1e3):.1f}% device {tag}")
    t = out["timing"] = time_partitioned(partitioned_ring_model())
    span = f"windows {PART_WARM_WINDOWS}-{PART_WARM_WINDOWS + PART_TIMED_WINDOWS - 1} at {PART_P} x {PART_R}"
    for label, k, b, g in (("in the window loop", "loop_kernel_ms", "loop_barrier_ms", "loop_gap_ms"),
                           ("the device alone", "kernel_ms", "barrier_ms", "gap_ms")):
        device_ms = t[k] + t[b] + t[g]
        print(f"timing partitioned (ring, {span}), {label}: window kernel {t[k] * 1e3:.2f} us, barrier "
              f"{t[b] * 1e3:.2f} us, gap between launches {t[g] * 1e3:.2f} us a window; the barrier "
              f"with its gap {100 * (t[b] + t[g]) / device_ms:.1f}% of the window's "
              f"{device_ms * 1e3:.2f} us {tag}")
    print(f"timing partitioned (ring, {span}), folded: one launch {t['loop_fold_ms'] * 1e3:.2f} us and "
          f"gap {t['loop_fold_gap_ms'] * 1e3:.2f} us a window in the window loop, "
          f"{t['fold_ms'] * 1e3:.2f} us and {t['fold_gap_ms'] * 1e3:.2f} us the device alone, "
          f"{100 * t['fold_bound_ms'] / t['fold_ms']:.2f}% of its bound {t['fold_bound_ms'] * 1e3:.3f} us "
          f"({t['fold_bound_by']}); the host issues a window in {t['fold_host_ms'] * 1e3:.2f} us folded, "
          f"{t['host_ms'] * 1e3:.2f} us unfolded {tag}")
    print(f"timing partitioned (ring, {span}): window kernel {t['kernel_ms'] * 1e3:.2f} us a window, "
          f"{100 * t['bound_ms'] / t['kernel_ms']:.2f}% of its bound {t['bound_ms'] * 1e3:.3f} us "
          f"({t['bound_by']}; {t['events_per_window']:.0f} events, {t['threefry_per_window']:.0f} "
          f"threefry a window); barrier {t['barrier_ms'] * 1e3:.2f} us a window, "
          f"{100 * t['barrier_bound_ms'] / t['barrier_ms']:.2f}% of its bound "
          f"{t['barrier_bound_ms'] * 1e3:.3f} us ({t['jobs_crossed_per_window']:.0f} jobs crossed a "
          f"window); plain window {t['plain_ms']:.3f} ms, plain barrier {t['plain_barrier_ms']:.3f} ms, "
          f"their state after window {PART_WARM_WINDOWS} == the kernels' {tag}")
    out["seconds"] = time.perf_counter() - t0
    print(f"partitioned phase: {out['seconds']:.1f} s {tag}")
    return out

# The result surface: the summaries and the window series of main-path
# runs, each run's model, kernel shape, sweeps and budget (for a caller
# that has not run it, tools/smoke_slice.py --surface).
SURFACE_RUNS = {
    "mm1": (lambda: mm1_model(LAM, MU, HORIZON_S, warmup_s=WARMUP_S), "mm1", None, None),
    "chaos": (chaos_model, "router", CHAOS_SWEEPS, CHAOS_MAX_EVENTS),
    "resilience-defended": (lambda: resilience_bench_model(True), "mm1", RES_SWEEPS, RES_MAX_EVENTS),
    "quorum-defended": (lambda: quorum_model(True), "router", None, QUORUM_MAX_EVENTS),
    "election-bully": (lambda: election_model("bully"), "router", None, ELECTION_MAX_EVENTS),
    "two-class-defended": (lambda: two_class_model(chaos=True, defended=True), "multi", None, None),
    "telemetry": (telemetry_model, "mm1", HETERO_SWEEPS, TEL_MAX_EVENTS),
}
# A server entity's conditional extras: the summary's key, the result's
# per-server field.
SERVER_EXTRAS = {
    "timed_out": "server_timed_out", "retried": "server_retried",
    "outage_dropped": "server_outage_dropped", "transit_dropped": "transit_dropped",
    "fault_dropped": "server_fault_dropped", "fault_retried": "server_fault_retried",
    "hedged": "server_hedged", "hedge_wins": "server_hedge_wins",
    "breaker_dropped": "server_breaker_dropped", "breaker_tripped": "breaker_tripped",
    "shed_dropped": "server_shed_dropped", "budget_dropped": "server_budget_dropped",
}
# Device work in a torch.profiler trace.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def same_bits(a, b) -> bool:
    """Equal values of the same type, floats bit for bit."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b


def expected_extras(result) -> dict:
    """Each summary entity's extras, (name, kind) -> dict, read off the
    result's fields by the JAX engine's rules."""
    out = {}
    for i, count in enumerate(result.sink_count):
        out[(f"sink[{i}]", "Sink")] = {
            "mean_latency_s": result.sink_mean_latency_s[i], "p50_s": result.sink_p50_s[i],
            "p99_s": result.sink_p99_s[i],
        }
    for i, completed in enumerate(result.server_completed):
        extra = {
            "completed": completed, "dropped": result.server_dropped[i],
            "utilization": result.server_utilization[i], "mean_wait_s": result.server_mean_wait_s[i],
            "mean_queue_len": result.server_mean_queue_len[i],
        }
        fired = {key: getattr(result, field)[i] for key, field in SERVER_EXTRAS.items()
                 if getattr(result, field) and getattr(result, field)[i]}
        # Timeouts and retries come as a pair, and hedge wins with hedges.
        if "timed_out" in fired or "retried" in fired:
            fired["timed_out"], fired["retried"] = result.server_timed_out[i], result.server_retried[i]
        fired.pop("hedge_wins", None)
        if "hedged" in fired:
            fired["hedge_wins"] = result.server_hedge_wins[i]
        out[(f"server[{i}]", "Server")] = {**extra, **{k: fired[k] for k in SERVER_EXTRAS if k in fired}}
    for i, admitted in enumerate(result.limiter_admitted):
        out[(f"limiter[{i}]", "RateLimiter")] = {"admitted": admitted, "dropped": result.limiter_dropped[i]}
    chaos = {"network_lost": result.network_lost} if result.network_lost else {}
    for key in ("fault_dropped", "fault_retried", "hedged", "hedge_wins", "transit_dropped"):
        if sum(getattr(result, SERVER_EXTRAS[key])):
            chaos[f"total_{key}"] = sum(getattr(result, SERVER_EXTRAS[key]))
    if chaos:
        out[("model", "Chaos")] = chaos
    if result.resilience_features:
        res = {"features": ", ".join(result.resilience_features)}
        for key in ("breaker_tripped", "breaker_dropped", "shed_dropped", "budget_dropped"):
            if sum(getattr(result, SERVER_EXTRAS[key])):
                res[f"total_{key}"] = sum(getattr(result, SERVER_EXTRAS[key]))
        if any(f > 0.0 for f in result.breaker_open_fraction):
            res["breaker_open_fraction_max"] = max(result.breaker_open_fraction)
        out[("model", "Resilience")] = res
    if result.consensus_features:
        con = {"features": ", ".join(result.consensus_features)}
        for key, value in (
            ("network_partitioned", result.network_partitioned),
            ("total_quorum_dropped", sum(result.server_quorum_dropped)),
            ("quorum_dark_fraction", result.quorum_dark_fraction),
            ("leader_changes", result.leader_changes),
            ("time_without_leader_max", result.time_without_leader_fraction),
        ):
            if value:
                con[key] = value
        out[("model", "Consensus")] = con
    engine = {"engine_path": result.engine_path}
    if result.blocks_total:
        engine["macro_blocks_run"] = result.blocks_total
    if result.kernel_decline:
        engine["kernel_decline"] = result.kernel_decline
    out[("engine", "Engine")] = engine
    return out


def check_summary(label: str, result) -> int:
    """summary() of a card run: each entity's extras equal the result's
    fields bit for bit, by the JAX engine's rules, in its order; the
    counts, the backend and the horizon the result's. Returns the number
    of extras compared."""
    summary = result.summary()
    head = summary.to_dict()
    for key, value in (
        ("events_processed", result.simulated_events), ("truncated_replicas", result.truncated_replicas),
        ("replicas", result.n_replicas), ("completed", result.truncated_replicas == 0),
        ("backend", "cuda"), ("start_time_s", 0.0), ("end_time_s", float(result.horizon_s)),
        ("wall_clock_seconds", result.wall_seconds),
    ):
        require(same_bits(head[key], value), f"{label}: summary {key} {head[key]!r}, result {value!r}")
    expected = expected_extras(result)
    got = {(e.name, e.kind): e for e in summary.entities}
    require(list(got) == list(expected), f"{label}: summary entities {list(got)}, expected {list(expected)}")
    compared = 0
    for key, extra in expected.items():
        entity = got[key]
        require(list(entity.extra) == list(extra), f"{label}: {key} extras {list(entity.extra)}, "
                f"expected {list(extra)}")
        for name, value in extra.items():
            require(same_bits(entity.extra[name], value),
                    f"{label}: {key} {name} {entity.extra[name]!r}, the result's {value!r}")
            compared += 1
        if key[1] == "Sink":
            index = int(key[0][5:-1])
            require(entity.events_received == result.sink_count[index], f"{label}: {key} received")
    return compared


def check_to_data(label: str, result) -> int:
    """to_data() of a card run with telemetry: every column of series()
    but the window starts, sampled at the window starts, its values the
    column's; returns the number of series."""
    series = result.timeseries.series()
    data = result.timeseries.to_data()
    require(list(data) == [k for k in series if k != "window_start_s"],
            f"{label}: to_data keys {sorted(data)} against series()")
    for name, column in data.items():
        require(np.array_equal(column.times_s, series["window_start_s"]),
                f"{label}: {name} sampled off the window starts")
        require(np.array_equal(np.asarray(column.values), series[name]),
                f"{label}: {name} values differ from the column")
    return len(data)


def inside(spans: list, t: float) -> bool:
    return any(lo <= t <= hi for lo, hi in spans)


def scope_profile(trace_path: Path) -> dict:
    """The engine's scopes in a torch.profiler Chrome trace: for each,
    its host ranges (count, host ms) and the device time of the work
    launched inside them (a kernel, copy or memset whose launching
    runtime or driver call, matched by its correlation id, lies in a
    range; device ms, the union of their intervals); and the event-step
    kernel's launches, each under an hs.kernel range or not (by its
    launching call)."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    host = {name: [] for name in PROFILER_SCOPES}
    for e in spans:
        if e.get("name") in host and e.get("cat") == "user_annotation":
            host[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    calls = {
        e["args"]["correlation"]: e["ts"]
        for e in spans
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})
    }
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    out = {}
    for name in PROFILER_SCOPES:
        work = [(e["ts"], e["ts"] + e["dur"]) for e in device
                if inside(host[name], calls.get(e.get("args", {}).get("correlation"), -1.0))]
        out[name] = {
            "ranges": len(host[name]),
            "host_ms": sum(hi - lo for lo, hi in host[name]) / 1e3,
            "device_ms": sum(hi - lo for lo, hi in merge_intervals(work)) / 1e3,
            "device_ops": len(work),
        }
    steps = [e for e in device if e.get("cat") == "kernel" and "event_step_kernel" in e["name"]]
    out["event_step_launches"] = len(steps)
    out["event_step_launches_under_hs.kernel"] = sum(
        inside(host["hs.kernel"], calls.get(e.get("args", {}).get("correlation"), -1.0)) for e in steps
    )
    out["event_step_device_ms"] = sum(e["dur"] for e in steps) / 1e3
    out["device_ms"] = sum(hi - lo for lo, hi in merge_intervals(
        [(e["ts"], e["ts"] + e["dur"]) for e in device])) / 1e3
    return out


def merge_intervals(intervals: list) -> list:
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def profiled(label: str, run, launches_of, tag: str) -> tuple:
    """``run()`` (a main_path_run or traced_run call, which time each
    launch by CUDA events) under torch.profiler with the CPU and CUDA
    activities; its Chrome trace written under chiprun_out/traces/ and
    read by scope_profile. Checks that the trace holds the run's every
    launch of the event-step kernel, each under an hs.kernel range, one
    hs.kernel and one hs.macro_block range a launch, one hs.reduce
    range; prints the device ms under each scope beside the launches'
    CUDA-event ms. Returns (the run's return, the profile)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        out = run()
        torch.cuda.synchronize()
    path = Path("chiprun_out") / "traces" / f"surface_{label}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    scopes = scope_profile(path)
    launches, kernel_ms = launches_of(out)
    print(f"surface {label} under torch.profiler: " + "; ".join(
        f"{name} {scopes[name]['ranges']} ranges, {scopes[name]['device_ms']:.3f} ms on the device "
        f"({scopes[name]['device_ops']} ops), {scopes[name]['host_ms']:.3f} ms host"
        for name in PROFILER_SCOPES
    ) + f"; the event-step kernel {scopes['event_step_launches']} launches in the trace, "
        f"{scopes['event_step_device_ms']:.3f} ms; by CUDA events {launches} launches, "
        f"{kernel_ms:.3f} ms; all device work {scopes['device_ms']:.3f} ms {tag}")
    require(scopes["event_step_launches"] == launches,
            f"{label}: the profiler saw {scopes['event_step_launches']} of {launches} launches")
    require(scopes["event_step_launches_under_hs.kernel"] == launches,
            f"{label}: {launches - scopes['event_step_launches_under_hs.kernel']} launches "
            "outside an hs.kernel range")
    expected = {"hs.macro_block": launches, "hs.kernel": launches, "hs.reduce": 1}
    counts = {name: scopes[name]["ranges"] for name in PROFILER_SCOPES}
    require(counts == expected, f"{label}: scope ranges {counts}, expected {expected}")
    return out, {**scopes, "launches": launches, "kernel_ms_cuda_events": kernel_ms}


def range_us(n: int = 20000) -> float:
    """Host microseconds of one torch.profiler.record_function range,
    entered and left, with no profiler running: the scopes' own cost."""
    start = time.perf_counter()
    for _ in range(n):
        with torch.profiler.record_function("hs.kernel"):
            pass
    return (time.perf_counter() - start) / n * 1e6


def surface_phase(tag: str, runs: dict) -> dict:
    """The result surface on the card: the summaries of SURFACE_RUNS'
    runs (``runs``, or made here) against their fields, the telemetry
    run's to_data() against its series(), and the M/M/1 scan and the
    flash crowd's traced run under torch.profiler with the engine's
    scopes."""
    t0 = time.perf_counter()
    out = {"summaries": {}}
    for label, (build_model, shape, sweeps, max_events) in SURFACE_RUNS.items():
        if label not in runs:
            runs[label] = main_path_run(label, build_model(), tag, shape, sweeps, max_events)
        result = runs[label][0]
        out["summaries"][label] = check_summary(label, result)
    out["to_data_series"] = check_to_data("telemetry", runs["telemetry"][0])
    print("surface: summary() extras equal to the result's fields, bit for bit: " + ", ".join(
        f"{label} {n}" for label, n in out["summaries"].items()
    ) + f"; to_data() of telemetry: {out['to_data_series']} series equal to series() {tag}")
    mm1 = SURFACE_RUNS["mm1"][0]()
    (result, _launches), out["mm1"] = profiled(
        "mm1-scan",
        lambda: main_path_run("mm1-profiled", mm1, tag, "mm1"),
        lambda run: (run[1], RUN_KERNEL_MS["mm1-profiled"][0]),
        tag,
    )
    traced_run("trace-flash warm-up", trace_model("flash", TRACE_LONG_CHUNK), tag)
    (result, launches, _ms), out["trace-flash"] = profiled(
        "trace-flash",
        lambda: traced_run("trace-flash profiled", trace_model("flash"), tag),
        lambda run: (run[1], run[2]),
        tag,
    )
    require(launches == result.trace_stream_steps, "trace-flash: launches against stream steps")
    out["range_us"] = range_us()
    counts = {label: sum(out[label][name]["ranges"] for name in PROFILER_SCOPES)
              for label in ("mm1", "trace-flash")}
    print(f"surface: a range costs {out['range_us']:.3f} us with no profiler running; "
          + ", ".join(f"{label} {n} ranges, {n * out['range_us'] / 1e3:.4f} ms a run"
                      for label, n in counts.items()) + f" {tag}")
    out["seconds"] = time.perf_counter() - t0
    print(f"surface phase: {out['seconds']:.1f} s {tag}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    card = card_label()
    tag = f"[{card}]"
    print(f"device: {name}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    built = build.build_libraries()
    build_s = time.perf_counter() - t0
    event_step.load_library()
    uniform.load_library()
    mm1_scan.load_library()
    names = ", ".join(path.name for path, _log in built.values())
    print(f"build: {names} in {build_s:.1f} s (nvcc, sm_90a, one per source in parallel) {tag}")
    ptxas = {}
    for stem, (_path, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")
        for kernel, info in ptxas_summary(log).items():
            ptxas[f"{stem} {kernel}"] = info
            print(
                f"  ptxas {stem} event_step_kernel{kernel}: {info['registers']} registers, "
                f"{info['spill_stores']} B spill stores, {info['spill_loads']} B spill loads"
            )

    draw_check = check_uniform(tag)

    mm1 = mm1_model(LAM, MU, HORIZON_S, warmup_s=WARMUP_S)
    mm1.macro_block = MACRO
    chain = pipeline_model(rate=8.0, service_means=(0.05, 0.08, 0.06), horizon_s=HORIZON_S)
    router = router_model()
    fanout = router_model("random", HORIZON_S, WARMUP_S)
    graph = graph_model()
    profile = graph_model(ramp=True)
    print(f"block checks at {REPLICAS} replicas, macro_block {MACRO}:")
    # Keyed by the kernels-line entry each main-path model stands for.
    max_abs = {
        "mm1": check_blocks("mm1", mm1, [0, 1, 2, 3, 78, 79, 80, 81]),
        "chain": check_blocks("chain", chain, [0, 40]),
        "router": check_blocks("fanout", fanout, [0, 1, 2, 3, 250, 251]),
        "graph": check_blocks("graph", graph, [0, 1, 60], GRAPH_SWEEPS),
        "families": check_blocks("mg1-lognormal", mg1_model("lognormal"), [0, 1, 2, 3, 80]),
        "profile": check_blocks("profile", profile, [0, 1, 60], GRAPH_SWEEPS),
    }
    # The other families, the mixed chain and the spike source; off the
    # main path, the bench's router sweep and the trap coverage.
    extra_abs = {
        **{
            f"mg1-{family}": check_blocks(f"mg1-{family}", mg1_model(family), [0, 1, 2, 3, 80])
            for family in MG1_FAMILIES
            if family != "lognormal"
        },
        "families-chain": check_blocks("families", families_model(), [0, 40]),
        "spike": check_blocks("spike", arrivals_model("spike"), [0, 1, 6]),
        "router-bench": check_blocks("router", router, [0, 1, 2, 3, 100, 101], ROUTER_SWEEPS),
        "mix": check_blocks("mix", mix_model(), [0, 1, 40]),
    }
    # The chaos instantiation: the bench model on the main path, and one
    # model per chaos branch.
    max_abs["chaos"] = check_blocks("chaos", chaos_model(), [0, 1, 2, 3, 150], CHAOS_SWEEPS)
    extra_abs.update({
        "deadline": check_blocks("deadline", hetero_model(), [0, 1, 2, 3, 60], HETERO_SWEEPS),
        "backoff": check_blocks("backoff", backoff_model(), [0, 1, 2, 3, 30]),
        "hedged-erlang2": check_blocks(
            "hedged-erlang2", hedged_model("erlang", BENCH_HORIZON_S, service_k=2), [0, 1, 2, 3, 30]
        ),
        "degrade": check_blocks("degrade", degrade_model(), [0, 1, 2, 3, 10]),
        "lossy": check_blocks("lossy", lossy_model(), [0, 1, 2, 3, 10]),
    })
    # The telemetry instantiations: the bench model on the main path, and
    # the window buffers on the chaos, deadline, M/M/1 and pareto models.
    max_abs["telemetry"] = check_blocks("telemetry", telemetry_model(), [0, 1, 2, 3, 24], HETERO_SWEEPS)
    extra_abs.update({
        "chaos-telemetry": check_blocks(
            "chaos-telemetry", with_telemetry(chaos_model(), BENCH_HORIZON_S / TEL_WINDOWS),
            [0, 1, 2, 3, 150], CHAOS_SWEEPS,
        ),
        "hetero-telemetry": check_blocks(
            "hetero-telemetry", with_telemetry(hetero_model(), HETERO_HORIZON_S / TEL_WINDOWS),
            [0, 1, 2, 3, 60], HETERO_SWEEPS,
        ),
        "mm1-telemetry": check_blocks(
            "mm1-telemetry", with_telemetry(mm1_model(LAM, MU, HORIZON_S, warmup_s=WARMUP_S), MM1_WINDOW_S),
            [0, 1, 2, 3, 80],
        ),
        "pareto-telemetry": check_blocks(
            "pareto-telemetry", with_telemetry(mg1_model("pareto"), MM1_WINDOW_S), [0, 1, 2, 3, 80]
        ),
    })
    # The resilience instantiations: bench_resilience's defended arm on the
    # main path, and the defenses on the chaos fan-out, the storm, the
    # utilisation-shed M/M/1 and the breaker matrix's tightest corner.
    max_abs["resilience"] = check_blocks(
        "resilience", resilience_bench_model(True), [0, 1, 2, 3, 40], RES_SWEEPS
    )
    extra_abs.update({
        "resilience-fanout": check_blocks("resilience-fanout", resilience_fanout_model(), [0, 1, 2, 3]),
        "storm": check_blocks("storm", storm_model(True), [0, 1, 2, 3, 24]),
        "shed-mm1": check_blocks("shed-mm1", shed_mm1_model(), [0, 1, 2, 3, 60]),
        "breaker-trip-on-first": check_blocks(
            "breaker-trip-on-first", breaker_corner_model(), [0, 1, 2, 3]
        ),
    })
    # Several sources and sinks: the two-tenant service on the main path,
    # the superposed pair (Poisson, and constant at one rate: the tie) and
    # the tenants with telemetry on the chaos-free code, the tenants with
    # chaos on the chaos code, with and without its telemetry sites, and
    # with a defense on the whole chaos code (all in event_step_multi.cu);
    # the consensus
    # instantiations: the defended quorum arm on the main path (blocks 16
    # and 20 lie in and after its cut), the undefended arm, the election
    # storm and stochastic cuts drawn on the salted stream.
    max_abs["multi-lean"] = check_blocks("two-class", two_class_model(), [0, 1, 2, 3, 100])
    max_abs["multi"] = check_blocks(
        "two-class-chaos", two_class_model(chaos=True), [0, 1, 2, 3, 100]
    )
    max_abs["multi-defended"] = check_blocks(
        "two-class-defended", two_class_model(chaos=True, defended=True), [0, 1, 2, 3, 100]
    )
    max_abs["consensus"] = check_blocks("quorum-defended", quorum_model(True), [0, 1, 2, 3, 16, 20])
    extra_abs.update({
        "superpose": check_blocks("superpose", superpose_model(), [0, 1, 2, 3, 80]),
        "superpose-tie": check_blocks(
            "superpose-tie", superpose_model("constant", (4.0, 4.0)), [0, 1, 2, 3, 80]
        ),
        "two-class-telemetry": check_blocks(
            "two-class-telemetry", two_class_model(TWO_CLASS_WINDOW_S), [0, 1, 2, 3, 100]
        ),
        "two-class-chaos-telemetry": check_blocks(
            "two-class-chaos-telemetry", two_class_model(TWO_CLASS_WINDOW_S, chaos=True),
            [0, 1, 2, 3, 100],
        ),
        "quorum-undefended": check_blocks("quorum-undefended", quorum_model(False), [0, 1, 2, 3, 16, 20]),
        "consensus-flapping": check_blocks(
            "flapping-cuts", flapping_cuts_model(), [0, 1, 2, 3, 8, 12, 16, 20]
        ),
        "election-bully": check_blocks("election-bully", election_model("bully"), [0, 1, 2, 3]),
        "stochastic-partitions": check_blocks(
            "stochastic-partitions", stochastic_partition_model(), [0, 1, 2, 3]
        ),
    })

    # The whole-run launch against the per-block structure, at the main path's
    # budgets, on every model timed below and on a fan-out whose transit
    # rows exceed the tile (tr_time read in device memory).
    print(f"whole runs at {REPLICAS} replicas, one launch against chained one-block launches:")
    whole = {
        "mm1": check_whole_run("mm1", mm1),
        "chain": check_whole_run("chain", chain),
        "router": check_whole_run("fanout", fanout),
        "graph": check_whole_run("graph", graph, GRAPH_SWEEPS),
        "router-bench": check_whole_run("router", router, ROUTER_SWEEPS),
        "families": check_whole_run("mg1-lognormal", mg1_model("lognormal")),
        "pareto": check_whole_run("mg1-pareto", mg1_model("pareto")),
        "profile": check_whole_run("profile", profile, GRAPH_SWEEPS, PROFILE_MAX_EVENTS),
        "chaos": check_whole_run("chaos", chaos_model(), CHAOS_SWEEPS, CHAOS_MAX_EVENTS),
        "deadline": check_whole_run("deadline", hetero_model(), HETERO_SWEEPS),
        "telemetry": check_whole_run("telemetry", telemetry_model(), HETERO_SWEEPS, TEL_MAX_EVENTS),
        "telemetry-off": check_whole_run(
            "telemetry without its spec", telemetry_model(0), HETERO_SWEEPS, TEL_MAX_EVENTS
        ),
        "resilience": check_whole_run(
            "resilience defended", resilience_bench_model(True), RES_SWEEPS, RES_MAX_EVENTS
        ),
        "resilience-off": check_whole_run(
            "resilience undefended", resilience_bench_model(False), RES_SWEEPS, RES_MAX_EVENTS
        ),
        "resilience-inert": check_whole_run(
            "resilience inert", inert_defenses(resilience_bench_model(False)), RES_SWEEPS,
            RES_MAX_EVENTS,
        ),
        "fanout-global-rows": check_whole_run(
            "fanout, transit_capacity 64",
            router_model("random", HORIZON_S, WARMUP_S, transit_capacity=64),
            global_rows=True,
        ),
        "multi-lean": check_whole_run("two-class", two_class_model()),
        "multi": check_whole_run("two-class-chaos", two_class_model(chaos=True)),
        "multi-defended": check_whole_run(
            "two-class-defended", two_class_model(chaos=True, defended=True)
        ),
        "consensus": check_whole_run(
            "quorum-defended", quorum_model(True), max_events=QUORUM_MAX_EVENTS
        ),
        "consensus-flapping": check_whole_run(
            "flapping-cuts", flapping_cuts_model(), max_events=QUORUM_MAX_EVENTS
        ),
    }

    timings = {
        "mm1": time_blocks(mm1, "mm1"),
        "chain": time_blocks(chain, "chain"),
        "router": time_blocks(fanout, "fanout"),
        "graph": time_blocks(graph, "graph", GRAPH_SWEEPS),
        "router-bench": time_blocks(router, "router", ROUTER_SWEEPS),
        "families": time_blocks(mg1_model("lognormal"), "mg1-lognormal"),
        "pareto": time_blocks(mg1_model("pareto"), "mg1-pareto"),
        "profile": time_blocks(profile, "profile", GRAPH_SWEEPS),
        "chaos": time_blocks(chaos_model(), "chaos", CHAOS_SWEEPS),
        "deadline": time_blocks(hetero_model(), "deadline", HETERO_SWEEPS),
        "telemetry": time_blocks(telemetry_model(), "telemetry", HETERO_SWEEPS),
        "telemetry-off": time_blocks(telemetry_model(0), "telemetry without its spec", HETERO_SWEEPS),
        "resilience": time_blocks(resilience_bench_model(True), "resilience defended", RES_SWEEPS),
        "resilience-off": time_blocks(
            resilience_bench_model(False), "resilience undefended", RES_SWEEPS
        ),
        "resilience-inert": time_blocks(
            inert_defenses(resilience_bench_model(False)), "resilience inert", RES_SWEEPS
        ),
        "multi-lean": time_blocks(two_class_model(), "two-class"),
        "multi": time_blocks(two_class_model(chaos=True), "two-class-chaos"),
        "multi-defended": time_blocks(
            two_class_model(chaos=True, defended=True), "two-class-defended"
        ),
        "consensus": time_blocks(quorum_model(True), "quorum-defended"),
        "consensus-flapping": time_blocks(flapping_cuts_model(), "flapping-cuts"),
    }
    for shape, t in timings.items():
        earlier = ""
        if shape in EARLIER_KERNEL_MS:
            change = 100 * (t["kernel_ms"] / EARLIER_KERNEL_MS[shape] - 1)
            earlier = f" (previous slice, one block a launch: {EARLIER_KERNEL_MS[shape]} ms, {change:+.1f}%)"
        w = whole[shape]
        print(
            f"timing {shape} ({t['model']}): kernel {t['kernel_ms']:.4f} ms/block in a "
            f"{TIMED_BLOCKS}-block launch{earlier}, {100 * t['bound_ms'] / t['kernel_ms']:.1f}% of its "
            f"bound {t['bound_ms']:.4f} ms/block ({t['bound_by']}: {t['bytes_per_launch'] / 1e6:.1f} "
            f"MB a launch, {t['threefry_per_block'] / REPLICAS:.1f} threefry/lane/block, "
            f"{t['int_ops_per_block'] / 1e9:.3f} G int ops/block); one block a launch "
            f"{t['single_ms']:.4f} ms (bound {t['single_bound_ms']:.4f}), through the wrapper "
            f"{t['wrapper_ms']:.4f} ms; the whole run {w['run_ms']:.3f} ms for {w['blocks']} blocks "
            f"({w['run_ms'] / w['blocks']:.4f} ms/block, {100 * w['bound_ms'] / w['run_ms']:.1f}% of "
            f"its bound {w['bound_ms']:.4f} ms, {w['bound_by']}); plain {t['plain_ms']:.3f} ms/block, "
            f"the plain step's torch-op draw {t['draw_ms']:.4f} ms/block; staged "
            f"{t['stage']['leaves'] or 'nothing'} {tag}"
        )
    on, off = timings["telemetry"], timings["telemetry-off"]
    print(
        "timing telemetry with / without its 64-window spec: kernel "
        f"{on['kernel_ms'] / off['kernel_ms']:.3f}x, through the wrapper "
        f"{on['wrapper_ms'] / off['wrapper_ms']:.3f}x, plain {on['plain_ms'] / off['plain_ms']:.3f}x, "
        f"draw {on['draw_ms'] / off['draw_ms']:.3f}x {tag}"
    )
    on, off = timings["resilience"], timings["resilience-off"]
    print(
        "timing bench_resilience defended / undefended (resilience kernel against the "
        f"chaos+telemetry kernel): kernel {on['kernel_ms'] / off['kernel_ms']:.3f}x, through the "
        f"wrapper {on['wrapper_ms'] / off['wrapper_ms']:.3f}x, plain "
        f"{on['plain_ms'] / off['plain_ms']:.3f}x, draw {on['draw_ms'] / off['draw_ms']:.3f}x {tag}"
    )
    on = timings["resilience-inert"]
    print(
        "timing bench_resilience with inert defenses / undefended (the same simulation: the "
        f"defenses' own cost): kernel {on['kernel_ms'] / off['kernel_ms']:.3f}x, through the "
        f"wrapper {on['wrapper_ms'] / off['wrapper_ms']:.3f}x, plain "
        f"{on['plain_ms'] / off['plain_ms']:.3f}x {tag}"
    )

    # The main path, through the entry point a user calls.
    runs = {}
    result, launches = main_path_run("mm1", mm1_model(LAM, MU, HORIZON_S, warmup_s=WARMUP_S), tag, "mm1")
    within(result.server_mean_wait_s[0], LAM / MU / (MU - LAM), "mm1 mean wait")
    within(result.sink_mean_latency_s[0], 1.0 / (MU - LAM), "mm1 mean sojourn")
    runs["mm1"] = (result, launches)
    runs["chain"] = main_path_run("chain", pipeline_model(8.0, (0.05, 0.08, 0.06), HORIZON_S), tag, "chain")
    result, launches = main_path_run("fanout", fanout, tag, "router")
    require(result.transit_dropped == [0] * N_FANOUT, f"fanout: transit drops {result.transit_dropped}")
    lam = FANOUT_LAM / N_FANOUT
    for v, wait in enumerate(result.server_mean_wait_s):
        within(wait, (lam / MU) / (MU - lam), f"fanout server[{v}] mean wait")
    within(result.sink_mean_latency_s[0], 1.0 / (MU - lam) + FANOUT_EDGE_S, "fanout sink mean latency")
    runs["router"] = (result, launches)

    # The default call: the chain form, its draws through the draw kernel.
    chain_runs = {}
    result, launches = chain_run("mm1-chain", mm1_model(LAM, MU, HORIZON_S, warmup_s=WARMUP_S), tag)
    within(result.server_mean_wait_s[0], LAM / MU / (MU - LAM), "mm1-chain mean wait")
    within(result.sink_mean_latency_s[0], 1.0 / (MU - LAM), "mm1-chain mean sojourn")
    chain_runs["mm1-chain"] = (result, launches)
    result, launches = chain_run(
        "chain-chain", pipeline_model(8.0, (0.05, 0.08, 0.06), HORIZON_S), tag
    )
    scan = runs["chain"][0]
    for v, wait in enumerate(result.server_mean_wait_s):
        within(wait, scan.server_mean_wait_s[v], f"chain-chain server[{v}] mean wait vs the scan")
    within(result.sink_mean_latency_s[0], scan.sink_mean_latency_s[0],
           "chain-chain sink mean latency vs the scan")
    chain_runs["chain-chain"] = (result, launches)
    result, launches = chain_run(
        "fanout-chain", router_model("random", HORIZON_S, WARMUP_S, constant_edges=True), tag
    )
    for v, wait in enumerate(result.server_mean_wait_s):
        within(wait, (lam / MU) / (MU - lam), f"fanout-chain server[{v}] mean wait")
    within(result.sink_mean_latency_s[0], 1.0 / (MU - lam) + FANOUT_EDGE_S,
           "fanout-chain sink mean latency")
    chain_runs["fanout-chain"] = (result, launches)

    runs["graph"] = main_path_run("graph", graph_model(), tag, "graph", GRAPH_SWEEPS)
    for family, (_shape, scv, gate, drop_share) in MG1_FAMILIES.items():
        result, launches = main_path_run(f"mg1-{family}", mg1_model(family), tag, "mm1")
        dropped, completed = result.server_dropped[0], result.server_completed[0]
        print(f"  mg1-{family} dropped {dropped} of {dropped + completed} jobs (gate {drop_share:g})")
        require(dropped <= drop_share * (dropped + completed), f"mg1-{family}: {dropped} drops")
        within(result.server_mean_wait_s[0], pk_wait(scv), f"mg1-{family} mean wait (P-K)", gate)
        runs[f"mg1-{family}"] = (result, launches)
    result, launches = main_path_run(
        "profile", graph_model(ramp=True), tag, "graph", GRAPH_SWEEPS, PROFILE_MAX_EVENTS
    )
    require(result.transit_dropped == [0] * 4, f"profile: transit drops {result.transit_dropped}")
    runs["profile"] = (result, launches)
    for kind, (_build, analytic) in ARRIVALS.items():
        model = arrivals_model(kind)
        result, launches = main_path_run(f"arrivals-{kind}", model, tag, "chain")
        table = float(_Compiled(model).profile_cum[0, -1])
        mean = result.sink_count[0] / REPLICAS
        within(mean, table, f"arrivals-{kind} per replica vs the tables", 0.005, unit="")
        within(mean, analytic, f"arrivals-{kind} per replica vs the integral", 0.01, unit="")
        runs[f"arrivals-{kind}"] = (result, launches)
    counts = per_replica_sink_counts(arrivals_model("ramp-constant"))
    low, high = int(counts.min()), int(counts.max())
    print(f"  arrivals-ramp-constant per replica: {low} to {high} (analytic 180)")
    require(abs(low - 180) <= 3 and abs(high - 180) <= 3, f"ramp-constant counts {low}..{high}")
    runs.update(chaos_main_path(tag))
    runs.update(telemetry_main_path(tag, runs))
    runs.update(resilience_main_path(tag))
    runs.update(multi_main_path(tag))
    runs.update(consensus_main_path(tag))
    sweeps = {
        "quorum": sweep_ms(quorum_model(True)),
        "election": sweep_ms(election_model("bully")),
        "stochastic": sweep_ms(stochastic_partition_model()),
    }
    print("consensus set-up at {} replicas: the sweeps {} {}".format(
        REPLICAS, ", ".join(f"{name} {ms:.2f} ms" for name, ms in sweeps.items()), tag
    ))

    shares = print_shares(tag)

    # Checkpointed and resumed runs, the M/M/1 ensemble and the opinion
    # rounds, each path driven with its launch count set to 0 just before.
    checkpoints = checkpoint_phase(tag)
    traces = trace_phase(tag)
    mm1_check = check_mm1_scan(tag)
    mm1_result, mm1_launches = mm1_main_path(tag)
    opinions = opinion_phase(tag)
    # The wide code's models, then the replica mesh, each run driven with
    # its launch count set to 0 just before (main_path_run, mesh_phase).
    wide = wide_phase(tag)
    shares.update(print_shares(tag, wide["runs"]))
    meshes = mesh_phase(tag)
    # The partitioned executor, its run driven with both launch counts set
    # to 0 just before (partitioned_phase).
    parts = partitioned_phase(tag)
    # The result surface: the summaries and window series of the runs
    # above, and two runs under torch.profiler with the engine's scopes.
    surface = surface_phase(tag, runs)

    print(f"library_ms: {LIBRARY_NOTE}; mm1_scan: none: no single PyTorch call computes the "
          f"Lindley recursion; partitioned and partition_barrier: {PART_LIBRARY_NOTE}")
    kernels = {
        "kernels": [
            {
                "name": f"event_step[{shape}]",
                "route": "cuda",
                "source": "happysim_tpu_torch/kernels/csrc/event_step.cuh",
                "replaces": "happysim_tpu/tpu/kernels/event_step.py:312",
                "launches": runs[RUN_OF_ENTRY.get(shape, shape)][1],
                "max_abs_err": max_abs[shape],
                "ms": timings[shape]["kernel_ms"],
                "plain_ms": timings[shape]["plain_ms"],
                "bound_ms": timings[shape]["bound_ms"],
                "bound_by": timings[shape]["bound_by"],
                "library_ms": None,
            }
            for shape in (
                "mm1", "chain", "router", "graph", "families", "profile", "chaos", "telemetry",
                "resilience", "multi-lean", "multi", "multi-defended", "consensus",
            )
        ] + [
            {
                "name": "event_step[trace]",
                "route": "cuda",
                "source": "happysim_tpu_torch/kernels/csrc/event_step.cuh",
                "replaces": "happysim_tpu/tpu/kernels/event_step.py:312",
                "launches": traces["runs"]["trace-flash"]["launches"],
                "max_abs_err": traces["max_abs_err"],
                "ms": traces["timing"]["flash"]["kernel_ms"],
                "plain_ms": traces["timing"]["flash"]["plain_ms"],
                "bound_ms": traces["timing"]["flash"]["bound_ms"],
                "bound_by": traces["timing"]["flash"]["bound_by"],
                "library_ms": None,
            },
        ] + [
            # The trace library's MULTI codes: chaos-free (the flash crowd
            # beside a Poisson source), with chaos (beside it, with a
            # deadline and a retry at the server) and with every feature's
            # sites (with a retry budget besides).
            {
                "name": f"event_step[{variant}]",
                "route": "cuda",
                "source": "happysim_tpu_torch/kernels/csrc/event_step_trace.cu",
                "replaces": "happysim_tpu/tpu/kernels/event_step.py:312",
                "launches": traces["runs"][f"trace-{name}"]["launches"],
                "max_abs_err": traces["max_abs_err"],
                "ms": traces["timing"][name]["kernel_ms"],
                "plain_ms": traces["timing"][name]["plain_ms"],
                "bound_ms": traces["timing"][name]["bound_ms"],
                "bound_by": traces["timing"][name]["bound_by"],
                "library_ms": None,
            }
            for variant, name in (
                ("trace-multi-lean", "poisson"), ("trace-multi", "chaos"),
                ("trace-multi-defended", "defended"),
            )
        ] + [
            {
                "name": f"event_step[{variant}]",
                "route": "cuda",
                "source": "happysim_tpu_torch/kernels/csrc/event_step_wide.cu",
                "replaces": "happysim_tpu/tpu/kernels/event_step.py:312",
                "launches": wide["runs"][run][1],
                "max_abs_err": wide["max_abs_err"],
                "ms": wide["timing"][run]["kernel_ms"],
                "plain_ms": wide["timing"][run]["plain_ms"],
                "bound_ms": wide["timing"][run]["bound_ms"],
                "bound_by": wide["timing"][run]["bound_by"],
                "library_ms": None,
            }
            for variant, run in (("wide-lean", "wide-fleet"), ("wide", "wide-quorum"))
        ] + [
            {
                "name": "event_step[partitioned]",
                "route": "cuda",
                "source": "happysim_tpu_torch/kernels/csrc/event_step.cuh",
                "replaces": "happysim_tpu/tpu/kernels/event_step.py:312",
                "launches": parts["launches"]["window"],
                "max_abs_err": max(list(parts["max_abs_err"].values())
                                   + list(parts["whole_max_abs_err"].values())
                                   + [parts["timing"]["plain_max_abs_err"]]),
                # The main path's launch: a window with the previous
                # window's barrier folded in, against both plain versions
                # and the folded launch's own bound.
                "ms": parts["timing"]["fold_ms"],
                "plain_ms": parts["timing"]["plain_ms"] + parts["timing"]["plain_barrier_ms"],
                "bound_ms": parts["timing"]["fold_bound_ms"],
                "bound_by": parts["timing"]["fold_bound_by"],
                "library_ms": None,
            },
            {
                "name": "partition_barrier",
                "route": "cuda",
                "source": "happysim_tpu_torch/kernels/csrc/partition_barrier.cu",
                "replaces": "happysim_tpu/tpu/partitioned.py:533 one_window's barrier (lax)",
                "launches": parts["launches"]["barrier"],
                "max_abs_err": max(list(parts["max_abs_err"].values())
                                   + list(parts["whole_max_abs_err"].values())
                                   + [parts["timing"]["plain_max_abs_err"]]),
                "ms": parts["timing"]["barrier_ms"],
                "plain_ms": parts["timing"]["plain_barrier_ms"],
                "bound_ms": parts["timing"]["barrier_bound_ms"],
                "bound_by": parts["timing"]["barrier_bound_by"],
                "library_ms": None,
            },
            {
                "name": "uniform",
                "route": "cuda",
                "source": "happysim_tpu_torch/kernels/csrc/uniform.cu",
                "replaces": "happysim_tpu/tpu/chain.py:345 jax.random.uniform",
                "launches": chain_runs["mm1-chain"][1],
                "max_abs_err": draw_check["max_abs_err"],
                "ms": draw_check["kernel_ms"],
                "plain_ms": draw_check["plain_ms"],
                "bound_ms": draw_check["bound_ms"],
                "bound_by": draw_check["bound_by"],
                "library_ms": None,
            },
            {
                "name": "mm1_scan",
                "route": "cuda",
                "source": "happysim_tpu_torch/kernels/csrc/mm1_scan.cu",
                "replaces": "happysim_tpu/tpu/mm1.py:67 lax.scan",
                "launches": mm1_launches,
                "max_abs_err": mm1_check["max_abs_err"],
                "ms": mm1_check["kernel_ms"],
                "plain_ms": mm1_check["plain_ms"],
                "bound_ms": mm1_check["bound_ms"],
                "bound_by": mm1_check["bound_by"],
                "library_ms": None,
            },
        ]
    }
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(
            {
                "card": card,
                "device": name,
                "build_seconds": build_s,
                "ptxas": ptxas,
                "timings": timings,
                "whole_run": whole,
                "uniform": draw_check,
                "shares": shares,
                "max_abs_err_off_main_path": extra_abs,
                "run_ensemble": {shape: report(*run) for shape, run in runs.items()},
                "chain": {name: report(*run) for name, run in chain_runs.items()},
                "checkpoint": checkpoints,
                "trace": traces,
                "consensus_sweeps_ms": sweeps,
                "mm1_scan": mm1_check,
                "run_mm1_ensemble": dataclasses.asdict(mm1_result),
                "opinion": opinions,
                "wide": {
                    "timing": wide["timing"], "whole_run": wide["whole"],
                    "runs": {name: report(*run) for name, run in wide["runs"].items()},
                    "seconds": wide["seconds"],
                },
                "mesh": meshes,
                "partitioned": parts,
                "surface": surface,
                **kernels,
            },
            indent=1,
        )
    )
    print(json.dumps(kernels))
    print(card)
    # One card drives every phase, whatever the machine holds.
    print(json.dumps({
        "ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
