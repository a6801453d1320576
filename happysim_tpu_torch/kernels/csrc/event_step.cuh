// Event-step kernel: advances every replica of a service graph (any
// number of sources and sinks, nodes no source reaches included) by
// `macro` event steps a block, its whole block loop in one launch.
//
// It replaces the Pallas TPU kernel
// happysim_tpu/tpu/kernels/event_step.py::build_block_step (its
// pl.pallas_call), which runs the JAX engine's traced one-event step
// (_Compiled.make_step(external_u=True)) `macro` times over a
// VMEM-resident replica tile. That body is a generic jaxpr evaluator, so
// this file writes out what the step computes, op for op in float32, in
// the order of the plain torch-op step
// (kernels/event_step.py::plain_block_step): next_candidates' argmin
// (first index wins ties: the sources, lowest index first, then the
// servers' completions, then their transit arrivals), the depth integral,
// _fire_source, _complete_server with its FIFO queue pull, _arrive_server
// and _deliver_sink.
//
// Each source's constants are a row of the HsSrc table, its profile (EXT)
// a row of the tables a thread block stages. Several sources or sinks
// take the MULTI instantiations: sink 0 adds to a lane's registers and the
// other sinks to their (R, nK) leaves in device memory; the sources' next
// arrivals sit in an HS_MAX_SOURCES register array, loaded and written
// back once a launch, where a fire puts its own and takes the earliest
// (the lowest index on a tie, as JAX's argmin) (the wide code, whose
// source count has no bound: in device memory). Every other
// instantiation runs one source and one sink, whose code keeps only
// source 0's next arrival and sink 0's accumulators, in registers.
//
// event_step_kernel<MAXV, GRAPH, EXT, CHAOS, TEL, RES, CON, MULTI, TRC>
// has twenty-five instantiations per server bound in six libraries (the
// wide and partitioned libraries add their own):
// - GRAPH = false, the "mm1" and "chain" shapes (lines of servers joined
//   by free edges, or a source wired straight to the sink): a delivery is
//   a server arrival or the sink;
// - GRAPH = true, the "router" and "graph" shapes and every model with a
//   limiter or a latency edge: transit arrivals join the candidates, and
//   a delivery is a bounded walk over the topology tables (limiter
//   admit/drop, router choice with depth-indexed route draws, edge
//   latency, then a transit park, a server arrival or the sink). JAX
//   computes every router branch and selects per lane; the walk runs
//   only the chosen one, which is the same thing;
// - EXT = true adds the M/G/1 family sampler (erlang-2/3, hyperexp,
//   lognormal, pareto, by the server's kind) and the rate-profile gap
//   (two table lookups per source fire). EXT = false keeps the constant
//   and exponential draws and the flat-rate gap;
// - CHAOS = true (only as <MAXV, true, true, true>) adds the chaos
//   branches of the step: deadlines with immediate or backoff retries
//   (attempt numbers in the slot arrays, the rings and the transit
//   registers), hedged service starts, brownout windows, fault windows
//   (outage-mode rejection with fault retries, degrade-mode capacity caps
//   and service inflation, the shared correlated schedule) and packet
//   loss on edges. Every chaos model runs it, a line of free edges
//   included: backoff retries park in the transit registers, which only
//   the graph code has, and one instantiation per server bound keeps the
//   build small. JAX computes both sides of each retry or loss select
//   and picks per lane; the kernel runs only the side taken and books
//   exactly what that side books (a retry counts only when a transit
//   register takes it, a lost crossing keeps the limiter and round-robin
//   updates made before it, an expired and discarded job forwards
//   nothing);
// - TEL = true (only as <MAXV, true, true, CHAOS, true>, built from
//   event_step_telemetry.cu into a library of its own) adds the windowed
//   telemetry sites: every counter the step books is also booked in the
//   (R, nW, ...) window buffer of the time JAX's step books it at, the
//   busy and depth integrals are split over the windows their interval
//   spans, and a measured sink delivery adds its count, latency and
//   histogram bin in its arrival window. Every telemetry model runs the
//   extended graph code, with or without the chaos branches;
// - RES = true (only as <MAXV, true, true, true, TEL, true>, built from
//   event_step_resilience.cu into a third library) adds the resilience
//   defenses to the chaos code: the per-server circuit breaker (closed,
//   open, half-open) over its exact sliding-window failure ring, the
//   load-shed gate at admission and the retry budget's token bucket at
//   the four launch sites (the fault-rejection retry, the deadline
//   retries, the hedge at a start and the hedge at a queue pull). Every
//   model with a defense runs it, with the telemetry sites where the
//   model has a spec; the defenses sit at their sites in the chaos
//   arrival and completion code;
// - CON = true (only as <MAXV, true, true, true, TEL, RES, true>, built
//   from event_step_consensus.cu into a fourth library) adds the
//   consensus tier to the chaos code: a delivery into a partition group's
//   member consults the group's (R, nP, Wp) windows after any packet loss
//   (dropped under a drop-mode cut, parked delay_s more in transit under
//   a delay-mode one), and an arrival at a quorum member counts the
//   members out of reach (drop-mode fault windows and cut groups) and is
//   rejected, and retried after a backoff, below the write quorum. The
//   quorum's dark time and the election are init sweeps, not the step's;
// - MULTI = true runs several sources or sinks, by feature set (hs_code),
//   built from event_step_multi.cu into a fifth library, each code with
//   or without the telemetry sites: a model without chaos takes the
//   extended graph code with MULTI (<MAXV, true, true, false, TEL, false,
//   false, true>), at the graph code's register count; a model with chaos
//   but neither the defenses nor the consensus tier takes the chaos code
//   without their sites (<MAXV, true, true, true, TEL, false, false,
//   true>); a model with a defense or the consensus tier takes the whole
//   chaos code with every feature's sites (<MAXV, true, true, true, true,
//   true, true, true>), each taken only where the model has the feature
//   (a null leaf, an unset flag);
// - TRC = true (built from event_step_trace.cu into a sixth library)
//   replays a trace, on the codes of the MULTI library chosen the same way
//   (with TRC as the ninth argument), and on the extended graph code
//   without MULTI (<MAXV, true, true, false, TEL, false, false, false,
//   true>) for a single-source traced model without chaos: the traced
//   source's fire reads its next instant and the arrival's tenant from the two
//   resident pages of the trace (HsTrc) instead of drawing a gap, and a
//   lane enters a block only while its block budget lasts and while the
//   block cannot read past the resident pages (the stall gate). A stalled
//   lane leaves the launch unhalted and resumes in the next one, after
//   the host has moved the window on. Each lane keys its blocks by its own
//   block count (trc_blocks), not by the launch's first block, so the
//   bits do not depend on the paging.
// Everything GRAPH, EXT, CHAOS, TEL, RES, CON, MULTI and TRC add sits under
// `if constexpr`, so the line, flat, extended, chaos and telemetry
// instantiations compile to the code they had without them.
//
// The trace pages. Lanes of a warp fire the traced source at nearby
// cursors of one small page, so the pages are read from device memory
// through the read-only cache (__ldg): two words a fire, against the
// dozens of dependent loads of a step.
//
// The profile tables. JAX hoists the (G,) time and cumulative grids as
// tile-shared kernel operands (const_spec), read once per tile. Here the
// wrapper passes them as device tensors, and each thread block copies
// them into shared memory once (2 G floats, 4 KB at G = 512) before its
// lanes step: every fire makes two binary searches of ~9 probes each at
// data-dependent addresses, and shared memory serves those without the
// read-only cache's sector traffic. Lanes of a warp search different
// addresses, so the cost is bank conflicts, not device-memory bytes.
//
// Design. One thread per replica, and each replica's whole block loop in
// one launch (the counterpart of the JAX engine's replica_chunks): a
// lane loads its register file once, then runs blocks first, first + 1,
// ... first + n_blocks - 1 until it halts, testing before each block
// whether its next event lies past the horizon (JAX's blocks_cond),
// folding the block index into its key and adding one to its own
// blocks[r] for each block it runs; it writes its registers, its staged
// rows and its halted flag once, after the loop. A run's event budget
// is one launch and the host waits once, at the reduce. The clock, the
// sources' earliest next arrival, sink 0's accumulators and, per server, the
// queue head and length, the earliest completion (and transit arrival)
// time, the counters and the integrals live in registers for the whole
// launch (per-server register arrays sized by the MAXV template argument
// and indexed only with compile-time indices through pick/put). The
// topology tables are read from the __grid_constant__ argument struct.
//
// The rows a step scans. The loops that run in lockstep across a warp
// (the first free transit or service slot, a row's minimum after an
// arrival or a completion, the fault windows, a breaker ring's reset)
// read one row per lane. In the JAX layout a lane's rows sit nV * TR (or
// nV * C, nV * W) elements from its neighbour's, so every warp-wide load
// of such a loop touches 32 sectors. The wrapper's plan
// (kernels/support.py::stage_plan) picks, in the order of their use per
// step, the leaves that fit a per-lane budget of dynamic shared memory
// (tr_time, tr_created, tr_attempt, the slot arrays, the fault windows,
// the shared windows, the breaker ring, the partition windows), sized so
// that the launch stays
// one wave on the card; each lane copies its own rows of those leaves
// into the tile at the start and back at the end, lane-minor (element j
// of lane l at j * blockDim.x + l), so a warp's lockstep scan reads 32
// consecutive words. Every row is reached through an HsRow, a base
// pointer and an element stride (1 in device memory, blockDim.x in the
// tile), so one code path serves both. The (nV, K) queue rings, the
// (nK, 80) histogram and the router/limiter registers, touched once per
// push, pull or delivery, stay in device memory in the JAX layout, as do
// the leaves the plan leaves out.
//
// The window cache (WC: the trace branch's lean code, one traced source,
// one sink, no chaos, with the telemetry sites). Every replica replays
// the same trace, so a warp's lanes sit in one telemetry window almost
// all the time, and a lane's clock only moves forward; yet each site
// booked its window cell in the (R, nW, ...) buffers, one 32-byte sector
// a lane. Here a lane keeps the row of its current window: in registers,
// the sink's count and latency sum and each server's completions, drops
// and busy and depth integrals; in the tile, lane-minor, a row of
// counter pairs for the tenants' arrivals and one for the sink's
// histogram bins (support.stage_plan sizes them after the scanned
// rows), each word counting a cell of the cached window in its low 16
// bits and the same cell of the run's own leaf (trc_arrivals, sink_hist)
// in its high 16. At each event the window of the event's time is
// computed; when it is not the cached one the cached row goes back (a
// sum's value stored, a count added to its cell, a pair's low half added
// and cleared) and the new window's row comes in (a sum loaded, a count
// from 0). A site whose window is the cached one books there; any other
// (a delivery that an edge's latency carries into a later window, an
// integral's piece in another window) books its cell in device memory,
// as before. The launch's end puts the window back and adds the pairs'
// high halves to the run's leaves. A half that reaches 0xFFFF goes to its
// cell at once, so no count wraps. Exact: a count is an integer sum,
// whatever the order of its parts. A float sum (the latency sum, an
// integral) is held in exactly one place at any time, memory or the
// cache (loaded when its window comes in, stored when it goes), and every
// addition into it is made where it is held, in the order the events
// make them; so each cell sees the sequence of roundings the plain step
// makes, and the bits do not change.
//
// The reachability memo (CON). An arrival at a quorum member counted the
// members in reach by scanning every member's fault windows and every
// group's partition windows, and a delivery into a group's member scanned
// its groups' windows again: O(nV (W + nP Wp)) compares an event, for a
// function of t that changes only at a window's edge. Here a lane keeps,
// in registers, the mask of cut groups, the count of members in reach and
// the time until which both hold, the first start or end of any window
// the scan read (every group's, the drop-mode members' own fault windows
// and the shared ones they subscribe to) that lies after the time of the
// scan. The step scans again at the first event whose time has reached
// that time (and at the launch's first event), and every consult answers
// from the mask with the groups' constant tables and from the count: a
// consult's time is its event's. Exact: each window's test
// (t >= start) & (t < end) is constant on [t0, e), e the first edge after
// the scan's time t0 (a start after t0 is at or after e, an end after t0
// too), and a lane's event times never decrease within a launch. The
// wide code past 32 groups (the mask's bits) and the trace library's code
// for several sources (where the memo's registers measured slower)
// scan at every consult.

// The uniforms. The JAX kernel reads a (macro, n_draws) block per replica
// that the host drew from fold_in(key, block). Here each lane folds each
// block's index into its replica's key once and draws a uniform where a
// step's branch reads it (HsDraw, csrc/threefry.cuh): element k * n_draws
// + slot of the same stream, so the bits equal the drawn block's whatever
// slots a step reads, and a slot no branch reads costs nothing.
//
// What bounds it on this card: 32-bit integer operations. A launch reads
// and writes each replica's dense registers once (about 9 MB at 65,536
// replicas of the M/M/1), whatever its block count, and draws one
// threefry2x32 (HS_THREEFRY_OPS integer operations) per uniform read and
// one per lane and block for the block's key, about 33 per lane and
// block on the M/M/1, its rotates and xors on the 64 INT32 lanes of an SM
// (16.7 Tops/s), its adds shared with the FMA pipe's IMAD (33.5 Tops/s
// for both); the float arithmetic is a few
// dozen operations per event against 67 TFLOP/s. The extended
// instantiations add a few dozen more per service draw (lognormal's
// erfinv: log1pf, a root and eight double multiply-adds, then expf;
// pareto's powf) and per profiled fire (two searches of the shared
// tables). What holds it below that: each step is a chain of dependent
// loads and about four warps per scheduler cannot hide their latency,
// lanes diverge on the event kind and the router branch, and the queue
// rings and sink_hist stay strided per replica.

// The chaos leaves (attempt arrays, fault registers, the chaos counters)
// are touched only at the events that need them: the (nV, W) fault
// registers are read at an arrival at, or a pull into, a faulted server.
// The attempt rows and the fault windows are staged where the plan has
// room; the counters stay in device memory in the JAX layout.
//
// The resilience leaves, (R, nV) registers in device memory in the JAX
// layout and the (R, nV, F) failure ring brk_fail_t (staged where the
// plan has room), are read and written only at an arrival at or a
// completion of their server: a
// failure writes one ring slot and compares the next, a trip or a close
// resets the server's F slots. A trip books its whole open interval
// min(cooldown, max(horizon - t, 0)) at once, into brk_open_time and, as
// an interval split over the windows it spans, into tel_brk_open_int.
//
// The telemetry buffers stay in device memory in the JAX layout,
// (R, nW, ...) row-major, and an event touches only the windows its time
// or interval falls in. The window of t is the compiled JAX step's
// int(t * float32(1 / window_s)) clipped to [0, nW); the window edges
// lo = w * window_s and hi = lo + window_s (hi = +inf for the last) are
// single float32 roundings, equal to numpy's window_edges, so no table
// is staged. An interval adds clip(min(hi, hi_w) - max(lo, lo_w), 0) to
// each window; the windows outside [w(lo) - 1, w(hi) + 1] get +0.0 in
// JAX's dense form, which leaves the (non-negative) sum unchanged, so the
// kernel walks only the windows in that range, skips the zero pieces,
// and stays bit-equal. (The trace branch's lean code books the cached
// window's pieces in its window cache, above.)
//
// Float agreement with the plain version: build with -fmad=false and
// without --use_fast_math (every torch op is its own kernel, so the
// plain version never contracts a multiply-add), and use logf/log10f,
// log1pf, sqrtf, expf, powf, exp2f and IEEE division as torch's CUDA ops
// do.
// Where the JAX engine's XLA contracts c + a * b into one multiply-add
// (the erfinv polynomial, the interp lerp, the profile extrapolation, the
// backoff's spread and re-arrival time, the budget's refill, a service's
// end t + x * y, a hedge's race, a direct exponential edge's arrival, the
// limiter's refill, the sink's sum of squares and the depth integrals),
// both versions evaluate it in double and round once to float
// (numerics.py::fma_f32, engine.py::_fused).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "partition_barrier.cuh"
#include "threefry.cuh"

// The lean instantiations' tables in the argument struct. A model past
// one of them runs the wide code (MAXV = HS_WIDE), which reads its
// tables from device memory (HsWide) and bounds none of these counts.
#define HS_WIDE 0
#define HS_MAX_NV 8
#define HS_MAX_ROUTERS 8
#define HS_MAX_TARGETS 8
#define HS_MAX_HOPS 8
#define HS_MAX_LIMITERS 4
#define HS_MAX_SOURCES 8
#define HS_MAX_PARTITIONS 8
#define HS_HIST_BINS 80
// Remote egress nodes of a partitioned model in the lean code's HsPrt
// tables (the wide code reads its remotes from HsWide and bounds none).
#define HS_MAX_REMOTES 8
// Threads per block: 64, which tools/ab_block_loop.py timed faster than
// 128 on the fan-out and the chaos bench (-DHS_THREADS=128 builds its
// variant; the wrapper checks the library's value).
#ifndef HS_THREADS
#define HS_THREADS 64
#endif
// 0 leaves every row in device memory whatever the plan says (a variant
// of tools/ab_block_loop.py, never the library's build).
#ifndef HS_STAGE_ROWS
#define HS_STAGE_ROWS 1
#endif
// 0 lifts the register cap below (a variant of tools/ab_block_loop.py).
#ifndef HS_REG_CAP
#define HS_REG_CAP 1
#endif
// 0 books every telemetry site in device memory and scans every window
// at every consult (the trace branch's lean code without its window
// cache, the consensus code without its memo): the variant the host
// tests hold the library's build against bit for bit, and the A/B tools'.
#ifndef HS_WINDOW_CACHE
#define HS_WINDOW_CACHE 1
#endif
#ifndef HS_REACH_MEMO
#define HS_REACH_MEMO 1
#endif
// The servers the wide code's loops over every server (the search and the
// depth integral) load at once before they use them.
#define HS_WIDE_CHUNK 8
#define HS_MAX_PROFILE_GRID 4096
#define HS_MAX_BREAKER_RING 4096
// Shared memory one block may take on sm_90 (227 KB).
#define HS_MAX_SMEM_PER_BLOCK (227 * 1024)

// Node kinds in the topology tables.
#define HS_SINK 0
#define HS_SERVER 1
#define HS_ROUTER 2
#define HS_LIMITER 3
#define HS_REMOTE 4  // PRT: the outbox to the neighbour partition
// Router policies.
#define HS_RANDOM 0
#define HS_ROUND_ROBIN 1
#define HS_WEIGHTED 2
#define HS_LEAST_OUTSTANDING 3
// Edge latency kinds.
#define HS_LAT_NONE 0
#define HS_LAT_CONSTANT 1
#define HS_LAT_EXPONENTIAL 2
// Service families (the JAX kind ids).
#define HS_SVC_CONSTANT 0
#define HS_SVC_EXPONENTIAL 1
#define HS_SVC_ERLANG 2
#define HS_SVC_HYPEREXP 3
#define HS_SVC_LOGNORMAL 4
#define HS_SVC_PARETO 5
// Per-server chaos flags (EventStepArgs::srv_flags).
#define HS_F_FAULTED 1       // has a fault spec
#define HS_F_DROP 2          // its fault mode is outage (else degrade)
#define HS_F_SHARED 4        // subscribes to the correlated schedule
#define HS_F_FAULT_RETRY 8   // fault rejections retry after a backoff
#define HS_F_BACKOFF 16      // retries go through the transit registers
#define HS_F_HEDGE 32        // hedged starts
#define HS_F_OUTAGE 64       // a brownout window
#define HS_F_DEADLINE 128    // a deadline

// The leaves the plan may stage in shared memory, in the order it takes
// them (kernels/support.py::STAGE_LEAVES).
#define HS_ST_TR_TIME 0
#define HS_ST_TR_CREATED 1
#define HS_ST_TR_ATTEMPT 2
#define HS_ST_SLOT_DONE 3
#define HS_ST_SLOT_CREATED 4
#define HS_ST_SLOT_ATTEMPT 5
#define HS_ST_FLT_START 6
#define HS_ST_FLT_END 7
#define HS_ST_FLT_SH_START 8
#define HS_ST_FLT_SH_END 9
#define HS_ST_BRK_FAIL_T 10
#define HS_ST_PRT_START 11
#define HS_ST_PRT_END 12
// The window cache's counter pairs (the trace branch's lean code with
// telemetry): the tenants' row, then the sink's histogram row.
#define HS_ST_TENANT_PAIRS 13
#define HS_ST_HIST_PAIRS 14
#define HS_STAGE_LEAVES 15

// The staging plan: where each leaf's rows sit in a lane's column of the
// tile (a word offset, -1: in device memory) and the column's words. The
// layout must match kernels/event_step.py::_Stage.
struct HsStage {
  int off[HS_STAGE_LEAVES];
  int words;
};

// A downstream node and the edge that leads to it.
struct HsRef {
  int kind;        // HS_SINK / HS_SERVER / HS_ROUTER / HS_LIMITER
  int index;
  float lat_mean;  // edge latency mean (s)
  int lat_kind;    // HS_LAT_*
};

// A lossy edge: the crossing is lost with probability p inside [start, end).
struct HsLoss {
  float p, start, end;
};

// One source: where it delivers, its arrivals and its rate profile. The
// layout must match kernels/event_step.py::_Src.
struct HsSrc {
  HsRef ref;            // where it delivers
  HsLoss loss;          // its edge's packet loss (CHAOS)
  int poisson;          // 1: -log(u)/rate gaps, 0: 1/rate
  float stop_after;     // no arrival after this time
  int prof_row;         // EXT: its row of the staged profile tables (-1: a flat rate)
  float prof_end_rate;  // EXT: the rate past the profile's grid
};

// Windowed telemetry (TEL instantiations): the window buffers, replica
// major in the JAX layout and null where the spec or the model has none,
// and the window grid. The layout must match kernels/event_step.py::_Tel.
struct HsTel {
  int* sink_count;       // (R, nW, nK)
  float* sink_sum;       // (R, nW, nK)
  int* sink_hist;        // (R, nW, nK, 80)
  float* depth_int;      // (R, nW, nV)
  float* busy_int;       // (R, nW, nV)
  int* completed;        // (R, nW, nV), and so on to tr_dropped
  int* dropped;
  int* timed_out;
  int* retried;
  int* outage_dropped;
  int* fault_dropped;
  int* fault_retried;
  int* hedged;
  int* hedge_wins;
  int* tr_dropped;
  int* lim_admitted;     // (R, nW, nL)
  int* lim_dropped;      // (R, nW, nL)
  int* net_lost;         // (R, nW)
  int nW;                // windows (0: the model has no telemetry)
  float window_s;        // the window width
  float inv_window_s;    // float32(1 / window_s)
};

// The resilience defenses (RES instantiations): their leaves, replica
// major in the JAX layout and null where the model has no such spec (the
// tel_ ones also without telemetry), and their constants. The layout must
// match kernels/event_step.py::_Res.
struct HsRes {
  int* brk_state;            // (R, nV) 0 closed, 1 open, 2 half-open
  float* brk_fail_t;         // (R, nV, F) recent failure times, -inf: empty
  int* brk_fail_idx;         // (R, nV) the ring's cursor
  float* brk_open_t;         // (R, nV) the last trip time
  int* brk_probes;           // (R, nV) half-open probes admitted
  int* brk_tripped;          // (R, nV)
  float* brk_open_time;      // (R, nV) open seconds, booked at trip time
  int* breaker_dropped;      // (R, nV)
  int* shed_dropped;         // (R, nV)
  float* bud_tokens;         // (R, nV) the retry budget's bucket
  float* bud_last;           // (R, nV) its last refill time
  int* budget_dropped;       // (R, nV) launches suppressed
  int* tel_breaker_dropped;  // (R, nW, nV), and so on
  int* tel_brk_tripped;
  float* tel_brk_open_int;
  int* tel_shed_dropped;
  int* tel_budget_dropped;
  int on;                    // 1: the model has a defense
  int breaker, shed, budget; // which ones
  int F;                     // the failure ring's width (failure_threshold)
  float brk_window, brk_cooldown;
  int brk_max_probes;        // half_open_probes
  int shed_policy;           // 0 queue_depth, 1 utilization
  int shed_depth;            // queue_depth: int(threshold)
  int u_shed;                // the priority draw's slot (-1: none)
  float shed_priority;       // priority_fraction
  float shed_busy_thr[HS_MAX_NV];  // utilization: float32(threshold * conc)
  float bud_ratio, bud_min_per_s, bud_burst;
};

// The consensus tier (CON instantiations): the partition windows and the
// counters the step books, replica major in the JAX layout and null where
// the model has none (the tel_ ones also without telemetry), and the
// groups' constants. Group and quorum membership are bit masks over the
// servers. The layout must match kernels/event_step.py::_Con.
struct HsCon {
  const float* prt_start;    // (R, nP, Wp) partition windows
  const float* prt_end;      // (R, nP, Wp)
  int* net_partitioned;      // (R,) deliveries a drop-mode cut vanished
  int* qrm_dropped;          // (R, nV) arrivals the quorum rejected
  int* tel_net_partitioned;  // (R, nW)
  int* tel_qrm_dropped;      // (R, nW, nV)
  int on;                    // 1: partition groups or a quorum
  int nP, Wp;                // groups, windows per group
  int prt_member[HS_MAX_PARTITIONS];  // bit v: server v is in the group
  int prt_drop[HS_MAX_PARTITIONS];    // 1: drop-mode, 0: delay-mode
  float prt_delay[HS_MAX_PARTITIONS]; // a delay-mode group's delay_s
  int touched;               // bit v: server v is in some group
  int quorum;                // 1: a quorum group
  int qrm_member;            // bit v: server v is a quorum member
  int qrm_n, qrm_write;      // members, and the write quorum
  int qrm_retry;             // bit v: a member whose rejections retry after a backoff
};

// Trace-driven arrivals (TRC instantiations): the traced source's leaves,
// replica major in the JAX layout, and the two resident pages of the
// trace, the window [base, base + 2P) of its arrivals. The layout must
// match kernels/event_step.py::_Trc.
struct HsTrc {
  uint32_t* cursor;   // (R,) arrivals fired, the read cursor
  int* blocks;        // (R,) blocks run, the lane's RNG stream index
  int* arrivals;      // (R, nT) arrivals per tenant
  int* tel_arrivals;  // (R, nW, nT), null without telemetry rates
  const float* t0;    // (P,) the times of the page at base
  const int* g0;      // (P,) its tenants
  const float* t1;    // (P,) the next page's times
  const int* g1;      // (P,) its tenants
  int on;             // 1: a traced source
  int src;            // the traced source's index
  int base;           // the absolute index of t0[0]
  int P;              // arrivals a page
  int nT;             // tenants
  int n_chunks;       // the run's block budget per lane
};

// The partitioned executor (PRT instantiations): the outbox leaves,
// replica major in the JAX layout (or, with the barrier folded in, a
// scratch outbox of the window's parity), the truncated-window counter,
// the transit rows' occupancy bounds, the window's end and event budget,
// the remote egress nodes' tables, and the previous window's barrier when
// it is folded into this launch. The layout must match
// kernels/event_step.py::_Prt.
struct HsPrt {
  float* ob_arrival;  // (R, OB) when each queued job reaches the neighbour
  float* ob_created;  // (R, OB) its creation time
  int* ob_ingress;    // (R, OB) the neighbour's server it enters
  int* ob_len;        // (R,) jobs queued this window
  int* ob_sent;       // (R,) jobs sent
  int* ob_dropped;    // (R,) jobs a full outbox dropped
  int* truncated;     // (R,) windows whose budget ran out with an event due
  // (R, nV) 1 + the highest occupied (not +inf) slot of each transit row
  // (0: empty), kept across windows beside the state (not a leaf); the
  // barrier keeps it too. Every scan of a row stops there.
  int* tr_hi;
  int on;             // 1: a window launch of the partitioned executor
  int OB;             // outbox capacity
  int budget;         // events a lane may run this window
  float limit;        // the window's end
  int nRm;            // remote egress nodes
  float rm_latency[HS_MAX_REMOTES];  // float32 latency_s of each
  int rm_ingress[HS_MAX_REMOTES];    // its ingress server
  // 1: each lane first runs its barrier of the previous window (`bar`:
  // the state's rows, and the other parity's scratch outbox to merge and
  // reset), as the barrier kernel would have before this launch.
  int fold;
  BarrierArgs bar;
};

// The wide code's tables (MAXV = HS_WIDE): the model's constants, one
// device buffer uploaded once per model and device, each table a pointer
// into it read through the read-only cache; per-server tables have nV
// rows, the router tables nR rows of nT, the group table nP rows of nV
// (1: server v is in group p), the remote tables nRm rows. Then the
// launch's scratch, which stands in for the lean code's register arrays,
// each array over the replicas rounded up to whole warps, in warp tiles
// (a warp reads one server's register of its 32 lanes as 32 consecutive
// words): `regs`, the nine per-server registers in HS_WIDE_REGS (nV,
// lanes) planes (copied from the state leaves at a launch's start and
// back at its end), and `smin`
// and `tmin`, the earliest completion and transit arrival per server (nV,
// lanes), derived at the start and scanned at every step. Null everywhere
// in the lean instantiations. The layout must match
// kernels/event_step.py::_Wide.
struct HsWide {
  const HsSrc* src;                 // (nS,)
  const HsRef* srv_ref;             // (nV,)
  const int *svc_kind, *conc, *qcap, *erlang_k;
  const float *hyp_p1, *hyp_f1, *hyp_f2, *ln_sigma, *par_alpha, *par_xmf;
  const int *srv_flags, *max_retries, *cap_slots;
  const float *deadline, *outage_start, *outage_end, *backoff, *jitter, *hedge, *lat_factor;
  const HsLoss* srv_loss;           // (nV,)
  const int* u_route;               // (hop depth,)
  const int *rt_policy, *rt_n, *rt_park;  // (nR,)
  const HsRef* rt_target;           // (nR, nT)
  const float* rt_cum;              // (nR, nT)
  const HsLoss* rt_loss;            // (nR, nT)
  const float *lim_rate, *lim_cap;  // (nL,)
  const HsRef* lim_ref;
  const HsLoss* lim_loss;
  const float* shed_busy_thr;       // (nV,)
  const int* prt_member;            // (nP, nV)
  const int* prt_drop;              // (nP,)
  const float* prt_delay;           // (nP,)
  const int *touched, *qrm_member, *qrm_retry;  // (nV,) 0 or 1
  const float* rm_latency;          // (nRm,) PRT: float32 latency_s of each remote
  const int* rm_ingress;            // (nRm,) its ingress server
  float *smin, *tmin;               // (nV, lanes) scratch
  float* regs;                      // (HS_WIDE_REGS, nV, lanes) scratch
  int nT;                           // the router tables' row length
  int on;                           // 1: the wide code's launch
};

// Launch arguments. The layout must match kernels/event_step.py::_Args.
struct EventStepArgs {
  // state leaves, replica-major, JAX layout
  float* t;                // (R,)
  float* src_next;         // (R, nS)
  int* events;             // (R,)
  float* slot_done;        // (R, nV, C)
  float* slot_created;     // (R, nV, C)
  float* q_created;        // (R, nV, K)
  float* q_enq;            // (R, nV, K)
  int* q_head;             // (R, nV)
  int* q_len;              // (R, nV)
  int* started;            // (R, nV)
  int* completed;          // (R, nV)
  int* dropped;            // (R, nV)
  int* wait_n;             // (R, nV)
  float* busy_int;         // (R, nV)
  float* depth_int;        // (R, nV)
  float* wait_sum;         // (R, nV)
  int* sink_count;         // (R, nK)
  float* sink_sum;         // (R, nK)
  float* sink_sq;          // (R, nK)
  int* sink_hist;          // (R, nK, 80)
  int* rr_next;            // (R, nR)
  float* lim_tokens;       // (R, nL)
  float* lim_last;         // (R, nL)
  int* lim_admitted;       // (R, nL)
  int* lim_dropped;        // (R, nL)
  float* tr_time;          // (R, nV, TR), null without transit
  float* tr_created;       // (R, nV, TR), null without transit
  int* tr_dropped;         // (R, nV), null without transit
  uint8_t* halted;         // (R,) out
  const uint32_t* keys;    // (R, 2) the replicas' threefry keys
  int* draws;              // (R,) out: threefry evaluations per lane (null: not counted)
  int* blocks;             // (R,) in/out: blocks each lane ran, added to (null: not counted)
  const float* src_rate;   // (R, nS)
  const float* srv_mean;   // (R, nV)
  int R, nV, C, K, macro, n_draws;
  unsigned int block;      // the first block's absolute index, which keys its draws
  int n_blocks;            // blocks block, block + 1, ..., block + n_blocks - 1
  int nS, nK;              // sources and sinks
  // Where the compiled JAX step rounds t + x * y once (ROADMAP C): 1 when
  // one service family is present (several: a select sits before the
  // add), 1 when some server's degrade windows inflate its service (JAX
  // then multiplies every arrival's service by its factor), 1 when some
  // server hedges (JAX's hedge select then sits before every arrival's
  // add).
  int svc_fused, degrade_lat, hedge_any;
  int u_gap, u_svc1, u_svc2;  // uniform slots (-1: none)
  float horizon, warmup;
  int svc_kind[HS_MAX_NV];   // 0 constant, 1 exponential
  int conc[HS_MAX_NV];       // valid slots per server
  int qcap[HS_MAX_NV];       // queue capacity per server
  HsSrc src[HS_MAX_SOURCES]; // each source
  HsRef srv_ref[HS_MAX_NV];  // where each server delivers
  // GRAPH only
  int graph;                 // 1: routers, limiters or a latency edge
  int nR, nL, TR;            // router, limiter and transit-slot counts
  int u_lat;                 // edge-latency draw slot (-1: none)
  int n_route_slots;         // route-draw slots, one per router hop depth
  int max_walk;              // bound on the hops of one delivery
  int u_route[HS_MAX_HOPS];
  int rt_policy[HS_MAX_ROUTERS];
  int rt_n[HS_MAX_ROUTERS];        // targets per router
  int rt_park[HS_MAX_ROUTERS];     // 1: any target edge carries latency
  HsRef rt_target[HS_MAX_ROUTERS][HS_MAX_TARGETS];
  float rt_cum[HS_MAX_ROUTERS][HS_MAX_TARGETS];  // weighted: float32 cumulative weights
  float lim_rate[HS_MAX_LIMITERS];
  float lim_cap[HS_MAX_LIMITERS];
  HsRef lim_ref[HS_MAX_LIMITERS];  // where each limiter delivers
  // EXT only
  int ext;                   // 1: a family beyond constant/exponential, or a profile
  int has_profile;           // profiled sources, each a row of the staged tables
  int prof_n;                // grid points G
  const float* prof_times;   // (nS, G) each source's time grid, device memory
  const float* prof_cum;     // (nS, G) its cumulative rate
  int erlang_k[HS_MAX_NV];   // 2 or 3
  float hyp_p1[HS_MAX_NV], hyp_f1[HS_MAX_NV], hyp_f2[HS_MAX_NV];
  float ln_sigma[HS_MAX_NV];
  float par_alpha[HS_MAX_NV], par_xmf[HS_MAX_NV];
  // CHAOS only: leaves (null where the model has none)
  int chaos;                 // 1: deadlines, retries, hedges, brownouts, faults or loss
  int* slot_attempt;         // (R, nV, C) attempt numbers
  int* q_attempt;            // (R, nV, K)
  int* tr_attempt;           // (R, nV, TR), with backoff retries
  const float* flt_start;    // (R, nV, W) fault windows
  const float* flt_end;      // (R, nV, W)
  const float* flt_sh_start; // (R, W_sh) the fired shared windows
  const float* flt_sh_end;   // (R, W_sh)
  int* timed_out;            // (R, nV)
  int* retried;              // (R, nV)
  int* outage_dropped;       // (R, nV)
  int* fault_dropped;        // (R, nV)
  int* fault_retried;        // (R, nV)
  int* hedged;               // (R, nV)
  int* hedge_wins;           // (R, nV)
  int* net_lost;             // (R,)
  int W, W_sh;               // fault window budgets
  int u_hed1, u_hed2, u_loss, u_jit;  // uniform slots (-1: none)
  int srv_flags[HS_MAX_NV];  // HS_F_*
  int max_retries[HS_MAX_NV];
  int cap_slots[HS_MAX_NV];  // usable slots while degraded
  float deadline[HS_MAX_NV];
  float outage_start[HS_MAX_NV], outage_end[HS_MAX_NV];
  float backoff[HS_MAX_NV], jitter[HS_MAX_NV];
  float hedge[HS_MAX_NV];
  float lat_factor[HS_MAX_NV];
  HsLoss srv_loss[HS_MAX_NV];                // each server's downstream edge
  HsLoss lim_loss[HS_MAX_LIMITERS];          // each limiter's downstream edge
  HsLoss rt_loss[HS_MAX_ROUTERS][HS_MAX_TARGETS];  // each router's target edges
  // TEL only
  HsTel tel;
  // RES only
  HsRes res;
  // CON only
  HsCon con;
  // TRC only
  HsTrc trc;
  // MAXV = HS_WIDE only
  HsWide wide;
  // The rows staged in shared memory (kernels/support.py::stage_plan).
  HsStage stage;
  // PRT only
  HsPrt prt;
};

// The planes of the wide code's `regs` scratch: q_len and depth, which the
// loops over every server read, then one 8-word record a lane and server
// holding q_head, started, completed, dropped, wait_n (int), busy and wsum
// (float), which an event reads at its own server, so a start or a pull
// touches one 32-byte sector of them, not five.
#define HS_WIDE_REGS 10

// The struct is passed by value as a __grid_constant__ kernel parameter.
// With the resilience constants it passes the classic 4 KB (4,808 bytes
// with the sources', the consensus tier's and the trace's); CUDA 12.1
// lifted the limit to 32,764 bytes on Volta and later (sm_90a included).
static_assert(sizeof(EventStepArgs) <= 32764,
              "event-step arguments exceed the 32,764-byte kernel-parameter limit");

// The block's dynamic shared memory: the profile tables (EXT
// instantiations with a profiled source: the time grid then the
// cumulative grid of each profiled source, in the order of their rows),
// then the row tile.
extern __shared__ float hs_tables[];

// Lanes `lane`, `lane + lanes`, ... of a thread block copy each profiled
// source's two (G,) tables into its row of the block's tables (the
// sources' rows in the arguments, or in the wide code's tables).
__device__ __forceinline__ void stage_profiles(const EventStepArgs& a, int lane, int lanes) {
  const int n = a.prof_n;
  const HsSrc* srcs = a.wide.on ? a.wide.src : a.src;
  for (int s = 0; s < a.nS; ++s) {
    const int row = srcs[s].prof_row;
    if (row < 0) continue;
    float* times = hs_tables + (size_t)2 * n * row;
    for (int i = lane; i < n; i += lanes) {
      times[i] = a.prof_times[(size_t)s * n + i];
      times[n + i] = a.prof_cum[(size_t)s * n + i];
    }
  }
}

// A read through the read-only cache (a plain load in the host build):
// the trace pages and the wide code's tables.
template <typename T>
__device__ __forceinline__ T hs_ldg(const T* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

// A row of a per-replica leaf: element j at p[j * s], with s 1 in device
// memory and blockDim.x in the shared tile.
template <typename T>
struct HsRow {
  T* p;
  int s;
  __device__ __forceinline__ T& operator[](int j) const { return p[j * s]; }
  __device__ __forceinline__ HsRow operator+(int j) const { return HsRow{p + j * s, s}; }
  __device__ __forceinline__ explicit operator bool() const { return p != nullptr; }
};

// A lane's n elements of a leaf from g (null: the model has not got it):
// copied into its column of the tile at word `off` when the plan stages
// the leaf, else read in place.
template <typename T>
__device__ __forceinline__ HsRow<T> stage_in(T* g, int off, int n, float* tile) {
  using M = typename std::remove_const<T>::type;
  if (!HS_STAGE_ROWS || g == nullptr || off < 0) return HsRow<T>{g, 1};
  const int stride = (int)blockDim.x;
  M* col = reinterpret_cast<M*>(tile + off * stride) + threadIdx.x;
  for (int j = 0; j < n; ++j) col[j * stride] = g[j];
  return HsRow<T>{col, stride};
}

// The staged row back to its n elements at g (nothing for a row read in
// place).
template <typename T>
__device__ __forceinline__ void stage_out(const HsRow<T>& row, T* g, int n) {
  if (row.p == g) return;
  for (int j = 0; j < n; ++j) g[j] = row[j];
}

// Register-array access with a run-time index: unrolled selects, so the
// arrays stay in registers (the JAX step's one-hot _pick / where(row)).
template <int MAXV, typename T>
__device__ __forceinline__ T pick(const T (&a)[MAXV], int i) {
  T out = a[0];
#pragma unroll
  for (int v = 1; v < MAXV; ++v)
    if (v == i) out = a[v];
  return out;
}

template <int MAXV, typename T>
__device__ __forceinline__ void put(T (&a)[MAXV], int i, T x) {
#pragma unroll
  for (int v = 0; v < MAXV; ++v)
    if (v == i) a[v] = x;
}

// The same for a per-server table in the argument struct.
template <int MAXV, typename T>
__device__ __forceinline__ T pick_arg(const T* a, int i) {
  T out = a[0];
#pragma unroll
  for (int v = 1; v < MAXV; ++v)
    if (v == i) out = a[v];
  return out;
}

// The wide code's per-server registers are rows in device memory (the
// state leaves, or the (nV, R) scratch), read and written in place.
template <typename T>
__device__ __forceinline__ T pick(const HsRow<T>& a, int i) {
  return a[i];
}

template <typename T>
__device__ __forceinline__ void put(const HsRow<T>& a, int i, T x) {
  a[i] = x;
}

// Entry i of a table: `lean`'s in the argument struct (a per-server table
// through pick_arg; `direct`: indexed as it stands), or the wide code's in
// device memory. Scalars go through the read-only cache.
template <int MAXV, bool direct = false, typename T>
__device__ __forceinline__ T hs_tab(const T* lean, const T* wide, int i) {
  if constexpr (MAXV == HS_WIDE) {
    if constexpr (std::is_arithmetic<T>::value) {
      return hs_ldg(wide + i);
    } else {
      return wide[i];
    }
  } else if constexpr (direct) {
    return lean[i];
  } else {
    return pick_arg<MAXV>(lean, i);
  }
}

// Server w's constant `field` of the arguments (the lean code) or of the
// wide code's tables.
#define HS_SRV(field, w) hs_tab<MAXV>(a.field, a.wide.field, w)
// Entry i of a router, limiter, hop or group table.
#define HS_ARR(lean, field, i) hs_tab<MAXV, true>(lean, a.wide.field, i)
// Entry (row, i) of a router's target tables.
#define HS_RT(field, row, i) \
  (MAXV == HS_WIDE ? a.wide.field[(row) * a.wide.nT + (i)] : a.field[row][i])

// Whether server w is in a set: bit w of the lean code's mask, or entry w
// of the wide code's (nV,) table.
template <int MAXV>
__device__ __forceinline__ bool hs_bit(int mask, const int* wide, int w) {
  if constexpr (MAXV == HS_WIDE) {
    return hs_ldg(wide + w) != 0;
  } else {
    return (mask >> w) & 1;
  }
}

// The engine's uniforms: rng.uniform(fold_in(key_r, block), (macro,
// n_draws), 1e-12, 1.0), element k * n_draws + slot for step k.
#define HS_U_LO 1e-12f
#define HS_U_SPAN 1.0f  // float32(1.0 - float32(1e-12))

// How one of the engine's uniforms is drawn: inlined at its read site,
// or through one called function. The CHAOS instantiations call it:
// inlined at their many read sites (service, hedge, loss, jitter, route
// and shed draws) it costs registers, spills and time; all others inline
// it, and so does the 1-server chaos instantiation with telemetry and no
// defense, which measured faster inlined (the kernel's draw_calls;
// tools/ab_draw_inline.py times both ways). HS_DRAW_INLINE or
// HS_DRAW_CALL forces one way on every instantiation, for that script.
__device__ __forceinline__ float hs_draw_inline(HsKey key, uint32_t index) {
  return hs_uniform_at(key, index, HS_U_LO, HS_U_SPAN);
}

__device__ __noinline__ float hs_draw_call(HsKey key, uint32_t index) {
  return hs_uniform_at(key, index, HS_U_LO, HS_U_SPAN);
}

// Step k's row of the block's uniforms, drawn on demand: u[slot] is made
// when a branch reads it, and the bits are the same whichever slots a
// step reads. `u + base` is the window of slots from `base` on (the
// service draws). Every draw adds one to *count.
struct HsDraw {
  HsKey key;       // fold_in(key_r, block)
  uint32_t base;   // k * n_draws (+ a window's base)
  int* count;      // this lane's threefry evaluations
  bool call;       // draw through hs_draw_call (a constant of the instantiation)
  __device__ __forceinline__ float operator[](int slot) const {
    *count += 1;
    const uint32_t index = base + (uint32_t)slot;
#if defined(HS_DRAW_INLINE)
    return hs_draw_inline(key, index);
#elif defined(HS_DRAW_CALL)
    return hs_draw_call(key, index);
#else
    return call ? hs_draw_call(key, index) : hs_draw_inline(key, index);
#endif
  }
  __device__ __forceinline__ HsDraw operator+(int offset) const {
    return HsDraw{key, base + (uint32_t)offset, count, call};
  }
};

// A service draw as the two factors of its last multiply, service = x *
// y (a constant service is mean * 1): a start adds it to t as one
// multiply-add, as XLA contracts t + x * y in the compiled JAX step.
struct HsSvc {
  float x, y;
};

__device__ __forceinline__ HsSvc sample_service(int kind, float mean, const HsDraw& u, int slot) {
  if (kind == 0) return HsSvc{mean, 1.0f};
  return HsSvc{-logf(u[slot]), mean};
}

// c + a * b rounded once: exact product and sum in double, then float
// (numerics.py::fma_f32; -fmad=false keeps the double ops apart).
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return (float)((double)c + (double)a * (double)b);
}

// Giles' float32 erfinv as XLA expands it (numerics.py::erfinv).
__device__ __forceinline__ float erfinv_f32(float x) {
  const float w = -log1pf(x * -x);
  const bool low = w < 5.0f;
  const float s = low ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = low ? 2.81022636e-08f : -0.000200214257f;
  p = fma_f64(p, s, low ? 3.43273939e-07f : 0.000100950558f);
  p = fma_f64(p, s, low ? -3.5233877e-06f : 0.00134934322f);
  p = fma_f64(p, s, low ? -4.39150654e-06f : -0.00367342844f);
  p = fma_f64(p, s, low ? 0.00021858087f : 0.00573950773f);
  p = fma_f64(p, s, low ? -0.00125372503f : -0.0076224613f);
  p = fma_f64(p, s, low ? -0.00417768164f : 0.00943887047f);
  p = fma_f64(p, s, low ? 0.246640727f : 1.00167406f);
  p = fma_f64(p, s, low ? 1.50140941f : 2.83297682f);
  return fabsf(x) == 1.0f ? x * INFINITY : p * x;
}

// One service draw of family `kind` from the window u[0..n_svc_draws)
// (JAX _sample_service; the kind picks the family, as jnp.select does),
// as its last multiply's factors.
template <int MAXV>
__device__ __forceinline__ HsSvc sample_family(const EventStepArgs& a, int w, float mean,
                                               const HsDraw& u) {
  const int kind = HS_SRV(svc_kind, w);
  if (kind == HS_SVC_CONSTANT) return HsSvc{mean, 1.0f};
  const float ua = u[0];
  if (kind == HS_SVC_EXPONENTIAL) return HsSvc{-logf(ua), mean};
  if (kind == HS_SVC_ERLANG) {
    if (HS_SRV(erlang_k, w) == 2) return HsSvc{(-logf(ua * u[1])) * mean, 0.5f};
    // XLA rewrites JAX's "/ 3.0" as a multiply by float(1/3).
    return HsSvc{(-logf(ua * u[1] * u[2])) * mean, 1.0f / 3.0f};
  }
  if (kind == HS_SVC_HYPEREXP) {
    const float factor = ua < HS_SRV(hyp_p1, w) ? HS_SRV(hyp_f1, w)
                                                          : HS_SRV(hyp_f2, w);
    return HsSvc{(-logf(u[1])) * mean, factor};
  }
  if (kind == HS_SVC_LOGNORMAL) {
    const float sigma = HS_SRV(ln_sigma, w);
    const float z = 1.41421354f * erfinv_f32(2.0f * ua - 1.0f);
    return HsSvc{mean, expf(sigma * z - 0.5f * sigma * sigma)};
  }
  const float alpha = HS_SRV(par_alpha, w);
  return HsSvc{mean * HS_SRV(par_xmf, w), powf(ua, -1.0f / alpha)};
}

// Server w's service draw from the window at u (EXT: any family), with
// several families present the product rounded first (engine.py's
// _service_terms).
template <int MAXV, bool EXT>
__device__ __forceinline__ HsSvc service_terms(const EventStepArgs& a, int w, float mean,
                                               const HsDraw& u) {
  HsSvc s;
  if constexpr (EXT) {
    s = sample_family<MAXV>(a, w, mean, u);
  } else {
    s = sample_service(HS_SRV(svc_kind, w), mean, u, 0);
  }
  if (!a.svc_fused) s = HsSvc{s.x * s.y, 1.0f};
  return s;
}

// numpy/jnp searchsorted(xp, x, side="right") on a sorted (n,) grid: the
// number of entries <= x.
__device__ __forceinline__ int search_right(const float* xp, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (xp[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// jnp.interp(x, xp, fp) on (n,) grids (numerics.py::interp).
__device__ __forceinline__ float interp(float x, const float* xp, const float* fp, int n) {
  const int i = min(max(search_right(xp, n, x), 1), n - 1);
  const float f_lo = fp[i - 1];
  const float df = fp[i] - f_lo;
  const float dx = xp[i] - xp[i - 1];
  const float delta = x - xp[i - 1];
  float f = fabsf(dx) <= 1.42108547e-14f ? f_lo : fma_f64(delta / dx, df, f_lo);
  if (x < xp[0]) f = fp[0];
  if (x > xp[n - 1]) f = fp[n - 1];
  return f;
}

// JAX _invert_profile: the gap g with Lambda(t + g) - Lambda(t) = inc,
// Lambda read forward then inverted, each extrapolated at the final rate
// past the grid.
__device__ __forceinline__ float invert_profile(int n, float end_rate, const float* times,
                                                const float* cum, float t, float inc) {
  const float t_end = times[n - 1], c_end = cum[n - 1];
  const float at = t <= t_end ? interp(t, times, cum, n) : fma_f64(t - t_end, end_rate, c_end);
  const float target = at + inc;
  const float t_next = target <= c_end ? interp(target, cum, times, n)
                                       : t_end + (target - c_end) / end_rate;
  return fmaxf(t_next - t, 1e-9f);
}

__device__ __forceinline__ int hist_bin(float latency) {
  const float logv = log10f(fmaxf(latency, 1e-12f));
  const float frac = (logv - (-5.0f)) / 8.0f;
  const int b = (int)(frac * 80.0f);  // truncation toward zero
  return min(max(b, 0), HS_HIST_BINS - 1);
}

// The window of time t: the compiled JAX step's clip(int32(t * float32(1 /
// window_s)), 0, nW - 1); a time past the grid lands in the last window.
__device__ __forceinline__ int tel_window(const HsTel& T, float t) {
  const float q = t * T.inv_window_s;
  if (!(q < (float)T.nW)) return T.nW - 1;
  return max((int)q, 0);
}

// A windowed counter (JAX _tel_count): column i of replica row `row`
// (r * nW) of an (R, nW, width) buffer, in the window of t; a null buffer
// is one the model has not got.
__device__ __forceinline__ void tel_count(int* buf, const HsTel& T, size_t row, int width,
                                          float t, int i) {
  if (buf) buf[(row + tel_window(T, t)) * width + i] += 1;
}

// The window cache's counter pairs (see the head of this file): each word
// of such a row in the tile counts one cell twice, 16 bits each.

// A lane's column of n counter pairs in the tile at word `off`, zeroed
// (off < 0: not planned, a null row).
__device__ __forceinline__ HsRow<uint32_t> pair_row(int off, int n, float* tile) {
  if (!HS_STAGE_ROWS || off < 0) return HsRow<uint32_t>{nullptr, 1};
  const int stride = (int)blockDim.x;
  uint32_t* col = reinterpret_cast<uint32_t*>(tile + off * stride) + threadIdx.x;
#pragma unroll 1
  for (int j = 0; j < n; ++j) col[j * stride] = 0u;
  return HsRow<uint32_t>{col, stride};
}

// One count into pair j: the launch's half (high) always, the cached
// window's half (low) where `win`. A half that reaches 0xFFFF goes to its
// cell at once (`launch`, or `window`), so neither wraps.
__device__ __forceinline__ void pair_add(const HsRow<uint32_t>& pairs, int j, bool win,
                                         int* window, int* launch) {
  uint32_t p = pairs[j] + (win ? 0x10001u : 0x10000u);
  if ((p & 0xFFFFu) == 0xFFFFu) {
    *window += 0xFFFF;
    p -= 0xFFFFu;
  }
  if ((p >> 16) == 0xFFFFu) {
    *launch += 0xFFFF;
    p -= 0xFFFF0000u;
  }
  pairs[j] = p;
}

// The cached window's halves of n pairs added to their cells in `window`
// (row r * nW + w of an (R, nW, n) buffer) and cleared. A loop, not
// unrolled: it sits in the step's loop and runs once a window.
__device__ __forceinline__ void pairs_flush(const HsRow<uint32_t>& pairs, int n, int* window) {
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const uint32_t p = pairs[j];
    const uint32_t lo = p & 0xFFFFu;
    if (lo) {
      window[j] += (int)lo;
      pairs[j] = p - lo;
    }
  }
}

// Four cells of a histogram row, one 16-byte access (a row starts at a
// multiple of 80 words, so every quad of it is aligned).
struct alignas(16) HsQuad {
  int v[4];
};

// The histogram's 80 pairs, four at a time: the cached window's halves
// added to the cells of `window` (null: none) and cleared; with `launch`
// (the launch's end), the launch's halves added to its cells. A quad of
// cells is read and written in one access each, and skipped where its
// halves are all 0.
__device__ __forceinline__ void hist_flush(const HsRow<uint32_t>& pairs, int* window, int* launch) {
#pragma unroll 2
  for (int q = 0; q < HS_HIST_BINS; q += 4) {
    uint32_t p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = pairs[q + k];
    const uint32_t any = p[0] | p[1] | p[2] | p[3];
    if (window && (any & 0xFFFFu)) {
      HsQuad* cell = reinterpret_cast<HsQuad*>(window + q);
      HsQuad c = *cell;
#pragma unroll
      for (int k = 0; k < 4; ++k) c.v[k] += (int)(p[k] & 0xFFFFu);
      *cell = c;
      if (!launch) {
#pragma unroll
        for (int k = 0; k < 4; ++k) pairs[q + k] = p[k] & 0xFFFF0000u;
      }
    }
    if (launch && (any >> 16)) {
      HsQuad* cell = reinterpret_cast<HsQuad*>(launch + q);
      HsQuad c = *cell;
#pragma unroll
      for (int k = 0; k < 4; ++k) c.v[k] += (int)(p[k] >> 16);
      *cell = c;
    }
  }
}

// TRC: the traced source's fire (JAX _fire_trace_source). The arrival at
// the cursor counts for its tenant (and, with TEL, in the window of t),
// the cursor advances, and the next instant is read from the resident
// pages: +inf padding past the trace's end, or an instant past
// stop_after, stops the source. Both offsets are clipped into the window
// [base, base + 2P), as JAX clips them; the stall gate keeps a firing
// lane inside it. Returns the source's next arrival. WC: the arrival
// counts in the tenants' pairs where the plan has them, window `win_w`
// (the window of t) in their low half.
template <bool TEL, bool WC = false>
__device__ __forceinline__ float trace_fire(const EventStepArgs& a, size_t r, size_t tel_row,
                                            float t, uint32_t& cursor, float stop_after,
                                            const HsRow<uint32_t>& pairs, int win_w) {
  const HsTrc& T = a.trc;
  const int span = 2 * T.P;
  const int off = min(max((int)cursor - T.base, 0), span - 1);
  const int tenant = off < T.P ? hs_ldg(T.g0 + off) : hs_ldg(T.g1 + (off - T.P));
  cursor += 1u;
  const int next = min(max((int)cursor - T.base, 0), span - 1);
  const float at = next < T.P ? hs_ldg(T.t0 + next) : hs_ldg(T.t1 + (next - T.P));
  if constexpr (WC) {
    if (pairs) {
      int* window = T.tel_arrivals ? T.tel_arrivals + (tel_row + win_w) * T.nT + tenant : nullptr;
      pair_add(pairs, tenant, window != nullptr, window, T.arrivals + r * T.nT + tenant);
      return at > stop_after ? INFINITY : at;
    }
  }
  T.arrivals[r * T.nT + tenant] += 1;
  if constexpr (TEL) tel_count(T.tel_arrivals, a.tel, tel_row, T.nT, t, tenant);
  return at > stop_after ? INFINITY : at;
}

// A time integral (JAX _tel_overlap): [lo, hi) split over the windows it
// spans, each piece times `scale`, added to column i of replica row `row`
// of an (R, nW, width) float buffer. The windows outside [w(lo) - 1,
// w(hi) + 1] overlap by nothing, and a zero piece leaves the sum as it is.
// With the window cache, the piece in the cached window `cw` goes to its
// cell's value `*cached` instead.
__device__ __forceinline__ void tel_integral(float* buf, const HsTel& T, size_t row, int width,
                                             int i, float lo, float hi, float scale,
                                             int cw = -1, float* cached = nullptr) {
  const int first = max(tel_window(T, lo) - 1, 0);
  const int last = min(tel_window(T, hi) + 1, T.nW - 1);
  for (int w = first; w <= last; ++w) {
    const float w_lo = (float)w * T.window_s;
    const float w_hi = w == T.nW - 1 ? INFINITY : w_lo + T.window_s;
    const float overlap = fmaxf(fminf(hi, w_hi) - fmaxf(lo, w_lo), 0.0f);
    if (overlap > 0.0f) {
      if (cached && w == cw) {
        *cached = fma_f64(overlap, scale, *cached);
      } else {
        float* cell = buf + (row + w) * width + i;
        *cell = fma_f64(overlap, scale, *cell);
      }
    }
  }
}

template <typename Row>
__device__ __forceinline__ float row_min(const Row& row, int n) {
  float m = INFINITY;
  for (int c = 0; c < n; ++c) m = fminf(m, row[c]);
  return m;
}

// A lane's per-server register: an array of MAXV registers, or in the
// wide code a row in device memory.
template <int MAXV, typename T>
using HsReg = typename std::conditional<MAXV == HS_WIDE, HsRow<T>,
                                        T[MAXV == HS_WIDE ? 1 : MAXV]>::type;

// One replica's registers and its rows, staged or in device memory.
template <int MAXV>
struct Lane {
  HsReg<MAXV, int> q_head, q_len, started, completed, dropped, wait_n;
  HsReg<MAXV, float> busy, depth, wsum;
  typename std::conditional<MAXV == HS_WIDE, HsRow<const float>, HsReg<MAXV, float>>::type mean;
  HsReg<MAXV, float> smin;  // earliest completion per server
  HsReg<MAXV, float> tmin;  // earliest transit arrival per server (GRAPH)
  int sk_count;  // sink 0's accumulators; the other sinks' stay in device memory
  float sk_sum, sk_sq;
  size_t sink_row;  // MULTI: this replica's first row (r * nK) of the sink leaves
  HsRow<float> slot_done, slot_created, tr_time, tr_created;  // (nV, C) and (nV, TR)
  float *q_created, *q_enq;
  float *lim_tokens, *lim_last;
  int *hist, *rr, *lim_admitted, *lim_dropped, *tr_dropped;
  // CHAOS: this replica's rows of the chaos leaves (null where absent)
  HsRow<int> slot_attempt, tr_attempt;
  int* q_attempt;
  HsRow<const float> flt_start, flt_end;  // (nV, W)
  HsRow<const float> flt_sh_start, flt_sh_end;  // (W_sh,)
  int *timed_out, *retried, *outage_dropped, *fault_dropped, *fault_retried;
  int *hedged, *hedge_wins, *net_lost;
  // TEL: this replica's first row (r * nW) of the window buffers
  size_t tel_row;
  // The window cache (the trace branch's lean code with telemetry; see
  // the head of this file): the window cached (-1: none yet this launch);
  // the sink's count and each server's completions and drops added in it
  // since, and the cells' values of the sink's latency sum and each
  // server's busy and depth integrals; the tile's rows of counter pairs
  // (null: not planned, counted in device memory).
  int win_w;
  int win_count;
  float win_sum;
  HsReg<MAXV, int> win_completed, win_dropped;
  HsReg<MAXV, float> win_busy, win_depth;
  HsRow<uint32_t> tenant_pairs, hist_pairs;
  // RES: this replica's first row (r * nV) of the resilience leaves, and
  // its (nV, F) failure rings
  size_t res_row;
  HsRow<float> brk_ring;
  // CON: this replica's (nP, Wp) partition windows and its counters, and
  // the reachability memo (reach_scan): bit g of memo_cut, group g cut;
  // memo_alive, the quorum's reachable members; both as of the last scan,
  // and true until memo_until, the first window edge after it.
  HsRow<const float> prt_start, prt_end;
  int *net_partitioned, *qrm_dropped;
  bool memo;  // whether the memo serves this launch (else every consult scans)
  uint32_t memo_cut;
  int memo_alive;
  float memo_until;
  // PRT: this replica's outbox rows and counters, and its transit rows'
  // occupancy bounds
  float *ob_arrival, *ob_created;
  int *ob_ingress, *ob_len, *ob_sent, *ob_dropped, *tr_hi;
  int drawn;  // threefry evaluations this launch (the block keys' included)
};

// -- the window cache (WC: the trace branch's lean code with telemetry) -----

// Window w's cells into the cache: the sums' values; the counts start at 0.
template <int MAXV>
__device__ __forceinline__ void win_enter(Lane<MAXV>& L, const EventStepArgs& a, int w) {
  const HsTel& T = a.tel;
  const size_t row = L.tel_row + w, cell = row * a.nV;
  L.win_w = w;
  L.win_count = 0;
  L.win_sum = T.sink_sum ? T.sink_sum[row] : 0.0f;
#pragma unroll
  for (int v = 0; v < MAXV; ++v) {
    const bool real = v < a.nV;
    L.win_completed[v] = 0;
    L.win_dropped[v] = 0;
    L.win_busy[v] = real && T.busy_int ? T.busy_int[cell + v] : 0.0f;
    L.win_depth[v] = real && T.depth_int ? T.depth_int[cell + v] : 0.0f;
  }
}

// The cached window back to its cells in device memory; at the launch's
// end (`hist_launch`, the run's histogram row), the histogram pairs'
// launch halves too, in the same pass.
template <int MAXV>
__device__ __forceinline__ void win_flush(Lane<MAXV>& L, const EventStepArgs& a,
                                          int* hist_launch = nullptr) {
  if (L.win_w < 0) return;  // no event this launch: every pair is 0
  const HsTel& T = a.tel;
  const size_t row = L.tel_row + L.win_w, cell = row * a.nV;
  if (T.sink_count) T.sink_count[row] += L.win_count;
  if (T.sink_sum) T.sink_sum[row] = L.win_sum;
#pragma unroll
  for (int v = 0; v < MAXV; ++v) {
    if (v >= a.nV) continue;
    if (T.completed) T.completed[cell + v] += L.win_completed[v];
    if (T.dropped) T.dropped[cell + v] += L.win_dropped[v];
    if (T.busy_int) T.busy_int[cell + v] = L.win_busy[v];
    if (T.depth_int) T.depth_int[cell + v] = L.win_depth[v];
  }
  if (L.tenant_pairs && a.trc.tel_arrivals)
    pairs_flush(L.tenant_pairs, a.trc.nT, a.trc.tel_arrivals + row * a.trc.nT);
  if (L.hist_pairs)
    hist_flush(L.hist_pairs, T.sink_sum ? T.sink_hist + row * HS_HIST_BINS : nullptr, hist_launch);
}

// The launch's end: the cached window back, and the launch's halves of
// the pairs to the run's histogram and tenant arrivals.
template <int MAXV>
__device__ __forceinline__ void win_close(Lane<MAXV>& L, const EventStepArgs& a, size_t r) {
  win_flush(L, a, L.hist);
  for (int j = 0; L.tenant_pairs && j < a.trc.nT; ++j) {
    const int n = (int)(L.tenant_pairs[j] >> 16);
    if (n) a.trc.arrivals[r * a.trc.nT + j] += n;
  }
}

// _deliver_sink into sink k: only arrivals inside [warmup, horizon] are
// measured. Sink 0 adds to the lane's registers; MULTI: another sink to
// its leaves in device memory. TEL: the delivery's count, latency and bin
// in its arrival window; WC: through the window cache where that window
// is the cached one (an edge's latency may carry it to a later one), and
// the bin through the tile's pairs where the plan has them.
template <int MAXV, bool TEL = false, bool MULTI = false, bool WC = false>
__device__ __forceinline__ void deliver_sink(Lane<MAXV>& L, const EventStepArgs& a, int k,
                                             float arrival, float created) {
  if (arrival >= a.warmup && arrival <= a.horizon) {
    const float latency = arrival - created;
    if (!MULTI || k == 0) {
      L.sk_count += 1;
      L.sk_sum = L.sk_sum + latency;
      L.sk_sq = fma_f64(latency, latency, L.sk_sq);
    } else {
      const size_t i = L.sink_row + k;
      a.sink_count[i] += 1;
      a.sink_sum[i] = a.sink_sum[i] + latency;
      a.sink_sq[i] = fma_f64(latency, latency, a.sink_sq[i]);
    }
    const int bin = hist_bin(latency);
    if constexpr (WC) {
      const HsTel& T = a.tel;
      const int w = tel_window(T, arrival);
      const bool cached = w == L.win_w;
      const size_t cell = L.tel_row + w;
      if (cached) {
        L.win_count += 1;
        L.win_sum = L.win_sum + latency;
      } else {
        if (T.sink_count) T.sink_count[cell] += 1;
        if (T.sink_sum) T.sink_sum[cell] = T.sink_sum[cell] + latency;
      }
      int* window = T.sink_sum ? T.sink_hist + cell * HS_HIST_BINS + bin : nullptr;
      if (L.hist_pairs) {
        pair_add(L.hist_pairs, bin, cached && window, window, L.hist + bin);
        if (window && !cached) *window += 1;
      } else {
        L.hist[bin] += 1;
        if (window) *window += 1;
      }
      return;
    }
    (MULTI ? L.hist + k * HS_HIST_BINS : L.hist)[bin] += 1;
    if constexpr (TEL) {
      const HsTel& T = a.tel;
      if (!T.sink_count && !T.sink_sum) return;
      size_t cell = L.tel_row + tel_window(T, arrival);
      if constexpr (MULTI) cell = cell * a.nK + k;
      if (T.sink_count) T.sink_count[cell] += 1;
      if (T.sink_sum) {
        T.sink_sum[cell] = T.sink_sum[cell] + latency;
        T.sink_hist[cell * HS_HIST_BINS + bin] += 1;
      }
    }
  }
}

// _arrive_server: start in the first free slot, else enqueue at the ring
// tail, else drop. WC: the window of t is the cached one.
template <int MAXV, bool EXT, bool TEL = false, bool WC = false>
__device__ __forceinline__ void arrive_server(Lane<MAXV>& L, const EventStepArgs& a, int w,
                                              float t, float created, const HsDraw& u) {
  const int C = a.C, K = a.K;
  const int cw = HS_SRV(conc, w);
  const HsRow<float> row = L.slot_done + w * C;
  int first_free = -1;
  for (int c = 0; c < cw; ++c)
    if (isinf(row[c])) { first_free = c; break; }
  if (first_free >= 0) {
    const HsSvc s = service_terms<MAXV, EXT>(a, w, pick(L.mean, w), u + a.u_svc1);
    const float service = s.x * s.y;
    const float done_at = fma_f64(s.x, s.y, t);
    row[first_free] = done_at;
    L.slot_created[w * C + first_free] = created;
    put(L.started, w, pick(L.started, w) + 1);
    if (t >= a.warmup) {
      put(L.wait_n, w, pick(L.wait_n, w) + 1);
      put(L.busy, w, pick(L.busy, w) + service);
      if constexpr (WC) {
        if (a.tel.busy_int) {
          float busy = pick(L.win_busy, w);
          tel_integral(a.tel.busy_int, a.tel, L.tel_row, a.nV, w, t, done_at, 1.0f, L.win_w, &busy);
          put(L.win_busy, w, busy);
        }
      } else if constexpr (TEL) {
        if (a.tel.busy_int) tel_integral(a.tel.busy_int, a.tel, L.tel_row, a.nV, w, t, done_at, 1.0f);
      }
    }
    put(L.smin, w, fminf(pick(L.smin, w), done_at));
  } else {
    const int ql = pick(L.q_len, w);
    if (ql < HS_SRV(qcap, w)) {
      const int tail = (pick(L.q_head, w) + ql) % K;
      L.q_created[w * K + tail] = created;
      L.q_enq[w * K + tail] = t;
      put(L.q_len, w, ql + 1);
    } else {
      put(L.dropped, w, pick(L.dropped, w) + 1);
      if constexpr (WC) {
        put(L.win_dropped, w, pick(L.win_dropped, w) + 1);
      } else if constexpr (TEL) {
        tel_count(a.tel.dropped, a.tel, L.tel_row, a.nV, t, w);
      }
    }
  }
}

// t plus the edge's latency draw (_sample_edge): nothing for a free
// edge, the mean for a constant one, -log(u) * mean for an exponential,
// added as one multiply-add except on an edge out of a router, where JAX
// selects among the targets' draws before the add (`routed`).
__device__ __forceinline__ float edge_arrival(const HsRef& e, float t, const HsDraw& u,
                                              int u_lat, bool routed) {
  if (e.lat_kind == HS_LAT_NONE) return t;
  if (e.lat_kind != HS_LAT_EXPONENTIAL) return t + e.lat_mean;
  const float draw = -logf(u[u_lat]);
  return routed ? t + draw * e.lat_mean : fma_f64(draw, e.lat_mean, t);
}

// How far server w's transit row is scanned: PRT, its occupancy bound
// (every slot from it on is free); else the whole row.
template <int MAXV, bool PRT>
__device__ __forceinline__ int transit_hi(const Lane<MAXV>& L, const EventStepArgs& a, int w) {
  if constexpr (PRT) {
    return L.tr_hi[w];
  } else {
    return a.TR;
  }
}

// _into_transit: park in the first free transit slot of server w until
// `arrival`; with none free the job is lost and tr_dropped counts it.
// A backoff retry parks here too, with its attempt number (CHAOS).
// PRT: the first free slot below the row's occupancy bound, else the
// bound's own slot, which raises it (JAX's first free slot either way).
template <int MAXV, bool CHAOS = false, bool TEL = false, bool PRT = false>
__device__ __forceinline__ void into_transit(Lane<MAXV>& L, const EventStepArgs& a, int w,
                                             float arrival, float created, int attempt = 0) {
  const HsRow<float> row = L.tr_time + w * a.TR;
  const int hi = transit_hi<MAXV, PRT>(L, a, w);
  auto park = [&](int c) {
    row[c] = arrival;
    L.tr_created[w * a.TR + c] = created;
    if constexpr (CHAOS) {
      if (L.tr_attempt) L.tr_attempt[w * a.TR + c] = attempt;
    }
    put(L.tmin, w, fminf(pick(L.tmin, w), arrival));
  };
  for (int c = 0; c < hi; ++c) {
    if (isinf(row[c])) {
      park(c);
      return;
    }
  }
  if constexpr (PRT) {
    if (hi < a.TR) {
      park(hi);
      if (!isinf(arrival)) L.tr_hi[w] = hi + 1;
      return;
    }
  }
  L.tr_dropped[w] += 1;
  // TEL: in the window of the would-be arrival, as JAX books it.
  if constexpr (TEL) tel_count(a.tel.tr_dropped, a.tel, L.tel_row, a.nV, arrival, w);
}

// Whether server w has a free transit register (the retry counters'
// gate: a retry that finds none is a tr_dropped, not a retry).
template <int MAXV, bool PRT = false>
__device__ __forceinline__ bool transit_free(const Lane<MAXV>& L, const EventStepArgs& a, int w) {
  const HsRow<float> row = L.tr_time + w * a.TR;
  const int hi = transit_hi<MAXV, PRT>(L, a, w);
  if constexpr (PRT) {
    if (hi < a.TR) return true;
  }
  for (int c = 0; c < hi; ++c)
    if (isinf(row[c])) return true;
  return false;
}

// PRT: _into_outbox, a job for the neighbour partition through remote rm:
// the outbox's next slot, arriving t + the remote's latency at its
// ingress (the lean code's HsPrt tables, or the wide code's); a full
// outbox drops it.
template <int MAXV>
__device__ __forceinline__ void into_outbox(Lane<MAXV>& L, const EventStepArgs& a, int rm,
                                            float t, float created) {
  const int slot = *L.ob_len;
  if (slot < a.prt.OB) {
    L.ob_arrival[slot] = t + HS_ARR(a.prt.rm_latency, rm_latency, rm);
    L.ob_created[slot] = created;
    L.ob_ingress[slot] = HS_ARR(a.prt.rm_ingress, rm_ingress, rm);
    *L.ob_len = slot + 1;
    *L.ob_sent += 1;
  } else {
    *L.ob_dropped += 1;
  }
}

// FaultTable.dark: is server w inside one of its fault windows (or, if
// it subscribes, a fired shared window) at t?
template <int MAXV>
__device__ __forceinline__ bool fault_dark(const Lane<MAXV>& L, const EventStepArgs& a, int w,
                                           float t) {
  bool dark = false;
  const HsRow<const float> start = L.flt_start + w * a.W;
  const HsRow<const float> end = L.flt_end + w * a.W;
  for (int i = 0; i < a.W; ++i) dark |= (t >= start[i]) & (t < end[i]);
  if (L.flt_sh_start && (HS_SRV(srv_flags, w) & HS_F_SHARED)) {
    for (int i = 0; i < a.W_sh; ++i)
      dark |= (t >= L.flt_sh_start[i]) & (t < L.flt_sh_end[i]);
  }
  return dark;
}

// Active slots of server w (the degrade-mode capacity cap counts these).
template <typename Row>
__device__ __forceinline__ int active_slots(const Row& row, int cw) {
  int n = 0;
  for (int c = 0; c < cw; ++c) n += isfinite(row[c]) ? 1 : 0;
  return n;
}

// When a retry launched at t re-arrives: t + backoff * 2^attempt * (1 +
// jitter * (u - 0.5)), with the spread and the final sum each one
// multiply-add, as XLA's CPU backend contracts them in the JAX step.
template <int MAXV>
__device__ __forceinline__ float backoff_arrival(const EventStepArgs& a, int w, int attempt,
                                                 const HsDraw& u, float t) {
  const float uj = a.u_jit >= 0 ? u[a.u_jit] : 0.5f;
  const float spread = fma_f64(HS_SRV(jitter, w), uj - 0.5f, 1.0f);
  return fma_f64(HS_SRV(backoff, w) * exp2f((float)attempt), spread, t);
}

// A hedge with delay h and a second draw of terms s2: the slot is held for
// min(S1, h + S2), h + S2 one multiply-add as XLA contracts it; the second
// attempt launches when S1 > h and wins when h + S2 < S1.
__device__ __forceinline__ float hedge_race(float service, HsSvc s2, float h, bool& hedged,
                                            bool& won) {
  hedged = service > h;
  const float raced = fma_f64(s2.x, s2.y, h);
  won = hedged && raced < service;
  return hedged ? fminf(service, raced) : service;
}

// -- resilience (RES) -------------------------------------------------------
// JAX's _breaker_* and _budget_* helpers for server w of one replica.

// _breaker_effective: an open breaker whose cooldown has run out reads
// (and is written back) as half-open with a fresh probe quota.
template <int MAXV>
__device__ __forceinline__ int breaker_effective(const Lane<MAXV>& L, const EventStepArgs& a,
                                                 int w, float t) {
  const HsRes& B = a.res;
  const size_t i = L.res_row + w;
  const int bst = B.brk_state[i];
  if (bst == 1 && t >= B.brk_open_t[i] + B.brk_cooldown) {
    B.brk_state[i] = 2;
    B.brk_probes[i] = 0;
    return 2;
  }
  return bst;
}

// _breaker_record_failure: one failure at t in effective state bst. A
// closed breaker writes t at the ring's cursor and trips when the oldest
// of the F most recent failures (the next slot) lies within the window;
// a half-open one re-trips at once. A trip resets the ring and books the
// whole open interval.
template <int MAXV, bool TEL>
__device__ __forceinline__ void breaker_failure(Lane<MAXV>& L, const EventStepArgs& a, int w,
                                                float t, int bst) {
  const HsRes& B = a.res;
  const size_t i = L.res_row + w;
  const HsRow<float> ring = L.brk_ring + w * B.F;
  bool trip = bst == 2;
  if (bst == 0) {
    const int idx = B.brk_fail_idx[i];
    const int cursor = (idx + 1) % B.F;
    ring[idx] = t;
    B.brk_fail_idx[i] = cursor;
    trip = ring[cursor] > t - B.brk_window;
  }
  if (!trip) return;
  const float open_len = fminf(B.brk_cooldown, fmaxf(a.horizon - t, 0.0f));
  for (int f = 0; f < B.F; ++f) ring[f] = -INFINITY;
  B.brk_fail_idx[i] = 0;
  B.brk_state[i] = 1;
  B.brk_open_t[i] = t;
  B.brk_probes[i] = 0;
  B.brk_tripped[i] += 1;
  B.brk_open_time[i] = B.brk_open_time[i] + open_len;
  if constexpr (TEL) {
    tel_count(B.tel_brk_tripped, a.tel, L.tel_row, a.nV, t, w);
    if (B.tel_brk_open_int)
      tel_integral(B.tel_brk_open_int, a.tel, L.tel_row, a.nV, w, t, t + open_len, 1.0f);
  }
}

// _breaker_close_on_success: a half-open breaker that admitted a probe
// closes (ring, cursor and probes reset).
template <int MAXV>
__device__ __forceinline__ void breaker_success(const Lane<MAXV>& L, const EventStepArgs& a, int w,
                                                int bst) {
  const HsRes& B = a.res;
  const size_t i = L.res_row + w;
  if (bst != 2 || B.brk_probes[i] <= 0) return;
  const HsRow<float> ring = L.brk_ring + w * B.F;
  for (int f = 0; f < B.F; ++f) ring[f] = -INFINITY;
  B.brk_state[i] = 0;
  B.brk_fail_idx[i] = 0;
  B.brk_probes[i] = 0;
}

// _budget_refresh: min(tokens + (t - last) * min_per_s + credit, burst),
// the first multiply-add rounded once as XLA contracts it.
template <int MAXV>
__device__ __forceinline__ float budget_refresh(const Lane<MAXV>& L, const EventStepArgs& a, int w,
                                                float t, float credit) {
  const HsRes& B = a.res;
  const size_t i = L.res_row + w;
  const float tokens =
      fminf(fma_f64(t - B.bud_last[i], B.bud_min_per_s, B.bud_tokens[i]) + credit, B.bud_burst);
  B.bud_tokens[i] = tokens;
  B.bud_last[i] = t;
  return tokens;
}

// _budget_debit: one token per launch that really happens.
template <int MAXV>
__device__ __forceinline__ void budget_debit(const Lane<MAXV>& L, const EventStepArgs& a, int w) {
  float* tokens = a.res.bud_tokens + L.res_row + w;
  *tokens = *tokens - 1.0f;
}

// _book_budget_dropped: a launch the budget suppressed.
template <int MAXV, bool TEL>
__device__ __forceinline__ void budget_dropped(const Lane<MAXV>& L, const EventStepArgs& a, int w,
                                               float t) {
  a.res.budget_dropped[L.res_row + w] += 1;
  if constexpr (TEL) tel_count(a.res.tel_budget_dropped, a.tel, L.tel_row, a.nV, t, w);
}

// -- consensus (CON) ---------------------------------------------------------

// Whether server w is in partition group g.
template <int MAXV>
__device__ __forceinline__ bool in_group(const EventStepArgs& a, int g, int w) {
  if constexpr (MAXV == HS_WIDE) {
    return hs_ldg(a.wide.prt_member + (size_t)g * a.nV + w) != 0;
  } else {
    return (a.con.prt_member[g] >> w) & 1;
  }
}

// The reachability memo's scan at t: which groups are cut, how many quorum
// members are reachable (one inside a drop-mode fault window, its own or
// a subscribed shared one, or in a cut group is not), and the first start
// or end of any window read that lies after t, until which both answers
// hold (see the head of this file).
template <int MAXV>
__device__ __forceinline__ void reach_scan(Lane<MAXV>& L, const EventStepArgs& a, float t) {
  const HsCon& P = a.con;
  float until = INFINITY;
  // Whether t lies in [s, e), noting the window's edges after t.
  auto inside = [&](float s, float e) {
    if (s > t) until = fminf(until, s);
    if (e > t) until = fminf(until, e);
    return (t >= s) & (t < e);
  };
  uint32_t cut = 0;
  const int nP = L.prt_start ? P.nP : 0;  // a quorum without partition groups has no windows
  for (int g = 0; g < nP; ++g) {
    const HsRow<const float> start = L.prt_start + g * P.Wp;
    const HsRow<const float> end = L.prt_end + g * P.Wp;
    bool c = false;
    for (int i = 0; i < P.Wp; ++i) c |= inside(start[i], end[i]);
    cut |= (uint32_t)c << g;
  }
  L.memo_cut = cut;
  if (P.quorum) {
    int alive = P.qrm_n;
    for (int m = 0; m < a.nV; ++m) {
      if (!hs_bit<MAXV>(P.qrm_member, a.wide.qrm_member, m)) continue;
      const int flags = HS_SRV(srv_flags, m);
      bool gone = false;
      if ((flags & HS_F_FAULTED) && (flags & HS_F_DROP)) {
        const HsRow<const float> start = L.flt_start + m * a.W;
        const HsRow<const float> end = L.flt_end + m * a.W;
        for (int i = 0; i < a.W; ++i) gone |= inside(start[i], end[i]);
        if (L.flt_sh_start && (flags & HS_F_SHARED)) {
          for (int i = 0; i < a.W_sh; ++i) gone |= inside(L.flt_sh_start[i], L.flt_sh_end[i]);
        }
      }
      if (!gone && hs_bit<MAXV>(P.touched, a.wide.touched, m)) {
        for (int g = 0; g < P.nP; ++g) gone |= ((cut >> g) & 1) && in_group<MAXV>(a, g, m);
      }
      alive -= gone ? 1 : 0;
    }
    L.memo_alive = alive;
  }
  L.memo_until = until;
}

// PartitionTable.consult for server w at t, the lane's clock: whether a
// group holding it is cut (returned), whether one of the cut groups is
// drop-mode, and the largest delay of the cut ones. A group's cut state
// comes from the memo, which the step scans again at the event where the
// clock reaches its next edge (where the memo does not serve, from the
// group's windows at every consult).
template <int MAXV>
__device__ __forceinline__ bool partition_consult(const Lane<MAXV>& L, const EventStepArgs& a,
                                                  int w, float t, bool& drop, float& delay) {
  const HsCon& P = a.con;
  const bool memo = L.memo;
  bool dark = false;
  drop = false;
  delay = 0.0f;
  for (int g = 0; g < P.nP; ++g) {
    if (!in_group<MAXV>(a, g, w)) continue;
    bool cut = false;
    if (memo) {
      cut = (L.memo_cut >> g) & 1;
    } else {
      const HsRow<const float> start = L.prt_start + g * P.Wp;
      const HsRow<const float> end = L.prt_end + g * P.Wp;
      for (int i = 0; i < P.Wp; ++i) cut |= (t >= start[i]) & (t < end[i]);
    }
    if (!cut) continue;
    dark = true;
    if (HS_ARR(P.prt_drop, prt_drop, g)) {
      drop = true;
    } else {
      delay = fmaxf(delay, HS_ARR(P.prt_delay, prt_delay, g));
    }
  }
  return dark;
}

// Quorum members reachable at t, the lane's clock: from the memo (where
// it does not serve, counted member by member).
template <int MAXV>
__device__ __forceinline__ int quorum_alive(const Lane<MAXV>& L, const EventStepArgs& a, float t) {
  const HsCon& Q = a.con;
  if (L.memo) return L.memo_alive;
  int alive = Q.qrm_n;
  for (int m = 0; m < a.nV; ++m) {
    if (!hs_bit<MAXV>(Q.qrm_member, a.wide.qrm_member, m)) continue;
    const int flags = HS_SRV(srv_flags, m);
    bool gone = (flags & HS_F_FAULTED) && (flags & HS_F_DROP) && fault_dark(L, a, m, t);
    if (!gone && hs_bit<MAXV>(Q.touched, a.wide.touched, m)) {
      bool drop;
      float delay;
      gone = partition_consult(L, a, m, t, drop, delay);
    }
    alive -= gone ? 1 : 0;
  }
  return alive;
}

// A rejected arrival's retry (a fault window's or the quorum's): parked
// in server w's transit registers until its backoff ends. It counts as a
// fault retry, and spends a budget token, only where a register takes it.
template <int MAXV, bool TEL, bool RES, bool PRT = false>
__device__ __forceinline__ void retry_park(Lane<MAXV>& L, const EventStepArgs& a, int w, float t,
                                           float created, int attempt, const HsDraw& u) {
  if (transit_free<MAXV, PRT>(L, a, w)) {
    L.fault_retried[w] += 1;
    if constexpr (TEL) tel_count(a.tel.fault_retried, a.tel, L.tel_row, a.nV, t, w);
    if constexpr (RES) {
      if (a.res.budget) budget_debit(L, a, w);
    }
  }
  into_transit<MAXV, true, TEL, PRT>(L, a, w, backoff_arrival<MAXV>(a, w, attempt, u, t), created,
                                     attempt + 1);
}

// _arrive_server with the chaos gates: a brownout window loses the
// arrival; an outage-mode fault window rejects it (parked for a retry
// after the backoff while its budget lasts, else a fault drop); a
// degrade-mode window caps the active slots and inflates service; a
// hedged server races a second sample.
//
// RES adds the defenses at their sites. The breaker is consulted first:
// open, or half-open with its probes spent, it rejects the arrival before
// the server sees it. A first attempt credits the budget. Brownout and
// fault rejections are the breaker's failures; a fault retry without a
// budget token is a fault drop and a budget drop. The shed gate sees only
// what those let through. A half-open probe is spent only by an arrival
// that takes a slot or a queue place; a hedge needs a token.
//
// CON adds the quorum gate after the fault window's: an arrival at a
// member while fewer than `write` members are reachable is rejected
// (every rejection counted in qrm_dropped), a failure of the breaker's,
// and retried after a backoff as a fault rejection is.
template <int MAXV, bool TEL = false, bool RES = false, bool CON = false, bool PRT = false>
__device__ __forceinline__ void arrive_server_chaos(Lane<MAXV>& L, const EventStepArgs& a, int w,
                                                    float t, float created, int attempt,
                                                    const HsDraw& u) {
  const int C = a.C, K = a.K;
  int bst = 0;          // RES: the breaker's effective state
  bool probe = false;   // RES: a half-open breaker's probe, spent if admitted
  bool bud_ok = true;   // RES: a budget token for a retry or a hedge
  if constexpr (RES) {
    const HsRes& B = a.res;
    bool shorted = false;
    if (B.breaker) {
      bst = breaker_effective(L, a, w, t);
      const bool probe_ok = B.brk_probes[L.res_row + w] < B.brk_max_probes;
      shorted = bst == 1 || (bst == 2 && !probe_ok);
      probe = bst == 2 && probe_ok;
    }
    if (B.budget) bud_ok = budget_refresh(L, a, w, t, attempt == 0 ? B.bud_ratio : 0.0f) >= 1.0f;
    if (shorted) {
      B.breaker_dropped[L.res_row + w] += 1;
      if constexpr (TEL) tel_count(B.tel_breaker_dropped, a.tel, L.tel_row, a.nV, t, w);
      return;
    }
  }
  const int cw = HS_SRV(conc, w);
  const int flags = HS_SRV(srv_flags, w);
  const HsRow<float> row = L.slot_done + w * C;
  const bool fdark = (flags & HS_F_FAULTED) && fault_dark(L, a, w, t);
  const bool degraded = fdark && !(flags & HS_F_DROP);
  const bool dark = (flags & HS_F_OUTAGE) && t >= HS_SRV(outage_start, w) &&
                    t < HS_SRV(outage_end, w);
  if (dark) {  // a brownout loss, disjoint from the fault ledger
    L.outage_dropped[w] += 1;
    if constexpr (TEL) tel_count(a.tel.outage_dropped, a.tel, L.tel_row, a.nV, t, w);
    if constexpr (RES) {
      if (a.res.breaker) breaker_failure<MAXV, TEL>(L, a, w, t, bst);
    }
    return;
  }
  if (fdark && (flags & HS_F_DROP)) {
    if constexpr (RES) {
      if (a.res.breaker) breaker_failure<MAXV, TEL>(L, a, w, t, bst);
    }
    const bool would = (flags & HS_F_FAULT_RETRY) && attempt < HS_SRV(max_retries, w);
    if (would && bud_ok) {
      retry_park<MAXV, TEL, RES, PRT>(L, a, w, t, created, attempt, u);
    } else {
      L.fault_dropped[w] += 1;
      if constexpr (TEL) tel_count(a.tel.fault_dropped, a.tel, L.tel_row, a.nV, t, w);
      if constexpr (RES) {
        if (would) budget_dropped<MAXV, TEL>(L, a, w, t);
      }
    }
    return;
  }
  if constexpr (CON) {
    const HsCon& Q = a.con;
    if (Q.quorum && hs_bit<MAXV>(Q.qrm_member, a.wide.qrm_member, w) &&
        quorum_alive(L, a, t) < Q.qrm_write) {
      if constexpr (RES) {
        if (a.res.breaker) breaker_failure<MAXV, TEL>(L, a, w, t, bst);
      }
      L.qrm_dropped[w] += 1;
      if constexpr (TEL) tel_count(Q.tel_qrm_dropped, a.tel, L.tel_row, a.nV, t, w);
      const bool would =
          hs_bit<MAXV>(Q.qrm_retry, a.wide.qrm_retry, w) && attempt < HS_SRV(max_retries, w);
      if (would && bud_ok) {
        retry_park<MAXV, TEL, RES, PRT>(L, a, w, t, created, attempt, u);
      } else if constexpr (RES) {
        if (would) budget_dropped<MAXV, TEL>(L, a, w, t);
      }
      return;
    }
  }
  if constexpr (RES) {
    const HsRes& B = a.res;
    if (B.shed) {
      bool shed = B.shed_policy == 0
                      ? pick(L.q_len, w) >= B.shed_depth
                      : (float)active_slots(row, cw) >= hs_tab<MAXV>(B.shed_busy_thr, a.wide.shed_busy_thr, w);
      if (shed && B.u_shed >= 0) shed = u[B.u_shed] >= B.shed_priority;  // priority is exempt
      if (shed) {
        B.shed_dropped[L.res_row + w] += 1;
        if constexpr (TEL) tel_count(B.tel_shed_dropped, a.tel, L.tel_row, a.nV, t, w);
        return;
      }
    }
  }
  int first_free = -1;
  const int cap = HS_SRV(cap_slots, w);
  if (!(degraded && cap < cw && active_slots(row, cw) >= cap)) {
    for (int c = 0; c < cw; ++c)
      if (isinf(row[c])) { first_free = c; break; }
  }
  if (first_free >= 0) {
    if constexpr (RES) {
      if (probe) a.res.brk_probes[L.res_row + w] += 1;
    }
    const float mean = pick(L.mean, w);
    const float factor = HS_SRV(lat_factor, w);
    const bool inflate = degraded && factor > 1.0f;
    // JAX multiplies every arrival's service by its factor (1 unless
    // inflated) once some server's degrade windows inflate.
    HsSvc s = service_terms<MAXV, true>(a, w, mean, u + a.u_svc1);
    if (a.degrade_lat) s = HsSvc{s.x * s.y, inflate ? factor : 1.0f};
    if (flags & HS_F_HEDGE) {
      const float h = HS_SRV(hedge, w);
      float service = s.x * s.y;
      if (bud_ok) {
        HsSvc second = service_terms<MAXV, true>(a, w, mean, u + a.u_hed1);
        if (a.degrade_lat) second = HsSvc{second.x * second.y, inflate ? factor : 1.0f};
        bool hedged, won;
        service = hedge_race(service, second, h, hedged, won);
        L.hedged[w] += hedged ? 1 : 0;
        L.hedge_wins[w] += won ? 1 : 0;
        if constexpr (RES) {
          if (hedged && a.res.budget) budget_debit(L, a, w);
        }
        if constexpr (TEL) {
          if (hedged) tel_count(a.tel.hedged, a.tel, L.tel_row, a.nV, t, w);
          if (won) tel_count(a.tel.hedge_wins, a.tel, L.tel_row, a.nV, t, w);
        }
      } else if constexpr (RES) {
        if (service > h) budget_dropped<MAXV, TEL>(L, a, w, t);
      }
      s = HsSvc{service, 1.0f};
    } else if (a.hedge_any) {
      s = HsSvc{s.x * s.y, 1.0f};
    }
    const float service = s.x * s.y;
    const float done_at = fma_f64(s.x, s.y, t);
    row[first_free] = done_at;
    L.slot_created[w * C + first_free] = created;
    if (L.slot_attempt) L.slot_attempt[w * C + first_free] = attempt;
    put(L.started, w, pick(L.started, w) + 1);
    if (t >= a.warmup) {
      put(L.wait_n, w, pick(L.wait_n, w) + 1);
      put(L.busy, w, pick(L.busy, w) + service);
      if constexpr (TEL) {
        if (a.tel.busy_int) tel_integral(a.tel.busy_int, a.tel, L.tel_row, a.nV, w, t, done_at, 1.0f);
      }
    }
    put(L.smin, w, fminf(pick(L.smin, w), done_at));
  } else {
    const int ql = pick(L.q_len, w);
    if (ql < HS_SRV(qcap, w)) {
      if constexpr (RES) {
        if (probe) a.res.brk_probes[L.res_row + w] += 1;
      }
      const int tail = (pick(L.q_head, w) + ql) % K;
      L.q_created[w * K + tail] = created;
      L.q_enq[w * K + tail] = t;
      if (L.q_attempt) L.q_attempt[w * K + tail] = attempt;
      put(L.q_len, w, ql + 1);
    } else {
      put(L.dropped, w, pick(L.dropped, w) + 1);
      if constexpr (TEL) tel_count(a.tel.dropped, a.tel, L.tel_row, a.nV, t, w);
    }
  }
}

// _route_choice for router `rix` at hop depth `hop`, then _bump_rr.
template <int MAXV>
__device__ __forceinline__ int route_choice(Lane<MAXV>& L, const EventStepArgs& a, int rix,
                                            int hop, const HsDraw& u) {
  const int n = HS_ARR(a.rt_n, rt_n, rix);
  const int policy = HS_ARR(a.rt_policy, rt_policy, rix);
  if (policy == HS_ROUND_ROBIN) {
    const int next = L.rr[rix];
    L.rr[rix] = next + 1;
    return next % n;
  }
  if (policy == HS_LEAST_OUTSTANDING) {
    // In-service plus queued per target, read after a completing slot
    // was freed; a strict < keeps the first index (argmin).
    int choice = 0, best = 0;
    for (int i = 0; i < n; ++i) {
      const int w = HS_RT(rt_target, rix, i).index;
      const HsRow<float> row = L.slot_done + w * a.C;
      int outstanding = pick(L.q_len, w);
      const int cw = HS_SRV(conc, w);
      for (int c = 0; c < cw; ++c) outstanding += isfinite(row[c]) ? 1 : 0;
      if (i == 0 || outstanding < best) { best = outstanding; choice = i; }
    }
    return choice;
  }
  const float ur = u[HS_ARR(a.u_route, u_route, min(hop, a.n_route_slots - 1))];
  if (policy == HS_RANDOM) return min((int)(ur * (float)n), n - 1);
  int count = 0;  // weighted: thresholds at or below the draw
  for (int i = 0; i < n; ++i) count += ur >= HS_RT(rt_cum, rix, i) ? 1 : 0;
  return min(count, n - 1);
}

// _deliver: hand a job leaving a node at t across the edge in `dest`.
// On a line the edge is free and leads to a server or the sink. In a
// graph it is a bounded walk: a limiter refills and admits or drops; a
// router chooses and recurses into a router target with hop + 1; the
// walk ends at a sink, a transit park, or a server arrival.
//
// CHAOS: `loss` is the edge into `dest` and follows the walk (a limiter's
// downstream edge, a router's chosen target edge); a lossy crossing is
// decided where the walk ends (edges into limiters and routers are
// loss-free), after any limiter and round-robin update, and vanishes the
// job with only net_lost counting it. `attempt` rides to the server.
// RES: the server arrival runs the defenses.
// CON: a delivery into a server of a partition group, sent at t, consults
// the groups after the loss (JAX's _partition_select): under a drop-mode
// cut it vanishes with only net_partitioned counting it, under a
// delay-mode cut it parks in the server's transit registers until its
// arrival plus the delay. A transit arrival (`consult` false) crossed
// before any cut and does not consult.
// PRT: a remote egress node (reached straight, or as a random router's
// choice among sinks and remotes) queues the job in the outbox.
// WC: the sink and the server book through the window cache.
template <int MAXV, bool GRAPH, bool EXT, bool CHAOS = false, bool TEL = false, bool RES = false,
          bool CON = false, bool MULTI = false, bool PRT = false, bool WC = false>
__device__ __forceinline__ void deliver(Lane<MAXV>& L, const EventStepArgs& a, HsRef dest,
                                        float t, float created, const HsDraw& u,
                                        HsLoss loss = HsLoss{0.0f, 0.0f, 0.0f},
                                        int attempt = 0, bool consult = true) {
  if constexpr (!GRAPH) {
    if (dest.kind == HS_SINK) {
      deliver_sink<MAXV, TEL, MULTI, WC>(L, a, dest.index, t, created);
    } else {
      arrive_server<MAXV, EXT, TEL, WC>(L, a, dest.index, t, created, u);
    }
  } else {
    bool park = false;    // chosen by a router with a latency-carrying target edge
    bool routed = false;  // the edge into dest is a router's
    int hop = 0;
    for (int step = 0; step < a.max_walk; ++step) {
      if (dest.kind == HS_LIMITER) {
        const int l = dest.index;
        const float refilled =
            fminf(fma_f64(t - L.lim_last[l], HS_ARR(a.lim_rate, lim_rate, l), L.lim_tokens[l]),
                  HS_ARR(a.lim_cap, lim_cap, l));
        const bool admit = refilled >= 1.0f;
        L.lim_tokens[l] = admit ? refilled - 1.0f : refilled;
        L.lim_last[l] = t;
        if (!admit) {  // dropped: only the limiter's own registers change
          L.lim_dropped[l] += 1;
          if constexpr (TEL) tel_count(a.tel.lim_dropped, a.tel, L.tel_row, a.nL, t, l);
          return;
        }
        L.lim_admitted[l] += 1;
        if constexpr (TEL) tel_count(a.tel.lim_admitted, a.tel, L.tel_row, a.nL, t, l);
        dest = HS_ARR(a.lim_ref, lim_ref, l);
        routed = false;
        if constexpr (CHAOS) loss = HS_ARR(a.lim_loss, lim_loss, l);
        continue;
      }
      if (dest.kind == HS_ROUTER) {
        const int rix = dest.index;
        const int choice = route_choice(L, a, rix, hop, u);
        dest = HS_RT(rt_target, rix, choice);
        routed = true;
        if constexpr (CHAOS) loss = HS_RT(rt_loss, rix, choice);
        if (dest.kind == HS_ROUTER) {
          hop += 1;
          continue;
        }
        park = HS_ARR(a.rt_park, rt_park, rix) != 0;
      }
      if constexpr (CHAOS) {
        if (loss.p > 0.0f && u[a.u_loss] < loss.p && t >= loss.start && t < loss.end) {
          *L.net_lost += 1;
          if constexpr (TEL) tel_count(a.tel.net_lost, a.tel, L.tel_row, 1, t, 0);
          return;
        }
      }
      if constexpr (PRT) {
        if (dest.kind == HS_REMOTE) {
          into_outbox(L, a, dest.index, t, created);
          return;
        }
      }
      if (dest.kind == HS_SINK) {
        deliver_sink<MAXV, TEL, MULTI, WC>(L, a, dest.index, edge_arrival(dest, t, u, a.u_lat, routed),
                                       created);
        return;
      }
      const bool crossing = park || dest.lat_kind != HS_LAT_NONE;
      if constexpr (CON) {
        bool drop;
        float delay;
        if (consult && hs_bit<MAXV>(a.con.touched, a.wide.touched, dest.index) &&
            partition_consult(L, a, dest.index, t, drop, delay)) {
          if (drop) {
            *L.net_partitioned += 1;
            if constexpr (TEL) tel_count(a.con.tel_net_partitioned, a.tel, L.tel_row, 1, t, 0);
          } else {
            const float arrival = crossing ? edge_arrival(dest, t, u, a.u_lat, routed) : t;
            into_transit<MAXV, CHAOS, TEL, PRT>(L, a, dest.index, arrival + delay, created);
          }
          return;
        }
      }
      if (crossing) {
        into_transit<MAXV, CHAOS, TEL, PRT>(L, a, dest.index,
                                            edge_arrival(dest, t, u, a.u_lat, routed), created);
      } else if constexpr (CHAOS) {
        arrive_server_chaos<MAXV, TEL, RES, CON, PRT>(L, a, dest.index, t, created, attempt, u);
      } else {
        arrive_server<MAXV, EXT, TEL, WC>(L, a, dest.index, t, created, u);
      }
      return;
    }
  }
}

// The earliest of a replica's nS next arrivals and the lowest source index
// holding it (the sources come first in next_candidates, and its argmin
// takes the lowest index on a tie).
__device__ __forceinline__ float earliest_source(const float* next, int nS, int& index) {
  float tn = next[0];
  index = 0;
  for (int s = 1; s < nS; ++s) {
    if (next[s] < tn) {
      tn = next[s];
      index = s;
    }
  }
  return tn;
}

// The same over the sources' register array (MULTI: HS_MAX_SOURCES
// entries, +inf past the model's nS).
template <int N>
__device__ __forceinline__ float earliest_source(const float (&next)[N], int& index) {
  float tn = next[0];
  index = 0;
#pragma unroll
  for (int s = 1; s < N; ++s) {
    if (next[s] < tn) {
      tn = next[s];
      index = s;
    }
  }
  return tn;
}

// The wide code's search over n servers' earliest times in `row` (its
// lane's smin or tmin), candidates base + v after those already in (tn,
// ev): HS_WIDE_CHUNK times loaded at once, then compared in order with a
// strict <, so the first index wins a tie.
__device__ __forceinline__ void wide_earliest(const HsRow<float>& row, int n, int base, float& tn,
                                              int& ev) {
  for (int v0 = 0; v0 < n; v0 += HS_WIDE_CHUNK) {
    float x[HS_WIDE_CHUNK];
#pragma unroll
    for (int j = 0; j < HS_WIDE_CHUNK; ++j) x[j] = v0 + j < n ? row[v0 + j] : INFINITY;
#pragma unroll
    for (int j = 0; j < HS_WIDE_CHUNK; ++j)
      if (x[j] < tn) { tn = x[j]; ev = base + v0 + j; }
  }
}

// The lane's next event time: the earliest of the sources' next arrivals,
// the servers' completions and (GRAPH) their transit arrivals (the wide
// code: of its nV servers, and their transit arrivals where it has any).
template <int MAXV, bool GRAPH>
__device__ __forceinline__ float next_event_time(const Lane<MAXV>& L, float src_next, int nV,
                                                 bool transit) {
  float tn = src_next;
  if constexpr (MAXV == HS_WIDE) {
    for (int v = 0; v < nV; ++v) tn = fminf(tn, L.smin[v]);
    if (transit)
      for (int v = 0; v < nV; ++v) tn = fminf(tn, L.tmin[v]);
  } else {
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      tn = fminf(tn, L.smin[v]);
      if constexpr (GRAPH) tn = fminf(tn, L.tmin[v]);
    }
  }
  return tn;
}

// Registers decide how many blocks an SM holds, so whether a launch over
// 65,536 replicas is one wave: at most 128 a thread keep 512 / HS_THREADS
// blocks on each of the 132 SMs. Held to it (`CAPPED`):
// - the instantiations of up to four servers without the chaos branches,
//   which fit 128 but for the chaos-free MULTI code with the trace and
//   telemetry (56 bytes of spill stores; the profiled graph measured
//   0.67x its time at 141), and the wide code without them (MAXV =
//   HS_WIDE = 0: its per-server registers are rows in device memory);
// - the MULTI chaos codes (lean, not PRT), whose one wave beats their
//   spills: two-class-chaos 0.84x its time at 218 registers, at four
//   servers 0.68x at 166, the traced chaos model 0.73x at 146; the code
//   with every site 0.92-0.95x on the defended two-class arm at 252,
//   0.96x on the defended quorum with a second source, 0.74x on the
//   traced defended model (tools/ab_parent.py against uncapped trees);
// - the consensus codes of up to four servers (CON, one source and one
//   sink; 168-190 registers free) with the defenses or without the
//   telemetry sites, which ran faster capped despite 244-316 bytes of
//   spills: the defended quorum 0.978x, 0.956x and 0.955x in three calls
//   of tools/ab_parent.py against an uncapped tree, the stochastic cuts
//   0.727x, 0.763x and 0.798x. The code with the telemetry sites and no
//   defense stays free: capped, the quorum's undefended arm ran 1.017x
//   (0.930x, 0.941x before), the flapping cuts 0.949x (0.898x, 0.885x)
//   and the bully election 1.577x (1.353x, 1.459x), no faster in all.
// The other chaos instantiations and the chaos-free ones of eight servers
// take what the compiler picks (the lean chaos bench measured 1.15x at
// 128).
#define HS_MIN_BLOCKS(CAPPED) (HS_REG_CAP && (CAPPED) ? 65536 / (128 * HS_THREADS) : 1)

template <int MAXV, bool GRAPH, bool EXT, bool CHAOS, bool TEL = false, bool RES = false,
          bool CON = false, bool MULTI = false, bool TRC = false, bool PRT = false>
__global__ void __launch_bounds__(HS_THREADS,
                                  HS_MIN_BLOCKS(CHAOS ? (MULTI || (CON && MAXV <= 4 && (RES || !TEL))) &&
                                                            !PRT && MAXV != HS_WIDE
                                                      : MAXV <= 4))
event_step_kernel(const __grid_constant__ EventStepArgs a) {
  constexpr bool WIDE = MAXV == HS_WIDE;
  // The window cache: the trace branch's lean code (one traced source, one
  // sink, no chaos) with the telemetry sites.
  constexpr bool WC = HS_WINDOW_CACHE && TEL && TRC && !CHAOS && !MULTI && !PRT && !WIDE;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (EXT) {
    if (a.has_profile) {  // every thread of the block stages, then syncs
      stage_profiles(a, threadIdx.x, blockDim.x);
      __syncthreads();
    }
  }
  if (r >= a.R) return;
  if constexpr (PRT) {
    // The previous window's barrier for this lane, folded into this
    // launch: it writes only this lane's rows and the outbox it reads,
    // which no other lane of the launch touches.
    if (a.prt.fold) hs_barrier_lane(a.prt.bar, r);
  }
  const int nV = a.nV, C = a.C, K = a.K, TR = a.TR, nd = a.n_draws;
  const int nS = MULTI ? a.nS : 1;  // one source and one sink without MULTI
  const size_t rv = (size_t)r * nV;
  // The servers a step scans: MAXV registers, or the wide code's nV rows.
  const int VB = WIDE ? nV : MAXV;

  Lane<MAXV> L;
  // The rows the plan stages go to this lane's column of the tile, after
  // the profile tables.
  float* tile = hs_tables + 2 * (size_t)a.prof_n * a.has_profile;
  const int* off = a.stage.off;
  L.slot_done = stage_in(a.slot_done + rv * C, off[HS_ST_SLOT_DONE], nV * C, tile);
  L.slot_created = stage_in(a.slot_created + rv * C, off[HS_ST_SLOT_CREATED], nV * C, tile);
  L.q_created = a.q_created + rv * K;
  L.q_enq = a.q_enq + rv * K;
  const size_t sink_row = MULTI ? (size_t)r * a.nK : (size_t)r;
  if constexpr (MULTI) L.sink_row = sink_row;
  L.hist = a.sink_hist + sink_row * HS_HIST_BINS;
  bool transit = false;
  if constexpr (GRAPH) {
    transit = a.tr_time != nullptr;
    L.tr_time = stage_in(transit ? a.tr_time + rv * TR : nullptr, off[HS_ST_TR_TIME], nV * TR, tile);
    L.tr_created =
        stage_in(transit ? a.tr_created + rv * TR : nullptr, off[HS_ST_TR_CREATED], nV * TR, tile);
    L.tr_dropped = transit ? a.tr_dropped + rv : nullptr;
    L.rr = a.rr_next + (size_t)r * a.nR;
    L.lim_tokens = a.lim_tokens + (size_t)r * a.nL;
    L.lim_last = a.lim_last + (size_t)r * a.nL;
    L.lim_admitted = a.lim_admitted + (size_t)r * a.nL;
    L.lim_dropped = a.lim_dropped + (size_t)r * a.nL;
  }
  if constexpr (CHAOS) {
    L.slot_attempt = stage_in(a.slot_attempt ? a.slot_attempt + rv * C : nullptr,
                              off[HS_ST_SLOT_ATTEMPT], nV * C, tile);
    L.q_attempt = a.q_attempt ? a.q_attempt + rv * K : nullptr;
    L.tr_attempt = stage_in(a.tr_attempt ? a.tr_attempt + rv * TR : nullptr,
                            off[HS_ST_TR_ATTEMPT], nV * TR, tile);
    L.flt_start =
        stage_in(a.flt_start ? a.flt_start + rv * a.W : nullptr, off[HS_ST_FLT_START], nV * a.W, tile);
    L.flt_end = stage_in(a.flt_end ? a.flt_end + rv * a.W : nullptr, off[HS_ST_FLT_END], nV * a.W, tile);
    L.flt_sh_start = stage_in(a.flt_sh_start ? a.flt_sh_start + (size_t)r * a.W_sh : nullptr,
                              off[HS_ST_FLT_SH_START], a.W_sh, tile);
    L.flt_sh_end = stage_in(a.flt_sh_end ? a.flt_sh_end + (size_t)r * a.W_sh : nullptr,
                            off[HS_ST_FLT_SH_END], a.W_sh, tile);
    L.timed_out = a.timed_out + rv;
    L.retried = a.retried + rv;
    L.outage_dropped = a.outage_dropped + rv;
    L.fault_dropped = a.fault_dropped ? a.fault_dropped + rv : nullptr;
    L.fault_retried = a.fault_retried ? a.fault_retried + rv : nullptr;
    L.hedged = a.hedged ? a.hedged + rv : nullptr;
    L.hedge_wins = a.hedge_wins ? a.hedge_wins + rv : nullptr;
    L.net_lost = a.net_lost ? a.net_lost + r : nullptr;
  }
  if constexpr (TEL) L.tel_row = (size_t)r * a.tel.nW;
  L.win_w = -1;
  L.tenant_pairs = L.hist_pairs = HsRow<uint32_t>{nullptr, 1};
  if constexpr (WC) {
    L.tenant_pairs = pair_row(off[HS_ST_TENANT_PAIRS], a.trc.nT, tile);
    L.hist_pairs = pair_row(off[HS_ST_HIST_PAIRS], HS_HIST_BINS, tile);
  }
  if constexpr (RES) {
    L.res_row = rv;
    L.brk_ring = stage_in(a.res.brk_fail_t ? a.res.brk_fail_t + rv * a.res.F : nullptr,
                          off[HS_ST_BRK_FAIL_T], nV * a.res.F, tile);
  }
  if constexpr (CON) {
    const HsCon& P = a.con;
    const size_t pw = (size_t)r * P.nP * P.Wp;
    L.prt_start = stage_in(P.prt_start ? P.prt_start + pw : nullptr, off[HS_ST_PRT_START],
                           P.nP * P.Wp, tile);
    L.prt_end = stage_in(P.prt_end ? P.prt_end + pw : nullptr, off[HS_ST_PRT_END], P.nP * P.Wp,
                         tile);
    L.net_partitioned = P.net_partitioned ? P.net_partitioned + r : nullptr;
    L.qrm_dropped = P.qrm_dropped ? P.qrm_dropped + rv : nullptr;
    // The memo, where it serves, is scanned at the launch's first event.
    // It serves the consensus codes but the trace library's code for
    // several sources, where the registers it holds measured slower on
    // the models without the tier (tools/ab_parent.py: the traced defended
    // model 1.063x); its mask holds 32 groups, which bounds the wide
    // code's groups alone (past them the wide code scans at every consult).
    L.memo = HS_REACH_MEMO && !(MULTI && TRC) && (!WIDE || P.nP <= 32);
    L.memo_cut = 0u;
    L.memo_alive = P.qrm_n;
    L.memo_until = -INFINITY;
  }
  if constexpr (PRT) {
    const HsPrt& X = a.prt;
    L.ob_arrival = X.ob_arrival + (size_t)r * X.OB;
    L.ob_created = X.ob_created + (size_t)r * X.OB;
    L.ob_ingress = X.ob_ingress + (size_t)r * X.OB;
    L.ob_len = X.ob_len + r;
    L.ob_sent = X.ob_sent + r;
    L.ob_dropped = X.ob_dropped + r;
    L.tr_hi = X.tr_hi + rv;
  }
  const HsKey key{a.keys[2 * (size_t)r], a.keys[2 * (size_t)r + 1]};
  L.drawn = 0;
  // Whether this instantiation draws through hs_draw_call (see HsDraw).
  constexpr bool draw_calls = CHAOS && (RES || !TEL || MAXV > 1);
  if constexpr (WIDE) {
    // The registers in the warp-tiled scratch, copied from the state
    // leaves' rows here and back after the loop, so the loop over every
    // server (the depth integral, the search) reads 32 consecutive words
    // a warp; the earliest times derived.
    const HsWide& X = a.wide;
    // PRT: a window runs about one event a lane, so its registers are read
    // in place in the state leaves' rows (the copy in and out measured
    // 1.17x the window's time on the nine-remote ring); the earliest times
    // stay in the scratch.
    // Each scratch array holds (n, lanes) words, lanes the replica count
    // rounded up to whole warps; this lane's first element and stride.
    const int lanes = (a.R + 31) & ~31;
    // Warp tiles: element v of lane r at ((r / 32) * nV + v) * 32 + r % 32
    // of an (nV, lanes) array, so a warp reads one server's register of its
    // 32 lanes as 32 consecutive words, and its scattered accesses (each
    // lane at its own server) stay inside one block of nV * 32 words.
    const size_t at_v = (size_t)(r >> 5) * nV * 32 + (r & 31);
    const size_t plane = (size_t)nV * lanes;
    int* iregs = reinterpret_cast<int*>(X.regs);
    L.q_len = HsRow<int>{iregs + at_v, 32};
    L.depth = HsRow<float>{X.regs + plane + at_v, 32};
    // Field f of the record of server v at 2 * plane + 8 * (at_v + 32 * v) + f.
    const size_t at = 2 * plane + 8 * at_v;
    L.q_head = HsRow<int>{iregs + at, 8 * 32};
    L.started = HsRow<int>{iregs + at + 1, 8 * 32};
    L.completed = HsRow<int>{iregs + at + 2, 8 * 32};
    L.dropped = HsRow<int>{iregs + at + 3, 8 * 32};
    L.wait_n = HsRow<int>{iregs + at + 4, 8 * 32};
    L.busy = HsRow<float>{X.regs + at + 5, 8 * 32};
    L.wsum = HsRow<float>{X.regs + at + 6, 8 * 32};
    L.mean = HsRow<const float>{a.srv_mean + rv, 1};
    L.smin = HsRow<float>{X.smin + at_v, 32};
    L.tmin = HsRow<float>{X.tmin + at_v, 32};
    if constexpr (PRT) {
      L.q_head = HsRow<int>{a.q_head + rv, 1};
      L.q_len = HsRow<int>{a.q_len + rv, 1};
      L.started = HsRow<int>{a.started + rv, 1};
      L.completed = HsRow<int>{a.completed + rv, 1};
      L.dropped = HsRow<int>{a.dropped + rv, 1};
      L.wait_n = HsRow<int>{a.wait_n + rv, 1};
      L.busy = HsRow<float>{a.busy_int + rv, 1};
      L.depth = HsRow<float>{a.depth_int + rv, 1};
      L.wsum = HsRow<float>{a.wait_sum + rv, 1};
    }
    for (int v = 0; v < nV; ++v) {
      if constexpr (!PRT) {
        L.q_head[v] = a.q_head[rv + v];
        L.q_len[v] = a.q_len[rv + v];
        L.started[v] = a.started[rv + v];
        L.completed[v] = a.completed[rv + v];
        L.dropped[v] = a.dropped[rv + v];
        L.wait_n[v] = a.wait_n[rv + v];
        L.busy[v] = a.busy_int[rv + v];
        L.depth[v] = a.depth_int[rv + v];
        L.wsum[v] = a.wait_sum[rv + v];
      }
      L.smin[v] = row_min(L.slot_done + v * C, hs_ldg(X.conc + v));
      if (transit) L.tmin[v] = row_min(L.tr_time + v * TR, transit_hi<MAXV, PRT>(L, a, v));
    }
  } else {
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      const bool real = v < nV;
      L.q_head[v] = real ? a.q_head[rv + v] : 0;
      L.q_len[v] = real ? a.q_len[rv + v] : 0;
      L.started[v] = real ? a.started[rv + v] : 0;
      L.completed[v] = real ? a.completed[rv + v] : 0;
      L.dropped[v] = real ? a.dropped[rv + v] : 0;
      L.wait_n[v] = real ? a.wait_n[rv + v] : 0;
      L.busy[v] = real ? a.busy_int[rv + v] : 0.0f;
      L.depth[v] = real ? a.depth_int[rv + v] : 0.0f;
      L.wsum[v] = real ? a.wait_sum[rv + v] : 0.0f;
      L.mean[v] = real ? a.srv_mean[rv + v] : 0.0f;
      L.smin[v] = real ? row_min(L.slot_done + v * C, a.conc[v]) : INFINITY;
      if constexpr (GRAPH)
        L.tmin[v] =
            real && transit ? row_min(L.tr_time + v * TR, transit_hi<MAXV, PRT>(L, a, v)) : INFINITY;
    }
  }
  float t = a.t[r];
  // The sources' earliest next arrival and its source. One source keeps
  // its next arrival in this register alone; MULTI: several keep theirs
  // in a register array (the wide code: in device memory, where a fire
  // writes its own and reads them all).
  const size_t src_row = (size_t)r * nS;  // this replica's first row of the (R, nS) leaves
  constexpr bool SREG = MULTI && !WIDE;
  float snext[SREG ? HS_MAX_SOURCES : 1];
  int src = 0;
  float src_next;
  if constexpr (SREG) {
#pragma unroll
    for (int s = 0; s < HS_MAX_SOURCES; ++s) snext[s] = s < nS ? a.src_next[src_row + s] : INFINITY;
    src_next = earliest_source(snext, src);
  } else {
    src_next = nS == 1 ? a.src_next[src_row] : earliest_source(a.src_next + src_row, nS, src);
  }
  int events = a.events[r];
  L.sk_count = a.sink_count[sink_row];
  L.sk_sum = a.sink_sum[sink_row];
  L.sk_sq = a.sink_sq[sink_row];
  const float rate0 = a.src_rate[src_row];  // source 0's rate
  // TRC: the lane's read cursor and its block count.
  uint32_t trc_cursor = 0;
  int trc_blocks = 0;
  if constexpr (TRC) {
    trc_cursor = a.trc.cursor[r];
    trc_blocks = a.trc.blocks[r];
  }

  // PRT: one window, a loop of up to `budget` events that stops at the
  // window's end (JAX's windowed step; a sink still measures up to the
  // horizon), run as one block.
  const float limit = PRT ? a.prt.limit : a.horizon;
  const int steps = PRT ? a.prt.budget : a.macro;
  int ran = 0;  // blocks this lane ran
  for (int c = 0; c < a.n_blocks; ++c) {
    // blocks_cond: a lane whose next event lies past the horizon (or that
    // has none) is halted for good and runs no further block.
    const float next = next_event_time<MAXV, GRAPH>(L, src_next, nV, transit);
    if (isinf(next) || next > limit) break;
    unsigned block = a.block + (unsigned)c;
    if constexpr (TRC) {
      // The stream step's gate: the lane's block budget, and the stall.
      // A lane whose traced source is live and whose block could read
      // past the resident pages leaves unhalted, frozen until the next
      // launch; the block is keyed by the lane's own count.
      if (trc_blocks >= a.trc.n_chunks) break;
      // One source keeps its next arrival in src_next alone (a fire never
      // writes snext then), several theirs in snext or device memory.
      float traced = src_next;
      if (nS > 1) {
        if constexpr (SREG) {
          traced = pick<HS_MAX_SOURCES>(snext, a.trc.src);
        } else {
          traced = a.src_next[src_row + a.trc.src];
        }
      }
      if (isfinite(traced) && (int)trc_cursor + a.macro >= a.trc.base + 2 * a.trc.P) break;
      block = (unsigned)trc_blocks;
      trc_blocks += 1;
    }
    // The block's key, folded once: the draws of step k are elements
    // k * n_draws + slot of its uniforms. PRT: each event folds its own.
    const HsKey block_key = PRT ? HsKey{0u, 0u} : hs_fold_in(key, block);
    if constexpr (!PRT) L.drawn += 1;
    ran += 1;
    for (int k = 0; k < steps; ++k) {
      // next_candidates: the source, the servers' completions, then (GRAPH)
      // the servers' transit arrivals; a strict < keeps the first index.
      float tn = src_next;
      int ev = -1;
      if constexpr (WIDE) {
        // HS_WIDE_CHUNK servers' times loaded at once, then compared in
        // order: the loads overlap instead of each waiting on the last.
        wide_earliest(L.smin, nV, 0, tn, ev);
        if (transit) wide_earliest(L.tmin, nV, nV, tn, ev);
      } else {
#pragma unroll
        for (int v = 0; v < VB; ++v)
          if (L.smin[v] < tn) { tn = L.smin[v]; ev = v; }
        if constexpr (GRAPH) {
#pragma unroll
          for (int v = 0; v < VB; ++v)
            if (L.tmin[v] < tn) { tn = L.tmin[v]; ev = VB + v; }
        }
      }
      if (isinf(tn) || tn > limit) break;  // halted: every later step is a no-op
      if constexpr (CON) {
        // The reachability memo, scanned again once the clock reaches its
        // next edge: every consult of this event, at tn, reads it.
        if (L.memo && !(tn < L.memo_until)) reach_scan(L, a, tn);
      }
      if constexpr (WC) {
        // The cache follows the clock: the last window's cells back, the
        // window of tn's in.
        const int w = tel_window(a.tel, tn);
        if (w != L.win_w) {
          win_flush(L, a);
          win_enter(L, a, w);
        }
      }

      // PRT: the event's row is uniform(fold_in(key, events), (n_draws,)),
      // keyed by the lane's event count before this event.
      const HsDraw u = PRT ? HsDraw{hs_fold_in(key, (uint32_t)events), 0u, &L.drawn, draw_calls}
                           : HsDraw{block_key, (uint32_t)(k * nd), &L.drawn, draw_calls};
      if constexpr (PRT) L.drawn += 1;
      const float lo = fmaxf(t, a.warmup);
      const float dt = fmaxf(tn - lo, 0.0f);
      if constexpr (WIDE) {
        // HS_WIDE_CHUNK servers' queue lengths and integrals loaded at
        // once, then added to. Every queue, the empty ones too: skipping
        // them (0 * dt leaves the integral as it is) measured slower.
        for (int v0 = 0; v0 < nV; v0 += HS_WIDE_CHUNK) {
          int ql[HS_WIDE_CHUNK];
          float depth[HS_WIDE_CHUNK];
#pragma unroll
          for (int j = 0; j < HS_WIDE_CHUNK; ++j) {
            const bool in = v0 + j < nV;
            ql[j] = in ? L.q_len[v0 + j] : 0;
            depth[j] = in ? L.depth[v0 + j] : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < HS_WIDE_CHUNK; ++j)
            if (v0 + j < nV) L.depth[v0 + j] = fma_f64((float)ql[j], dt, depth[j]);
        }
      } else {
#pragma unroll
        for (int v = 0; v < VB; ++v)
          if (v < nV) L.depth[v] = fma_f64((float)L.q_len[v], dt, L.depth[v]);
      }
      if constexpr (TEL) {
        // The same measured interval [lo, tn), split over the windows it
        // spans; an empty queue adds nothing.
        if (a.tel.depth_int) {
#pragma unroll
          for (int v = 0; v < VB; ++v)
            if (v < nV && L.q_len[v] > 0) {
              if constexpr (WC) {
                tel_integral(a.tel.depth_int, a.tel, L.tel_row, nV, v, lo, tn, (float)L.q_len[v],
                             L.win_w, &L.win_depth[v]);
              } else {
                tel_integral(a.tel.depth_int, a.tel, L.tel_row, nV, v, lo, tn, (float)L.q_len[v]);
              }
            }
        }
      }
      t = tn;
      events += 1;

      HsRef dest;
      float created;
      int from = -1, from_slot = 0;
      HsLoss loss{0.0f, 0.0f, 0.0f};  // CHAOS: the edge's packet loss
      int attempt = 0;                // CHAOS: the attempt a transit arrival carries
      bool forward = true;            // CHAOS: false once a deadline expired
      if (ev < 0) {  // _fire_source of the earliest source
        const HsSrc& S = WIDE ? a.wide.src[src] : a.src[src];
        bool traced = false;  // TRC: the traced source reads its pages
        if constexpr (TRC) traced = src == a.trc.src;
        float fired;
        if (traced) {
          size_t tel_row = 0;
          if constexpr (TEL) tel_row = L.tel_row;
          fired = trace_fire<TEL, WC>(a, (size_t)r, tel_row, t, trc_cursor, S.stop_after,
                                      L.tenant_pairs, L.win_w);
        } else {
          const float rate = !MULTI || src == 0 ? rate0 : a.src_rate[src_row + src];
          bool profiled = false;
          if constexpr (EXT) profiled = S.prof_row >= 0;
          float gap;
          if (profiled) {
            const int n = a.prof_n;
            const float* times = hs_tables + (size_t)2 * n * S.prof_row;
            const float inc = S.poisson ? -logf(u[a.u_gap]) : 1.0f;
            gap = invert_profile(n, S.prof_end_rate, times, times + n, t, inc);
          } else {
            gap = S.poisson ? (-logf(u[a.u_gap])) / rate : 1.0f / rate;
          }
          const float next_time = t + gap;
          fired = next_time > S.stop_after ? INFINITY : next_time;
        }
        if (nS == 1) {
          src_next = fired;
        } else if constexpr (SREG) {
          put(snext, src, fired);
          src_next = earliest_source(snext, src);
        } else {
          a.src_next[src_row + src] = fired;
          src_next = earliest_source(a.src_next + src_row, nS, src);
        }
        dest = S.ref;
        created = t;
        if constexpr (CHAOS) loss = S.loss;
      } else if (!GRAPH || ev < VB) {  // _complete_server: the first slot holding the earliest time
        from = ev;
        const int cv = HS_SRV(conc, from);
        const HsRow<float> row = L.slot_done + from * C;
        float best = INFINITY;
        for (int c = 0; c < cv; ++c) {
          const float x = row[c];
          if (x < best) { best = x; from_slot = c; }
        }
        created = L.slot_created[from * C + from_slot];
        row[from_slot] = INFINITY;
        put(L.completed, from, pick(L.completed, from) + 1);
        if constexpr (WC) {
          put(L.win_completed, from, pick(L.win_completed, from) + 1);
        } else if constexpr (TEL) {
          tel_count(a.tel.completed, a.tel, L.tel_row, nV, t, from);
        }
        dest = HS_SRV(srv_ref, from);
        if constexpr (CHAOS) {
          loss = HS_SRV(srv_loss, from);
          // The completing job's attempt; the job it forwards arrives as a
          // first attempt.
          const int job_attempt = L.slot_attempt ? L.slot_attempt[from * C + from_slot] : 0;
          // _complete_server's deadline: an expired job is retried while
          // its attempts last (through the transit registers after the
          // backoff, or at once at the queue's tail), else timed out; it
          // is not forwarded either way.
          const int flags = HS_SRV(srv_flags, from);
          const int max_retries = HS_SRV(max_retries, from);
          const bool expired =
              (flags & HS_F_DEADLINE) && (t - created) > HS_SRV(deadline, from);
          bool retry = expired && job_attempt < max_retries;
          bool budgeted = false;  // RES: a retry spends a budget token
          if constexpr (RES) {
            // The breaker's cooldown is resolved at every completion. A
            // server with a deadline and retries refreshes its budget; a
            // retry without a token is a budget drop and times out. An
            // expired job is the breaker's failure, any other its success.
            const HsRes& B = a.res;
            const int bst = B.breaker ? breaker_effective(L, a, from, t) : 0;
            budgeted = B.budget && (flags & HS_F_DEADLINE) && max_retries > 0;
            if (budgeted) {
              const bool ok = budget_refresh(L, a, from, t, 0.0f) >= 1.0f;
              if (retry && !ok) {
                budget_dropped<MAXV, TEL>(L, a, from, t);
                retry = false;
              }
            }
            if (B.breaker) {
              if (expired) {
                breaker_failure<MAXV, TEL>(L, a, from, t, bst);
              } else {
                breaker_success(L, a, from, bst);
              }
            }
          }
          if (expired) {
            forward = false;
            if (retry) {
              if (flags & HS_F_BACKOFF) {
                if (transit_free<MAXV, PRT>(L, a, from)) {
                  L.retried[from] += 1;
                  if constexpr (TEL) tel_count(a.tel.retried, a.tel, L.tel_row, nV, t, from);
                  if (budgeted) budget_debit(L, a, from);
                }
                into_transit<MAXV, true, TEL, PRT>(L, a, from,
                                                   backoff_arrival<MAXV>(a, from, job_attempt, u, t),
                                                   created, job_attempt + 1);
              } else {
                const int ql = pick(L.q_len, from);
                if (ql < HS_SRV(qcap, from)) {
                  if (budgeted) budget_debit(L, a, from);
                  const int tail = (pick(L.q_head, from) + ql) % K;
                  L.q_created[from * K + tail] = created;
                  L.q_enq[from * K + tail] = t;
                  if (L.q_attempt) L.q_attempt[from * K + tail] = job_attempt + 1;
                  put(L.q_len, from, ql + 1);
                  L.retried[from] += 1;
                  if constexpr (TEL) tel_count(a.tel.retried, a.tel, L.tel_row, nV, t, from);
                } else {
                  put(L.dropped, from, pick(L.dropped, from) + 1);
                  if constexpr (TEL) tel_count(a.tel.dropped, a.tel, L.tel_row, nV, t, from);
                }
              }
            } else {
              L.timed_out[from] += 1;
              if constexpr (TEL) tel_count(a.tel.timed_out, a.tel, L.tel_row, nV, t, from);
            }
          }
        }
      } else {  // _transit_arrive: the first slot holding the row's minimum
        const int v = ev - VB;
        const HsRow<float> trow = L.tr_time + v * TR;
        int hi = transit_hi<MAXV, PRT>(L, a, v);
        float best = INFINITY;
        int slot = 0;
        for (int c = 0; c < hi; ++c) {
          const float x = trow[c];
          if (x < best) { best = x; slot = c; }
        }
        created = L.tr_created[v * TR + slot];
        if constexpr (CHAOS) {
          if (L.tr_attempt) attempt = L.tr_attempt[v * TR + slot];
        }
        trow[slot] = INFINITY;
        if constexpr (PRT) {
          // The highest slot popped: the bound falls past the free slots
          // below it.
          if (slot == hi - 1) {
            while (hi > 0 && isinf(trow[hi - 1])) --hi;
            L.tr_hi[v] = hi;
          }
        }
        put(L.tmin, v, row_min(trow, hi));
        dest = HsRef{HS_SERVER, v, 0.0f, HS_LAT_NONE};
      }

      // A transit arrival crossed before any partition cut: no consult.
      const bool consult = !GRAPH || ev < VB;
      if constexpr (CHAOS) {
        if (forward)
          deliver<MAXV, GRAPH, EXT, true, TEL, RES, CON, MULTI, PRT>(L, a, dest, t, created, u,
                                                                      loss, attempt, consult);
      } else {
        deliver<MAXV, GRAPH, EXT, false, TEL, false, false, MULTI, PRT, WC>(L, a, dest, t, created, u);
      }

      if (from >= 0) {
        // FIFO pull into the freed slot. On a line the delivery went to
        // another server; in a graph a feedback delivery may have re-claimed
        // the slot (it takes the first free one, ahead of the queue).
        const int ql = pick(L.q_len, from);
        const HsRow<float> row = L.slot_done + from * C;
        bool pull = ql > 0 && (!GRAPH || isinf(row[from_slot]));
        bool inflate = false;  // CHAOS: a degrade-mode window inflates the pull
        bool pull_ok = true;   // RES: a budget token for the pull's hedge
        if constexpr (RES) {
          // A hedged server's budget is refreshed at every completion.
          if (a.res.budget && (HS_SRV(srv_flags, from) & HS_F_HEDGE))
            pull_ok = budget_refresh(L, a, from, t, 0.0f) >= 1.0f;
        }
        if constexpr (CHAOS) {
          const int flags = HS_SRV(srv_flags, from);
          if (pull && (flags & HS_F_FAULTED) && !(flags & HS_F_DROP) &&
              fault_dark(L, a, from, t)) {
            const int cap = HS_SRV(cap_slots, from);
            const int cv = HS_SRV(conc, from);
            pull = !(cap < cv && active_slots(row, cv) >= cap);
            inflate = HS_SRV(lat_factor, from) > 1.0f;
          }
        }
        if (pull) {
          const int head = pick(L.q_head, from);
          HsSvc s = service_terms<MAXV, EXT>(a, from, pick(L.mean, from), u + a.u_svc2);
          if constexpr (CHAOS) {
            const int flags = HS_SRV(srv_flags, from);
            const float factor = HS_SRV(lat_factor, from);
            // A server whose degrade windows inflate multiplies its pull's
            // service by the factor, 1 while not dark.
            if ((flags & HS_F_FAULTED) && !(flags & HS_F_DROP) && factor > 1.0f)
              s = HsSvc{s.x * s.y, inflate ? factor : 1.0f};
            float service = s.x * s.y;
            if constexpr (RES) {
              if (!pull_ok && (HS_SRV(srv_flags, from) & HS_F_HEDGE) &&
                  service > HS_SRV(hedge, from))
                budget_dropped<MAXV, TEL>(L, a, from, t);
            }
            if ((flags & HS_F_HEDGE) && pull_ok) {
              HsSvc second = service_terms<MAXV, EXT>(a, from, pick(L.mean, from), u + a.u_hed2);
              if ((flags & HS_F_FAULTED) && !(flags & HS_F_DROP) && factor > 1.0f)
                second = HsSvc{second.x * second.y, inflate ? factor : 1.0f};
              bool hedged, won;
              service = hedge_race(service, second, HS_SRV(hedge, from), hedged, won);
              L.hedged[from] += hedged ? 1 : 0;
              L.hedge_wins[from] += won ? 1 : 0;
              if constexpr (RES) {
                if (hedged && a.res.budget) budget_debit(L, a, from);
              }
              if constexpr (TEL) {
                if (hedged) tel_count(a.tel.hedged, a.tel, L.tel_row, nV, t, from);
                if (won) tel_count(a.tel.hedge_wins, a.tel, L.tel_row, nV, t, from);
              }
            }
            if (flags & HS_F_HEDGE) s = HsSvc{service, 1.0f};
            if (L.slot_attempt) L.slot_attempt[from * C + from_slot] = L.q_attempt[from * K + head];
          }
          const float service = s.x * s.y;
          const float done_at = fma_f64(s.x, s.y, t);
          row[from_slot] = done_at;
          L.slot_created[from * C + from_slot] = L.q_created[from * K + head];
          put(L.q_head, from, (head + 1) % K);
          put(L.q_len, from, ql - 1);
          put(L.started, from, pick(L.started, from) + 1);
          if (t >= a.warmup) {
            put(L.busy, from, pick(L.busy, from) + service);
            put(L.wsum, from, pick(L.wsum, from) + (t - L.q_enq[from * K + head]));
            put(L.wait_n, from, pick(L.wait_n, from) + 1);
            if constexpr (WC) {
              if (a.tel.busy_int) {
                float busy = pick(L.win_busy, from);
                tel_integral(a.tel.busy_int, a.tel, L.tel_row, nV, from, t, done_at, 1.0f, L.win_w,
                             &busy);
                put(L.win_busy, from, busy);
              }
            } else if constexpr (TEL) {
              if (a.tel.busy_int)
                tel_integral(a.tel.busy_int, a.tel, L.tel_row, nV, from, t, done_at, 1.0f);
            }
          }
        }
        put(L.smin, from, row_min(row, HS_SRV(conc, from)));
      }
    }
  }

  const float next = next_event_time<MAXV, GRAPH>(L, src_next, nV, transit);
  a.halted[r] = (isinf(next) || next > a.horizon) ? 1 : 0;
  // PRT: the budget ran out with an event still due in the window.
  if constexpr (PRT) {
    if (next <= limit) a.prt.truncated[r] += 1;
  }
  if (a.draws) a.draws[r] = L.drawn;
  if (a.blocks) a.blocks[r] += ran;
  if (ran == 0) return;  // a lane halted on entry changed nothing
  if constexpr (WC) win_close(L, a, (size_t)r);

  if constexpr (TRC) {
    a.trc.cursor[r] = trc_cursor;
    a.trc.blocks[r] = trc_blocks;
  }
  a.t[r] = t;
  if (nS == 1) {
    a.src_next[src_row] = src_next;
  } else if constexpr (SREG) {
#pragma unroll
    for (int s = 0; s < HS_MAX_SOURCES; ++s)
      if (s < nS) a.src_next[src_row + s] = snext[s];
  }
  a.events[r] = events;
  a.sink_count[sink_row] = L.sk_count;
  a.sink_sum[sink_row] = L.sk_sum;
  a.sink_sq[sink_row] = L.sk_sq;
  if constexpr (WIDE && !PRT) {  // the scratch registers back to the leaves' rows
    for (int v = 0; v < nV; ++v) {
      a.q_head[rv + v] = L.q_head[v];
      a.q_len[rv + v] = L.q_len[v];
      a.started[rv + v] = L.started[v];
      a.completed[rv + v] = L.completed[v];
      a.dropped[rv + v] = L.dropped[v];
      a.wait_n[rv + v] = L.wait_n[v];
      a.busy_int[rv + v] = L.busy[v];
      a.depth_int[rv + v] = L.depth[v];
      a.wait_sum[rv + v] = L.wsum[v];
    }
  }
#pragma unroll
  for (int v = 0; v < (WIDE ? 0 : MAXV); ++v) {
    if (v < nV) {
      a.q_head[rv + v] = L.q_head[v];
      a.q_len[rv + v] = L.q_len[v];
      a.started[rv + v] = L.started[v];
      a.completed[rv + v] = L.completed[v];
      a.dropped[rv + v] = L.dropped[v];
      a.wait_n[rv + v] = L.wait_n[v];
      a.busy_int[rv + v] = L.busy[v];
      a.depth_int[rv + v] = L.depth[v];
      a.wait_sum[rv + v] = L.wsum[v];
    }
  }
  // The staged rows back to device memory (the fault windows are read
  // only).
  stage_out(L.slot_done, a.slot_done + rv * C, nV * C);
  stage_out(L.slot_created, a.slot_created + rv * C, nV * C);
  if constexpr (GRAPH) {
    if (transit) {
      stage_out(L.tr_time, a.tr_time + rv * TR, nV * TR);
      stage_out(L.tr_created, a.tr_created + rv * TR, nV * TR);
    }
  }
  if constexpr (CHAOS) {
    if (a.slot_attempt) stage_out(L.slot_attempt, a.slot_attempt + rv * C, nV * C);
    if (a.tr_attempt) stage_out(L.tr_attempt, a.tr_attempt + rv * TR, nV * TR);
  }
  if constexpr (RES) {
    if (a.res.brk_fail_t) stage_out(L.brk_ring, a.res.brk_fail_t + rv * a.res.F, nV * a.res.F);
  }
}

// The code a launch of the library for several sources or sinks
// (event_step_multi.cu) or of the trace library (event_step_trace.cu,
// `trace`) takes, each with the telemetry sites where the model has a
// spec (args.tel.nW), so a model pays only for the sites it has:
// - HS_CODE_LINE (the trace library only): one source, one sink, no
//   chaos: the extended graph code with the trace;
// - HS_CODE_LEAN: several sources or sinks without chaos: the extended
//   graph code with MULTI;
// - HS_CODE_CHAOS: chaos without the defenses or the consensus tier: the
//   chaos code with MULTI and none of their sites;
// - HS_CODE_FULL: the defenses or the consensus tier: the chaos code with
//   MULTI and every feature's sites (the telemetry ones always), each
//   taken only where the model has the feature.
// Each of the two libraries exports its choice by name through
// HS_EVENT_STEP_CODE, which kernels/event_step.py reads to count each
// code's launches.
#define HS_CODE_LINE 0
#define HS_CODE_LEAN 1
#define HS_CODE_CHAOS 2
#define HS_CODE_FULL 3

static inline int hs_code(const EventStepArgs& a, bool trace) {
  if (!a.chaos) return trace && a.nS == 1 && a.nK == 1 ? HS_CODE_LINE : HS_CODE_LEAN;
  return a.res.on || a.con.on ? HS_CODE_FULL : HS_CODE_CHAOS;
}

// extern "C" hs_event_step_code(args): the name of the code the launch
// of `args` takes in a library that picks it by hs_code(args, TRACE).
#define HS_EVENT_STEP_CODE(TRACE)                                            \
  extern "C" const char* hs_event_step_code(const EventStepArgs* args) {     \
    static const char* const names[] = {"line", "lean", "chaos", "full"};    \
    return names[hs_code(*args, TRACE)];                                     \
  }

#if defined(__CUDACC__)
// Dynamic shared memory of a launch: the profile tables, then the row
// tile, a column of stage.words words per thread.
static size_t hs_smem_bytes(const EventStepArgs& a) {
  const size_t tables = 2 * (size_t)a.prof_n * a.has_profile * sizeof(float);
  return tables + (HS_STAGE_ROWS ? (size_t)a.stage.words * HS_THREADS * sizeof(float) : 0);
}

// What every library checks before it launches: a block count, a plan
// and a profile grid within the bounds, a trace only on the trace
// library (`trace`), which needs one, and the wide code's tables and
// scratch only on a library's wide instantiations (`wide`), which need
// them; the lean code's tables in the arguments bound the sources, the
// partition groups and the remotes.
static bool hs_args_ok(const EventStepArgs& a, bool trace = false, bool wide = false,
                       bool prt = false) {
  if (a.R < 0 || a.n_blocks < 1 || a.stage.words < 0) return false;
  if (a.trc.on != (trace ? 1 : 0)) return false;
  if (a.prt.on != (prt ? 1 : 0)) return false;
  if (prt) {
    const HsPrt& x = a.prt;
    if (x.OB < 1 || x.budget < 1 || x.nRm < 1 || (!wide && x.nRm > HS_MAX_REMOTES) ||
        (wide && (!a.wide.rm_latency || !a.wide.rm_ingress)) || !x.ob_arrival ||
        !x.ob_created || !x.ob_ingress || !x.ob_len || !x.ob_sent || !x.ob_dropped ||
        !x.truncated || !x.tr_hi || !a.tr_time)
      return false;
    // A folded barrier covers this launch's lanes, its state rows the
    // launch's own.
    if (x.fold && (!hs_barrier_args_ok(x.bar) || (long long)x.bar.P * x.bar.R != a.R ||
                   x.bar.nV != a.nV || x.bar.TR != a.TR || x.bar.OB != x.OB ||
                   x.bar.t != a.t || x.bar.tr_time != a.tr_time || x.bar.tr_hi != x.tr_hi))
      return false;
  }
  if (a.wide.on != (wide ? 1 : 0)) return false;
  if (wide) {
    const HsWide& w = a.wide;
    if (!w.src || !w.srv_ref || !w.conc || !w.qcap || !w.srv_flags || !w.smin || !w.tmin ||
        !w.regs || w.nT < 0 ||
        (a.nR > 0 && (!w.rt_target || w.nT < 1)))
      return false;
  } else if (a.nS > HS_MAX_SOURCES || (a.con.on && a.con.nP > HS_MAX_PARTITIONS)) {
    return false;
  }
  if (a.nS < 1 || a.nK < 1 || a.has_profile < 0) return false;
  if (a.has_profile && (a.prof_n < 2 || a.prof_n > HS_MAX_PROFILE_GRID)) return false;
  if (a.con.on && (a.con.nP < 1 || a.con.Wp < 1)) return false;
  if (a.trc.on && (a.trc.src < 0 || a.trc.src >= a.nS || a.trc.P < 1 || a.trc.nT < 1 ||
                   a.trc.n_chunks < 0 || !a.trc.t0 || !a.trc.g0 || !a.trc.t1 || !a.trc.g1))
    return false;
  return hs_smem_bytes(a) <= HS_MAX_SMEM_PER_BLOCK;
}

// One instantiation over every replica on stream s, its dynamic shared
// memory limit raised first where the launch takes more than 48 KB.
template <typename Kernel>
static void hs_launch(Kernel kernel, const EventStepArgs& a, cudaStream_t s) {
  const size_t smem = hs_smem_bytes(a);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 block(HS_THREADS);
  const dim3 grid((a.R + HS_THREADS - 1) / HS_THREADS);
  kernel<<<grid, block, smem, s>>>(a);
}

// The library's build constants, which the wrapper checks when it loads it.
extern "C" int hs_event_step_max_servers() { return HS_MAX_NV; }

extern "C" int hs_event_step_max_remotes() { return HS_MAX_REMOTES; }

extern "C" int hs_event_step_max_sources() { return HS_MAX_SOURCES; }

extern "C" int hs_event_step_max_profile_grid() { return HS_MAX_PROFILE_GRID; }

extern "C" int hs_event_step_args_size() { return (int)sizeof(EventStepArgs); }

extern "C" int hs_event_step_threads() { return HS_THREADS; }
#endif
