#!/usr/bin/env python3
"""On-card smoke run of drake_tpu_torch, the PyTorch + CUDA port: the MPM
substep (slice 1), the batched iiwa contact-implicit MPC of bench.py (slice
2), the coupled MPM + rigid world with its MPPI controller (slice 3,
BASELINE config 5), that world with the dense implicit grid contact, the
codimensional cloth's bagging demo, the tile pipeline, the world with
the implicit grid contact on the tile pipeline (the default of "implicit"),
the quadrotor obstacle MPC (config 3), the pendulum dircol (config 1) and
the acrobot swing-up with TV-LQR (config 2) with the LQR family's examples,
the optimization layer, and continuous-time and hybrid simulation with the
bouncing-ball, rimless-wheel and compass-gait demos.
Run from the root of a checkout, on a machine with one
NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits 1):

1. build the hand-written kernels from drake_tpu_torch/ops/csrc with nvcc;
2. hold each kernel (K1 grid update on a dense grid, K1 from K2's block
   windows, K2 blocked P2G, K3 blocked G2P, one output row per sorted row,
   compared on the rows the blocks take) against its plain PyTorch
   version on the card, on substep inputs of the bench scene (v and F perturbed from a fixed seed so that every channel is live)
   at both sizes, and at the small size with the capacities cut: blocks that
   overflow ``block_capacity`` (counts clamped to a pmax that is no multiple
   of a kernel's chunk) and blocks beyond ``max_active_blocks``; and hold K2
   to its contract on the rows' order: a block whose rows are not sorted by
   cell comes out as NaN, every other block as before;
3. drive the MPM path -- ``simulate`` (K2 + K1 from block windows),
   ``mpm_substep_blocked`` (K2 + K1 from block windows + K3) and the
   transfer functions composed by hand, ``particle_to_grid`` ->
   ``update_grid`` -> ``grid_to_particle`` (K2 + the dense K1, the dense
   grid that grid contact and cloth will use), 50 substeps each, and the
   same three with ``xla_only=True`` (the plain versions) -- on the
   elastic-block scene of benchmarks/bench_mpm_substeps.py at 17,576 and
   132,651 particles; check dropped == 0, finite state, free fall (mean v_z
   = -g t), and kernel vs plain agreement in x and v, and count the kernel
   launches of that run;
4. time each kernel at that path's shapes, back to back (inputs warm in
   the L2 cache) and with the cache flushed before every call (cold), beside
   its plain version and its bound: the larger of its bytes over the card's
   memory rate and its operations over the card's float32 rate; K1 from
   block windows also beside the chain it replaced (the dense grid of
   ``_grid_from_blocks``, then the dense K1), and an empty kernel at each
   K1's launch shape.

``python3 chip_smoke.py --profile`` adds a fifth phase: ``torch.profiler``
over 20 substeps of each kernel path, for the device time, the busy share
and the kernel count of a substep.

Then the MPC of ``drake_tpu_torch.bench`` (it reaches none of K1-K3):

6. parity at batch 8 on the bench world: the port in float32 on the card
   against the port in float64 on the CPU, for one planning step and one
   plant step, the planning step's Jacobian (27 x 34) and one ``rti_solve``;
7. the main path at full width: ``bench.build_rollout(batch=1024,
   mpc_steps=30)`` after a 2-step warm-up, timed by CUDA events and the host
   clock; solves/s, lanes progressing, median final box error, frozen
   lanes, rejected plans and peak memory, with the quality gates below;
8. with ``--profile``: ``torch.profiler`` over 2 RTI MPC steps: device ms,
   busy share and kernel launches per MPC step, device time per layer (the
   ``record_function`` ranges of the port) and outside every layer.

Then the coupled world of ``drake_tpu_torch.benchmarks`` (config 5's paddle
pushing an MPM blob; K1 and K2 batched over lanes, K3 not on this path):

9. both K1 and K2 over 256 and 64 lanes (32^3 grid, A = 64, pmax = 512)
   against their plain versions, on the coupled world's own state after a
   few steps with v and F perturbed, timed as in phase 4 (K2 also against
   the bound of its live blocks and channels only); lanes of each batched
   call against the unbatched call on that lane; and K1 from block windows
   held to its contract on the order of the active ids;
10. parity: 4 lanes through one coupled step (10 substeps, P2G through K2,
    grid update through K1 from block windows) and one ``mppi_step`` (2 scenarios x 2 samples,
    the same perturbations) in float32 on the card against float64 on the
    CPU: particle x, v, F, C, the rigid state, impulses, the MPPI controls
    and costs, within the bounds COUPLED_PARITY;
11. the coupled world bench (``bench_coupled_world.run``): K = 64 rollouts
    of 10 coupled steps in one call, with the kernels and with
    ``xla_only=True``: substeps/s, finite state, dropped == 0 in every lane,
    peak memory, the kernel launches, and kernel vs plain agreement;
12. config 5 at full width (``bench_coupled_mpc.run``): 32 scenarios x 8
    MPPI samples = 256 lanes in one call, horizon 10 x 10 substeps, 50 MPC
    steps after a 1-step warm-up: solves/s, goal reached, median final
    error, non-finite scenarios, dropped, peak memory, launches, with the
    gates below (CONFIG5_*);
    with ``--profile``, ``torch.profiler`` over one coupled step of the 256
    lanes (per coupled substep) and over one MPC step: device ms, busy
    share, kernels, the ranges ``coupling.substep``, ``coupling.contact`` and
    ``coupled.sap_step``, the K1 and K2 kernels, and the cuBLAS gemv kernels
    (none of them the grid's B x_node product, which K1 computes).

Then the dense implicit grid contact (``mpm/grid_contact.py``, the branch
``contact_model="implicit", tiled=False`` of ``CoupledWorld.step``) on the
same world, with the JAX bench's --implicit solve parameters:

13. a. parity: one dense implicit coupled step of 4 lanes, float32 on the
       card against float64 on the CPU, within IMPLICIT_PARITY, and each
       solve's Newton iteration count;
    b. K = 64 and K = 32 rollouts of 10 coupled steps in one call
       (``bench_coupled_world.rollout``, the paddle's face 5 mm inside the
       blob, the bench's controls + 10 N) after a warm-up rollout: substeps/s,
       Newton iterations, solves at the cap, final residuals, peak memory, the
       kernel launches (K2 and K1 from block windows with the node mass, one
       each a substep; no dense K1), with the gates: finite, dropped == 0,
       every lane's impulse on the paddle nonzero, every lane in contact
       (more than one Newton iteration in some substep), every solve below
       the cap at its tolerance;
    c. the K = 64 rollout with ``xla_only=True`` against the kernels, within
       IMPLICIT_MAX_DIFF; both rollouts run once more, each bit for bit its first run,
       and the Newton's fixed-order scatter timed beside ``index_add_``;
       K1 from block windows with the mass against its plain version
       and timed beside the velocity-only launch; with ``--profile``, the
       device share and host ms of ``grid_contact.newton`` and
       ``grid_contact.line_search`` per coupled substep.

Then the cloth (``mpm/cloth.py``, the cloth branch of
``CoupledWorld.step``) on the fork's bagging demo
(``drake_tpu_torch.examples.mpm_bagging``: a 22 x 22 sheet held at its
corners catches a free ball on a floating joint; 32^3 grid, 20 substeps a
coupled step; K2 and K1 from block windows, K3 not on this path):

14. a. parity: one coupled step of the bagging world on 2 lanes by each
       contact model (the ball in the sheet at the demo's speed at contact),
       and 20 substeps of ``simulate_cloth`` on the drape sheet, float32 on
       the card against float64 on the CPU within BAGGING_PARITY, Newton
       iteration counts at most 1 apart;
    b. the main path: the demo's first BAGGING_STEPS coupled steps with the
       implicit grid contact on one world, timed by the host wall after a
       warm-up step: substeps/s, peak memory, Newton iterations, the kernel
       launches (one K2 and one K1 with the node mass a substep), with the
       gates: finite, dropped == 0, the sheet's impulse on the ball from
       its first contact on pointing up, the ball's height within
       BAGGING_Z_END_BOUND of the JAX package's CPU run;
    c. steps 60-70 (before contact) and 160-170 (in contact) from 14b's
       states with the kernels and with ``xla_only=True``, within
       BAGGING_MAX_DIFF_PATHS in x and v; K2 and K1 with the mass at
       the cloth's shape (one world, 32^3, A = 256) against their plain
       versions, timed warm and cold beside their bounds (K2's counts the
       blocks that hold particles, as K1 from block windows reads them); with
       ``--profile``, ``cloth.substep``, ``cloth.forces``,
       ``grid_contact.newton`` and the device timeline of one coupled step;
    d. 14b with the penalty contact, with its gates less the Newton's.

Then the tile pipeline (``mpm/tiles.py``: the group's sort every
TILED_RESORT substeps, and every substep one block sort, K2, K1 from block
windows and K3 over the live particles):

15. a. ``simulate_tiled`` on phase 3's scenes (17,576 and 132,651
       particles, 50 substeps) with the kernels and with ``xla_only=True``:
       substeps/s by CUDA events, launches a substep (one K2, one K1 from
       block windows, one K3), and the gates dropped == 0, finite, free
       fall, kernel vs plain and the tiled path vs phase 3's
       ``mpm_substep_blocked`` within MAX_DIFF_PATHS;
    b. the reference test's fast block (v = 3 dx/dt, two resident
       substeps): dropped > 0, the same count by the kernels and plain;
    c. K3 over the coupled world's 64 lanes (32^3, A = 64, pmax = 512) on
       phase 9's state, against its plain version and against the call on
       one lane's own sort, timed warm and cold beside its bound.

Then the world of phase 13 with the implicit grid contact on the tile
pipeline (``CoupledWorld(contact_model="implicit")``, tiled by default;
``mpm/tiles_contact.py``), with the JAX bench's --implicit solve
parameters:

16. a. parity: one tiled coupled step of 4 lanes, float32 on the card
       against float64 on the CPU, within TILED_PARITY, Newton iteration
       counts at most 1 apart;
    b. K = 64 and K = 32 rollouts of 10 coupled steps of the converged
       solve, as 13b: substeps/s, Newton iterations, solves at the cap,
       residuals, peak memory, the closure's nodes beside the grid's, the
       launches (one K2, one K1 with the node mass and one K3 a substep, no
       dense K1), with 13b's gates;
    c. the same with the fixed-count solve (``unroll_iterations`` =
       TILED_UNROLL), with the gates less the cap's;
    d. at K = 64, the tiled world against phase 13's dense world and the
       kernels against ``xla_only=True``, within TILED_MAX_DIFF; with
       ``--profile``, ``grid_contact.newton`` and
       ``grid_contact.line_search`` per coupled substep.

Then the two NLP and MPC configs of slice 3b, which reach none of K1-K3
(their dense algebra is library calls: batched LU, eigh, 3x3 solves):

17. the quadrotor obstacle MPC, BASELINE config 3
    (``drake_tpu_torch.benchmarks.bench_quadrotor_mpc``):
    a. parity at batch 8, card float32 against CPU float64: the dynamics,
       the rk4 step and its Jacobian, one 8-iteration ``ilqr.solve`` and one
       ``rti_solve``, within QUAD_PARITY;
    b. the bench's rollout at 4,096 lanes in one call (horizon 30, 25 MPC
       steps, RTI): solves/s, peak memory, the lanes progressing, with the
       gates: finite, no frozen lane, progressing >= the JAX package's CPU
       float32 count on the same states less 1% of the lanes;
    c. with ``--profile``, ``ilqr.*`` and ``mpc.plant_step`` per RTI step;
18. the pendulum dircol, BASELINE config 1:
    a. the first SQP iteration from the straight-line guess, card float64
       against CPU float64 within 1e-9 of scale: the QP's data and solution,
       the CPU's QP solved on the card, the whole iteration, and their
       iteration counts;
    b. ``examples/pendulum_dircol.py``'s flow in float64 on the card (the
       Sl1QP solve, PD tracking through ``simulate_controlled``, its steps
       replayed as a CUDA graph and held against the eager loop bit for
       bit), with tests/test_dircol.py's gates, printing ``SWING-UP SUCCESS``;
    c. ``bench_dircol_f32``'s 32 cold starts in float32 in one call:
       solves/s and the feasible count, gated by the JAX package's CPU
       float32 counts on the same guesses moved by up to 2 ulps (the count
       is chaotic in the last bit); the peak memory of one
       iteration's ``torch.func`` derivatives at the 32 lanes;
    d. with ``--profile``, ``sqp.derivatives``, ``ipm.solve`` and
       ``sqp.line_search`` per SQP iteration, and the batched ``eigh``
       timed alone.

Then config 2 and the LQR family (``drake_tpu_torch.examples``), which reach
none of K1-K3 either:

19. a. card float64 against CPU float64 within 1e-9 of scale: the CARE,
       DARE and both Lyapunov solvers over 64 seeded systems, the LQR of
       the acrobot, the cart-pole and the quadrotor at their fixed points,
       and a TV-LQR (S, K, k0) about a passive acrobot swing;
    b. ``examples/acrobot_swingup.py``'s stages in float64 (iLQR, dircol,
       TV-LQR, the closed loop), each stage's seconds and iterations, the
       closed loop's CUDA graph against the eager loop over its first
       steps, and the example's gate, printing ``SWINGUP+TVLQR SUCCESS``;
    c. in float32 at their full widths, each with its own gates and wall
       time: ``cart_pole_lqr`` (256 lanes), ``acrobot_spong`` (1, then 64
       lanes), ``acrobot_lqr_estimator`` and ``acrobot_spong_optimize``
       (32 x 8 = 256 lanes; ``--iters`` cut to 1);
    d. with ``--profile``, one iLQR iteration, one SQP iteration, the TV-LQR
       solve and one closed-loop step (CUDA graph and eager).

Then the optimization layer (``drake_tpu_torch.solvers``: MathematicalProgram,
the ADMM QP, the conic ADMM, AL-Newton, the LCP solvers, the block
Cholesky, branch-and-bound, the Shor relaxation; ``systems.optimization``),
which reaches none of K1-K3, on the seeded inputs of tests/solver_cases.py:

20. a. card float64 against CPU float64 within 1e-9 of scale, iteration
       and node counts equal: each back end on its parity tests' inputs,
       and ``MathematicalProgram.Solve`` on every program of the parity
       tests (every program type and back end);
    b. those solves at the entry, float64, each with its seconds,
       ``info["solver"]`` and the gate of its JAX test or of
       tutorials/03_optimization.py; ``find_fixed_point`` on the pendulum,
       the acrobot upright and the quadrotor hover;
    c. each back end at full width (the QP at 4,096 lanes of n = 120, the
       LCP at 4,096 of n = 27, the conic SOCP and SDP at 1,024 each,
       AL-Newton at 1,024, the block Cholesky at 1,024 scenarios of n =
       384 beside the dense Cholesky), timed by CUDA events after a
       warm-up, float64 with gates, then float32 without;
    d. with ``--profile``, one solve of each at its 20c width and the
       knapsack MIP: ``qp.chunk``, ``qp.polish``, ``conic.iterate``,
       ``al.inner``, ``al.line_search``, ``lcp.fb``, ``bb.node``.

Then continuous-time and hybrid simulation (``systems/simulator.py``'s
``simulate_adaptive``, ``simulate_hybrid`` and ``dense_output``,
``math/trajectories.py``, ``systems/primitives.py``, ``diagram.py``,
``comms.py``, ``control/controllers.py``, ``multibody/plant.py``, the
continuous contact plant, TAMSI and PGS), which reaches none of K1-K3:

21. a. the port in float32 on the card against float64 on the CPU on small
       seeded inputs of each module, within SYS_PARITY, the counts (steps,
       rejects, events, Newton iterations) equal or within
       SYS_PARITY_COUNTS;
    b. the bouncing ball (STEPS_BALL rk4 steps and the dense output at BALL_QUERIES
       times), the rimless wheel (20 s) and the compass gait (12 s), float32
       on the card at the reference's size and depth, each with its own
       checks and held to the JAX package's float32 readings
       (SYSTEMS_JAX_F32), with its seconds;
    c. over lanes in one call, lanes/s and peak memory: the wheel's
       ``simulate_hybrid`` over 1,024 pushes (each of LANE_CHECKS_SYS lanes
       against its one-lane run), ``simulate_adaptive`` over 1,024
       oscillators (float32 against float64), and SAP, TAMSI and PGS (both
       sweeps) over 1,024 lanes of the bench world (64 held to the CPU's
       float64 solves), with TAMSI and PGS against SAP at physics level on
       1,024 slides of test_contact.py's sphere;
    d. a publishing rollout and a closed loop with comms through the port's
       copy of pubsub on the card: the messages equal the CPU run's;
    with ``--profile``, the ranges ``hybrid.macro``, ``hybrid.isolate``,
    ``adaptive.step``, ``tamsi.newton`` and ``pgs.sweep``.

Then the full SAP discrete plant (the ball, planar, screw and universal
joints, every primitive pair and hydro patch, SAP's limits, couplers,
ball/distance/weld constraints, implicit PD and Hunt-Crossley models,
force elements, loop topology) and Drake's rigid-contact demos, which
reach none of K1-K3:

22. a. card float64 against the port's CPU float64 on one SAP step of
       each feature over RIGID_PARITY_LANES lanes, within RIGID_PARITY of
       scale, Newton counts equal (or within the CPU's own spread under
       RIGID_NUDGES); the cylinder's hydro patch runs, finite, but is not
       compared (ROADMAP.md, Queue 3);
    b. the ten demos at RIGID_DEPTHS, float32 on the card, a process each
       (``--rigid-demo NAME``, the demo's ``smoke``), RIGID_WORKERS at a
       time, started with phase 17 and run beside phases 17-22a: each
       check the depth reaches, each final state within RIGID_FLOOR_FACTOR
       times its float32 floor of the JAX package's CPU float32 reading
       (tests/contact_reference.json), the seconds;
    c. the allegro PD grasp over GRASP_LANES lanes in one call, alone:
       lanes/s, peak memory; finite, every joint within its limit's slack,
       every lane's grasp closed and caged, the first GRASP_CHECK_LANES
       against the JAX package's float32 run;
    d. with ``--profile``, ``sap.assemble`` and ``sap.newton`` per step of
       22c.

Phase 19 runs in a process of its own (``--acrobot-only``), started with
phase 17 and run beside phases 17-22a, as 22b's demos: phases 17-22 time
no kernel, and each of these paths is host-bound, so they share the card.
``python3 chip_smoke.py --opt-only [--profile]`` runs phase 20 alone,
``--systems-only [--profile]`` phase 21 alone and ``--contact-only
[--profile]`` phase 22 alone; none prints a result line.

The last two lines are a JSON object of per-kernel results (launches by
path) and ``{"ok": true, "device": {...}}``.  There is no CPU path: without a
CUDA device the script exits 1 and prints no result.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback
import types

import numpy as np

# Phases 3 and 15 (the MPM paths): cut from the bench's 200 substeps to 100
# to keep the whole script within its time limit with phase 20, and to 50
# with phase 21; their gates do not depend on the count (free fall -g t,
# kernel against plain, launches a substep).
SUBSTEPS = 50
WARMUP_SUBSTEPS = 3
KERNEL_REPS = 20
PROFILE_SUBSTEPS = 20
SEED = 0
# Published peaks of an H100 SXM (NVIDIA's data sheet): device memory rate and
# float32 rate outside the tensor cores.  A kernel's bound is the larger of
# its bytes over the first and its operations over the second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Written between two cold calls: several times the 50 MB L2 cache, and long
# enough on the card for the host to queue the next call behind it.
FLUSH_BYTES = 512 * 2**20
# Spin on the card while the host queues the calls of a timed loop, so that
# the events bracket back-to-back kernels and not the host's dispatch.  The
# spin is torch.cuda._sleep, a private function of PyTorch (its own tests use
# it); should it go, any kernel of a few ms in front of the loop does the same.
SPIN_CYCLES = 5_000_000
# Kernel vs plain, max |x| and |v| difference after SUBSTEPS (float32;
# different summation orders; far below a cell of 1/64).
MAX_DIFF_PATHS = 1e-4
# Free fall: mean v_z against -g t (as tests/test_mpm.py).
FREE_FALL_RTOL = 1e-3

# The MPC of drake_tpu_torch.bench (phases 6-8).
MPC_PARITY_BATCH = 8
MPC_BATCH = 1024
MPC_STEPS = 30
MPC_WARMUP_STEPS = 2
PROFILE_MPC_STEPS = 2
# Phase 6 bounds, card float32 against CPU float64 on the same program, as a
# share of the float64 answer's largest magnitude (of max(1, |x|) for
# states).  Float32 rounds at 1.2e-7; the SAP Newton system amplifies it by
# its conditioning (stiff contact rows against the arm's mass matrix), the
# Jacobian's IFT backward solves that system once more, and the card sums
# in other orders than the CPU.  The same comparison on a CPU gave 1.1e-7
# (states), 1.7e-6 (Jacobian) and 1.6e-8 (RTI torques): the bounds leave
# about two orders of magnitude above that.
MPC_PARITY_STATE = 1e-5
MPC_PARITY_JACOBIAN = 1e-4
MPC_PARITY_RTI = 1e-4
# Phase 7 quality gates: lanes whose box ends closer to its goal than it
# started, and the median final box error against the median initial one.
MPC_MIN_PROGRESSING = 0.9
MPC_MAX_ERR_RATIO = 0.6
# The port's layers, as record_function ranges (phase 8).  The last four
# never nest in one another and hold the SAP ranges; the linearization's
# backward passes run on the calling thread, so their kernels fall inside
# ilqr.linearize.
MPC_LAYERS = ("sap.assemble", "sap.newton", "sap.ift_backward", "ilqr.linearize",
              "ilqr.riccati", "ilqr.forward", "mpc.plant_step")
MPC_TOP_LAYERS = MPC_LAYERS[3:]

# The coupled MPM + rigid world and its MPPI, BASELINE config 5 (phases
# 9-12; drake_tpu_torch.benchmarks).
COUPLED_KERNEL_LANES = (256, 64)  # config 5's 32 x 8 lanes; the coupled world's 64
COUPLED_PREP_STEPS = 3  # coupled steps before phase 9 takes the kernels' inputs
COUPLED_PREP_FORCE = 15.0  # N on the paddle during them: it presses into the blob
LANE_CHECKS = 3  # lanes of a batched call held against the unbatched call
COUPLED_PARITY_LANES = 4
COUPLED_PARITY_SCENARIOS = 2  # x 2 samples = 4 lanes of one mppi_step
COUPLED_WORLD_LANES = 64
COUPLED_HORIZON = 10
CONFIG5_SCENARIOS = 32
CONFIG5_SAMPLES = 8
CONFIG5_STEPS = 50
CONFIG5_WARMUP_STEPS = 1  # the bench's warm-up rollout
# Phase 12 gates, fixed before the first run on the card: every scenario
# finite, no particle dropped, at least half of the 32 scenarios within 6 cm
# of the goal, median final error at most 6 cm.  The JAX package's TPU record
# of this configuration (22/32, 0.049 m, other draws) is a quality reference
# only.
CONFIG5_MIN_REACHED = 16
CONFIG5_MAX_MEDIAN_ERR = 0.06
# Phase 10 bounds, card float32 against CPU float64 on the same program, as
# a share of the float64 answer's scale (max(1, |x|) for positions, F and
# the rigid state; max |.| for velocities, impulses, controls and costs).
# The same comparison between float32 and float64 on a CPU gave the maxima
# in COUPLED_PARITY_CPU; the bounds leave two orders of magnitude above them.
COUPLED_PARITY_CPU = {
    "x": 1.7e-7, "v": 4.0e-6, "F": 5.2e-7, "C": 4.1e-6, "rigid": 5.3e-7,
    "impulses": 2.8e-6, "u_traj": 3.4e-6, "cost": 2.6e-7,
}
COUPLED_PARITY = {
    "x": 2e-5, "v": 4e-4, "F": 5e-5, "C": 4e-4, "rigid": 5e-5,
    "impulses": 3e-4, "u_traj": 3e-4, "cost": 3e-5,
}
# Phase 11: kernels against plain versions after the whole rollout (64 lanes,
# 100 substeps), max |x|, |v| and rigid-state difference in float32.  The
# blocked P2G's plain version against the scatter, both float32 on a CPU
# over 8 of these lanes, differed by 6.0e-8 (x) and 4.4e-7 (v).
COUPLED_MAX_DIFF_PATHS = 1e-4
COUPLED_LAYERS = ("coupling.substep", "coupling.contact", "coupled.sap_step")
COUPLED_TOP_LAYERS = ("coupling.substep", "coupled.sap_step")

# The dense implicit world (phase 13): config 5's paddle and blob with the
# dense implicit grid contact (CoupledWorld contact_model="implicit",
# tiled=False) and the solve parameters of the JAX bench's --implicit
# (benchmarks/bench_coupled_world.py:106-121): k 5e4, d 100, mu 0.3, at most
# 20 Newton iterations, 12 line-search points, 2 levels.
IMPLICIT_LANES = (64, 32)  # the JAX bench's K = 64, and the K = 32 cell
# The paddle starts with its face 5 mm inside the blob's box (at the bench's
# 0.31 m it is 3 cm away, which the bench's +-5 N do not close in 0.1 s) and
# is pushed by the bench's controls 5 sin(k) plus a constant 10 N.
IMPLICIT_PADDLE_X0 = 0.345
IMPLICIT_PUSH = 10.0
IMPLICIT_PARITY_LANES = 4
# Phase 13a bounds, card float32 against CPU float64 on one coupled step of
# 4 lanes (paddles at 0.345 + 1 mm a lane, at rest, 10, 5, 15, 12 N), as a
# share of the float64 answer's scale (as COUPLED_PARITY; the solves' final
# residuals (substeps, lanes) by their largest).  The same comparison between
# float32 and float64 on a CPU gave IMPLICIT_PARITY_CPU; the bounds leave two
# orders of magnitude above it.  Iteration counts: equal on the CPU; a solve
# that ends within float32 rounding of its tolerance may take one more or one
# fewer iteration on the card.
IMPLICIT_PARITY_CPU = {
    "x": 1.8e-7, "v": 1.8e-5, "F": 6.6e-7, "C": 8.5e-6, "rigid": 5.0e-7,
    "impulses": 4.3e-5, "residual": 5.7e-5,
}
IMPLICIT_PARITY = {name: 100 * value for name, value in IMPLICIT_PARITY_CPU.items()}
IMPLICIT_PARITY_ITERATIONS = 1
# Phase 13c: kernels against plain versions after the 64-lane rollout, max
# |difference| in the particles' x, the paddle's position q, the particles'
# v and the paddle's velocity.  x and q: 1e-4, as phase 11 (the blocked
# P2G's plain version against the scatter, both float32 on a CPU over 8 of
# these lanes, differed by 1.8e-7 in x).  The velocities: the dense world's
# float32 floor, its float32 rollout against its float64 one on a CPU
# (``python tests/tiled_world_spread.py --dense``: 4.935e-5 in x, 2.654e-5
# in q, 9.143e-4 in v, 4.278e-4 in the paddle's velocity), rounded up, as
# 16d's.  With the scatters in a fixed order both paths are the same in
# every run, and a lane's solve capped at 20 iterations keeps the two
# paths' rounding apart: 2.464e-4 in v and 1.647e-4 in the paddle's state
# on an NVIDIA H100 80GB HBM3 at 700.00 W, over the 1e-4 of the earlier
# single bound.
IMPLICIT_MAX_DIFF = {"x": 1e-4, "q": 1e-4, "v": 1e-3, "paddle v": 5e-4}
IMPLICIT_LAYERS = ("grid_contact.substep", "grid_contact.newton", "grid_contact.line_search",
                   "coupled.sap_step")
IMPLICIT_TOP_LAYERS = ("grid_contact.substep", "coupled.sap_step")
# The tiled world's (phase 16): a resident substep, with or without the
# contact, is one tiles.substep.
TILED_LAYERS = ("tiles.substep", "grid_contact.newton", "grid_contact.line_search",
                "coupled.sap_step")
TILED_TOP_LAYERS = ("tiles.substep", "coupled.sap_step")

# The cloth bagging world (phase 14): drake_tpu_torch.examples.mpm_bagging,
# the full width of examples/mpm_bagging.py (22 x 22 sheet, 32^3 grid, dt
# 5e-5, 20 substeps a 1 ms step, the ball on a floating joint).  The sheet,
# held at its corners only, sags under gravity with the falling ball: the
# ball first leaves its free fall at step 152 in both packages (on the CPU,
# tests/bagging_reference.py), is caught by step 190 and thrown back up.
# Of the demo's 2,200 steps: the fall and the first 8 steps of the catch;
# cut from 200 (the fall and the whole catch) to keep the script within its
# time limit with phase 20.
BAGGING_STEPS = 160
BAGGING_CONTACT_STEP = 152
# 14c: 5 steps with the kernels and with xla_only from 14b's state at step
# 60 (before contact) and at step 160 (in contact); cut from 10 to keep the
# script within its time limit with phase 22 (its bounds, measured over 10
# steps, stand).
BAGGING_PATH_STARTS = (60, 160)
BAGGING_PATH_STEPS = 5
# 14a: the ball at the demo's speed at contact, its centre at z = 0.405, so
# that the sheet's 4 central vertices lie 3.6 mm inside it (with the centre
# at 0.41, its lowest point on the sheet's plane, they lie 1.3 mm outside and
# one step makes no contact); lane 1 ball and sheet 1 cm along x.  The
# drape: simulate_cloth's 20 substeps, the sheet 5 mm above the sphere's
# top, its vertices perturbed by 2 mm from a generator seeded SEED so that
# the elastic forces act.
BAGGING_PARITY_Z = 0.405
BAGGING_PARITY_VZ = -0.626
BAGGING_PARITY_SHIFT = 0.01
DRAPE_PARITY_Z = 0.475
DRAPE_PARITY_SUBSTEPS = 20
# Phase 14a bounds, card float32 against CPU float64, as phase 13a's: 100x
# the same comparison between float32 and float64 on a CPU
# (``bagging_parity_values`` on the CPU in both types), which gave
# BAGGING_PARITY_CPU.
BAGGING_PARITY_CPU = {
    "implicit": {"x": 3.4e-7, "v": 2.0e-5, "C": 3.4e-5, "rigid": 8.9e-5,
                 "impulses": 1.4e-5, "residual": 6.9e-4},
    "penalty": {"x": 4.5e-7, "v": 2.4e-4, "C": 1.5e-3, "rigid": 2.0e-7, "impulses": 8.7e-6},
    "drape": {"x": 2.1e-7, "v": 2.4e-5, "C": 3.2e-5},
}
BAGGING_PARITY = {case: {name: 100 * value for name, value in values.items()}
                  for case, values in BAGGING_PARITY_CPU.items()}
BAGGING_PARITY_ITERATIONS = 1
# Phase 14b and 14d: the ball's height after step BAGGING_STEPS against the
# JAX package's CPU float32 run of the same steps (tests/bagging_reference.py
# --steps 160 [--penalty], JAX_PLATFORMS=cpu), within bounds fixed before the
# first run on the card, at step 200: there the port's CPU float32 and
# float64 runs ended 4.39e-5 m apart with the implicit contact (each solve
# stops at its tolerance, and the order of the sums moves where) and 2.85e-7
# m apart with the penalty.  At step 160 they end 3.06e-5 m apart (the JAX
# package's float32 run 4.8e-7 m from the port's) and 2.45e-7 m apart (the
# JAX package's float32 run equal to the port's): the bounds are 33x and
# 41x those spreads.
BAGGING_Z_END = {"implicit": 0.3069148063659668, "penalty": 0.30403661727905273}
BAGGING_Z_END_BOUND = {"implicit": 1e-3, "penalty": 1e-5}
# Phase 14c: kernels against plain versions, max |x| and |v| difference after
# the 10 steps.  Before contact, 1e-4 as phase 13c.  In contact the solves
# stop at their tolerance and the ball's spin (0.15 kg, r 0.07 m) feels
# every rounding: the same two summation orders, the blocked P2G's plain
# version against the scatter, both float32 on a CPU over steps 160-170
# (tests/bagging_reference.py --paths), differed by 2.15e-6 in x and 8.31e-4
# in v (and 0.30 rad/s in the ball's spin, so no bound is put on the
# rigid state).  Runs of this phase on an NVIDIA H100 80GB HBM3 at 700 W
# read at most 1.073e-6 in x (four runs, from 1.8e-7 up) and 3.094e-4 in v
# (five runs, from 2.6e-5 up); the bounds are 3x those largest readings.
BAGGING_MAX_DIFF_PATHS = {60: {"x": 1e-4, "v": 1e-4}, 160: {"x": 3.3e-6, "v": 9.3e-4}}
CLOTH_LAYERS = ("cloth.substep", "cloth.forces", "grid_contact.newton", "coupled.sap_step")
CLOTH_TOP_LAYERS = ("cloth.substep", "coupled.sap_step")

# The tile pipeline (phase 15): simulate_tiled's group sort every
# TILED_RESORT substeps (the reference bench's --resort), on phase 3's scenes;
# K3 over the coupled world's lanes.
TILED_RESORT = 8
K3_LANES = 64
# The tiled implicit world (phase 16): phase 13's world and solve on the tile
# pipeline.  16c's fixed count: about twice the dense world's 4.2 mean
# Newton iterations (PERF.md section 5).
TILED_UNROLL = 8
# Phase 16a bounds, as phase 13a's: 100x the same comparison between float32
# and float64 on a CPU (``implicit_parity_values(..., tiled=True)`` on the CPU
# in both types), which gave TILED_PARITY_CPU.
TILED_PARITY_CPU = {
    "x": 1.8e-7, "v": 1.8e-5, "F": 1.2e-6, "C": 1.5e-5, "rigid": 4.9e-7,
    "impulses": 5.2e-5, "residual": 5.8e-5,
}
TILED_PARITY = {name: 100 * value for name, value in TILED_PARITY_CPU.items()}
# Phase 16d: after the K = 64 rollout, the tiled world against the dense
# one and the kernels against xla_only, max |difference| in the particles'
# x, the paddle's position q, the particles' v and the paddle's velocity.
# x and q: 1e-4, tests/test_tiles_contact.py's bound for the two solves of
# the coupled world in float32 (and phase 13c's).  The velocities: the
# float32 floor of this rollout, the port's tiled float32 run against its
# float64 run on a CPU (tests/tiled_world_spread.py: 9.15e-4 in v, 4.28e-4
# in the paddle's velocity), rounded up.  A lane's solve that stops at its
# tolerance feels every rounding on the card, where the Newton's
# index_add_ sums in no fixed order: the same two paths, kernels and
# plain, read 1.648e-4, 2.47e-6 and 1.643e-4 apart in the paddle's state
# in three runs of this script (NVIDIA H100 80GB HBM3, 700.00 W).
TILED_MAX_DIFF = {"x": 1e-4, "q": 1e-4, "v": 1e-3, "paddle v": 5e-4}

# The quadrotor obstacle MPC, BASELINE config 3 (phase 17;
# drake_tpu_torch.benchmarks.bench_quadrotor_mpc: rk4 at dt 0.02, horizon 30,
# the RTI schedule).  It reaches none of K1-K3.
QUAD_PARITY_BATCH = 8
QUAD_BATCH = 4096  # BASELINE config 3's "4k batched scenarios", in one call
# 17b: 15 of the bench's 25 MPC steps (0.3 s of its 0.5), cut to keep the
# script within its time limit with phase 22; QUAD_JAX_PROGRESSING is the
# JAX package's count at this depth.
QUAD_STEPS = 15
PROFILE_QUAD_STEPS = 2
# Phase 17a bounds: 100x the same comparison between float32 and float64 on
# a CPU (``quad_parity_values`` on the CPU in both types), which gave
# QUAD_PARITY_CPU, as a share of the float64 answer's scale (max(1, |x|) for
# states, max |.| otherwise).
QUAD_PARITY_CPU = {
    "dynamics": 1.9e-7, "rk4 x_next": 9.8e-8, "rk4 Jacobian": 1.4e-7, "solve xs": 5.1e-5,
    "solve us": 7.2e-5, "solve cost": 3.4e-5, "rti xs": 1.4e-8, "rti us": 4.0e-8,
    "rti cost": 1.2e-7,
}
QUAD_PARITY = {name: 100 * value for name, value in QUAD_PARITY_CPU.items()}
# Phase 17b gate: the lanes progressing (the bench's test, final distance to
# the goal below the initial one less 5 cm) at least the JAX package's CPU
# float32 count on the same 4,096 initial states (the port's draws:
# ``JAX_PLATFORMS=cpu python tests/nlp_mpc_reference.py --draws ...``, which
# gave 4,093 at 25 steps and at QUAD_STEPS = 15), less 1% of the lanes.
QUAD_JAX_PROGRESSING = 4093
QUAD_PROGRESS_SLACK = 0.01
QUAD_LAYERS = ("ilqr.linearize", "ilqr.riccati", "ilqr.forward", "mpc.plant_step")

# The pendulum dircol, BASELINE config 1 (phase 18;
# drake_tpu_torch.examples.pendulum_dircol and benchmarks.bench_dircol_f32).
# It reaches none of K1-K3.
# 18b: the closed loop's CUDA graph against the eager loop over its first
# 1,000 of 4,000 steps (through the swing's first half), cut from all of
# them to keep the script within its time limit with phase 22.
DIRCOL_GRAPH_CHECK_STEPS = 1000
DIRCOL_PARITY = 1e-9  # 18a: card float64 against CPU float64, of the scale
DIRCOL_BATCH = 32  # the float32 bench's batch, in one call
# Phase 18c gate: the lanes feasible (violation < 1e-3) at least the
# JAX package's CPU float32 count on the same 32 guesses moved by at most 2
# ulps (the port's draws; ``tests/nlp_mpc_reference.py --nudge 2``): the
# float32 solve is chaotic in the last bit, and the JAX package's own count
# reads 17 on the guesses themselves and DIRCOL_JAX_FEASIBLE_NUDGED (moved
# -2, -1, +1, +2 ulps), so that a gate at 17 would be a coin toss.
DIRCOL_JAX_FEASIBLE = 17
DIRCOL_JAX_FEASIBLE_NUDGED = (16, 14, 13, 17)
DIRCOL_FEASIBLE_GATE = min((DIRCOL_JAX_FEASIBLE,) + DIRCOL_JAX_FEASIBLE_NUDGED)
PROFILE_SQP_ITERS = 4
DIRCOL_LAYERS = ("sqp.derivatives", "ipm.solve", "sqp.line_search")

# Config 2 and the LQR family (phase 19; drake_tpu_torch.examples
# acrobot_swingup, cart_pole_lqr, acrobot_spong, acrobot_spong_optimize and
# acrobot_lqr_estimator).  They reach none of K1-K3: their dense algebra is
# library calls (LU, lstsq, matrix_exp, eigh) and small elementwise ops.
LQR_PARITY = 1e-9  # 19a: card float64 against CPU float64, of the scale
LQR_PARITY_SYSTEMS = 64
# 19b: the JAX example on a CPU (JAX_PLATFORMS=cpu python
# tests/acrobot_reference.py --jax): 118 iLQR iterations, 300 SQP
# iterations (success on the violation, 6.8e-08), closed-loop error
# 9.00e-04 against the example's gate of 1e-3.
SWINGUP_JAX_CPU_ERR = 9.00e-4
SWINGUP_JAX_CPU_ITERS = (118, 300)
GRAPH_CHECK_STEPS = 200  # 19b: the closed loop's CUDA graph against eager
CEM_ITERS = 1  # 19c: acrobot_spong_optimize's --iters, cut from 4
PROFILE_ILQR_ITERS = 4
PROFILE_LOOP_STEPS = 200
ILQR_LAYERS = ("ilqr.linearize", "ilqr.riccati", "ilqr.forward")
TVLQR_LAYERS = ("tvlqr.linearize", "tvlqr.expm", "tvlqr.backward")
# The optimization layer (phase 20; tests/solver_cases.py's inputs).
OPT_PARITY = 1e-9  # 20a: card float64 against CPU float64, of the scale
OPT_QP_LANES = 4096  # config 3's lanes; n = 30 x 4 rotor thrusts
OPT_LCP_LANES = 4096
OPT_LCP_N = 27  # the iiwa world's 9 contacts x (normal + 2 friction)
OPT_CONIC_LANES = 1024
OPT_AL_LANES = 1024
OPT_BC_SCENARIOS = 1024
OPT_BC_BLOCKS = 64  # of 6 x 6: n = 384
OPT_CHECK_LANES = 64  # 20c: lanes held against the IPM and the CPU run
OPT_LEMKE_LANES = 16
# 20c's absolute LCP gates, on spd_lcps(4096, 27, seed=SEED): 20 lanes stall
# at the smoothing's floor, at residuals between 3e-7 and 3.3e-7, in the JAX
# package as in the port (tests/test_torch_solvers.py,
# test_lcp_fb_stalls_where_the_reference_does); every other lane ends below
# 1e-8.
OPT_LCP_MIN_BELOW = 4076  # lanes with a residual below 1e-8
OPT_LCP_MAX_RESIDUAL = 3.3e-7
# 20c's yardstick for the ADMM QP.  At the IPM's default tol 1e-9 a lane
# with a weakly active bound (s and z both ~sqrt(mu)) ends up to ~1e-4 off
# in x on these QPs (7.3e-5 in a run on an H100); at 1e-12 they agree with
# the ADMM within 1e-8.
OPT_IPM_TOL = 1e-12
# 20c's float32 conic ADMM, reported without a gate: cut from its default
# 4,000 iterations (which it ran to, 4.6 and 5.4 s on an H100) to keep the
# whole script within its time limit with phase 21.
OPT_F32_CONIC_ITERS = 1000

# Continuous-time and hybrid simulation (phase 21; drake_tpu_torch's
# systems/simulator.py, math/trajectories.py, primitives, diagram,
# controllers, multibody/plant, contact/plant, tamsi, pgs, comms and the
# examples bouncing_ball, rimless_wheel and compass_gait).  It reaches none
# of K1-K3.  21a bounds: 100x the same comparison between float32 and
# float64 on a CPU (``systems_parity_values`` on the CPU in both types),
# which gave SYS_PARITY_CPU, as a share of the float64 answer's largest
# magnitude.  The SAP and TAMSI solves there stop at 1e-3, a tolerance
# float32 reaches (at 1e-6 and 1e-8 its solves run to their caps).
SYS_PARITY_CPU = {
    "traj zoh value": 2.36e-08, "traj zoh derivative": 0.0, "traj foh value": 1.68e-07,
    "traj foh derivative": 1.13e-07, "traj hermite value": 2.23e-07,
    "traj hermite derivative": 9.59e-07, "traj spline value": 2.49e-07,
    "traj spline derivative": 2.41e-07, "traj bspline": 1.53e-07, "traj bezier": 1.55e-07,
    "traj pose": 1.86e-07, "adaptive x": 7.01e-07, "adaptive final time": 2.78e-08,
    "hybrid xs": 2.40e-06, "dense output": 4.00e-07, "linear system": 8.44e-08,
    "mlp": 1.25e-07, "discrete derivative": 4.31e-08, "first order hold": 1.68e-07,
    "diagram cascade": 1.09e-06, "diagram feedback": 3.28e-07, "pid closed loop": 2.18e-07,
    "inverse dynamics control": 8.96e-08, "joint stiffness control": 3.04e-08,
    "multibody plant": 1.68e-07, "continuous contact": 7.88e-07, "step with forces": 5.64e-07,
    "tamsi": 3.19e-06, "pgs gs": 5.32e-07, "pgs jacobi": 5.82e-07,
}
# A quantity the CPU's float32 gives exactly (the hold's derivative) is held
# at float32's epsilon, 1.2e-7.
SYS_PARITY = {name: max(100 * value, 1.2e-7) for name, value in SYS_PARITY_CPU.items()}
# Counts: equal, but the adaptive integrator's, where a float32 step's error
# ratio lies within rounding of 1 and is accepted in one type and rejected
# in the other (one lane of 8 on the CPU: 21 steps and 1 reject in float32,
# 20 and 0 in float64).
SYS_PARITY_COUNTS = {"adaptive steps": 1, "adaptive rejects": 1}
# 21b: the JAX package's float32 readings on the CPU
# (``JAX_PLATFORMS=cpu python tests/systems_reference.py``).
SYSTEMS_JAX_F32 = {
    "ball": {"apexes": [[0.40149998664855957, 0.15588220953941345],
                        [0.6599999666213989, 0.10357201099395752]],
             "n_apexes": 2, "ratio": 0.5059585668545757, "t_flight": 0.25849997997283936},
    "wheel": {"strikes": 19, "w_meas": 1.0950673818588257},
    "wheel_lanes": {"seconds": 3.0, "strikes_sum": 2660, "strikes_min": 0, "strikes_max": 4,
                    # each lane's strikes, one digit a lane in lane order
                    "strikes": (
                        "320034333430303233230233334433332332334333333323033230323320320323243034"
                        "343334433333333413440344243332342334033030334030334322322233332333433332"
                        "340333030323423033343223333432333443322332343323304303433232334033230303"
                        "334342003332333333032334243333340333433330333332333130332334334433433323"
                        "303033331433330333334323333232233330332333423023332303333023344233223332"
                        "333200324033233303330242333333333432303324003423234343433333323233331333"
                        "333332233243333322333333432330233321332032033322333333333332333334330342"
                        "032434333324333223203333334332223323333332233333223232333322103230332322"
                        "433333033332034333333332033333130233133332233323323343240223332312333332"
                        "333332330023403323322343400032333233203333223332334330333242333333434431"
                        "232323323333334343232332043132233323333332442304322333323012304223433243"
                        "033323343323303333234033333333233222433320230323332303433303333032322332"
                        "333333332033333333333333333032332333434333323243423333303033023333233330"
                        "223333003333303133333043333313233432333334334330232033333033032303333322"
                        "0200320420433303")},
    "compass": {"strikes": 17, "post_last": [-0.2706921100616455, 0.27141663432121277,
                                             1.0909202098846436, 0.37053006887435913],
                "d_last": 0.0064291199669241905},
}
# 21b's ball: 7,500 rk4 steps and the dense output at 3,001 times (the
# first 0.75 s of the demo's 1.5 s: its first two rebound apexes, which its
# checks read), cut from 15,000 and 6,001 to keep the script within its
# time limit with phase 22; SYSTEMS_JAX_F32["ball"] is the JAX package's
# reading at this depth.
STEPS_BALL = 7500
BALL_QUERIES = 3001
# 21b's bounds against the JAX run.  The float32 bisection's dt / 2^24 lies
# below t's ulp late in a 20 s run in both packages, so event times differ in
# their last bits: the strikes within 1, the apex ratio and apex-to-apex
# time within 1e-3 (the dense grid's step is 2.5e-4 s), the wheel's
# limit-cycle speed within 1e-3 rad/s.  The gait's last post-impact state
# within 10x its float32 floor: the port's float32 on the CPU ends 2.19e-4
# from its float64 there, the JAX package's float32 1.26e-5 (the card read
# 1.606e-4 from the JAX package's float32).
DEMO_BOUNDS = {"ball ratio": 1e-3, "ball t_flight": 1e-3, "strikes": 1, "wheel speed": 1e-3,
               "gait state": 2.2e-3}
# The graph-replayed loops bit for bit their eager loops: the ball's simulate
# over GRAPH_BALL_STEPS steps through a contact (it touches at step 20 and
# leaves at about step 90; the eager loop takes about 22 ms a step on an
# H100), the wheel's simulate_hybrid
# over the 21c lanes GRAPH_WHEEL_SECONDS deep (169 of them strike, the first
# at about 0.5 s).
GRAPH_BALL_STEPS = 120
GRAPH_WHEEL_SECONDS = 0.6
# 21c: the wheel over 1,024 pushes uniform in WHEEL_PUSH_RANGE from numpy's
# seed SEED, HYBRID_LANE_SECONDS deep, each lane's strikes held to the JAX
# package's on the same push (SYSTEMS_JAX_F32) within WHEEL_LANE_SLACK, and
# at most WHEEL_LANES_DIFFERING lanes differing at all: a lane differs only
# where a strike falls within float32 rounding of the window's end, and the
# port's float32 on the CPU differs in none of the 1,024.  LANE_CHECKS_SYS
# lanes are held to their one-lane runs.
HYBRID_LANES = 1024
HYBRID_LANE_SECONDS = 3.0
WHEEL_PUSH_RANGE = (0.9, 1.6)
WHEEL_LANE_SLACK = 1
WHEEL_LANES_DIFFERING = 8
LANE_CHECKS_SYS = 4
# The adaptive integrator over lanes: the oscillator to 2 pi at accuracy 1e-5,
# back to x0 within 1e-4 (the CPU's float32 5.4e-5 to 6.6e-5 over the draws
# of seeds 0-9), steps within 6 of the float64 run's: the CPU's float32
# differs by at most 4 over seeds 0-9 (at seeds 0, 2 and 4; 2 or 3 at the
# others), as the card did at seed 0.
ADAPTIVE_LANES = 1024
ADAPTIVE_ACCURACY = 1e-5
ADAPTIVE_RETURN_BOUND = 1e-4
ADAPTIVE_STEP_SLACK = 6
# TAMSI, PGS and SAP over the bench world's lanes; the first 64 held to the
# CPU's float64 solves at 100x the CPU's float32 spread on them (SAP 1.0e-6,
# TAMSI 5.9e-5, PGS 3.8e-7 of max |v|).
CONTACT_LANES = 1024
CONTACT_CHECK_LANES = 64
PGS_SWEEPS = 100
CONTACT_PARITY = {"sap": 1e-4, "tamsi": 6e-3, "pgs gs": 4e-5, "pgs jacobi": 4e-5}

# Phase 22, the discrete plant's constraints and the rigid-contact demos.
# 22a: card float64 against the port's CPU float64 on one SAP step of each
# feature, within RIGID_PARITY of each quantity's scale, over
# RIGID_PARITY_LANES seeded lanes.
RIGID_PARITY = 1e-9
RIGID_PARITY_LANES = 4
# 22a's solves run to a tight tolerance: at the default 1e-6 a lane whose
# residual ends near the tolerance takes one more or fewer iterations under
# the other device's rounding, and its velocity moves within 1e-6 (seen on
# the card: 1.6e-7).  The Newton count itself follows the last bit (a SAP
# lane at a line-search tie, ROADMAP.md): a lane's card count must equal
# the CPU's, or sit within the spread that nudging every input by each of
# RIGID_NUDGES (relative) gives on the CPU in the same run.
RIGID_SAP = dict(rel_tolerance=1e-10, max_iterations=60)
RIGID_NUDGES = (1e-15, -1e-15, 1e-14, -1e-14)
# 22b: each demo at a depth that covers its defining event (the full depths
# run apart, PERF.md): rod2d past its impact (~step 434 of 5e-4 s), the
# rolling sphere settled and past its slide-to-roll (~step 58), the humanoid
# past its first touch (~step 235), the allegro hand's load to its stops
# and the grasp closed on the ball (~step 300), the gripper through its
# first 0.25 s of shaking (its slide read from step 200, as the
# reference's), the four-bar and the strandbeest through part of a crank
# turn, the planar gripper through its press, the spatula through its
# first twist, the suspension whole (rk4 in a CUDA graph).  Each demo's
# ``smoke(depth, ...)`` returns its final states and the checks this depth
# reaches.  The demos run in processes of their own, RIGID_WORKERS at a
# time in the order listed (the longest first), beside phases 17-21.
RIGID_DEPTHS = {"simple_gripper": 250, "strandbeest": 0.2, "atlas_drop": 280,
                "spatula_slip_control": 120, "allegro_hand": [200, 300],
                "bushing_suspension": 4000, "four_bar": 0.25, "rolling_sphere": [30, 100],
                "rod2d": 500, "planar_gripper": 200}
RIGID_WORKERS = 4
# A reading's bound: this many times its float32 floor (the JAX package's
# |float32 - float64| on the CPU, tests/contact_reference.py), at least the
# minimum.
RIGID_FLOOR_FACTOR = 10.0
RIGID_MIN_BOUND = 1e-5
RIGID_REFERENCE = "tests/contact_reference.json"
# 22c: the allegro PD grasp over 1,024 lanes in one call (config 4's batch),
# through the fingers' closing on the ball, timed alone after 22b.
GRASP_LANES = 1024
GRASP_LANE_STEPS = 300
GRASP_CHECK_LANES = 64
RIGID_PROFILE_STEPS = 3
RIGID_LAYERS = ("sap.assemble", "sap.newton")

KERNELS = {
    # name: (route, source, the TPU kernel it replaces)
    "update_grid": ("cuda", "drake_tpu_torch/ops/csrc/mpm_kernels.cu",
                    "drake_tpu/ops/mpm_kernels.py:59"),
    "update_grid_blocks": ("cuda", "drake_tpu_torch/ops/csrc/mpm_kernels.cu",
                           "drake_tpu/ops/mpm_kernels.py:59"),
    "p2g_block": ("cuda", "drake_tpu_torch/ops/csrc/mpm_kernels.cu",
                  "drake_tpu/ops/mpm_kernels.py:267"),
    "g2p_block": ("cuda", "drake_tpu_torch/ops/csrc/mpm_kernels.cu",
                  "drake_tpu/ops/mpm_kernels.py:536"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    return out[0].strip()


def scene(mpm, scale, device):
    """The elastic block of benchmarks/bench_mpm_substeps.py (--scale)."""
    config = mpm.MpmConfig(grid_size=(64, 64, 128), dx=1.0 / 64, dt=1e-4)
    half = 0.1 * scale
    lo = (0.5 - half, 0.5 - half, 0.6 - half)
    hi = (0.5 + half, 0.5 + half, 0.6 + half)
    state = mpm.make_particle_block(config, lo, hi, device=device)
    return config.capacities_for(state.x.shape[0]), state


def time_ms(torch, fn, reps):
    """Mean device time of `fn` over `reps` back-to-back calls, by CUDA
    events (inputs and outputs stay warm in the L2 cache)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(torch, fn, reps, flush):
    """Mean device time of `fn` over `reps` calls, each between its own pair
    of events and after `flush` (larger than the L2 cache) was overwritten,
    so that no input or output of the call is cached."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for i in range(reps):
        flush.fill_(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def time_kernel(torch, kernel, plain, flush, nbytes, flops, chain=None):
    """Warm (kernel, plain, plain, kernel: both orders within one run) and
    cold times of a kernel beside its plain version and its bound; and, for
    a kernel that replaced a chain of calls, that chain's warm and cold
    times (chain, kernel, kernel, chain)."""
    warm = [time_ms(torch, kernel, KERNEL_REPS)]
    p_ms = [time_ms(torch, plain, KERNEL_REPS), time_ms(torch, plain, KERNEL_REPS)]
    warm.append(time_ms(torch, kernel, KERNEL_REPS))
    cold = time_cold_ms(torch, kernel, KERNEL_REPS, flush)
    least, bound_by = bound_ms(nbytes, flops)
    line = (f"kernel warm {warm!r} ms, cold {cold!r} ms, plain {p_ms!r} ms, bound {least!r} "
            f"ms ({nbytes} bytes, {flops} operations: {bound_by}), share of bound warm "
            f"{least * 2 / sum(warm):.3f} cold {least / cold:.3f}")
    out = {"ms": sum(warm) / 2, "cold_ms": cold, "plain_ms": sum(p_ms) / 2,
           "bound_ms": least, "bound_by": bound_by}
    if chain is not None:
        c_ms = [time_ms(torch, chain, KERNEL_REPS)]
        k_ms = [time_ms(torch, kernel, KERNEL_REPS), time_ms(torch, kernel, KERNEL_REPS)]
        c_ms.append(time_ms(torch, chain, KERNEL_REPS))
        c_cold = time_cold_ms(torch, chain, KERNEL_REPS, flush)
        out.update(replaced_chain_ms=sum(c_ms) / 2, replaced_chain_cold_ms=c_cold)
        line += (f"; the chain it replaced warm {c_ms!r} ms (kernel beside it {k_ms!r} ms), "
                 f"cold {c_cold!r} ms")
    return out, line


def time_empty_launch(torch, mk, blocks, threads, dev):
    """Warm ms of an empty kernel of `blocks` CTAs of `threads`, back to
    back: what a launch of that shape costs with no work."""
    return time_ms(torch, lambda: mk.empty_launch_cuda(blocks, threads, dev), KERNEL_REPS)


def bound_ms(nbytes, flops):
    """(least time in ms the card could take, what bounds it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


# Bounds on |kernel - plain|, as (label, last-axis columns, bound) from the
# plain output: 1e-5 of the output's scale, for float32 sums taken in another
# order (and with fused multiply-adds).
def bound_k1(ref):
    return [("v", slice(None), 1e-5 * max(1.0, float(ref.abs().max())))]


def bound_k2(ref):
    return [("all", slice(None), 1e-5 * float(ref.abs().max()))]


# K1 from block windows against its plain version: the same windows, summed
# in the same order; only the rounding of B (x_node - o) (three products,
# fused multiply-adds on the card) and the order of gravity's multiply-add
# differ.  With the mass (phase 13), the mass and the velocity each within
# 1e-5 of their largest magnitude.
def bound_k1_blocks(ref):
    return [("v", slice(None), 1e-5 * float(ref.abs().max()))]


def k1_needed_bytes(mass):
    """The bytes K1's function needs: every node's mass read and velocity (3)
    written, and the momentum (3) of the nodes with mass only -- a node
    without mass gets velocity 0 whatever its momentum, and the kernel reads
    no other."""
    return 4 * (4 * mass.numel() + 3 * int((mass > 0).sum()))


def k1_blocks_work(mk, active, grid_size, with_mass=False):
    """(bytes, operations) K1 from block windows needs: the 13 live channels
    of every active block that is no sentinel and the active ids read once,
    12 B of velocity written per node, and with the mass 4 B more; 22
    operations per window node of a live block (u0 + B (x_node - o) and the
    four sums) and 9 per node (the update; the mass is one of the sums)."""
    nx, ny, nz = grid_size
    live = int((active < (nx // 4) * (ny // 4) * (nz // 4)).sum())
    nodes = active[..., 0].numel() * nx * ny * nz
    out_bytes = (16 if with_mass else 12) * nodes
    return (4 * live * 13 * mk.P2G_NODES + 8 * active.numel() + out_bytes,
            22 * live * mk.P2G_NODES + 9 * nodes)


def k1_blocks_launch(active, grid_size, sms):
    """(CTAs, threads) of K1 from block windows on a card of `sms` SMs, as
    its launcher splits the work: tiles of (grid blocks (bx, by), a run of 8
    along z), at most 32 a CTA, at most about 4 CTAs of 512 threads per SM
    over all lanes, each CTA within one lane."""
    nx, ny, nz = grid_size
    lanes = active[..., 0].numel()
    tiles = (nx // 4) * (ny // 4) * -(-(nz // 4) // 8)
    per = min(32, -(-tiles * lanes // (4 * sms)))
    return lanes * -(-tiles // per), 512


def k2_live_bytes(mk, sort):
    """The bytes of K2's work that the P2G uses downstream: the packed
    columns 0:28 of every row, the block table, and the output of the blocks
    that hold particles in their 13 value channels only (the sentinel
    blocks' rows and the 3 pad channels are written and thrown away)."""
    live = int((sort.counts > 0).sum())
    return live, 4 * (sort.packed.shape[0] * 28 + live * 13 * mk.P2G_NODES
                      + 2 * sort.starts.numel())


def kernel_cases(torch, np, mpm, mk, config, state):
    """(name, kernel call, plain call, error bounds, bytes, operations, the
    chain of calls the kernel replaced or None, the output rows to compare
    or None for all) at the substep inputs of `state`, perturbed so that
    stress, u0 and C are all nonzero.  Bytes count what the function needs
    of every input, read once, and every output written once: K1 the
    momentum of the nodes with mass only (k1_needed_bytes), K1 from block
    windows what k1_blocks_work counts, K2 packed columns 0:28, K3 what
    k3_work counts.
    Operations count the float32 multiplies and adds of the taken
    particles.  K1 and K1 from block windows both take K2's plain output."""
    rng = np.random.default_rng(SEED)
    n = state.x.shape[0]
    dev = state.x.device
    v = torch.as_tensor(0.1 * rng.standard_normal((n, 3)), dtype=torch.float32, device=dev)
    F = torch.as_tensor(
        np.eye(3) + 0.01 * rng.standard_normal((n, 3, 3)), dtype=torch.float32, device=dev
    )
    s = state.replace(v=v, F=F)
    pmax = config.block_capacity
    dxi2 = 4.0 / config.dx**2
    sort = mpm.sort_particles(config, s)
    p2g_args = (sort.packed, sort.starts, sort.counts, pmax)
    win = mk.p2g_block_reference(*p2g_args)  # K2's plain output
    grid = mpm._grid_from_blocks(config, sort, win)
    mass = grid.mass.contiguous()
    mom = grid.momentum.movedim(-1, 0).contiguous()
    grid_args = (mass, mom, config.dt, config.gravity, config.wall_width)
    vel = mk.update_grid_reference(*grid_args)
    blocks_args = (win, sort.active, config.grid_size, config.dx, config.dt, config.gravity,
                   config.wall_width)
    node_pos = mpm.window_node_pos(config, sort.active, torch.float32)
    vel_ext = mpm.block_velocity_windows(config, vel.movedim(0, -1), sort.active, node_pos)
    g2p_args = (sort.packed, vel_ext, sort.starts, sort.counts, pmax, dxi2, config.dt)
    k3_bounds = bound_k3(dxi2)

    A = sort.starts.shape[0]
    taken = n - int(sort.dropped)
    table_bytes = 2 * A * 4  # starts and counts
    k1_bytes = k1_needed_bytes(mass)
    k2_bytes = 4 * (n * 28 + A * mk.P2G_NV * mk.P2G_NODES) + table_bytes
    k3_bytes, k3_flops = k3_work(mk, taken, sort.counts)
    k1_flops = mass.numel() * 3 * 2
    k2_flops = taken * 27 * (2 + 2 * 13)
    k1b_bytes, k1b_flops = k1_blocks_work(mk, sort.active, config.grid_size)
    rows = mk.taken_rows(sort.starts, sort.counts, n, pmax)
    return [
        ("update_grid", lambda: mk.update_grid_cuda(*grid_args),
         lambda: mk.update_grid_reference(*grid_args), bound_k1, k1_bytes, k1_flops, None, None),
        ("update_grid_blocks", lambda: mk.update_grid_blocks_cuda(*blocks_args),
         lambda: mk.update_grid_blocks_reference(*blocks_args), bound_k1_blocks, k1b_bytes,
         k1b_flops, lambda: mpm.update_grid(config, mpm._grid_from_blocks(config, sort, win)),
         None),
        ("p2g_block", lambda: mk.p2g_block_cuda(*p2g_args),
         lambda: mk.p2g_block_reference(*p2g_args), bound_k2, k2_bytes, k2_flops, None, None),
        ("g2p_block", lambda: mk.g2p_block_cuda(*g2p_args),
         lambda: mk.g2p_block_reference(*g2p_args), k3_bounds, k3_bytes, k3_flops, None, rows),
    ]


def bound_k3(dxi2):
    """K3's bounds on |kernel - plain|, from the plain output."""

    def bounds(ref):
        # C = dxi2 (sum w v n - v x) is a difference of terms of size
        # dxi2 |v| |x|: its rounding scales with that, not with |C|.
        vmax = float(ref[..., 3:6].abs().max())
        xmax = max(1.0, float(ref[..., 0:3].abs().max()))
        return [
            ("x,v,F", slice(0, 15), 1e-5 * max(1.0, float(ref[..., :15].abs().max()))),
            ("C", slice(15, 24), 1e-5 * dxi2 * vmax * xmax),
        ]

    return bounds


def k3_work(mk, taken, counts):
    """(bytes, operations) K3 needs: packed columns 16:40 read and 24 outputs
    written for each taken row, the window of each block that holds
    particles (the others' windows are never read) and the block table read
    once; 27 taps x 12 channels of multiply-adds and the update a row."""
    live = int((counts > 0).sum())
    nbytes = 4 * (taken * (mk.PACKED_COLS - 16 + mk.G2P_OUT)
                  + live * mk.P2G_NODES * mk.G2P_VEL_CH) + 2 * counts.numel() * 4
    return nbytes, taken * (27 * (2 + 2 * mk.G2P_VEL_CH) + 150)


def kernel_parity(torch, name, kernel, plain, bounds, rows=None):
    """(max |kernel - plain|, within the bounds, their line), on the output
    rows `rows` (a mask) where given: K3 writes the rows its blocks take."""
    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    if rows is not None:
        got, ref = got[rows], ref[rows]
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got - ref).abs()
    ok, parts = True, []
    for label, cols, bound in bounds(ref):
        err = float(diff[..., cols].max())
        ok = ok and err <= bound
        parts.append(f"{label} {err:.3e} <= {bound:.3e}")
    return float(diff.max()), ok, "; ".join(parts)


MPM_PATHS = ("simulate", "blocked", "dense")


def run_path(torch, mpm, path, config, state, n):
    """Drive `n` substeps of one of MPM_PATHS; returns (state, device ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if path == "simulate":
        out = mpm.simulate(config, state, n)
    elif path == "blocked":
        out = state
        for _ in range(n):
            out = mpm.mpm_substep_blocked(config, out)
    else:  # "dense": the transfer functions composed by hand
        out = state
        for _ in range(n):
            grid = mpm.particle_to_grid(config, out)
            out = mpm.grid_to_particle(config, out, mpm.update_grid(config, grid))
            out = out.replace(dropped=grid.dropped)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _device_us(avg):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(avg, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def profile_paths(torch, mpm, scales, card):
    """torch.profiler over PROFILE_SUBSTEPS substeps of the two substep
    paths: device time, busy share and kernel count per substep, and the
    hand-written kernels' device time per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for scale, (config, state) in scales.items():
        n = state.x.shape[0]
        for path in ("simulate", "blocked"):
            run_path(torch, mpm, path, config, state, WARMUP_SUBSTEPS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_path(torch, mpm, path, config, state, PROFILE_SUBSTEPS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_SUBSTEPS
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run_path(torch, mpm, path, config, state, PROFILE_SUBSTEPS)
                torch.cuda.synchronize()
                traced_ms = (time.perf_counter() - t0) * 1e3
            avgs = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
            device_ms = sum(_device_us(a) for a in avgs) / 1e3
            check(device_ms > 0, "the profiler recorded no device time")
            count = sum(a.count for a in avgs)
            print(f"[profile scale={scale} n={n}] {path} kernel: wall "
                  f"{wall_ms!r} ms/substep (no profiler), device kernels "
                  f"{device_ms / PROFILE_SUBSTEPS!r} ms/substep, busy "
                  f"{device_ms / traced_ms!r}, "
                  f"{count / PROFILE_SUBSTEPS!r} kernels/substep [{card}]")
            for a in avgs:
                for kernel in ("update_grid_kernel", "update_grid_blocks_kernel",
                               "p2g_block_kernel", "g2p_block_kernel"):
                    if kernel in a.key:
                        print(f"[profile scale={scale} n={n}] {path}: {kernel} "
                              f"{_device_us(a) / 1e3 / a.count!r} ms/call "
                              f"x {a.count} [{card}]")


def order_contract(torch, mpm, mk, config, state):
    """K2 on rows that break its contract: the fullest block's rows reversed,
    so that they stay that block's but are no longer sorted by cell.  The
    kernel must answer that block with NaN in its 13 live channels and every
    other block exactly as on the sorted rows."""
    sort = mpm.sort_particles(config, state)
    a = int(sort.counts.argmax())
    first, count = int(sort.starts[a]), int(sort.counts[a])
    cells = sort.packed[first:first + count, 25:28]
    check(bool((cells != cells[0]).any()), "the fullest block holds one cell only")
    rows = torch.arange(state.x.shape[0], device=sort.packed.device)
    rows[first:first + count] = rows[first:first + count].flip(0)
    args = (sort.starts, sort.counts, config.block_capacity)
    good = mk.p2g_block_cuda(sort.packed, *args)
    bad = mk.p2g_block_cuda(sort.packed[rows].contiguous(), *args)
    torch.cuda.synchronize()
    others = torch.ones(sort.starts.shape[0], dtype=torch.bool, device=good.device)
    others[a] = False
    check(bool(torch.isfinite(good).all()), "p2g_block: non-finite on sorted rows")
    check(bool(torch.isnan(bad[a, :13]).all()) and bool((bad[a, 13:] == 0).all()),
          "p2g_block: a block out of cell order was not marked NaN")
    check(torch.equal(bad[others], good[others]),
          "p2g_block: a block out of cell order changed another block")
    print(f"[parity n={state.x.shape[0]}] p2g_block: block {a} ({count} rows) reversed "
          f"-> NaN in its channels 0:13, the other {int(others.sum())} blocks unchanged ok")


def mpc_parity(torch, bench, ilqr, dev, card):
    """Phase 6: the bench program in float32 on the card against float64 on
    the CPU, at batch MPC_PARITY_BATCH from the bench's initial states."""
    out = {}
    for device, dtype in ((torch.device("cpu"), torch.float64), (dev, torch.float32)):
        _, x0s, info = bench.build_rollout(MPC_PARITY_BATCH, 1, device=device, dtype=dtype)
        p, lim = info["params"], info["u_limit"]
        us = info["us0"].expand(MPC_PARITY_BATCH, -1, -1)
        # Torques off gravity compensation, so that the arm moves.
        u = us[:, 0] + torch.linspace(-5.0, 5.0, 7, dtype=dtype, device=device)
        t = torch.zeros(MPC_PARITY_BATCH, dtype=dtype, device=device)
        res = ilqr.rti_solve(info["plan_step"], info["running_cost"], info["final_cost"],
                             p, x0s, us, dt=info["h"], u_lower=-lim, u_upper=lim)
        values = {
            "planning x_next": (info["plan_step"](p, x0s, u, t), MPC_PARITY_STATE, True),
            "plant x_next": (info["plant_step"](p, x0s, u, t), MPC_PARITY_STATE, True),
            "planning Jacobian": (ilqr.linearize(info["plan_step"], p, x0s, u, t)[1],
                                  MPC_PARITY_JACOBIAN, False),
            "rti xs": (res.xs, MPC_PARITY_STATE, True),
            "rti us": (res.us, MPC_PARITY_RTI, False),
            "rti cost": (res.cost, MPC_PARITY_RTI, False),
        }
        out[device.type] = {k: (v.detach().double().cpu(), b, s) for k, (v, b, s) in values.items()}
    torch.cuda.synchronize()
    for name, (ref, rel, is_state) in out["cpu"].items():
        got = out["cuda"][name][0]
        check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite on the card")
        scale = float(ref.abs().max())
        bound = rel * (max(1.0, scale) if is_state else scale)
        err = float((got - ref).abs().max())
        ok = err <= bound
        print(f"[mpc parity batch={MPC_PARITY_BATCH}] {name} {tuple(ref.shape)}: "
              f"max|f32 card - f64 cpu| = {err:.3e} (<= {bound:.3e}, {rel:.0e} of "
              f"{'max(1, max|x|)' if is_state else 'max|ref|'} = {scale:.3e}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"MPC parity: {name} off by {err:.3e} (bound {bound:.3e})")


def mpc_main_path(torch, bench, mk, dev, card):
    """Phase 7: the full-width rollout, timed; returns what phase 8 needs."""
    t0 = time.perf_counter()
    warm, x0s, _ = bench.build_rollout(MPC_BATCH, MPC_WARMUP_STEPS, device=dev)
    warm(x0s)
    torch.cuda.synchronize()
    print(f"[mpc warm-up] batch={MPC_BATCH}, {MPC_WARMUP_STEPS} steps: "
          f"{time.perf_counter() - t0!r} s [{card}]")
    rollout, x0s, info = bench.build_rollout(MPC_BATCH, MPC_STEPS, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = rollout(x0s)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mk.LAUNCHES)
    device_s = start.elapsed_time(end) / 1e3
    peak = torch.cuda.max_memory_allocated()
    q = bench.quality(res, x0s, info)
    solves = MPC_BATCH * MPC_STEPS
    print(f"[mpc run] batch={MPC_BATCH} horizon={info['horizon']} steps={MPC_STEPS} float32 "
          f"TF32 off: wall {wall!r} s (CUDA events {device_s!r} s), {solves / wall!r} solves/s, "
          f"{wall / MPC_STEPS * 1e3!r} ms per MPC step [{card}]")
    print(f"[mpc run] {q['progressing']}/{MPC_BATCH} progressing, median final box error "
          f"{q['median_err']!r} m (initial {q['median_err0']!r} m), finite={q['finite']}, "
          f"lanes frozen by the x_bound/finite guard {q['frozen_lanes']} "
          f"({q['frozen_steps']} steps), non-finite plans {q['rejected_plans']} [{card}]")
    print(f"[mpc run] peak memory {peak} B ({peak / 2**30:.3f} GiB); K1-K3 launches on "
          f"this path {json.dumps(launches)} (it reaches none of them) [{card}]")
    check(q["finite"], "MPC rollout: non-finite state")
    check(q["progressing"] >= MPC_MIN_PROGRESSING * MPC_BATCH,
          f"MPC rollout: {q['progressing']}/{MPC_BATCH} lanes progressing")
    check(q["median_err"] <= MPC_MAX_ERR_RATIO * q["median_err0"],
          f"MPC rollout: median error {q['median_err']:.4f} above "
          f"{MPC_MAX_ERR_RATIO} x {q['median_err0']:.4f}")
    return res, info


def profile_layers(torch, run, n, layers, top_layers, tag, unit, card, named=()):
    """torch.profiler over `run` (n units of work, after one warm-up call and
    one timed call without the profiler): device ms, busy share and kernel
    launches per unit, and per layer (a ``record_function`` range) the
    device time read off the device timeline -- the kernels that start
    inside the span of one of the range's annotations (a nested range's
    kernels count in each enclosing one; the profiler's own per-range
    totals count some device time twice) -- beside the range's inclusive
    host time, and what lies outside every range of `top_layers`.  Each
    string of `named` gets a line: the kernels whose names hold it (zero
    where none ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    # The ranges also appear on the device's timeline as annotations that
    # span their kernels: they are no kernels of their own.
    kernels = [a for a in avgs if a.device_type == DeviceType.CUDA
               and not getattr(a, "is_user_annotation", False) and a.key not in layers]
    device_ms = sum(_device_us(a) for a in kernels) / 1e3
    check(device_ms > 0, "the profiler recorded no device time")
    count = sum(a.count for a in kernels)
    print(f"[profile {tag}] wall {wall_ms!r} ms/{unit} (no profiler), {traced_ms / n!r} "
          f"traced; device kernels {device_ms / n!r} ms/{unit}, busy "
          f"{device_ms / traced_ms!r}, {count / n!r} kernels/{unit} [{card}]")
    spans = {layer: [] for layer in layers}
    timeline = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name in spans:
            spans[e.name].append((e.time_range.start, e.time_range.end))
        elif not getattr(e, "is_user_annotation", False):
            timeline.append((e.time_range.start, e.time_range.end - e.time_range.start))
    for layer in spans:
        spans[layer].sort()

    def inside(layer, t):
        i = bisect.bisect_right(spans[layer], (t, float("inf"))) - 1
        return i >= 0 and t < spans[layer][i][1]

    timeline_ms = sum(d for _, d in timeline) / 1e3
    outside = sum(d for t, d in timeline
                  if not any(inside(layer, t) for layer in top_layers)) / 1e3

    # By launch: the kernels that the ops inside a range's calls launched
    # (the profiler ties each kernel to the op that launched it).  A range's
    # span on the device runs from the first to the last kernel that it
    # launches outside its nested ranges, so a range that opens and closes
    # with nested ranges (cloth.substep) spans only its middle there.
    annotations = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}

    def launched_us(e):
        return (sum(k.duration for k in e.kernels if k.name not in annotations)
                + sum(launched_us(c) for c in e.cpu_children))

    result = {"device_ms": device_ms / n, "timeline_ms": timeline_ms / n, "layers": {}}
    for layer in layers:
        check(spans[layer], f"no device annotation of {layer} in the trace")
        dev = sum(d for t, d in timeline if inside(layer, t)) / 1e3
        launched = sum(launched_us(e) for e in prof.events()
                       if e.name == layer and e.device_type == DeviceType.CPU) / 1e3
        rows = [a for a in avgs if a.key == layer and a.device_type == DeviceType.CPU]
        host = sum(float(a.cpu_time_total) for a in rows) / 1e3
        calls = sum(a.count for a in rows)
        print(f"[profile {tag}] {layer}: device kernels {dev / n!r} ms/{unit} ({launched / n!r} "
              f"by launch), host {host / n!r} ms/{unit} (both inclusive), {calls / n!r} "
              f"calls/{unit} [{card}]")
        result["layers"][layer] = (dev / n, host / n)
    print(f"[profile {tag}] outside {'/'.join(top_layers)}: device kernels "
          f"{outside / n!r} ms/{unit}; all kernels on the timeline {timeline_ms / n!r} "
          f"ms/{unit} [{card}]")
    for name in named:
        hits = [a for a in kernels if name in a.key]
        print(f"[profile {tag}] kernels named *{name}*: "
              f"{sum(_device_us(a) for a in hits) / 1e3 / n!r} ms/{unit}, "
              f"{sum(a.count for a in hits) / n!r} launches/{unit} [{card}]")
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    for a in top:
        print(f"[profile {tag}] kernel {a.key[:90]}: {_device_us(a) / 1e3 / n!r} ms/{unit}, "
              f"{a.count / n!r} launches/{unit} [{card}]")
    return result


def mpc_profile(torch, mpc, res, info, card):
    """Phase 8: torch.profiler over PROFILE_MPC_STEPS RTI MPC steps from the
    main path's state after a third of its steps.  The layers' ranges: what
    no top-level range holds is the cost sums, the plan guard and the lane
    guards between them."""
    x_start = res.xs[:, MPC_STEPS // 3].contiguous()
    us_warm = info["us0"].expand(x_start.shape[0], -1, -1)
    lim = info["u_limit"]

    def run():
        return mpc.ilqr_mpc_rollout(
            info["plan_step"], info["running_cost"], info["final_cost"], info["params"],
            x_start, us_warm, PROFILE_MPC_STEPS, dt=info["h"], u_lower=-lim, u_upper=lim,
            options=info["light_options"], sim_dynamics=info["plant_step"], x_bound=50.0,
            plan_guard=info["plan_guard"])

    profile_layers(torch, run, PROFILE_MPC_STEPS, MPC_LAYERS, MPC_TOP_LAYERS,
                   f"mpc batch={x_start.shape[0]} RTI", "MPC step", card)


def coupled_inputs(torch, np, paddle_blob, lanes, dev):
    """Phase 9's inputs: config 5's world over `lanes` lanes (blob and
    paddle moved by offsets 0.04 (U - 0.5) from a generator seeded SEED, as
    the bench moves its scenarios; the paddle's face in the blob's first
    layer, moving at 0.2 m/s), after COUPLED_PREP_STEPS coupled steps under
    COUPLED_PREP_FORCE, with v and F perturbed from SEED so that stress, u0
    and C are all live.  Returns (config, particle state)."""
    w = paddle_blob.build(device=dev)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    dx0 = 0.04 * (torch.rand(lanes, generator=gen, dtype=torch.float64) - 0.5)
    s = paddle_blob.shifted(paddle_blob.lanes(w.state0, lanes), dx0.float().to(dev))
    rigid = s.rigid.clone()
    rigid[:, 0] += 0.04
    rigid[:, 1] = 0.2
    s = s._replace(rigid=rigid)
    force = torch.full((lanes, 1), COUPLED_PREP_FORCE, device=dev)
    for _ in range(COUPLED_PREP_STEPS):
        s = w.world.step(w.params, s, force)
    p = s.particles
    rng = np.random.default_rng(SEED)
    shape = tuple(p.x.shape)
    v = p.v + torch.as_tensor(0.1 * rng.standard_normal(shape), dtype=torch.float32, device=dev)
    F = p.F + torch.as_tensor(0.01 * rng.standard_normal(shape + (3,)), dtype=torch.float32,
                              device=dev)
    return w.world.mpm_config, p.replace(v=v, F=F)


def lane_kernel_cases(mpm, mk, config, state):
    """(name, kernel call, plain call, error bounds, bytes, operations, the
    replaced chain or None) of both K1 and K2 over the lanes of `state`: K1
    on the lanes' grids from the plain scatter P2G, K2 on the lanes' block
    sort, K1 from block windows on K2's output (the kernel's: the plain K2
    is held against it first).  Bytes and operations are counted as in
    kernel_cases."""
    pmax = config.block_capacity
    grid = mpm.particle_to_grid_scatter(config, state)
    mass = grid.mass.contiguous()
    mom = grid.momentum.movedim(-1, -4).contiguous()
    grid_args = (mass, mom, config.dt, config.gravity, config.wall_width)
    sort = mpm.sort_particles(config, state)
    p2g_args = (sort.packed, sort.starts, sort.counts, pmax)
    win = mk.p2g_block_cuda(*p2g_args)
    blocks_args = (win, sort.active, config.grid_size, config.dx, config.dt, config.gravity,
                   config.wall_width)
    rows = sort.packed.shape[0]
    blocks = sort.starts.numel()
    taken = rows - int(sort.dropped.sum())
    k1_bytes = k1_needed_bytes(mass)
    k2_bytes = 4 * (rows * 28 + blocks * mk.P2G_NV * mk.P2G_NODES) + 2 * blocks * 4
    k1b_bytes, k1b_flops = k1_blocks_work(mk, sort.active, config.grid_size)
    return [
        ("update_grid", lambda: mk.update_grid_cuda(*grid_args),
         lambda: mk.update_grid_reference(*grid_args), bound_k1, k1_bytes,
         mass.numel() * 3 * 2, None),
        ("p2g_block", lambda: mk.p2g_block_cuda(*p2g_args),
         lambda: mk.p2g_block_reference(*p2g_args), bound_k2, k2_bytes,
         taken * 27 * (2 + 2 * 13), None),
        ("update_grid_blocks", lambda: mk.update_grid_blocks_cuda(*blocks_args),
         lambda: mk.update_grid_blocks_reference(*blocks_args), bound_k1_blocks, k1b_bytes,
         k1b_flops, lambda: mpm.update_grid(config, mpm._grid_from_blocks(config, sort, win))),
    ], grid_args, sort, blocks_args


def lane_checks(torch, mpm, mk, tree_map, config, state, grid_args, sort, blocks_args, outs,
                card):
    """Lane l of the batched calls against the unbatched calls on lane l:
    both K1 on lane l's input (bit for bit), K2 on lane l's own block sort
    of lane l's particles (its table equal to the batched one's lane l, its
    output within the K2 bound).  Then K1 from block windows on lane 0's
    active ids (and windows) reversed: lane 0 must come out NaN and every
    other lane as before."""
    lanes, n = state.x.shape[:2]
    vel, out, vel_b = outs["update_grid"], outs["p2g_block"], outs["update_grid_blocks"]
    for lane in sorted({0, lanes // 2, lanes - 1}):
        vel_l = mk.update_grid_cuda(grid_args[0][lane], grid_args[1][lane], *grid_args[2:])
        vel_bl = mk.update_grid_blocks_cuda(blocks_args[0][lane], blocks_args[1][lane],
                                            *blocks_args[2:])
        one = mpm.sort_particles(config, tree_map(lambda t: t[lane], state))
        out_l = mk.p2g_block_cuda(one.packed, one.starts, one.counts, config.block_capacity)
        torch.cuda.synchronize()
        check(torch.equal(vel_l, vel[lane]), f"update_grid: lane {lane} differs from its own call")
        check(torch.equal(vel_bl, vel_b[lane]),
              f"update_grid_blocks: lane {lane} differs from its own call")
        check(torch.equal(one.active, sort.active[lane])
              and torch.equal(one.counts, sort.counts[lane])
              and torch.equal(one.starts + lane * n, sort.starts[lane]),
              f"sort_particles: lane {lane}'s block table differs from its own sort")
        err = float((out_l - out[lane]).abs().max())
        bound = bound_k2(out[lane])[0][2]
        print(f"[lanes L={lanes}] lane {lane}: update_grid and update_grid_blocks equal to "
              f"their own calls; block table equal; p2g_block max|batched - own| = "
              f"{err:.3e} (<= {bound:.3e}) {'ok' if err <= bound else 'FAIL'} [{card}]")
        check(err <= bound, f"p2g_block: lane {lane} differs from its own call")
    win, active = blocks_args[0].clone(), blocks_args[1].clone()
    win[0], active[0] = win[0].flip(0), active[0].flip(0)
    bad = mk.update_grid_blocks_cuda(win, active, *blocks_args[2:])
    torch.cuda.synchronize()
    check(bool(torch.isnan(bad[0]).all()),
          "update_grid_blocks: a lane with its active ids reversed was not marked NaN")
    check(torch.equal(bad[1:], vel_b[1:]),
          "update_grid_blocks: a lane with its active ids reversed changed another lane")
    print(f"[lanes L={lanes}] update_grid_blocks: lane 0's active ids reversed -> NaN in "
          f"lane 0, the other {lanes - 1} lanes unchanged ok [{card}]")


def coupled_parity_values(torch, paddle_blob, cpl, mppi, tree_map, device, dtype):
    """Phase 10's quantities of config 5's world on `device` in `dtype`:
    COUPLED_PARITY_LANES lanes with the paddle's face in the blob (0.345 m +
    4 mm a lane, 0.2 m/s, torques 2, -1, 0.5, 4 N) through one coupled step
    (its 10 substeps' impulses taken again by simulate_coupled), and one
    mppi_step of 2 scenarios x 2 samples (the first two lanes) over the
    bench's horizon of 10 coupled steps, its perturbations drawn on the CPU
    from SEED in float64."""
    w = paddle_blob.build(device=device, dtype=dtype)
    L = COUPLED_PARITY_LANES
    kw = dict(dtype=dtype, device=device)
    s = paddle_blob.lanes(w.state0, L)
    q = 0.345 + 0.004 * torch.arange(L, **kw)
    s = s._replace(rigid=torch.stack([q, torch.full_like(q, 0.2)], dim=-1))
    tau = torch.tensor([[2.0], [-1.0], [0.5], [4.0]], **kw)
    world = w.world
    geoms = world.rigid_geoms(w.params, s.rigid[:, :1], s.rigid[:, 1:])
    _, impulses = cpl.simulate_coupled(world.mpm_config, world.contact_params, s.particles,
                                       geoms, world.substeps_per_step)
    nxt = world.step(w.params, s, tau)
    B = COUPLED_PARITY_SCENARIOS
    opts = mppi.MppiOptions(num_samples=L // B, temperature=0.05, noise_sigma=8.0,
                            u_lower=(-25.0,), u_upper=(25.0,))
    noise = torch.randn((B, L // B, COUPLED_HORIZON, 1), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(SEED)).to(**kw)
    u_nom = torch.full((B, COUPLED_HORIZON, 1), 5.0, **kw)
    res = mppi.mppi_step(lambda st, u: world.step(w.params, st, u), w.running_cost,
                         w.final_cost, tree_map(lambda t: t[:B], s), u_nom, noise, opts)
    out = {"x": nxt.particles.x, "v": nxt.particles.v, "F": nxt.particles.F,
           "C": nxt.particles.C, "rigid": nxt.rigid, "impulses": impulses,
           "u_traj": res.u_traj, "cost": res.cost}
    return {k: v.detach().double().cpu() for k, v in out.items()}


# How each phase 10 quantity is scaled: max(1, max|ref|) or max|ref|.
COUPLED_PARITY_UNIT_SCALE = {"x": True, "F": True, "rigid": True}


def coupled_parity_errors(ref, got):
    """{name: (max |got - ref| / scale, scale)}; non-finite gives inf."""
    out = {}
    for name, r in ref.items():
        g = got[name]
        check(g.shape == r.shape, f"{name}: shape {tuple(g.shape)} vs {tuple(r.shape)}")
        scale = float(r.abs().max())
        if COUPLED_PARITY_UNIT_SCALE.get(name):
            scale = max(1.0, scale)
        err = float((g - r).abs().max()) if bool(g.isfinite().all()) else float("inf")
        out[name] = (err / scale, scale)
    return out


def coupled_parity(torch, modules, dev, card):
    """Phase 10: card float32 against CPU float64 (see
    coupled_parity_values), within COUPLED_PARITY."""
    ref = coupled_parity_values(torch, *modules, torch.device("cpu"), torch.float64)
    got = coupled_parity_values(torch, *modules, dev, torch.float32)
    for name, (rel, scale) in coupled_parity_errors(ref, got).items():
        bound = COUPLED_PARITY[name]
        ok = rel <= bound
        print(f"[coupled parity lanes={COUPLED_PARITY_LANES}] {name} {tuple(ref[name].shape)}: "
              f"max|f32 card - f64 cpu| / scale = {rel:.3e} (<= {bound:.1e}; scale "
              f"{scale:.3e}; float32 on a CPU: {COUPLED_PARITY_CPU[name]:.1e}) "
              f"{'ok' if ok else 'FAIL'} [{card}]")
        check(ok, f"coupled parity: {name} off by {rel:.3e} of its scale (bound {bound:.1e})")


def coupled_world_phase(torch, mk, bench_world, dev, card):
    """Phase 11: the coupled world bench, K = 64 rollouts of 10 coupled
    steps in one call, with the kernels and with xla_only=True; returns the
    kernel run's launches."""
    runs = {}
    for xla_only in (False, True):
        mk.reset_launch_counts()
        res = bench_world.run(COUPLED_WORLD_LANES, COUPLED_HORIZON, device=dev,
                              xla_only=xla_only)
        launches = dict(mk.LAUNCHES)
        label = "plain" if xla_only else "kernel"
        # A warm-up rollout and the timed one, one K2 and one launch of K1
        # from block windows a substep over all lanes, the dense K1 never.
        n = 0 if xla_only else 2 * COUPLED_HORIZON * res["substeps_per_step"]
        want = {"update_grid": 0, "update_grid_blocks": n, "p2g_block": n, "g2p_block": 0}
        print(f"[coupled world {label}] K={res['lanes']} horizon={res['horizon']} x "
              f"{res['substeps_per_step']} substeps, {res['particles']} particles a lane: "
              f"{res['substeps_per_s']!r} substeps/s (wall {res['wall_s']!r} s, CUDA events "
              f"{res['device_s']!r} s), dropped max {res['dropped_max']}, finite "
              f"{res['finite']}, peak memory {res['peak_memory_bytes']} B, launches "
              f"{json.dumps(launches)} [{card}]")
        check(launches == want, f"coupled world {label}: launches {launches}, expected {want}")
        check(res["finite"], f"coupled world {label}: non-finite state")
        check(res["dropped_max"] == 0, f"coupled world {label}: dropped {res['dropped_max']}")
        runs[label] = res
        if not xla_only:
            kernel_launches = launches
    k, p = runs["kernel"]["final_state"], runs["plain"]["final_state"]
    dx = float((k.particles.x - p.particles.x).abs().max())
    dv = float((k.particles.v - p.particles.v).abs().max())
    dr = float((k.rigid - p.rigid).abs().max())
    ok = max(dx, dv, dr) <= COUPLED_MAX_DIFF_PATHS
    print(f"[coupled world] kernel vs plain after the rollout: max|dx| {dx:.3e}, max|dv| "
          f"{dv:.3e}, max|d rigid| {dr:.3e} (<= {COUPLED_MAX_DIFF_PATHS:.0e}) "
          f"{'ok' if ok else 'FAIL'}; kernel/plain substeps/s "
          f"{runs['kernel']['substeps_per_s'] / runs['plain']['substeps_per_s']!r}")
    check(ok, "coupled world: kernel and plain paths disagree")
    return kernel_launches


def config5_phase(torch, mk, bench_mpc, dev, card):
    """Phase 12: config 5 at full width, CONFIG5_SCENARIOS x CONFIG5_SAMPLES
    lanes in one call, CONFIG5_STEPS MPC steps after a warm-up, with its
    gates; returns (launches, the bench's result)."""
    mk.reset_launch_counts()
    res = bench_mpc.run(CONFIG5_SCENARIOS, CONFIG5_SAMPLES, CONFIG5_STEPS, seed=SEED,
                        device=dev)
    launches = dict(mk.LAUNCHES)
    # Each MPC step: one MPPI solve over the horizon, then the applied step.
    per_step = (res["horizon"] + 1) * res["substeps_per_step"]
    n = (CONFIG5_STEPS + CONFIG5_WARMUP_STEPS) * per_step
    want = {"update_grid": 0, "update_grid_blocks": n, "p2g_block": n, "g2p_block": 0}
    print(f"[config5] {res['scenarios']} scenarios x {res['samples']} samples = "
          f"{res['scenarios'] * res['samples']} lanes, horizon {res['horizon']} x "
          f"{res['substeps_per_step']} substeps, {res['steps']} MPC steps, float32 TF32 off: "
          f"wall {res['wall_s']!r} s, {res['solves_per_s']!r} solves/s, "
          f"{res['wall_s'] / res['steps'] * 1e3!r} ms per MPC step [{card}]")
    print(f"[config5] goal reached {res['reached']}/{res['scenarios']} (err < 6 cm), median "
          f"final error {res['median_err']!r} m, non-finite scenarios {res['nonfinite']}, "
          f"dropped max {res['dropped_max']}, peak memory {res['peak_memory_bytes']} B "
          f"({res['peak_memory_bytes'] / 2**30:.3f} GiB), launches {json.dumps(launches)} "
          f"[{card}]")
    check(launches == want, f"config 5: launches {launches}, expected {want}")
    check(res["nonfinite"] == 0, f"config 5: {res['nonfinite']} non-finite scenarios")
    check(res["dropped_max"] == 0, f"config 5: dropped {res['dropped_max']}")
    check(res["reached"] >= CONFIG5_MIN_REACHED,
          f"config 5: {res['reached']}/{res['scenarios']} reached the goal")
    check(res["median_err"] <= CONFIG5_MAX_MEDIAN_ERR,
          f"config 5: median final error {res['median_err']:.4f} m")
    return launches, res


def coupled_profile(torch, bench_mpc, mppi, tree_map, res, dev, card):
    """With --profile: torch.profiler over one coupled step of config 5's
    256 lanes (per coupled substep: its tenth, SAP included) and over one
    MPC step, both from the main path's state after a third of its steps;
    the ranges coupling.substep, coupling.contact and coupled.sap_step, the
    K1 and K2 kernels, and the cuBLAS gemv kernels."""
    w, _, opts, dynamics, _ = bench_mpc.make_problem(CONFIG5_SCENARIOS, CONFIG5_SAMPLES,
                                                     SEED, dev)
    state = tree_map(lambda t: t[:, CONFIG5_STEPS // 3].contiguous(), res["states"])
    lanes = tree_map(lambda t: t.repeat_interleave(CONFIG5_SAMPLES, dim=0), state)
    u = torch.full((CONFIG5_SCENARIOS * CONFIG5_SAMPLES, 1), 10.0, device=dev)
    named = ("update_grid_kernel", "update_grid_blocks_kernel", "p2g_block_kernel", "gemv")
    profile_layers(torch, lambda: w.world.step(w.params, lanes, u),
                   w.world.substeps_per_step, COUPLED_LAYERS, COUPLED_TOP_LAYERS,
                   f"config5 coupled step L={u.shape[0]}", "coupled substep", card, named)
    u_nom = torch.zeros((CONFIG5_SCENARIOS, bench_mpc.HORIZON, 1), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    profile_layers(torch, lambda: mppi.mppi_mpc_rollout(
        dynamics, w.running_cost, w.final_cost, state, u_nom, 1, opts, generator=gen),
        1, COUPLED_LAYERS, COUPLED_TOP_LAYERS,
        f"config5 MPC step B={CONFIG5_SCENARIOS} M={CONFIG5_SAMPLES}", "MPC step", card, named)


def implicit_world(paddle_blob, gc, device, dtype=None, xla_only=False, tiled=False,
                   unroll=0):
    """(paddle_blob.PaddleBlob, world): config 5's world with the implicit
    grid contact, dense or (``tiled``) on the tile pipeline, and the JAX
    bench's --implicit solve parameters (``unroll`` its --unroll);
    ``xla_only`` takes the kernels' plain versions."""
    import torch

    w = paddle_blob.build(device=device, dtype=dtype or torch.float32, xla_only=xla_only)
    world = dataclasses.replace(
        w.world, contact_model="implicit", tiled=tiled,
        grid_contact_params=gc.GridContactParams(
            stiffness=5e4, damping=100.0, friction=0.3, max_iterations=20,
            line_search_points=12, line_search_levels=2, unroll_iterations=unroll))
    return w, world


def implicit_parity_values(torch, paddle_blob, gc, device, dtype, tiled=False):
    """Phase 13a's (16a's with ``tiled``) quantities on `device` in `dtype`:
    IMPLICIT_PARITY_LANES lanes (paddles at 0.345 m + 1 mm a lane, at rest;
    10, 5, 15, 12 N) through one implicit coupled step of 10 substeps.
    Returns (the quantities in float64 on the CPU, each solve's Newton
    iterations (substeps, lanes))."""
    w, world = implicit_world(paddle_blob, gc, device, dtype, tiled=tiled)
    L = IMPLICIT_PARITY_LANES
    kw = dict(dtype=dtype, device=device)
    s = paddle_blob.lanes(w.state0, L)
    q = IMPLICIT_PADDLE_X0 + 0.001 * torch.arange(L, **kw)
    s = s._replace(rigid=torch.stack([q, torch.zeros_like(q)], dim=-1))
    tau = torch.tensor([[10.0], [5.0], [15.0], [12.0]], **kw)
    with gc.solve_log() as log:
        nxt = world.step(w.params, s, tau)
    out = {"x": nxt.particles.x, "v": nxt.particles.v, "F": nxt.particles.F,
           "C": nxt.particles.C, "rigid": nxt.rigid,
           "impulses": sum(sol.impulses for sol in log),
           "residual": torch.stack([sol.residual for sol in log])}
    its = torch.stack([sol.iterations for sol in log]).cpu()
    return {k: v.detach().double().cpu() for k, v in out.items()}, its


def implicit_parity(torch, paddle_blob, gc, dev, card, tiled=False):
    """Phase 13a (16a with ``tiled``): card float32 against CPU float64,
    within IMPLICIT_PARITY (TILED_PARITY), iteration counts within
    IMPLICIT_PARITY_ITERATIONS."""
    tag = "tiled" if tiled else "implicit"
    bounds, cpu = (TILED_PARITY, TILED_PARITY_CPU) if tiled else (IMPLICIT_PARITY,
                                                                  IMPLICIT_PARITY_CPU)
    ref, its_ref = implicit_parity_values(torch, paddle_blob, gc, torch.device("cpu"),
                                          torch.float64, tiled)
    got, its = implicit_parity_values(torch, paddle_blob, gc, dev, torch.float32, tiled)
    for name, (rel, scale) in coupled_parity_errors(ref, got).items():
        bound = bounds[name]
        ok = rel <= bound
        print(f"[{tag} parity lanes={IMPLICIT_PARITY_LANES}] {name} {tuple(ref[name].shape)}: "
              f"max|f32 card - f64 cpu| / scale = {rel:.3e} (<= {bound:.1e}; scale "
              f"{scale:.3e}; float32 on a CPU: {cpu[name]:.1e}) "
              f"{'ok' if ok else 'FAIL'} [{card}]")
        check(ok, f"{tag} parity: {name} off by {rel:.3e} of its scale (bound {bound:.1e})")
    d = int((its - its_ref).abs().max())
    ok = d <= IMPLICIT_PARITY_ITERATIONS
    print(f"[{tag} parity lanes={IMPLICIT_PARITY_LANES}] Newton iterations a solve, lanes x "
          f"substeps: card {its.T.tolist()}, cpu float64 {its_ref.T.tolist()}, max |difference| "
          f"{d} (<= {IMPLICIT_PARITY_ITERATIONS}) {'ok' if ok else 'FAIL'} [{card}]")
    check(ok, f"{tag} parity: iteration counts {d} apart")
    check(bool((its_ref > 1).any(dim=0).all()), f"{tag} parity: a lane never met the blob")


def implicit_rollout(torch, mk, gc, paddle_blob, bench_world, lanes, dev, card,
                     xla_only=False, tiled=False, unroll=0):
    """Phase 13b (13c with ``xla_only``; 16b-d with ``tiled``, 16c with
    ``unroll``): `lanes` rollouts of COUPLED_HORIZON implicit coupled steps
    in one call (bench_coupled_world.rollout), timed after one warm-up
    rollout as phase 11 times its; prints the pace, the Newton iterations,
    peak memory and the kernels, and checks the gates (the fixed count's
    less the cap's).  Returns what phase 13 or 16 reports."""
    w, world = implicit_world(paddle_blob, gc, dev, xla_only=xla_only, tiled=tiled,
                              unroll=unroll)
    states = paddle_blob.lanes(w.state0, lanes)
    rigid = states.rigid.clone()
    rigid[:, 0] = IMPLICIT_PADDLE_X0
    states = states._replace(rigid=rigid)
    us = bench_world.controls(lanes, COUPLED_HORIZON, dev) + IMPLICIT_PUSH
    bench_world.rollout(world, w.params, states, us)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    with gc.solve_log() as log:
        out, dropped = bench_world.rollout(world, w.params, states, us * 1.0001)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches, with_mass = dict(mk.LAUNCHES), dict(mk.LAUNCHES_WITH_MASS)
    peak = torch.cuda.max_memory_allocated()
    gp = world.grid_contact_params
    substeps = COUPLED_HORIZON * world.substeps_per_step
    its = torch.stack([sol.iterations for sol in log]).cpu()  # (substeps, lanes)
    res = torch.stack([sol.residual for sol in log]).double().cpu()
    impulse = sum(sol.impulses for sol in log)[:, 0].double().cpu()  # (lanes, 6) on the paddle
    capped = its >= gp.max_iterations
    label = "plain" if xla_only else "kernel"
    tag = (f"{'tiled' if tiled else 'implicit'} world {label} K={lanes}"
           + (f" unroll={unroll}" if unroll else ""))
    per_lane = its.double().mean(dim=0)
    finite = all(bool(torch.isfinite(t).all()) for t in (
        out.rigid, out.particles.x, out.particles.v, out.particles.F, out.particles.C))
    res_conv = float(res[~capped].max()) if bool((~capped).any()) else 0.0
    print(f"[{tag}] horizon {COUPLED_HORIZON} x {world.substeps_per_step} substeps, "
          f"{out.particles.x.shape[1]} particles a lane, float32 TF32 off: "
          f"{lanes * substeps / wall!r} substeps/s (wall {wall!r} s, CUDA events "
          f"{start.elapsed_time(end) / 1e3!r} s, {wall / substeps * 1e3!r} ms a coupled "
          f"substep of all lanes) [{card}]")
    print(f"[{tag}] Newton iterations a solve: median {float(its.double().median())!r}, max "
          f"{int(its.max())}; mean a substep per lane: median {float(per_lane.median())!r}, "
          f"max {float(per_lane.max())!r}; {int(capped.sum())} of {its.numel()} lane-substeps "
          f"at the cap of {gp.max_iterations}; largest final residual {float(res.max())!r} "
          f"(of the solves below the cap {res_conv!r}, tolerance {gp.rel_tolerance}) [{card}]")
    print(f"[{tag}] dropped max {int(dropped.max())} (lanes with a drop "
          f"{int((dropped > 0).sum())}), finite {finite}, peak memory {peak} B "
          f"({peak / 2**30:.3f} GiB), launches {json.dumps(launches)} (with the mass "
          f"{with_mass['update_grid_blocks']}), a substep {launches['p2g_block'] / substeps!r} "
          f"K2, {launches['update_grid_blocks'] / substeps!r} K1 from block windows and "
          f"{launches['g2p_block'] / substeps!r} K3 [{card}]")
    if tiled:
        # The closure at the end: its blocks of each lane beside its slots.
        from drake_tpu_torch.mpm import tiles

        cfg = world.mpm_config
        ss = tiles.sort_to_tiles(cfg, out.particles)
        _, firsts = tiles.closure(cfg, ss.active)
        ext = gp.ext_capacity_factor * cfg.max_active_blocks
        print(f"[{tag}] closure at the end: {int(firsts.sum(dim=-1).max())} blocks in the "
              f"largest lane ({64 * int(firsts.sum(dim=-1).max())} nodes), {ext} slots "
              f"({64 * ext} nodes a lane in the solve) beside the grid's "
              f"{math.prod(cfg.grid_size)} nodes; the substeps' sort capacity "
              f"{min(math.prod(cfg.grid_size) // 64, ss.capacity + 27)} blocks [{card}]")
    n = 0 if xla_only else substeps
    want = {"update_grid": 0, "update_grid_blocks": n, "p2g_block": n,
            "g2p_block": n if tiled else 0}
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    check(with_mass["update_grid_blocks"] == n, f"{tag}: {with_mass} launches with the mass")
    check(finite, f"{tag}: non-finite state")
    check(int(dropped.max()) == 0, f"{tag}: dropped {int(dropped.max())}")
    check(bool((impulse.abs().amax(dim=-1) > 0).all()), f"{tag}: a lane put no impulse on the paddle")
    check(bool((its > 1).any(dim=0).all()), f"{tag}: a lane took one Newton iteration in every substep")
    if unroll:
        check(bool((its == unroll).all()), f"{tag}: a solve took other than {unroll} iterations")
    else:
        check(res_conv <= gp.rel_tolerance, f"{tag}: a solve below the cap ended at {res_conv:.3e}")
    return {"world": world, "params": w.params, "final": out, "controls": us, "states": states,
            "launches": launches, "substeps_per_s": lanes * substeps / wall,
            "device_s": start.elapsed_time(end) / 1e3, "peak_memory_bytes": peak,
            "iterations_median": float(its.double().median()), "capped": int(capped.sum()),
            "wall_s": wall}


def implicit_k1_mass(torch, mpm, mk, config, state, flush, card, tag=None):
    """K1 from block windows with the mass, on the 64-lane rollout's final
    state (phase 13) or the cloth's (phase 14): held against its plain
    version (mass and velocity each within 1e-5 of their largest magnitude)
    and timed, warm and cold with its bound, beside the velocity-only launch
    on the same input."""
    sort = mpm.sort_particles(config, state)
    win = mk.p2g_block_cuda(sort.packed, sort.starts, sort.counts, config.block_capacity)
    args = (win, sort.active, config.grid_size, config.dx, config.dt, config.gravity,
            config.wall_width)
    vel, mass = mk.update_grid_blocks_cuda(*args, with_mass=True)
    vel_r, mass_r = mk.update_grid_blocks_reference(*args, with_mass=True)
    torch.cuda.synchronize()
    tag = tag or f"implicit K1 mass L={state.x.shape[0]} A={config.max_active_blocks}"
    err = {}
    for name, got, ref in (("mass", mass, mass_r), ("v", vel, vel_r)):
        check(bool(torch.isfinite(got).all()), f"{tag}: non-finite {name}")
        e = float((got - ref).abs().max())
        bound = 1e-5 * float(ref.abs().max())
        err[name] = e
        print(f"[parity {tag}] update_grid_blocks with the mass: {name} max|kernel - plain| "
              f"= {e:.3e} (<= {bound:.3e}) {'ok' if e <= bound else 'FAIL'} [{card}]")
        check(e <= bound, f"{tag}: {name} disagrees with the plain version")
    check(torch.equal(vel, mk.update_grid_blocks_cuda(*args)),
          f"{tag}: the velocity differs with and without the mass")
    timed = {}
    for label, with_m in (("with the mass", True), ("velocity only", False)):
        nbytes, flops = k1_blocks_work(mk, sort.active, config.grid_size, with_mass=with_m)
        timed[label], line = time_kernel(
            torch, lambda: mk.update_grid_blocks_cuda(*args, with_mass=with_m),
            lambda: mk.update_grid_blocks_reference(*args, with_mass=with_m), flush, nbytes,
            flops)
        print(f"[time {tag}] update_grid_blocks {label}: {line} [{card}]")
    out = dict(timed["with the mass"])
    out.update(max_abs_err=max(err.values()), velocity_only_ms=timed["velocity only"]["ms"],
               velocity_only_cold_ms=timed["velocity only"]["cold_ms"],
               velocity_only_bound_ms=timed["velocity only"]["bound_ms"])
    return out


def implicit_repeat(torch, gc, bench_world, first, plain, card):
    """13c: the K = 64 rollout with the kernels and its xla_only twin run
    once more, each bit for bit its first run (the Newton's scatters and the
    plain P2G sum in a fixed order, ``solver.scatter_sum``); and the
    Newton's scatter timed at this rollout's shape, in its fixed order
    beside the ``index_add_`` it replaced (atomics, no fixed order)."""
    from drake_tpu_torch.mpm import solver as mpm

    for label, res in (("kernel", first), ("xla_only", plain)):
        again, _ = bench_world.rollout(res["world"], res["params"], res["states"],
                                       res["controls"] * 1.0001)
        pairs = ((again.particles.x, res["final"].particles.x),
                 (again.particles.v, res["final"].particles.v),
                 (again.particles.F, res["final"].particles.F), (again.rigid, res["final"].rigid))
        same = all(torch.equal(a, b) for a, b in pairs)
        diff = max(float((a - b).abs().max()) for a, b in pairs)
        print(f"[implicit world] {label} K={IMPLICIT_LANES[0]} rollout run twice: bit for bit "
              f"{same} (max |d| {diff:.3e}) [{card}]")
        check(same, f"implicit world: two runs of the {label} rollout differ")
    config = first["world"].mpm_config
    x = first["final"].particles.x
    st = gc._stencil(config, x)
    vals = torch.randn(x.shape, generator=torch.Generator(device=x.device).manual_seed(SEED),
                       device=x.device)
    L = x.shape[0]

    def atomic():
        contrib = st.weight[..., None] * vals[..., None, :]
        out = torch.zeros((L * st.nodes + 1, 3), dtype=vals.dtype, device=vals.device)
        out.index_add_(0, st.drop_index, contrib.reshape(-1, 3))
        return out[:-1].reshape(L, st.nodes, 3)

    fixed = gc._scatter(st, st.weight, vals)
    e = float((fixed - atomic()).abs().max() / fixed.abs().max())
    check(torch.equal(fixed, gc._scatter(st, st.weight, vals)), "the fixed-order scatter varies")
    ms_fixed = time_ms(torch, lambda: gc._scatter(st, st.weight, vals), KERNEL_REPS)
    ms_atomic = time_ms(torch, atomic, KERNEL_REPS)
    ms_plan = time_ms(torch, lambda: mpm.scatter_plan(st.drop_index, L * st.nodes + 1),
                      KERNEL_REPS)
    print(f"[implicit world] the Newton's scatter at L={L}, {x.shape[1]} particles x 27 taps "
          f"into {L * st.nodes} nodes x 3: fixed order {ms_fixed!r} ms (its plan, once a "
          f"substep, {ms_plan!r} ms), index_add_ {ms_atomic!r} ms; the two {e:.1e} apart of "
          f"max |.| [{card}]")


def implicit_phase(torch, mpm, mk, gc, paddle_blob, bench_world, dev, card, profile):
    """Phase 13: the dense implicit world on the card (13a parity, 13b the
    rollouts at IMPLICIT_LANES, 13c kernel against plain at the first, K1
    with the mass); returns (the 64-lane run's launches, K1 with mass's
    results)."""
    implicit_parity(torch, paddle_blob, gc, dev, card)
    runs = {lanes: implicit_rollout(torch, mk, gc, paddle_blob, bench_world, lanes, dev, card)
            for lanes in IMPLICIT_LANES}
    first = runs[IMPLICIT_LANES[0]]
    plain = implicit_rollout(torch, mk, gc, paddle_blob, bench_world, IMPLICIT_LANES[0], dev,
                             card, xla_only=True)
    implicit_repeat(torch, gc, bench_world, first, plain, card)
    k, p = first["final"], plain["final"]
    d = {"x": k.particles.x - p.particles.x, "q": k.rigid[:, 0] - p.rigid[:, 0],
         "v": k.particles.v - p.particles.v, "paddle v": k.rigid[:, 1] - p.rigid[:, 1]}
    d = {name: float(t.abs().max()) for name, t in d.items()}
    ok = all(d[name] <= bound for name, bound in IMPLICIT_MAX_DIFF.items())
    print(f"[implicit world] kernel vs plain after the K={IMPLICIT_LANES[0]} rollout, max "
          f"|difference|: " + ", ".join(f"{name} {d[name]:.3e} (<= {IMPLICIT_MAX_DIFF[name]:.0e})"
                                      for name in IMPLICIT_MAX_DIFF)
          + f" {'ok' if ok else 'FAIL'}; kernel/plain substeps/s "
          f"{first['substeps_per_s'] / plain['substeps_per_s']!r}")
    check(ok, "implicit world: kernel and plain paths disagree")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    k1_mass = implicit_k1_mass(torch, mpm, mk, first["world"].mpm_config, k.particles, flush,
                               card)
    del flush
    if profile:
        world, u = first["world"], first["controls"][:, -1]
        logs = []

        def run():
            with gc.solve_log() as log:
                world.step(first["params"], k, u)
            logs.append(log)

        prof = profile_layers(torch, run, world.substeps_per_step, IMPLICIT_LAYERS,
                              IMPLICIT_TOP_LAYERS, f"implicit coupled step L={IMPLICIT_LANES[0]}",
                              "coupled substep", card,
                              ("update_grid_blocks_kernel", "p2g_block_kernel", "index",
                               "gather", "scatter"))
        its = torch.stack([sol.iterations for sol in logs[-1]]).double()
        for layer in ("grid_contact.newton", "grid_contact.line_search"):
            dev_ms, host_ms = prof["layers"][layer]
            print(f"[profile implicit] {layer}: {dev_ms / prof['device_ms']:.3f} of the device "
                  f"time, {dev_ms!r} device ms and {host_ms!r} host ms a coupled substep; "
                  f"Newton iterations a substep (max over lanes): "
                  f"{float(its.max(dim=1).values.mean())!r} [{card}]")
    return first["launches"], runs[IMPLICIT_LANES[1]]["launches"], k1_mass, first["final"]


def tiled_run(torch, tiles, config, state, n):
    """`n` substeps of ``simulate_tiled`` (the group's sort every
    TILED_RESORT); returns (state, device ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = tiles.simulate_tiled(config, state, n, resort_every=TILED_RESORT)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def tiled_mpm_phase(torch, mpm, mk, tiles, scales, blocked, card):
    """Phase 15a-b: ``simulate_tiled`` on phase 3's scenes with the kernels
    and with ``xla_only``, against each other and against `blocked` (phase
    3's ``mpm_substep_blocked`` kernel state by scale); then the fast block.
    Returns the kernel runs' launches and the largest kernel-plain
    difference."""
    total = {name: 0 for name in KERNELS}
    t = SUBSTEPS * next(iter(scales.values()))[0].dt
    diff = 0.0
    for scale, (config, state) in scales.items():
        n = state.x.shape[0]
        plain_cfg = dataclasses.replace(config, xla_only=True)
        for cfg in (config, plain_cfg):
            tiled_run(torch, tiles, cfg, state, WARMUP_SUBSTEPS)
        mk.reset_launch_counts()
        out_k, ms_k = tiled_run(torch, tiles, config, state, SUBSTEPS)
        launched = dict(mk.LAUNCHES)
        out_p, ms_p = tiled_run(torch, tiles, plain_cfg, state, SUBSTEPS)
        check(dict(mk.LAUNCHES) == launched, "the plain tiled path launched a kernel")
        want = {"update_grid": 0, "update_grid_blocks": SUBSTEPS, "p2g_block": SUBSTEPS,
                "g2p_block": SUBSTEPS}
        check(launched == want, f"tiled launches {launched}, expected {want}")
        for name in KERNELS:
            total[name] += launched[name]
        for label, out, ms in (("kernel", out_k, ms_k), ("plain", out_p, ms_p)):
            dropped = int(out.dropped)
            finite = all(bool(torch.isfinite(f).all()) for f in (out.x, out.v, out.F, out.C))
            vz = float(out.v[:, 2].double().mean())
            rel = abs(vz - (-9.81 * t)) / (9.81 * t)
            print(f"[tiled scale={scale} n={n}] {label}: {SUBSTEPS} substeps, the group's sort "
                  f"every {TILED_RESORT}, dropped={dropped}, finite={finite}, mean v_z={vz!r} "
                  f"(-g t={-9.81 * t!r}, rel {rel:.2e}), {SUBSTEPS / (ms / 1e3)!r} substeps/s "
                  f"({ms / SUBSTEPS!r} ms/substep by CUDA events)"
                  + (f", launches a substep {json.dumps({k: v / SUBSTEPS for k, v in launched.items()})}"
                     if label == "kernel" else "") + f" [{card}]")
            check(dropped == 0, f"tiled {label} dropped {dropped} particles")
            check(finite, f"tiled {label}: non-finite state")
            check(rel <= FREE_FALL_RTOL, f"tiled {label}: free fall off by {rel:.2e}")
        for other, ref in (("plain", out_p), ("mpm_substep_blocked", blocked[scale])):
            dx_max = float((out_k.x - ref.x).abs().max())
            dv_max = float((out_k.v - ref.v).abs().max())
            ok = max(dx_max, dv_max) <= MAX_DIFF_PATHS
            if other == "plain":
                diff = max(diff, dx_max, dv_max)
            print(f"[tiled scale={scale} n={n}] kernel vs {other}: max|dx| {dx_max:.3e}, "
                  f"max|dv| {dv_max:.3e} (<= {MAX_DIFF_PATHS:.0e}) {'ok' if ok else 'FAIL'}")
            check(ok, f"tiled scale {scale}: the kernels and {other} disagree")
    # 15b: the reference test's fast block, 3 cells a substep: the second
    # resident substep finds particles past their home's window.
    config, state = scales[1]
    fast = state.replace(v=torch.full_like(state.v, 3.0 * config.dx / config.dt))
    counts = {}
    for label, cfg in (("kernel", config), ("plain", dataclasses.replace(config, xla_only=True))):
        ss = tiles.sort_to_tiles(cfg, fast)
        ss = tiles.resident_substep(cfg, tiles.resident_substep(cfg, ss))
        counts[label] = int(ss.dropped)
    ok = counts["kernel"] == counts["plain"] > 0
    print(f"[tiled fast block] v = 3 dx/dt, two resident substeps: dropped (stale) kernel "
          f"{counts['kernel']}, plain {counts['plain']} of {state.x.shape[0]} "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, f"tiled fast block: stale counts {counts}")
    return total, diff


def k3_lanes(torch, np, mpm, mk, tree_map, paddle_blob, dev, card):
    """Phase 15c: K3 over K3_LANES lanes of the coupled world (phase 9's
    state), its windows from the plain K2 and K1: against its plain version
    and, on three lanes, against the call on the lane's own sort; timed warm
    and cold beside its bound.  Returns the timing and the difference."""
    config, state = coupled_inputs(torch, np, paddle_blob, K3_LANES, dev)
    pmax = config.block_capacity
    dxi2 = 4.0 / config.dx**2
    sort = mpm.sort_particles(config, state)
    win = mk.p2g_block_reference(sort.packed, sort.starts, sort.counts, pmax)
    vel = mk.update_grid_blocks_reference(win, sort.active, config.grid_size, config.dx,
                                          config.dt, config.gravity, config.wall_width)
    node_pos = mpm.window_node_pos(config, sort.active, torch.float32)
    vel_ext = mpm.block_velocity_windows(config, vel, sort.active, node_pos)
    args = (sort.packed, vel_ext, sort.starts, sort.counts, pmax, dxi2, config.dt)
    rows = sort.packed.shape[0]
    taken = mk.taken_rows(sort.starts, sort.counts, rows, pmax)
    kernel = lambda: mk.g2p_block_cuda(*args)  # noqa: E731
    plain = lambda: mk.g2p_block_reference(*args)  # noqa: E731
    bounds = bound_k3(dxi2)
    tag = (f"K3 lanes L={K3_LANES} grid {config.grid_size} A={config.max_active_blocks} "
           f"pmax={pmax} rows={rows} taken={int(taken.sum())}")
    check(int(sort.dropped.sum()) == 0, f"{tag}: the coupled scene dropped particles")
    err, ok, detail = kernel_parity(torch, "g2p_block", kernel, plain, bounds, taken)
    print(f"[parity {tag}] g2p_block: max|kernel - plain| = {err:.3e} ({detail}) "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, f"g2p_block disagrees with its plain version at {tag}")
    out = kernel()
    lanes, n = state.x.shape[:2]
    for lane in sorted({0, lanes // 2, lanes - 1}):
        one = mpm.sort_particles(config, tree_map(lambda t: t[lane], state))
        out_l = mk.g2p_block_cuda(one.packed, vel_ext[lane].contiguous(), one.starts,
                                  one.counts, pmax, dxi2, config.dt)
        mine = mk.taken_rows(one.starts, one.counts, n, pmax)
        batched = out[lane * n:(lane + 1) * n]
        check(torch.equal(mine, taken[lane * n:(lane + 1) * n]),
              f"g2p_block: lane {lane}'s taken rows differ from its own sort's")
        e = float((out_l[mine] - batched[mine]).abs().max())
        bound = min(b for _, _, b in bounds(batched[mine]))
        print(f"[lanes L={lanes}] lane {lane}: g2p_block max|batched - own| = {e:.3e} "
              f"(<= {bound:.3e}) {'ok' if e <= bound else 'FAIL'} [{card}]")
        check(e <= bound, f"g2p_block: lane {lane} differs from its own call")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    nbytes, flops = k3_work(mk, int(taken.sum()), sort.counts)
    res, line = time_kernel(torch, kernel, plain, flush, nbytes, flops)
    res["max_abs_err"] = err
    print(f"[time {tag}] g2p_block: {line} [{card}]")
    del flush
    return res


def tiled_world_phase(torch, mk, gc, paddle_blob, bench_world, dense_final, dev, card, profile):
    """Phase 16: the implicit world on the tile pipeline (16a parity, 16b the
    converged rollouts at IMPLICIT_LANES, 16c the fixed-count ones, 16d the
    tiled world against phase 13's dense one, `dense_final`, and the kernels
    against plain).  Returns each rollout's launches by its label."""
    implicit_parity(torch, paddle_blob, gc, dev, card, tiled=True)
    runs = {}
    for unroll in (0, TILED_UNROLL):
        for lanes in IMPLICIT_LANES:
            runs[(unroll, lanes)] = implicit_rollout(torch, mk, gc, paddle_blob, bench_world,
                                                     lanes, dev, card, tiled=True, unroll=unroll)
            torch.cuda.empty_cache()
    first = runs[(0, IMPLICIT_LANES[0])]
    plain = implicit_rollout(torch, mk, gc, paddle_blob, bench_world, IMPLICIT_LANES[0], dev,
                             card, xla_only=True, tiled=True)
    k, p = first["final"], plain["final"]
    for other, ref in (("plain", p), ("the dense world (phase 13)", dense_final)):
        diff = {"x": k.particles.x - ref.particles.x, "q": k.rigid[:, 0] - ref.rigid[:, 0],
                "v": k.particles.v - ref.particles.v,
                "paddle v": k.rigid[:, 1] - ref.rigid[:, 1]}
        diff = {name: float(d.abs().max()) for name, d in diff.items()}
        ok = all(diff[name] <= bound for name, bound in TILED_MAX_DIFF.items())
        print(f"[tiled world] kernel vs {other} after the K={IMPLICIT_LANES[0]} rollout: "
              + ", ".join(f"max|d {name}| {diff[name]:.3e} (<= {bound:.0e})"
                          for name, bound in TILED_MAX_DIFF.items())
              + f" {'ok' if ok else 'FAIL'} [{card}]")
        check(ok, f"tiled world: the kernels and {other} disagree")
    if profile:
        world, u = first["world"], first["controls"][:, -1]
        logs = []

        def run():
            with gc.solve_log() as log:
                world.step(first["params"], k, u)
            logs.append(log)

        prof = profile_layers(torch, run, world.substeps_per_step, TILED_LAYERS,
                              TILED_TOP_LAYERS, f"tiled coupled step L={IMPLICIT_LANES[0]}",
                              "coupled substep", card,
                              ("update_grid_blocks_kernel", "p2g_block_kernel",
                               "g2p_block_kernel", "index", "gather", "scatter"))
        its = torch.stack([sol.iterations for sol in logs[-1]]).double()
        for layer in ("grid_contact.newton", "grid_contact.line_search"):
            dev_ms, host_ms = prof["layers"][layer]
            print(f"[profile tiled] {layer}: {dev_ms / prof['device_ms']:.3f} of the device "
                  f"time, {dev_ms!r} device ms and {host_ms!r} host ms a coupled substep; "
                  f"Newton iterations a substep (max over lanes): "
                  f"{float(its.max(dim=1).values.mean())!r} [{card}]")
    return {f"tiled implicit world K={lanes}" + (f" unroll={u}" if u else "") + " (phase 16)":
            r["launches"] for (u, lanes), r in runs.items()}


def bagging_parity_values(torch, cloth, mpm_bagging, mpm_cloth_demo, gc, device, dtype):
    """Phase 14a's quantities on `device` in `dtype`: one coupled step of the
    bagging world on 2 lanes by each contact model (BAGGING_PARITY_*), and
    DRAPE_PARITY_SUBSTEPS substeps of simulate_cloth on the drape.  Returns
    ({case: {quantity: float64 on the CPU}}, the implicit step's Newton
    iterations (substeps, lanes))."""
    import numpy as np

    out, its = {}, None
    for model in ("implicit", "penalty"):
        bag = mpm_bagging.build(model, device=device, dtype=dtype)
        s = mpm_bagging.lanes(bag.state0, 2)
        rigid = s.rigid.clone()
        rigid[:, 6] = BAGGING_PARITY_Z
        rigid[:, 12] = BAGGING_PARITY_VZ
        rigid[1, 4] += BAGGING_PARITY_SHIFT
        x = s.particles.x.clone()
        x[1, :, 0] += BAGGING_PARITY_SHIFT
        s = s._replace(rigid=rigid, particles=s.particles.replace(x=x))
        with torch.no_grad(), gc.solve_log() as log:
            nxt, imp = bag.world.step_with_impulses(bag.params, s, rigid.new_zeros(2, 6))
        vals = {"x": nxt.particles.x, "v": nxt.particles.v, "C": nxt.particles.C,
                "rigid": nxt.rigid, "impulses": imp}
        if model == "implicit":
            vals["residual"] = torch.stack([sol.residual for sol in log])
            its = torch.stack([sol.iterations for sol in log]).cpu()
        check(int(nxt.particles.dropped.max()) == 0, f"bagging parity {model}: dropped")
        out[model] = vals
    grid, cfg, sheet, geoms, params = mpm_cloth_demo.build(device, dtype, z=DRAPE_PARITY_Z)
    rng = np.random.default_rng(SEED)
    x = sheet.x + torch.as_tensor(0.002 * rng.standard_normal(tuple(sheet.x.shape)),
                                  dtype=dtype, device=device)
    with torch.no_grad():
        st, acc = cloth.simulate_cloth(grid, cfg, sheet.replace(x=x), DRAPE_PARITY_SUBSTEPS,
                                       geoms, params)
    out["drape"] = {"x": st.x, "v": st.v, "C": st.C}
    check(float(acc.abs().max()) == 0.0, "drape parity: the sheet met the sphere")
    return ({case: {k: v.detach().double().cpu() for k, v in vals.items()}
             for case, vals in out.items()}, its)


def bagging_parity(torch, modules, dev, card):
    """Phase 14a: card float32 against CPU float64, within BAGGING_PARITY,
    the implicit step's iteration counts within BAGGING_PARITY_ITERATIONS."""
    ref, its_ref = bagging_parity_values(torch, *modules, torch.device("cpu"), torch.float64)
    got, its = bagging_parity_values(torch, *modules, dev, torch.float32)
    for case in ref:
        for name, (rel, scale) in coupled_parity_errors(ref[case], got[case]).items():
            bound = BAGGING_PARITY[case][name]
            ok = rel <= bound
            print(f"[bagging parity {case}] {name} {tuple(ref[case][name].shape)}: "
                  f"max|f32 card - f64 cpu| / scale = {rel:.3e} (<= {bound:.1e}; scale "
                  f"{scale:.3e}; float32 on a CPU: {BAGGING_PARITY_CPU[case][name]:.1e}) "
                  f"{'ok' if ok else 'FAIL'} [{card}]")
            check(ok, f"bagging parity {case}: {name} off by {rel:.3e} (bound {bound:.1e})")
    d = int((its - its_ref).abs().max())
    ok = d <= BAGGING_PARITY_ITERATIONS
    print(f"[bagging parity implicit] Newton iterations a solve, lanes x substeps: card "
          f"{its.T.tolist()}, cpu float64 {its_ref.T.tolist()}, max |difference| {d} (<= "
          f"{BAGGING_PARITY_ITERATIONS}) {'ok' if ok else 'FAIL'} [{card}]")
    check(ok, f"bagging parity: iteration counts {d} apart")
    check(bool((its_ref > 1).any(dim=0).all()), "bagging parity: a lane's ball never met the sheet")


def bagging_run(torch, mk, gc, mpm_bagging, model, dev, xla_only=False, state=None, start=0,
                steps=None, keep=()):
    """`steps` steps (default BAGGING_STEPS) of the bagging demo on one world
    from `state` at step `start` (default: the demo's start), after one
    warm-up step from there, keeping the states after the steps in `keep`.
    Returns (the world, the joined results, {step: kept state}, launches,
    launches with the mass, Newton iterations, peak bytes)."""
    steps = BAGGING_STEPS if steps is None else steps
    bag = mpm_bagging.build(model, device=dev, xla_only=xla_only)
    mpm_bagging.simulate(bag, 1, state=state, start=start)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launch_counts()
    parts, kept = [], {}
    with gc.solve_log() as log:
        at = start
        for stop in sorted(set(keep) | {start + steps}):
            parts.append(mpm_bagging.simulate(bag, stop - at, state=state, start=at))
            state, at = parts[-1].state, stop
            kept[stop] = state
    launches, with_mass = dict(mk.LAUNCHES), dict(mk.LAUNCHES_WITH_MASS)
    peak = torch.cuda.max_memory_allocated()
    res = mpm_bagging.BaggingRun(
        state=parts[-1].state, ball_z=torch.cat([p.ball_z for p in parts]),
        impulses=torch.cat([p.impulses for p in parts]),
        dropped=torch.cat([p.dropped for p in parts]), wall_s=sum(p.wall_s for p in parts))
    its = torch.stack([sol.iterations for sol in log]).cpu() if log else None
    return bag, res, kept, launches, with_mass, its, peak


def bagging_main_path(torch, mk, gc, mpm_bagging, model, dev, card):
    """Phase 14b (implicit) or 14d (penalty): the demo's first BAGGING_STEPS
    steps on one world, timed by the host wall after one warm-up step, with
    the gates: finite, no particle dropped, one K2 and one K1 from block
    windows a substep (with the mass on the implicit branch), the sheet's
    impulse on the ball from the first contact on pointing up, the ball's
    height within its bound of the JAX package's.  Returns (launches, the
    states at the steps of BAGGING_PATH_STARTS, the final state, the
    world)."""
    keep = BAGGING_PATH_STARTS if model == "implicit" else ()
    bag, res, kept, launches, with_mass, its, peak = bagging_run(
        torch, mk, gc, mpm_bagging, model, dev, keep=keep)
    phase = "14b" if model == "implicit" else "14d"
    tag = f"bagging {model} (phase {phase})"
    substeps = BAGGING_STEPS * bag.world.substeps_per_step
    p = res.state.particles
    finite = all(bool(torch.isfinite(t).all()) for t in (res.state.rigid, p.x, p.v, p.C))
    z = float(res.ball_z[-1])
    z_ref, bound = BAGGING_Z_END[model], BAGGING_Z_END_BOUND[model]
    imp = res.impulses[BAGGING_CONTACT_STEP - 1:].double().sum(dim=0).cpu()  # [tau; f]
    dropped = int(res.dropped.max())
    print(f"[{tag}] {BAGGING_STEPS} coupled steps x {bag.world.substeps_per_step} substeps, "
          f"{p.x.shape[0]} vertices, one world, float32 TF32 off: "
          f"{substeps / res.wall_s!r} substeps/s (wall {res.wall_s!r} s, "
          f"{res.wall_s / substeps * 1e3!r} ms a substep), peak memory {peak} B "
          f"({peak / 2**30:.3f} GiB) [{card}]")
    print(f"[{tag}] launches {json.dumps(launches)} (with the mass "
          f"{with_mass['update_grid_blocks']}), a substep {launches['p2g_block'] / substeps!r} "
          f"K2 and {launches['update_grid_blocks'] / substeps!r} K1 from block windows; "
          f"dropped max {dropped}, finite {finite} [{card}]")
    z_contact = float(res.ball_z[BAGGING_CONTACT_STEP - 1])
    print(f"[{tag}] ball z at step {BAGGING_CONTACT_STEP} {z_contact!r}, "
          f"at step {BAGGING_STEPS} {z!r} (JAX package, CPU float32: {z_ref!r}; |difference| "
          f"{abs(z - z_ref)!r} <= {bound!r}); the sheet's impulse on the ball over steps "
          f"{BAGGING_CONTACT_STEP}-{BAGGING_STEPS}: f {imp[3:].tolist()} N s, tau "
          f"{imp[:3].tolist()} N m s [{card}]")
    n = substeps
    want = {"update_grid": 0, "update_grid_blocks": n, "p2g_block": n, "g2p_block": 0}
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    want_mass = n if model == "implicit" else 0
    check(with_mass["update_grid_blocks"] == want_mass,
          f"{tag}: {with_mass} launches with the mass, expected {want_mass}")
    check(finite, f"{tag}: non-finite state")
    check(dropped == 0, f"{tag}: dropped {dropped}")
    check(float(imp[5]) > float(imp[3:5].norm()), f"{tag}: the sheet's impulse {imp[3:].tolist()} "
          "does not point up")
    check(abs(z - z_ref) <= bound, f"{tag}: ball z {z!r} off the JAX package's {z_ref!r}")
    if its is not None:
        gp = gc.GridContactParams()
        capped = int((its >= gp.max_iterations).sum())
        print(f"[{tag}] Newton iterations a solve over {its.numel()} solves: median "
              f"{float(its.double().median())!r}, max {int(its.max())}, mean "
              f"{float(its.double().mean())!r}; {capped} at the cap of {gp.max_iterations} "
              f"[{card}]")
    return launches, kept, res.state, bag


def cloth_kernels(torch, cloth, mpm, mk, bag, state, card):
    """Phase 14c's kernel part: K2 and K1 from block windows with the mass at
    the cloth's shape (one world, 32^3, A = 256) on the sheet at `state`, held
    against their plain versions and timed warm and cold beside their
    bounds (K2's of its live blocks, and of every block's output beside
    it)."""
    config = bag.world.mpm_config
    sheet = state.particles
    p = cloth._to_mpm_state(config, sheet,
                            cloth.vertex_forces(bag.world.cloth_config, sheet))
    sort = mpm.sort_particles(config, p)
    A = sort.starts.numel()
    rows = sort.packed.shape[0]
    live = int((sort.counts > 0).sum())
    tag = f"cloth n={rows} A={A} ({live} live) grid {config.grid_size}"
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=sort.packed.device)
    out = {"update_grid_blocks": implicit_k1_mass(torch, mpm, mk, config, p, flush, card,
                                                  tag=f"{tag} K1 mass")}
    p2g_args = (sort.packed, sort.starts, sort.counts, config.block_capacity)
    kernel = lambda: mk.p2g_block_cuda(*p2g_args)  # noqa: E731
    plain = lambda: mk.p2g_block_reference(*p2g_args)  # noqa: E731
    err, ok, detail = kernel_parity(torch, "p2g_block", kernel, plain, bound_k2)
    print(f"[parity {tag}] p2g_block: max|kernel - plain| = {err:.3e} ({detail}) "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, f"p2g_block disagrees with its plain version at {tag}")
    # The bound counts the live blocks' output only: K1 from block windows
    # finds a node's windows among the blocks that hold particles, so the
    # sentinel blocks' windows (236 of 256 here) are written and never read.
    _, live_bytes = k2_live_bytes(mk, sort)
    taken = rows - int(sort.dropped)
    flops = taken * 27 * (2 + 2 * 13)
    out["p2g_block"], line = time_kernel(torch, kernel, plain, flush, live_bytes, flops)
    out["p2g_block"]["max_abs_err"] = err
    print(f"[time {tag}] p2g_block on its {live} live blocks of {A} and 13 live channels of "
          f"{mk.P2G_NV}: {line} [{card}]")
    full_bytes = 4 * (rows * 28 + A * mk.P2G_NV * mk.P2G_NODES) + 2 * A * 4
    full_ms, _ = bound_ms(full_bytes, flops)
    print(f"[time {tag}] p2g_block with every block's whole output written: bound "
          f"{full_ms!r} ms ({full_bytes} bytes), share of it warm "
          f"{full_ms / out['p2g_block']['ms']:.3f} [{card}]")
    del flush
    return out


def cloth_phase(torch, mpm, mk, gc, cloth, mpm_bagging, mpm_cloth_demo, dev, card, profile):
    """Phase 14: the cloth bagging demo on the card (14a parity, 14b the
    main path implicit, 14c kernels against plain versions over steps 60-70
    and 160-170 and K1 and K2 at the cloth's shape, 14d the main path with
    the penalty).  Returns (14b's launches, 14d's launches, the kernel
    results)."""
    bagging_parity(torch, (cloth, mpm_bagging, mpm_cloth_demo, gc), dev, card)
    launches, kept, final, bag = bagging_main_path(torch, mk, gc, mpm_bagging, "implicit", dev,
                                                   card)
    for start in BAGGING_PATH_STARTS:
        k, pl = (bagging_run(torch, mk, gc, mpm_bagging, "implicit", dev, xla_only=xla_only,
                             state=kept[start], start=start, steps=BAGGING_PATH_STEPS)[1]
                 for xla_only in (False, True))
        dx = float((k.state.particles.x - pl.state.particles.x).abs().max())
        dv = float((k.state.particles.v - pl.state.particles.v).abs().max())
        dr = float((k.state.rigid - pl.state.rigid).abs().max())
        bound = BAGGING_MAX_DIFF_PATHS[start]
        ok = dx <= bound["x"] and dv <= bound["v"]
        print(f"[bagging kernels (phase 14c)] steps {start}-{start + BAGGING_PATH_STEPS} from "
              f"14b's state, kernel vs plain: max|dx| {dx:.3e} (<= {bound['x']:.1e}), max|dv| "
              f"{dv:.3e} (<= {bound['v']:.1e}), max|d rigid| {dr:.3e} "
              f"{'ok' if ok else 'FAIL'}; kernel/plain substeps/s {pl.wall_s / k.wall_s!r} "
              f"[{card}]")
        check(ok, f"bagging steps {start}-{start + BAGGING_PATH_STEPS}: kernel and plain "
              "paths disagree")
    timed = cloth_kernels(torch, cloth, mpm, mk, bag, final, card)
    if profile:
        tau = final.rigid.new_zeros(6)

        def run():
            with torch.no_grad():
                bag.world.step(bag.params, final, tau)

        profile_layers(torch, run, bag.world.substeps_per_step, CLOTH_LAYERS, CLOTH_TOP_LAYERS,
                       f"bagging implicit coupled step at step {BAGGING_STEPS}", "substep",
                       card, ("update_grid_blocks_kernel", "p2g_block_kernel", "index",
                              "gather", "scatter"))
    torch.cuda.empty_cache()
    launches_penalty = bagging_main_path(torch, mk, gc, mpm_bagging, "penalty", dev, card)[0]
    return launches, launches_penalty, timed


def rel_errors(ref, got):
    """{name: max |got - ref| over the float64 answer's scale}: max(1, |x|)
    for the names marked as states, max |ref| otherwise."""
    out = {}
    for name, (r, is_state) in ref.items():
        g = got[name][0]
        scale = float(r.abs().max())
        out[name] = float((g - r).abs().max()) / (max(1.0, scale) if is_state else max(scale, 1e-300))
    return out


def quad_parity_values(torch, bq, ilqr, device, dtype):
    """Phase 17a's quantities at batch QUAD_PARITY_BATCH from the bench's
    draws, as {name: (float64 CPU tensor, is_state)}: the dynamics, the rk4
    step and its Jacobian, one 8-iteration ``ilqr.solve`` and one
    ``rti_solve`` from the hover warm start."""
    from drake_tpu_torch.models import quadrotor

    prob = bq.build(dtype, device)
    p = prob["params"]
    x0s = torch.tensor(bq.draws(QUAD_PARITY_BATCH), dtype=dtype, device=device)
    us = prob["us0"].expand(QUAD_PARITY_BATCH, -1, -1)
    # Rotor forces off hover, so that the quadrotor turns.
    u = us[:, 0] + torch.linspace(-0.5, 0.5, 4, dtype=dtype, device=device)
    t = torch.zeros(QUAD_PARITY_BATCH, dtype=dtype, device=device)
    lims = dict(dt=bq.DT, u_lower=prob["u_lower"], u_upper=prob["u_upper"])
    costs = (prob["running_cost"], prob["final_cost"], p)
    sol = ilqr.solve(prob["step"], *costs, x0s, us, options=ilqr.IlqrOptions(max_iters=8), **lims)
    rti = ilqr.rti_solve(prob["step"], *costs, x0s, us, **lims)
    values = {
        "dynamics": (quadrotor.dynamics(p, x0s, u), False),
        "rk4 x_next": (prob["step"](p, x0s, u, t), True),
        "rk4 Jacobian": (ilqr.linearize(prob["step"], p, x0s, u, t)[1], False),
        "solve xs": (sol.xs, True), "solve us": (sol.us, False), "solve cost": (sol.cost, False),
        "rti xs": (rti.xs, True), "rti us": (rti.us, False), "rti cost": (rti.cost, False),
    }
    out = {k: (v.detach().double().cpu(), s) for k, (v, s) in values.items()}
    return out, sol.iterations.cpu()


def quad_parity(torch, bq, ilqr, dev, card):
    """Phase 17a: card float32 against CPU float64."""
    ref, ref_it = quad_parity_values(torch, bq, ilqr, torch.device("cpu"), torch.float64)
    got, got_it = quad_parity_values(torch, bq, ilqr, dev, torch.float32)
    torch.cuda.synchronize()
    for name, err in rel_errors(ref, got).items():
        finite = bool(torch.isfinite(got[name][0]).all())
        ok = finite and err <= QUAD_PARITY[name]
        print(f"[quadrotor parity batch={QUAD_PARITY_BATCH} (phase 17a)] {name} "
              f"{tuple(ref[name][0].shape)}: max|f32 card - f64 cpu| / scale = {err:.3e} "
              f"(<= {QUAD_PARITY[name]:.1e}) {'ok' if ok else 'FAIL'}")
        check(ok, f"quadrotor parity: {name} off by {err:.3e} of its scale")
    print(f"[quadrotor parity (phase 17a)] 8-iteration solve iterations: card float32 "
          f"{got_it.tolist()}, cpu float64 {ref_it.tolist()}")


def quad_main_path(torch, bq, mk, dev, card):
    """Phase 17b: the bench's rollout at QUAD_BATCH lanes in one call."""
    mk.reset_launch_counts()
    res = bq.run(QUAD_BATCH, QUAD_STEPS, device=dev)
    launches = dict(mk.LAUNCHES)
    need = math.ceil(QUAD_JAX_PROGRESSING - QUAD_PROGRESS_SLACK * QUAD_BATCH)
    print(f"[quadrotor run (phase 17b)] batch={QUAD_BATCH} horizon={bq.HORIZON} "
          f"steps={QUAD_STEPS} RTI float32 TF32 off: wall {res['wall_s']!r} s, "
          f"{res['solves_per_s']!r} solves/s, {res['wall_s'] / QUAD_STEPS * 1e3!r} ms per MPC "
          f"step [{card}]")
    print(f"[quadrotor run (phase 17b)] {res['progressing']}/{QUAD_BATCH} progressing (gate "
          f">= {need}: the JAX package's CPU float32 {QUAD_JAX_PROGRESSING} less "
          f"{QUAD_PROGRESS_SLACK:.0%}), median final error {res['median_final_err']!r} m, "
          f"finite={res['finite']}, frozen lanes {res['frozen_lanes']}, rejected plans "
          f"{res['rejected_plans']}, peak memory {res['peak_memory_bytes']} B "
          f"({res['peak_memory_bytes'] / 2**30:.3f} GiB); K1-K3 launches {json.dumps(launches)} "
          f"[{card}]")
    check(res["finite"], "quadrotor rollout: non-finite state or input")
    check(res["frozen_lanes"] == 0, f"quadrotor rollout: {res['frozen_lanes']} lanes frozen")
    check(res["progressing"] >= need,
          f"quadrotor rollout: {res['progressing']}/{QUAD_BATCH} progressing, below {need}")
    return launches, res


def quad_profile(torch, bq, mpc, ilqr, res, dev, card):
    """Phase 17c: torch.profiler over PROFILE_QUAD_STEPS RTI MPC steps of the
    4,096 lanes from 17b's states after a third of its steps."""
    prob = bq.build(torch.float32, dev)
    x_start = res["result"].xs[:, QUAD_STEPS // 3].contiguous()

    def run():
        return mpc.ilqr_mpc_rollout(
            prob["step"], prob["running_cost"], prob["final_cost"], prob["params"], x_start,
            prob["us0"], PROFILE_QUAD_STEPS, dt=bq.DT, u_lower=prob["u_lower"],
            u_upper=prob["u_upper"], options=ilqr.IlqrOptions(rti=True))

    profile_layers(torch, run, PROFILE_QUAD_STEPS, QUAD_LAYERS, QUAD_LAYERS,
                   f"quadrotor batch={QUAD_BATCH} RTI", "RTI step", card)


def dircol_first_iteration(torch, pendulum_dircol, sqp, ipm, dev, card):
    """Phase 18a: the pendulum's first SQP iteration from the straight-line
    guess, card float64 against CPU float64, held three ways: the QP's data
    and its solution (each device's own), the QP alone (the CPU's data
    solved on the card), and the whole iteration (``sqp.solve`` with
    ``max_iters=1``)."""
    opts = sqp.SqpOptions()
    out = {}
    for key, device in (("cpu", torch.device("cpu")), ("card", dev)):
        system, problem, x0, xf = pendulum_dircol.build_problem(torch.float64, device)
        z0 = problem.initial_guess(x0, xf, pendulum_dircol.TIMESPAN, torch.float64, device)[None]
        lb, ub = problem.bounds(torch.float64, device)
        args = (system.default_params,)
        m = problem.constraints(z0[0], *args).shape[0]
        data = sqp.qp_at(problem.cost, problem.constraints, z0, z0.new_zeros((1, m)),
                         torch.full((1,), opts.penalty0, dtype=torch.float64, device=device),
                         lb, ub, opts, args)
        out[key] = {
            "data": data, "qp": ipm.solve_qp_ipm(*data, opts.qp),
            "iteration": sqp.solve(problem.cost, problem.constraints, z0, lb, ub,
                                   dataclasses.replace(opts, max_iters=1), args),
        }
    cpu, card_ = out["cpu"], out["card"]
    alone = ipm.solve_qp_ipm(*(a.to(dev) for a in cpu["data"]), opts.qp)
    torch.cuda.synchronize()
    pairs = {f"QP data {name}": (c, g) for name, c, g in zip(
        ("P", "q", "G", "b", "lb", "ub"), cpu["data"], card_["data"])}
    for name in ("w", "y", "z_lower", "z_upper"):
        pairs[f"QP {name}"] = (getattr(cpu["qp"], name), getattr(card_["qp"], name))
        pairs[f"QP alone {name}"] = (getattr(cpu["qp"], name), getattr(alone, name))
    for name in ("z", "lam", "cost", "constraint_violation"):
        pairs[f"iteration {name}"] = (getattr(cpu["iteration"], name),
                                      getattr(card_["iteration"], name))
    for name, (c, g) in pairs.items():
        c, g = c.cpu(), g.cpu()
        finite = torch.isfinite(c)
        scale = max(1.0, float(c[finite].abs().max()))
        same_inf = bool(torch.equal(finite, torch.isfinite(g)))
        err = float((g[finite] - c[finite]).abs().max()) / scale
        ok = same_inf and err <= DIRCOL_PARITY
        print(f"[dircol first iteration (phase 18a)] {name} {tuple(c.shape)}: max|f64 card - "
              f"f64 cpu| / max(1, max|cpu|) = {err:.3e} (<= {DIRCOL_PARITY:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"dircol first iteration: {name} off by {err:.3e} of its scale")
    its = {k: (int(v["qp"].iterations[0]), int(v["iteration"].iterations[0]))
           for k, v in out.items()}
    print(f"[dircol first iteration (phase 18a)] IPM and SQP iterations: cpu {its['cpu']}, "
          f"card {its['card']}, QP alone on the card {int(alone.iterations[0])}")
    check(its["cpu"] == its["card"] and int(alone.iterations[0]) == its["cpu"][0],
          "dircol first iteration: iteration counts differ")


def dircol_main_path(torch, pendulum_dircol, dircol, sqp, mk, dev, card):
    """Phase 18b: examples/pendulum_dircol.py's flow in float64 on the card,
    with tests/test_dircol.py's gates."""
    system, problem, x0, xf = pendulum_dircol.build_problem(torch.float64, dev)
    z0 = problem.initial_guess(x0, xf, pendulum_dircol.TIMESPAN, torch.float64, dev)[None]
    dircol.solve(problem, system.default_params, z0, sqp.SqpOptions(max_iters=2))  # warm-up
    torch.cuda.synchronize()
    mk.reset_launch_counts()
    out = pendulum_dircol.run(torch.float64, dev)
    launches = dict(mk.LAUNCHES)
    sol = out["sol"]
    viol, h = float(sol.constraint_violation[0]), float(sol.h[0])
    u_max = float(sol.us.abs().max())
    end_err = max(float((sol.xs[0, 0] - x0).abs().max()), float((sol.xs[0, -1] - xf).abs().max()))
    print(f"[dircol swing-up (phase 18b)] float64: solve {out['solve_s']!r} s, "
          f"{int(sol.iterations[0])} SQP iterations, success={bool(sol.success[0])}, cost "
          f"{float(sol.cost[0])!r}, viol {viol:.3e}, h {h!r}, |u| max {u_max!r}, end knots "
          f"off by {end_err:.3e}; closed loop {out['xs'].shape[-2] - 1} steps in "
          f"{out['track_s']!r} s, final error {out['err']:.3e}; K1-K3 launches "
          f"{json.dumps(launches)} [{card}]")
    print("SWING-UP", "SUCCESS" if out["err"] < pendulum_dircol.SUCCESS_ERR else "FAILURE")
    check(bool(sol.success[0]) and viol < 1e-5, f"dircol: success {bool(sol.success[0])}, "
          f"viol {viol:.3e}")
    check(u_max <= 3.0 + 1e-6 and 0.2 - 1e-9 <= h <= 0.5 + 1e-9, f"dircol: |u| {u_max}, h {h}")
    check(end_err <= 1e-6, f"dircol: end knots off by {end_err:.3e}")
    check(out["err"] < 1e-3, f"dircol closed loop: final error {out['err']:.3e}")
    with torch.enable_grad():  # autograd on: utils.scan runs the eager loop
        eager = pendulum_dircol.track(system, sol, x0[None], DIRCOL_GRAPH_CHECK_STEPS)
    diff = max(float((g[: DIRCOL_GRAPH_CHECK_STEPS + 1] - e).abs().max())
               for g, e in zip(out["xs"], eager[0]))
    print(f"[dircol swing-up (phase 18b)] the closed loop's first {DIRCOL_GRAPH_CHECK_STEPS} "
          f"steps, CUDA graph against eager: max |difference| in x {diff!r} (== 0)")
    check(diff == 0.0, f"dircol: the graphed closed loop is {diff!r} off the eager one")
    return launches


def dircol_bench_phase(torch, bench_dircol_f32, sqp, mk, dev, card):
    """Phase 18c: the float32 bench's batch of DIRCOL_BATCH cold starts in
    one call."""
    mk.reset_launch_counts()
    res = bench_dircol_f32.run(DIRCOL_BATCH, device=dev)
    launches = dict(mk.LAUNCHES)
    print(f"[dircol f32 bench (phase 18c)] batch={DIRCOL_BATCH} in one call: wall "
          f"{res['wall_s']!r} s, {res['solves_per_s']!r} solves/s, {res['feasible']}/"
          f"{DIRCOL_BATCH} feasible at viol < {res['feas_tol']} (gate >= "
          f"{DIRCOL_FEASIBLE_GATE}: the JAX package's CPU float32 count {DIRCOL_JAX_FEASIBLE} "
          f"on these guesses, {DIRCOL_JAX_FEASIBLE_NUDGED} on them moved -2, -1, +1, +2 "
          f"ulps), {res['success']} within 10x constraint_tol, "
          f"SQP iterations max {res['sqp_iterations_max']} median "
          f"{res['sqp_iterations_median']}, peak memory {res['peak_memory_bytes']} B; K1-K3 "
          f"launches {json.dumps(launches)} [{card}]")
    # The Lagrangian Hessian by torch.func over the 32 lanes: its peak memory.
    system, problem, _, _ = bench_dircol_f32.pendulum_dircol.build_problem(torch.float32, dev)
    z = res["z0s"]
    lb, ub = problem.bounds(torch.float32, dev)
    m = problem.constraints(z[0], system.default_params).shape[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sqp.qp_at(problem.cost, problem.constraints, z, z.new_ones((DIRCOL_BATCH, m)),
              torch.full((DIRCOL_BATCH,), 10.0, dtype=torch.float32, device=dev), lb, ub,
              bench_dircol_f32.OPTIONS, (system.default_params,))
    torch.cuda.synchronize()
    print(f"[dircol f32 bench (phase 18c)] one iteration's derivatives and QP data at batch "
          f"{DIRCOL_BATCH}: peak {torch.cuda.max_memory_allocated() - base} B above the "
          f"{base} B held [{card}]")
    check(res["finite"], "dircol f32 bench: non-finite solution")
    check(res["feasible"] >= DIRCOL_FEASIBLE_GATE,
          f"dircol f32 bench: {res['feasible']}/{DIRCOL_BATCH} feasible, below "
          f"{DIRCOL_FEASIBLE_GATE}")
    return launches, res


def dircol_profile(torch, bench_dircol_f32, dircol, res, dev, card):
    """Phase 18d: torch.profiler over PROFILE_SQP_ITERS SQP iterations of the
    float32 bench's batch, and the batched eigh of its Lagrangian Hessians
    timed alone."""
    system, problem, _, _ = bench_dircol_f32.pendulum_dircol.build_problem(torch.float32, dev)
    z0s = res["z0s"]
    opts = dataclasses.replace(bench_dircol_f32.OPTIONS, max_iters=PROFILE_SQP_ITERS)

    def run():
        return dircol.solve(problem, system.default_params, z0s, opts)

    profile_layers(torch, run, PROFILE_SQP_ITERS, DIRCOL_LAYERS, DIRCOL_LAYERS,
                   f"dircol f32 batch={DIRCOL_BATCH}", "SQP iteration", card,
                   ("syevj", "syevd", "getrf", "getrs", "laswp"))
    n = z0s.shape[-1]
    for dtype, lanes in ((torch.float32, DIRCOL_BATCH), (torch.float64, 1)):
        H = torch.randn((lanes, n, n), dtype=dtype, device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED))
        H = H + H.mT
        ms = time_ms(torch, lambda: torch.linalg.eigh(H), KERNEL_REPS)
        print(f"[profile dircol (phase 18d)] torch.linalg.eigh of {lanes} x {n} x {n} {dtype}: "
              f"{ms!r} ms a call (back to back, CUDA events) [{card}]")


def random_stabilizable(torch, lanes, n=4, m=2, seed=SEED):
    """`lanes` seeded systems as in tests/test_torch_control.py: A, B with
    entries N(0, 1), Q = C'C / n + 0.1 I, R = D'D / m + 0.5 I, float64 CPU."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, dtype=torch.float64, generator=gen)

    A, B, C, D = randn(lanes, n, n), randn(lanes, n, m), randn(lanes, n, n), randn(lanes, m, m)
    eye = lambda k: torch.eye(k, dtype=torch.float64)  # noqa: E731
    return A, B, C.mT @ C / n + 0.1 * eye(n), D.mT @ D / m + 0.5 * eye(m)


def lqr_parity_values(torch, device):
    """Phase 19a's quantities on `device` in float64, as {name: CPU tensor}:
    the Riccati and Lyapunov solvers over LQR_PARITY_SYSTEMS systems, the
    upright and hover LQRs of the acrobot, the cart-pole and the quadrotor,
    and a TV-LQR (S, K, k0) about a passive acrobot swing with a desired
    state off it."""
    from drake_tpu_torch.control import lqr
    from drake_tpu_torch.math import riccati
    from drake_tpu_torch.models import acrobot, cart_pole, quadrotor
    from drake_tpu_torch.systems import simulator

    A, B, Q, R = (a.to(device) for a in random_stabilizable(torch, LQR_PARITY_SYSTEMS))
    n = A.shape[-1]
    eye = torch.eye(n, dtype=torch.float64, device=device)
    radius = torch.linalg.eigvals(A).abs().amax(-1)[:, None, None]
    out = {"solve_care": riccati.solve_care(A, B, Q, R),
           "solve_dare": riccati.solve_dare(0.5 * A, B, Q, R),
           "lyapunov continuous": riccati.solve_lyapunov_continuous(A - (radius + 0.5) * eye, Q),
           "lyapunov discrete": riccati.solve_lyapunov_discrete(0.8 * A / radius, Q)}
    f64 = dict(dtype=torch.float64, device=device)
    for name, model, x0, u0, Qd, Rd in (
            ("acrobot", acrobot, acrobot.upright_state(torch.float64, device), None,
             (10.0, 10.0, 1.0, 1.0), (1.0,)),
            ("cart-pole", cart_pole, cart_pole.upright_state(torch.float64, device), None,
             (100.0, 50.0, 5.0, 5.0), (1.0,)),
            ("quadrotor", quadrotor, torch.zeros(12, **f64), "hover",
             (10.0,) * 6 + (1.0,) * 6, (0.1,) * 4)):
        p = model.default_params(torch.float64, device)
        u = quadrotor.hover_input(p) if u0 == "hover" else torch.zeros(1, **f64)
        res = lqr.lqr_for_system(model.make_system(p), p, x0, u, torch.diag(torch.tensor(Qd, **f64)),
                                 torch.diag(torch.tensor(Rd, **f64)))
        out[f"{name} K"], out[f"{name} S"] = res.K, res.S
    p = acrobot.default_params(torch.float64, device)
    system = acrobot.make_system(p)
    with torch.no_grad():
        xs, _ = simulator.simulate(system, p, torch.tensor([1.2, -0.4, 0.0, 0.0], **f64),
                                      torch.zeros((300, 1), **f64), 0.01)
    Qa = torch.diag(torch.tensor((10.0, 10.0, 1.0, 1.0), **f64))
    tv = lqr.finite_horizon_lqr(system, p, Qa, torch.ones((1, 1), **f64), 0.0, 3.0, 300,
                                x0_traj=xs, u0_traj=torch.zeros((301, 1), **f64), Qf=Qa,
                                xd_traj=xs + 0.05)
    out.update({"TV-LQR S": tv.S, "TV-LQR K": tv.K, "TV-LQR k0": tv.k0})
    return {k: v.detach().cpu() for k, v in out.items()}


def lqr_parity(torch, dev, card):
    """Phase 19a: card float64 against CPU float64 within LQR_PARITY of the
    scale."""
    ref = lqr_parity_values(torch, torch.device("cpu"))
    got = lqr_parity_values(torch, dev)
    for name, r in ref.items():
        g = got[name]
        scale = max(1.0, float(r.abs().max()))
        err = float((g - r).abs().max()) / scale
        ok = bool(torch.isfinite(g).all()) and err <= LQR_PARITY
        print(f"[lqr parity (phase 19a)] {name} {tuple(r.shape)}: max|f64 card - f64 cpu| / "
              f"max(1, max|cpu|) = {err:.3e} (<= {LQR_PARITY:.0e}) {'ok' if ok else 'FAIL'}")
        check(ok, f"lqr parity: {name} off by {err:.3e} of its scale")


def swingup_phase(torch, acrobot_swingup, mk, dev, card):
    """Phase 19b: examples/acrobot_swingup.py's four stages in float64 on
    the card, with the example's gate; the closed loop's CUDA graph held
    against the eager loop over its first GRAPH_CHECK_STEPS steps."""
    mk.reset_launch_counts()
    out = acrobot_swingup.run(dev)
    launches = dict(mk.LAUNCHES)
    warm, sol, s = out["warm"], out["sol"], out["seconds"]
    xf = out["xf"]
    print(f"[swing-up (phase 19b)] float64 iLQR: {int(warm.iterations[0])} iterations, final "
          f"error {float(torch.linalg.vector_norm(warm.xs[0, -1] - xf))!r}, {s['ilqr']!r} s; "
          f"dircol: {int(sol.iterations[0])} SQP iterations, success={bool(sol.success[0])}, "
          f"viol {float(sol.constraint_violation[0]):.3e}, cost {float(sol.cost[0])!r}, "
          f"T {float(sol.h[0]) * (acrobot_swingup.KNOTS - 1)!r} s, {s['dircol']!r} s (the JAX "
          f"package on a CPU: {SWINGUP_JAX_CPU_ITERS[0]} and {SWINGUP_JAX_CPU_ITERS[1]} "
          f"iterations) [{card}]")
    check(bool(sol.success[0]), f"swing-up: dircol failed, viol "
          f"{float(sol.constraint_violation[0]):.3e} after {int(sol.iterations[0])} iterations")
    steps = out["xs"].shape[-2] - 1
    print(f"[swing-up (phase 19b)] TV-LQR ({acrobot_swingup.N_GRID + 1} knots) {s['tvlqr']!r} s; "
          f"closed loop {steps} steps in {s['closed_loop']!r} s "
          f"({s['closed_loop'] / steps * 1e3!r} ms a step, CUDA graph), final error "
          f"{out['err']:.3e} (the JAX package on a CPU: {SWINGUP_JAX_CPU_ERR:.2e}; gate "
          f"< {acrobot_swingup.SUCCESS_ERR:.0e}); K1-K3 launches {json.dumps(launches)} [{card}]")
    x_init = (out["x0"] + torch.tensor(acrobot_swingup.PERTURB, dtype=torch.float64,
                                       device=dev))[None]
    args = (out["system"], x_init, xf, out["T"], out["bal"], out["tvlqr"], GRAPH_CHECK_STEPS)
    with torch.no_grad():
        graphed = acrobot_swingup.closed_loop(*args)
    with torch.enable_grad():  # autograd on: utils.scan runs the eager loop
        eager = acrobot_swingup.closed_loop(*args)
    diff = max(float((g - e).abs().max()) for g, e in zip(graphed, eager))
    print(f"[swing-up (phase 19b)] the closed loop's first {GRAPH_CHECK_STEPS} steps, CUDA graph "
          f"against eager: max |difference| in x and u {diff!r} (== 0)")
    check(diff == 0.0, f"swing-up: the graphed closed loop is {diff!r} off the eager one")
    ok = out["err"] < acrobot_swingup.SUCCESS_ERR
    print("SWINGUP+TVLQR", "SUCCESS" if ok else "FAILURE")
    check(ok, f"swing-up: closed-loop final error {out['err']:.3e}")
    return launches, out


def family_phase(torch, examples, mk, dev, card):
    """Phase 19c: the LQR family's examples at their full widths in float32
    on the card, each with its own gates and its wall time."""
    cart_pole_lqr, acrobot_spong, acrobot_lqr_estimator, acrobot_spong_optimize = examples
    by_path = {}

    def timed(name, fn):
        mk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        by_path[f"{name} (phase 19c)"] = dict(mk.LAUNCHES)
        return out, time.perf_counter() - t0

    out, wall = timed("cart-pole LQR, 256 lanes", lambda: cart_pole_lqr.run(torch.float32, dev))
    ok = cart_pole_lqr.gates(out)
    print(f"[cart-pole lqr (phase 19c)] float32: closed-loop error {out['err_cl']:.3e} (< 1e-2), "
          f"open-loop {out['err_ol']!r} (> 0.5), basin {out['n_stable']}/{out['lanes']} "
          f"recovered (> 200); sweep of {out['lanes']} lanes x {cart_pole_lqr.STEPS} steps "
          f"{out['sweep_s']!r} s ({out['lanes'] / out['sweep_s']!r} lanes/s), wall {wall!r} s "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "cart-pole LQR: a gate failed")

    out, wall = timed("acrobot Spong, 1 + 64 lanes", lambda: acrobot_spong.run(torch.float32, dev))
    ok = acrobot_spong.gates(out)
    sec = out["seconds"]
    print(f"[acrobot spong (phase 19c)] float32: single swing-up error {out['err']:.3e} (< 1e-2) "
          f"in {sec['single']!r} s; {out['n_up']}/{out['batch']} upright (>= 90%), max error "
          f"{float(out['errs'].max()):.3e}, {acrobot_spong.STEPS} steps in {sec['batch']!r} s "
          f"({out['batch'] / sec['batch']!r} lanes/s); |u| max {out['u_max']!r}; wall {wall!r} s "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "acrobot Spong: a gate failed")

    out, wall = timed("acrobot LQR + estimator", lambda: acrobot_lqr_estimator.run(torch.float32,
                                                                                    dev))
    ok = acrobot_lqr_estimator.gates(out)
    print(f"[acrobot lqr estimator (phase 19c)] float32: final state error "
          f"{out['err_final']:.3e}, estimate error {out['est_err']:.3e} (both < 5e-2), "
          f"{acrobot_lqr_estimator.STEPS} steps in {out['seconds']!r} s, wall {wall!r} s "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "acrobot LQR with estimator: a gate failed")

    out, wall = timed("Spong CEM, 32 x 8 lanes", lambda: acrobot_spong_optimize.run(
        torch.float32, dev, iters=CEM_ITERS))
    ok = acrobot_spong_optimize.gates(out)
    print(f"[acrobot spong optimize (phase 19c)] float32, {acrobot_spong_optimize.SCENARIOS} "
          f"scenarios x {acrobot_spong_optimize.CANDIDATES} candidates = {out['lanes']} lanes in "
          f"one call, --iters {CEM_ITERS}: default gains' cost {out['base_cost']!r}, best "
          f"{out['best_cost']!r} (<= default + 1e-6 and < 1.0) at gains "
          f"{out['best_gains'].tolist()}; ensemble calls {[round(v, 3) for v in out['seconds']]} s "
          f"({out['lanes'] / out['seconds'][-1]!r} lanes/s at {acrobot_spong_optimize.STEPS} "
          f"steps), wall {wall!r} s {'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "Spong CEM: a gate failed")
    return by_path


def swingup_profile(torch, acrobot_swingup, ilqr, lqr, out, dev, card):
    """Phase 19d: torch.profiler over PROFILE_ILQR_ITERS iLQR iterations,
    PROFILE_SQP_ITERS SQP iterations, the TV-LQR solve and PROFILE_LOOP_STEPS
    closed-loop steps (CUDA graph, then eager) of the swing-up in float64."""
    system, x0, xf = out["system"], out["x0"], out["xf"]
    params = system.default_params
    problem = acrobot_swingup.dircol_problem(system, x0, xf)

    def run_ilqr():
        with torch.no_grad():
            return acrobot_swingup.warm_start(system, x0[None], xf, ilqr.IlqrOptions(
                max_iters=PROFILE_ILQR_ITERS, tol=1e-9))

    profile_layers(torch, run_ilqr, PROFILE_ILQR_ITERS, ILQR_LAYERS, ILQR_LAYERS,
                   "swing-up iLQR", "iLQR iteration", card)

    def run_sqp():
        return acrobot_swingup.polish(problem, out["z0"], dataclasses.replace(
            acrobot_swingup.SQP_OPTIONS, max_iters=PROFILE_SQP_ITERS))

    profile_layers(torch, run_sqp, PROFILE_SQP_ITERS, DIRCOL_LAYERS, DIRCOL_LAYERS,
                   "swing-up dircol", "SQP iteration", card, ("syevj", "syevd", "getrf"))
    tv = out["tvlqr"]
    f64 = dict(dtype=torch.float64, device=dev)

    def run_tvlqr():
        with torch.no_grad():
            return lqr.finite_horizon_lqr(
                system, params, torch.diag(torch.tensor(acrobot_swingup.Q_DIAG, **f64)),
                torch.ones((1, 1), **f64), 0.0, out["T"], acrobot_swingup.N_GRID, x0_traj=tv.x0,
                u0_traj=tv.u0, Qf=out["bal"].S)

    profile_layers(torch, run_tvlqr, 1, TVLQR_LAYERS, TVLQR_LAYERS, "swing-up TV-LQR",
                   "TV-LQR solve", card, ("matrix_exp", "getrf", "getrs"))
    x_init = (x0 + torch.tensor(acrobot_swingup.PERTURB, dtype=torch.float64, device=dev))[None]
    args = (system, x_init, xf, out["T"], out["bal"], tv, PROFILE_LOOP_STEPS)
    for mode, grad in (("CUDA graph", False), ("eager", True)):
        def run_loop():
            with torch.set_grad_enabled(grad):
                return acrobot_swingup.closed_loop(*args)

        profile_layers(torch, run_loop, PROFILE_LOOP_STEPS, (), (),
                       f"swing-up closed loop ({mode})", "closed-loop step", card)


# ---- phase 20: the optimization layer ---------------------------------------------------


def solver_cases():
    """tests/solver_cases.py, the seeded inputs that the port's CPU parity
    tests hold against the JAX package (NumPy only)."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parent / "tests" / "solver_cases.py"
    spec = importlib.util.spec_from_file_location("solver_cases", path)
    module = sys.modules["solver_cases"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def opt_mods(torch):
    from drake_tpu_torch.solvers import al_newton, program, semidefinite_relaxation

    return types.SimpleNamespace(program=program, semidefinite_relaxation=semidefinite_relaxation,
                                 al_newton=al_newton, stack=torch.stack)


def backend_values(torch, sc, device):
    """Phase 20a's back-end quantities on `device` in float64, on the inputs
    of tests/test_torch_solvers.py: {name: ({field: CPU tensor}, iterations
    (CPU tensor) or None)}."""
    from drake_tpu_torch.solvers import al_newton, block_cholesky, conic, lcp, qp

    def on(*arrays):
        return tuple(None if a is None else torch.tensor(np.asarray(a), dtype=torch.float64,
                                                         device=device) for a in arrays)

    out = {}
    admm, _ = sc.admm_qps((3, 4, 5, 6, 7))
    for name, opts in (("default", {}), ("rho updates", dict(rho=10.0, rho_update_interval=10)),
                       ("cut", dict(polish=False, max_iters=30, rho_update_interval=8))):
        s = qp.solve_qp(*on(*admm), options=qp.QpOptions(**opts))
        out[f"qp {name}"] = ({"x": s.x, "y": s.y}, s.iterations)
    s = qp.solve_qp(*on(*sc.admm_qps_free()))
    out["qp m = 0"] = ({"x": s.x}, s.iterations)
    for name, (P, c, A, b, dims) in {
            "lp": sc.conic_lp(), "pinned socp": sc.pinned_socps(sc.seeded_targets(5)),
            "max eigenvalue sdp": sc.max_eig_sdps(sc.seeded_symmetric(4)),
            "m = 0": sc.conic_qp_free(), "mixed cones": sc.mixed_cones()}.items():
        s = conic.solve_conic(*on(P, c, A, b), conic.ConeDims(**dims))
        out[f"conic {name}"] = ({"x": s.x, "s": s.s, "y": s.y}, s.iterations)
    for name, (f, c, z0, lb, ub) in {
            "rosenbrock": (sc.rosenbrock_cost, sc.line_constraint, sc.rosenbrock_starts(4), None,
                           None),
            "m = 0": (sc.box_quadratic_cost, sc.no_constraint,
                      np.array([[0.0, 0.0, 0.0], [0.5, -0.5, 0.2]]), -np.ones(3), np.ones(3)),
            "descent fallback": (sc.double_well_cost, sc.sum_constraint, sc.DOUBLE_WELL_STARTS,
                                 None, None)}.items():
        s = al_newton.solve(f, c, *on(z0, lb, ub))
        out[f"al-newton {name}"] = ({"z": s.z, "lam": s.lam, "cost": s.cost}, s.iterations)
    z, resid = lcp.solve_lcp_fb(*on(*sc.spd_lcps(6, 7)))
    out["lcp fb"] = ({"z": z, "residual": resid}, None)
    cases = {}
    for name, pattern in sc.COUPLINGS.items():
        rng = np.random.default_rng(0)
        cases[name] = (pattern, *sc.random_block_spd(rng, 4, 3, pattern), rng.normal(size=12))
    cases["chain over 8 scenarios"] = sc.chain_scenarios(8, blocks=5)
    for name, (pattern, diag, off, rhs) in cases.items():
        chol = block_cholesky.BlockSparseCholesky(diag.shape[-3], diag.shape[-1], pattern)
        d, *blocks, r = on(diag, *off.values(), rhs)
        Ld, Lo = chol.factor(d, dict(zip(off, blocks)))
        out[f"block cholesky {name}"] = ({"Ld": Ld, "x": chol.solve(Ld, Lo, r)}, None)
    return {k: ({f: v.detach().double().cpu() for f, v in fields.items()},
                None if it is None else it.cpu()) for k, (fields, it) in out.items()}


def program_values(torch, sc, device):
    """Phase 20a/b's MathematicalProgram solves on `device`: {name: (result,
    seconds)}, each program of tests/solver_cases.py solved once."""
    out = {}
    for name, (prog, var, options) in sc.programs(opt_mods(torch)).items():
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = prog.Solve(device=device, options=options)
        if device.type == "cuda":
            torch.cuda.synchronize()
        out[name] = (prog, var, res, time.perf_counter() - t0)
    return out


def solve_iterations(info):
    """The back end's iterations of a MathematicalProgram result, or the
    MIP's node count."""
    if "mip_nodes" in info:
        return ("nodes", info["mip_nodes"])
    for key in ("qp", "conic", "result"):
        if key in info:
            return (key, int(info[key].iterations))
    return None


def opt_parity(torch, sc, dev, card):
    """Phase 20a: each back end and each MathematicalProgram on the card
    against the CPU, float64: within OPT_PARITY of the scale, the same
    iteration counts.  Returns the card's program results for 20b."""
    cpu = torch.device("cpu")
    ref, got = backend_values(torch, sc, cpu), backend_values(torch, sc, dev)
    for name, (fields, it_ref) in ref.items():
        errs = {f: float((got[name][0][f] - r).abs().max()) / max(1.0, float(r.abs().max()))
                if r.numel() else 0.0 for f, r in fields.items()}
        it_got = got[name][1]
        same_it = it_ref is None or bool(torch.equal(it_ref, it_got))
        ok = max(errs.values()) <= OPT_PARITY and same_it and all(
            bool(torch.isfinite(v).all()) for v in got[name][0].values())
        its = "" if it_ref is None else f"; iterations card {it_got.tolist()} cpu {it_ref.tolist()}"
        print(f"[opt parity (phase 20a)] {name}: max|f64 card - f64 cpu| / max(1, max|cpu|) "
              f"{json.dumps({f: float(f'{e:.3e}') for f, e in errs.items()})} (<= {OPT_PARITY:.0e})"
              f"{its} {'ok' if ok else 'FAIL'}")
        check(ok, f"opt parity: {name} differs on the card")
    ref_p, got_p = program_values(torch, sc, cpu), program_values(torch, sc, dev)
    for name, (prog, _, r, _) in ref_p.items():
        g = got_p[name][2]
        err = float(np.abs(g._z - r._z).max()) / max(1.0, float(np.abs(r._z).max()))
        it = (solve_iterations(g.solver_info), solve_iterations(r.solver_info))
        ok = (err <= OPT_PARITY and it[0] == it[1] and g.is_success() == r.is_success()
              and g.solver_info["solver"] == r.solver_info["solver"])
        print(f"[opt parity (phase 20a)] Solve {name} ({prog.program_type()}, "
              f"{g.solver_info['solver']}): z off by {err:.3e} of scale (<= {OPT_PARITY:.0e}), "
              f"{it[0]} on the card, {it[1]} on the cpu, success {g.is_success()} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"opt parity: Solve {name} differs on the card")
    return got_p


def opt_entries(torch, sc, programs, dev, card):
    """Phase 20b: MathematicalProgram at its entry on the card, float64, one
    Solve each (20a's card solves), with the gates of the JAX tests and the
    tutorial; find_fixed_point on three systems."""
    answer = np.array([2.0, 1.0]) / np.sqrt(5.0)
    lam_max = float(np.linalg.eigvalsh([[2.0, 1.0], [1.0, 3.0]])[-1])

    def z(name):
        return programs[name][2]._z

    def cost(name):
        return programs[name][2].optimal_cost

    gates = {
        "tutorial_qp": (np.abs(z("tutorial_qp") - 0.5).max(), 1e-6, "v = [0.5, 0.5]"),
        "tutorial_nlp_sqp": (np.abs(z("tutorial_nlp_sqp") - answer).max(), 1e-4,
                             "p = target / |target|"),
        "tutorial_nlp_al_mu1": (np.abs(z("tutorial_nlp_al_mu1") - answer).max(), 1e-4,
                                "p = target / |target| (AlNewtonOptions(mu0=1.0))"),
        "lp": (np.abs(z("lp") - 1.0).max(), 1e-5, "x = [1, 1]"),
        "box_and_two_sided_rows": (np.abs(z("box_and_two_sided_rows") - [1.0, 1.5]).max(), 1e-5,
                                   "x = [1, 1.5]"),
        "socp_min_norm": (abs(cost("socp_min_norm") - 1.0 / np.sqrt(2.0)), 1e-4,
                          "cost 1/sqrt(2)"),
        "rotated_lorentz_cone": (abs(cost("rotated_lorentz_cone") - 2.0), 1e-4, "cost 2"),
        "sdp_max_eigenvalue": (abs(cost("sdp_max_eigenvalue") - lam_max), 1e-4, "cost lambda_max"),
        "sdp_matrix_variable": (abs(cost("sdp_matrix_variable") - 2.0), 1e-3, "cost 2"),
        "mip_knapsack": (max(np.abs(np.round(z("mip_knapsack")) - [0.0, 1.0, 1.0]).max(),
                             abs(cost("mip_knapsack") + 6.0)), 1e-4, "b = (0, 1, 1), cost -6"),
        "mip_quadratic": (max(np.abs(np.round(z("mip_quadratic")) - [0.0, 1.0]).max(),
                              abs(cost("mip_quadratic") - 0.25)), 1e-4, "b = (0, 1), cost 0.25"),
        "shor_binary_quadratic": (abs(cost("shor_binary_quadratic") + 2.0), 5e-3, "bound -2"),
    }
    for name, (prog, _, res, seconds) in programs.items():
        gate = gates.get(name)
        ok = gate is None or (res.is_success() and gate[0] <= gate[1])
        info = res.solver_info
        extra = f", {info['mip_nodes']} nodes" if "mip_nodes" in info else ""
        gated = (f"; |off| {gate[0]:.3e} from {gate[2]} (<= {gate[1]:.0e})" if gate else
                 "; held to the cpu by 20a")
        print(f"[opt entries (phase 20b)] {name}: {prog.program_type()} -> {info['solver']}, "
              f"{solve_iterations(info)}{extra}, success {res.is_success()}, cost "
              f"{res.optimal_cost!r}, {seconds!r} s{gated} {'ok' if ok else 'FAIL'} [{card}]")
        check(ok, f"opt entries: {name} failed its gate")
    al = programs["tutorial_nlp_al"][2]
    print(f"[opt entries (phase 20b)] tutorial_nlp_al (AlNewtonOptions() defaults) stops on "
          f"feasibility {np.abs(al._z - answer).max():.3e} from the answer, as both packages do on "
          f"a CPU (tests/test_torch_program.py)")
    fixed_points(torch, sc, dev, card)


def fixed_points(torch, sc, dev, card):
    """find_fixed_point on the pendulum of tests/test_debug.py, the port's
    acrobot about upright and its quadrotor about hover, float64 on the
    card; the residual below 1e-6 and the rotors at m g / 4."""
    from drake_tpu_torch.models import acrobot, quadrotor
    from drake_tpu_torch.systems.base import ContinuousSystem
    from drake_tpu_torch.systems.optimization import find_fixed_point

    f64 = dict(dtype=torch.float64, device=dev)
    pend = ContinuousSystem(f=sc.pendulum_f(torch.stack, torch.sin), num_states=2, num_inputs=1)
    pa, pq = acrobot.default_params(**f64), quadrotor.default_params(**f64)
    xq = np.zeros(12)
    xq[3:6] = [0.05, -0.02, 0.3]
    hover = float(pq.mass * pq.gravity) / 4
    for name, system, x0, u0, xw in (
            ("pendulum", pend, *sc.PENDULUM_GUESS, 1e-4),
            ("acrobot upright", acrobot.make_system(pa), np.array([np.pi - 0.1, 0.05, 0.1, 0.0]),
             np.array([0.3]), 1e-3),
            ("quadrotor hover", quadrotor.make_system(pq), xq,
             np.full(4, hover) + [0.2, -0.1, 0.0, 0.1], 1e-3)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs, us, ok = find_fixed_point(system, x0, u0, x_cost_weight=xw, device=dev)
        seconds = time.perf_counter() - t0
        x_t, u_t = torch.tensor(xs, **f64), torch.atleast_1d(torch.tensor(us, **f64))
        resid = float(system.f(system.default_params, x_t, u_t, 0.0).abs().max())
        rotors = float(np.abs(us - hover).max()) if name == "quadrotor hover" else 0.0
        good = ok and resid < 1e-6 and rotors < 1e-6
        print(f"[opt entries (phase 20b)] find_fixed_point {name}: success {ok}, |f(x*, u*)| "
              f"{resid:.3e} (< 1e-6), x* {np.round(xs, 6).tolist()}, u* {np.round(us, 9).tolist()}"
              + (f" (m g / 4 = {hover!r}: off by {rotors:.3e}, < 1e-6)" if rotors or
                 name == "quadrotor hover" else "")
              + f", {seconds!r} s {'ok' if good else 'FAIL'} [{card}]")
        check(good, f"find_fixed_point {name} failed")


def mpc_qps(torch, lanes, dtype, device, seed=SEED, horizon=30, rotors=4, eq_rows=60, box=1.5):
    """20c's QPs, made on the card from a seeded generator: n = horizon x
    rotors (the quadrotor MPC's decision size), A = [G; I] with `eq_rows`
    equality rows and n box rows as tests/test_solvers.py lays them out,
    P = L L' / n + I (L / sqrt(n) keeps P's spectrum in [1, ~5]).  Returns
    the ADMM form (P, q, A, l, u) and the IPM form (P, q, G, b, lb, ub)."""
    n = horizon * rotors
    gen = torch.Generator(device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, dtype=torch.float64, device=device, generator=gen)

    L = randn(lanes, n, n) / math.sqrt(n)
    P = L @ L.mT + torch.eye(n, dtype=torch.float64, device=device)
    q = randn(lanes, n)
    G = randn(lanes, eq_rows, n) / math.sqrt(n)
    b = 0.1 * randn(lanes, eq_rows)
    lb = torch.full((lanes, n), -box, dtype=torch.float64, device=device)
    eye = torch.eye(n, dtype=torch.float64, device=device).expand(lanes, n, n)
    admm = (P, q, torch.cat([G, eye], dim=1), torch.cat([b, lb], dim=1), torch.cat([b, -lb], dim=1))
    return (tuple(a.to(dtype) for a in admm),
            tuple(a.to(dtype) for a in (P, q, G, b, lb, -lb)))


def timed_call(torch, fn, warm_up=True):
    """(result, device ms by CUDA events, host s, peak bytes above what was
    held) of fn(), after one warm-up call unless `warm_up` is False."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), time.perf_counter() - t0, (
        torch.cuda.max_memory_allocated() - base)


def opt_batched(torch, sc, dev, card):
    """Phase 20c: each back end at full width, float64 with its gates after a
    warm-up call, then float32 reported without a gate or a warm-up (the
    float64 calls have loaded the code; the float32 conic ADMM runs its
    OPT_F32_CONIC_ITERS iterations).  Returns the inputs of 20d."""
    from drake_tpu_torch.solvers import al_newton, block_cholesky, conic, ipm, lcp, qp

    out = {}

    def report(name, lanes, dtype, ms, host, peak, extra, ok=True):
        call = "after a warm-up call" if dtype == torch.float64 else "the first float32 call"
        print(f"[opt batched (phase 20c)] {name} {lanes} lanes {str(dtype)[6:]}: "
              f"{ms!r} ms by CUDA events, {call} ({host!r} s host), {lanes / (ms / 1e3)!r} "
              f"solves/s, peak "
              f"{peak} B above the inputs; {extra} {'ok' if ok else 'FAIL'} [{card}]")
        check(ok, f"opt batched: {name} {str(dtype)[6:]} failed its gate")

    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        # The ADMM QP over config 3's 4,096 lanes, n = 120.
        admm, ipm_form = mpc_qps(torch, OPT_QP_LANES, dtype, dev)
        sol, ms, host, peak = timed_call(torch, lambda: qp.solve_qp(*admm), f64)
        finite = bool(torch.isfinite(sol.x).all())
        extra = (f"n = {admm[1].shape[-1]}, m = {admm[3].shape[-1]}; finite {finite}, converged "
                 f"{int(sol.converged.sum())}/{OPT_QP_LANES}, iterations max "
                 f"{int(sol.iterations.max())}")
        ok = True
        if f64:
            k = OPT_CHECK_LANES
            ref = ipm.solve_qp_ipm(*(a[:k] for a in ipm_form),
                                   ipm.IpmOptions(tol=OPT_IPM_TOL, max_iters=60))
            err = float((sol.x[:k] - ref.w).abs().max())
            extra += (f"; the first {k} lanes' x against the port's IPM at tol {OPT_IPM_TOL:.0e}: "
                      f"{err:.3e} (<= 1e-5)")
            ok = finite and err <= 1e-5 and bool(ref.converged.all())
            out["qp"] = admm
        report("qp.solve_qp", OPT_QP_LANES, dtype, ms, host, peak, extra, ok)
        del admm, ipm_form, sol

        # The FB LCP over 4,096 lanes of the iiwa world's 9 contacts x 3.
        M, q = (torch.tensor(a, dtype=dtype, device=dev)
                for a in sc.spd_lcps(OPT_LCP_LANES, OPT_LCP_N, seed=SEED))
        (z, resid), ms, host, peak = timed_call(torch, lambda: lcp.solve_lcp_fb(M, q), f64)
        worst, below = float(resid.max()), int((resid < 1e-8).sum())
        extra = (f"n = {OPT_LCP_N}; max residual {worst:.3e}, below 1e-8 in "
                 f"{below}/{OPT_LCP_LANES} lanes")
        ok = True
        if f64:
            # Lanes with a degenerate pair (z and w both ~0) stall at the
            # smoothing's floor (sqrt(1e-12)) above 1e-8, in the JAX package
            # as in the port: the gates are the reference's own readings on
            # these inputs (OPT_LCP_*), and each lane's residual is held to
            # the port's CPU run.
            _, resid_cpu = lcp.solve_lcp_fb(M.cpu(), q.cpu())
            err_cpu = float((resid.cpu() - resid_cpu).abs().max())
            k = OPT_LEMKE_LANES
            Mh, qh, zh = M[:k].cpu().numpy(), q[:k].cpu().numpy(), z[:k].cpu().numpy()
            err = max(float(np.abs(zh[i] - lcp.lemke(Mh[i], qh[i]).z).max()) for i in range(k))
            extra += (f" (>= {OPT_LCP_MIN_BELOW}; max <= {OPT_LCP_MAX_RESIDUAL:.1e}); every "
                      f"lane's residual against the CPU run: {err_cpu:.3e} (<= {OPT_PARITY:.0e}); "
                      f"the first {k} lanes against lemke: {err:.3e} (<= 1e-6)")
            ok = (bool(torch.isfinite(z).all()) and below >= OPT_LCP_MIN_BELOW
                  and worst <= OPT_LCP_MAX_RESIDUAL and err_cpu <= OPT_PARITY and err <= 1e-6)
            out["lcp"] = (M, q)
        report("lcp.solve_lcp_fb", OPT_LCP_LANES, dtype, ms, host, peak, extra, ok)

        # The conic ADMM: the pinned SOCP and the max-eigenvalue SDP.
        targets = sc.seeded_targets(OPT_CONIC_LANES)
        mats = sc.seeded_symmetric(OPT_CONIC_LANES)
        for name, (P, c, A, b, dims), want in (
                ("pinned socp", sc.pinned_socps(targets), np.linalg.norm(targets, axis=1)),
                ("max eigenvalue sdp", sc.max_eig_sdps(mats), np.linalg.eigvalsh(mats)[:, -1])):
            c, A, b = (torch.tensor(np.asarray(a), dtype=dtype, device=dev) for a in (c, A, b))
            cone = conic.ConeDims(**dims)
            opts = conic.ConicOptions() if f64 else conic.ConicOptions(max_iters=OPT_F32_CONIC_ITERS)
            sol, ms, host, peak = timed_call(
                torch, lambda: conic.solve_conic(None, c, A, b, cone, opts), f64)
            err = float(np.abs(sol.x[:, 0].double().cpu().numpy() - want).max())
            extra = (f"{name}: converged {int(sol.converged.sum())}/{OPT_CONIC_LANES}, iterations "
                     f"max {int(sol.iterations.max())}; t* off by {err:.3e}"
                     + (" (<= 1e-4)" if f64 else ""))
            report("conic.solve_conic", OPT_CONIC_LANES, dtype, ms, host, peak, extra,
                   err <= 1e-4 if f64 else True)
            if f64 and name == "pinned socp":
                out["conic"] = (c, A, b, cone)

        # AL-Newton: the equality-constrained Rosenbrock from seeded starts.
        z0 = sc.rosenbrock_starts(OPT_AL_LANES)
        z0_t = torch.tensor(z0, dtype=dtype, device=dev)
        sol, ms, host, peak = timed_call(torch, lambda: al_newton.solve(
            sc.rosenbrock_cost, sc.line_constraint, z0_t), f64)
        succ = sol.success
        line = (sol.z.sum(-1) - 1.0).abs()
        extra = (f"success {int(succ.sum())}/{OPT_AL_LANES}, outer iterations max "
                 f"{int(sol.iterations.max())}; max |x + y - 1| over the successful lanes "
                 f"{float(line[succ].max()) if bool(succ.any()) else float('nan'):.3e}")
        ok = True
        if f64:
            k = OPT_CHECK_LANES
            ref = al_newton.solve(sc.rosenbrock_cost, sc.line_constraint,
                                  torch.tensor(z0[:k], dtype=dtype))
            err = float((sol.z[:k].cpu() - ref.z).abs().max()) / max(1.0, float(ref.z.abs().max()))
            same = bool(torch.equal(sol.success[:k].cpu(), ref.success))
            extra += (f" (<= 1e-6); the first {k} lanes against the port's CPU run: z off by "
                      f"{err:.3e} of scale (<= 1e-8), success flags equal {same}")
            ok = err <= 1e-8 and same and bool(succ.any()) and float(line[succ].max()) <= 1e-6
            out["al"] = z0_t
        report("al_newton.solve", OPT_AL_LANES, dtype, ms, host, peak, extra, ok)

        # The block Cholesky: a chain of 64 blocks of 6 x 6 over 1,024 scenarios.
        couplings, diag, off, rhs = sc.chain_scenarios(OPT_BC_SCENARIOS, OPT_BC_BLOCKS)
        chol = block_cholesky.BlockSparseCholesky(OPT_BC_BLOCKS, 6, couplings)
        d, *blocks, r = (torch.tensor(a, dtype=dtype, device=dev)
                         for a in (diag, *off.values(), rhs))
        off_t = dict(zip(off, blocks))

        def sparse():
            return chol.solve(*chol.factor(d, off_t), r)

        x, ms, host, peak = timed_call(torch, sparse, f64)
        H = chol.to_dense(d, off_t)
        x_dense, ms_dense, host_dense, peak_dense = timed_call(
            torch, lambda: torch.cholesky_solve(r[..., None], torch.linalg.cholesky(H))[..., 0], f64)
        err = float((x - x_dense).abs().max()) / max(1.0, float(x_dense.abs().max()))
        extra = (f"n = {OPT_BC_BLOCKS * 6}, factor and solve; the dense torch.linalg.cholesky "
                 f"solve of to_dense: {ms_dense!r} ms ({host_dense!r} s host, peak {peak_dense} B); "
                 f"x off the dense by {err:.3e} of scale" + (" (<= 1e-10)" if f64 else ""))
        report("BlockSparseCholesky", OPT_BC_SCENARIOS, dtype, ms, host, peak, extra,
               err <= 1e-10 if f64 else True)
        if f64:
            out["block cholesky"] = sparse
        del H, x_dense
        torch.cuda.empty_cache()
    return out


def opt_profile(torch, sc, inputs, programs, dev, card):
    """Phase 20d: torch.profiler over one solve of each back end at its 20c
    width (float64), and over the knapsack MIP's branch-and-bound."""
    from drake_tpu_torch.solvers import al_newton, conic, lcp, qp

    runs = (
        ("qp.solve_qp 4096 lanes", lambda: qp.solve_qp(*inputs["qp"]), ("qp.chunk", "qp.polish")),
        ("conic.solve_conic pinned socp 1024 lanes",
         lambda: conic.solve_conic(None, *inputs["conic"]), ("conic.iterate",)),
        ("al_newton.solve 1024 lanes", lambda: al_newton.solve(
            sc.rosenbrock_cost, sc.line_constraint, inputs["al"]), ("al.inner", "al.line_search")),
        ("lcp.solve_lcp_fb 4096 lanes", lambda: lcp.solve_lcp_fb(*inputs["lcp"]), ("lcp.fb",)),
        ("MIP knapsack", lambda: programs["mip_knapsack"][0].Solve(device=dev), ("bb.node",)),
    )
    for tag, run, layers in runs:
        profile_layers(torch, run, 1, layers, layers, tag, "solve", card)


def acrobot_phase(torch, mk, dev, card, profile):
    """Phase 19 (19a-19c, and 19d with `profile`): config 2 and the LQR
    family; returns the kernels' launches by path."""
    from drake_tpu_torch.control import lqr
    from drake_tpu_torch.examples import (acrobot_lqr_estimator, acrobot_spong,
                                          acrobot_spong_optimize, acrobot_swingup, cart_pole_lqr)
    from drake_tpu_torch.trajopt import ilqr

    lqr_parity(torch, dev, card)
    by_path = {}
    by_path["acrobot swing-up float64 (phase 19b)"], swingup = swingup_phase(
        torch, acrobot_swingup, mk, dev, card)
    by_path.update(family_phase(torch, (cart_pole_lqr, acrobot_spong, acrobot_lqr_estimator,
                                        acrobot_spong_optimize), mk, dev, card))
    if profile:
        swingup_profile(torch, acrobot_swingup, ilqr, lqr, swingup, dev, card)
    return by_path


def opt_phase(torch, mk, dev, card, profile):
    """Phase 20, 20a-20c (and 20d with `profile`); returns the kernels'
    launches in it (none: no kernel lies on this path)."""
    sc = solver_cases()
    mk.reset_launch_counts()
    t = [time.perf_counter()]
    programs = opt_parity(torch, sc, dev, card)
    t.append(time.perf_counter())
    opt_entries(torch, sc, programs, dev, card)
    t.append(time.perf_counter())
    inputs = opt_batched(torch, sc, dev, card)
    t.append(time.perf_counter())
    launches = dict(mk.LAUNCHES)
    if profile:
        opt_profile(torch, sc, inputs, programs, dev, card)
        t.append(time.perf_counter())
    print("[opt (phase 20)] seconds of host wall of 20a-20c" + (", 20d" if profile else "")
          + ": " + json.dumps([round(b - a, 1) for a, b in zip(t, t[1:])]))
    return launches


# ---------------------------------------------------------------------------
# Phase 21: continuous-time and hybrid simulation (systems/simulator.py,
# math/trajectories.py, primitives, diagram, controllers, multibody/plant,
# the continuous contact plant, TAMSI, PGS, comms) and the three demos.
# ---------------------------------------------------------------------------


def systems_mods():
    from drake_tpu_torch import bench
    from drake_tpu_torch.contact import pgs, sap, tamsi
    from drake_tpu_torch.contact import plant as cplant
    from drake_tpu_torch.control import controllers
    from drake_tpu_torch.examples import bouncing_ball, compass_gait, rimless_wheel
    from drake_tpu_torch.math import trajectories
    from drake_tpu_torch.models import pendulum
    from drake_tpu_torch.multibody import plant as mplant
    from drake_tpu_torch.multibody.model import ModelBuilder
    from drake_tpu_torch.systems import comms, diagram, primitives, simulator
    from drake_tpu_torch.systems.base import ContinuousSystem, DiscreteSystem

    return types.SimpleNamespace(**{k: v for k, v in locals().items()})


def contact_lanes_sys(torch, m, lanes, device, dtype, seed=SEED, first=None):
    """(data, contact) of the bench world (the iiwa and its box, 9
    contacts) at `lanes` states drawn on the CPU from a generator seeded
    `seed` (only the `first` of them with `first`): the arm about its home
    pose, the box 2 mm into the ground at a random tilt, random velocities
    and arm torques; h = 0.01."""
    g = torch.Generator().manual_seed(seed)
    f64 = dict(dtype=torch.float64)
    home = torch.tensor([0.0, 0.6, 0.0, -1.75, 0.0, 1.0, 0.0], **f64)
    q = torch.zeros((lanes, 14), **f64)
    q[:, :7] = home + 0.3 * torch.randn((lanes, 7), generator=g, **f64)
    quat = torch.tensor([1.0, 0, 0, 0], **f64) + 0.05 * torch.randn((lanes, 4), generator=g, **f64)
    q[:, 7:11] = quat / quat.norm(dim=1, keepdim=True)
    q[:, 11:13] = torch.tensor([0.62, 0.0], **f64) + 0.05 * torch.randn((lanes, 2), generator=g,
                                                                        **f64)
    q[:, 13] = 0.058
    v = 0.3 * torch.randn((lanes, 13), generator=g, **f64)
    tau = torch.cat([20.0 * torch.randn((lanes, 7), generator=g, **f64),
                     torch.zeros((lanes, 6), **f64)], dim=1)
    model, params, scene, _ = m.bench.build_world(dtype, device)
    q, v, tau = (a[:first].to(device=device, dtype=dtype) for a in (q, v, tau))
    return m.sap.assemble(model, params, scene, q, v, tau, 0.01)


def systems_parity_values(torch, device, dtype):
    """Phase 21a's quantities of modules 1-9 on small seeded inputs, in
    `dtype` on `device`: (values {name: float64 numpy}, counts {name: int
    numpy})."""
    m = systems_mods()
    kw = dict(dtype=dtype, device=device)
    rng = np.random.default_rng(SEED)
    val, cnt = {}, {}

    def T(a):
        return torch.as_tensor(np.asarray(a), **kw)

    def put(name, x):
        val[name] = x.detach().double().cpu().numpy()

    # 1. trajectories
    breaks = np.cumsum(np.concatenate([[0.3], rng.uniform(0.2, 1.0, 6)]))
    y, yd = rng.standard_normal((2, 7, 3))
    tq = T(np.concatenate([breaks, [breaks[-1] + 0.3], rng.uniform(breaks[0], breaks[-1], 25)]))
    PP = m.trajectories.PiecewisePolynomial
    for name, pp in (("zoh", PP.zero_order_hold(T(breaks), T(y))),
                     ("foh", PP.first_order_hold(T(breaks), T(y))),
                     ("hermite", PP.cubic_hermite(T(breaks), T(y), T(yd))),
                     ("spline", PP.cubic_with_continuous_second_derivatives(T(breaks), T(y)))):
        put(f"traj {name} value", pp.value(tq))
        put(f"traj {name} derivative", pp.derivative_value(tq))
    bs = m.trajectories.BsplineTrajectory.make_clamped_uniform(T(rng.standard_normal((8, 2))),
                                                               t0=0.3, tf=float(breaks[-1]))
    put("traj bspline", torch.cat([bs.value(tq), bs.derivative_value(tq)], -1))
    bz = m.trajectories.BezierCurve(breaks=T([0.3, breaks[-1]]),
                                    control_points=T(rng.standard_normal((6, 2))))
    put("traj bezier", torch.cat([bz.value(tq), bz.derivative_value(tq)], -1))
    pose = m.trajectories.PiecewisePose.make(T(breaks[:4]), T(rng.standard_normal((4, 3))),
                                             T(rng.standard_normal((4, 4))))
    X = pose.value(tq)
    put("traj pose", torch.cat([X.R.flatten(-2), X.p, pose.velocity(tq)], -1))

    # 2. the simulator
    osc = m.ContinuousSystem(f=lambda p, x, u, t: torch.stack([x[..., 1], -x[..., 0]], -1),
                             num_states=2, num_inputs=0)
    x0 = T(rng.standard_normal((8, 2)))
    xf, stats = m.simulator.simulate_adaptive(osc, None, x0, lambda t, x: x[..., :0],
                                              t_final=2 * math.pi, accuracy=1e-5)
    put("adaptive x", xf)
    put("adaptive final time", stats["final_time"])
    cnt["adaptive steps"] = stats["num_steps"].cpu().numpy()
    cnt["adaptive rejects"] = stats["num_rejected"].cpu().numpy()
    ball = m.ContinuousSystem(f=lambda p, x, u, t: torch.stack(
        [x[..., 1], -9.81 + 0.0 * x[..., 0]], -1), num_states=2, num_inputs=0)
    floor = m.simulator.WitnessFunction(
        g=lambda p, x, t: x[..., 0],
        reset=lambda p, x, t: torch.stack([torch.clamp_min(x[..., 0], 0.0), -0.8 * x[..., 1]], -1))
    ceiling = m.simulator.WitnessFunction(
        g=lambda p, x, t: 0.5 - x[..., 0],
        reset=lambda p, x, t: torch.stack([x[..., 0], -x[..., 1]], -1))
    hx0 = T(np.stack([rng.uniform(0.1, 0.45, 8), rng.uniform(-2.0, 2.0, 8)], 1))
    with torch.no_grad():
        xs, _, counts = m.simulator.simulate_hybrid(ball, None, hx0, 1.0, 0.005, (floor, ceiling))
    put("hybrid xs", xs)
    cnt["hybrid events"] = counts.cpu().numpy()
    us = torch.zeros((60, 0), **kw)
    with torch.no_grad():
        oxs, ots = m.simulator.simulate(osc, None, T([1.0, 0.0]), us, 0.1)
    dense = m.simulator.dense_output(osc, None, oxs, ots, us)
    put("dense output", dense.value(T(np.linspace(0.0, 6.0, 41))))

    # 3. primitives, 4. diagram
    A, B = rng.standard_normal((3, 3)), rng.standard_normal((3, 2))
    lin = m.primitives.linear_system(T(A), T(B))
    xl, ul = T(rng.standard_normal((8, 3))), T(rng.standard_normal((8, 2)))
    put("linear system", torch.cat([lin.f(None, xl, ul), lin.output(None, xl, ul)], -1))
    mlp = m.primitives.MlpParams(weights=(T(rng.standard_normal((3, 16))),
                                          T(rng.standard_normal((16, 2)))),
                                 biases=(T(rng.standard_normal(16)), T(rng.standard_normal(2))))
    put("mlp", m.primitives.mlp_apply(mlp, xl))
    dd = m.primitives.state_interpolator_with_discrete_derivative(2, 0.1)
    ddx = m.simulator.simulate_discrete(dd, None, torch.zeros(5, **kw),
                                        T(rng.standard_normal((12, 2))))
    put("discrete derivative", torch.cat([ddx, dd.output(None, ddx, ddx[..., :2])], -1))
    hold = m.primitives.first_order_hold(T(breaks), T(y))
    put("first order hold", hold(tq))
    integ = m.primitives.linear_system(torch.zeros((1, 1), **kw), torch.ones((1, 1), **kw))
    chain = m.diagram.cascade(integ, integ)
    loop = m.diagram.feedback(m.primitives.linear_system(T([[1.0]]), T([[1.0]])),
                              lambda p, yy, r, t: 5.0 * (r - yy))
    with torch.no_grad():
        cxs, _ = m.simulator.simulate(chain, (None, None), torch.zeros(2, **kw),
                                      torch.ones((300, 1), **kw), 1e-3)
        fxs, _ = m.simulator.simulate(loop, None, T([1.0]), T(rng.standard_normal((300, 1))), 1e-3)
    put("diagram cascade", cxs)
    put("diagram feedback", fxs)

    # 5. controllers, 6. multibody/plant
    psys = m.pendulum.make_system(m.pendulum.default_params(dtype, device))
    # The desired state is made here, not in the policy: a closed loop on
    # the card is a CUDA graph, which copies nothing from the host.
    desired = (T([0.5]), torch.zeros(1, **kw))
    pid = m.controllers.pid_controller([20.0], [10.0], [5.0], lambda s: desired, 1e-3,
                                       device=device)
    with torch.no_grad():
        pxs, pus, _ = m.simulator.simulate_controlled(psys, psys.default_params,
                                                      torch.zeros(2, **kw), pid, 500, 1e-3,
                                                      policy_state=torch.zeros(1, **kw))
    put("pid closed loop", torch.cat([pxs[1:], pus], -1))
    b = m.ModelBuilder()
    b.add_body("l1", parent=None, joint_type="revolute", mass=1.2, com=(0, 0, -0.3),
               inertia_com=np.diag([0.02, 0.03, 0.01]), axis=(0, 1, 0), damping=0.1)
    b.add_body("l2", parent="l1", joint_type="revolute", mass=0.8, com=(0, 0, -0.25),
               inertia_com=np.diag([0.01, 0.02, 0.01]), X_PJ_xyz=(0, 0, -0.6), axis=(0, 1, 0))
    arm, arm_p = b.build(dtype, device)
    xa = T(rng.standard_normal((8, 4)))
    idc = m.controllers.inverse_dynamics_controller(
        arm, arm_p, [30.0, 20.0], [1.0, 2.0], [4.0, 3.0],
        lambda s, d=(T([0.2, -0.1]), T([0.0, 0.1]), T([0.3, 0.0])): d, 1e-3, device=device)
    put("inverse dynamics control", idc(T(rng.standard_normal((8, 2))), xa, 0.0)[0])
    jsc = m.controllers.joint_stiffness_controller(arm, arm_p, [30.0, 20.0], [4.0, 3.0],
                                                   [0.2, -0.1], device=device)
    put("joint stiffness control", jsc(None, xa, 0.0))
    model, params, scene, _ = m.bench.build_world(dtype, device)
    cdata, contact = contact_lanes_sys(torch, m, 8, device, dtype)
    plant = m.mplant.make_system(model, params)
    qb = T(rng.standard_normal((8, 14)) * 0.3 + np.r_[[0, 0.6, 0, -1.75, 0, 1, 0, 1, 0, 0, 0,
                                                       0.62, 0, 0.06]])
    vb, ub = T(rng.standard_normal((8, 13)) * 0.3), T(rng.standard_normal((8, 7)) * 10)
    put("multibody plant", plant.f(params, torch.cat([qb, vb], -1), ub))

    # 7. the continuous contact plant, 8. TAMSI, 9. PGS
    _, bparams, bsys = m.bouncing_ball.build(dtype, device)
    bq = np.concatenate([np.tile([1.0, 0, 0, 0, 0, 0], (8, 1)),
                         0.05 + rng.uniform(-2e-3, 5e-4, (8, 1))], 1)
    bx = T(np.concatenate([bq, rng.standard_normal((8, 6))], 1))
    put("continuous contact", bsys.f(bparams, bx, bx[..., :0]))
    # Tolerances that float32 reaches (the defaults, 1e-6 and 1e-8, it does
    # not: its solves would run to their caps).
    q1, v1, sol, _ = m.cplant.step_with_forces(model, params, scene, qb, vb,
                                               torch.cat([ub, torch.zeros((8, 6), **kw)], -1),
                                               0.01, m.sap.SapParameters(rel_tolerance=1e-3))
    put("step with forces", torch.cat([q1, v1], -1))
    cnt["step with forces SAP iterations"] = sol.iterations.cpu().numpy()
    tam = m.tamsi.solve_tamsi(cdata, contact, 0.01, rel_tolerance=1e-3)
    put("tamsi", torch.cat([tam.v, tam.gamma.flatten(-2)], -1))
    cnt["tamsi iterations"] = tam.iterations.cpu().numpy()
    for method in ("gs", "jacobi"):
        with torch.no_grad():
            ps = m.pgs.solve_pgs(cdata, 100, method)
        put(f"pgs {method}", torch.cat([ps.v, ps.gamma.flatten(-2)], -1))
    return val, cnt


def parity_errors(ref, got):
    """Each quantity's max |got - ref| as a share of max |ref| (of 1 where
    that is 0)."""
    out = {}
    for name, r in ref.items():
        scale = float(np.max(np.abs(r))) or 1.0
        out[name] = float(np.max(np.abs(got[name] - r))) / scale
    return out


def systems_parity(torch, dev, card):
    """21a: the port in float32 on the card against float64 on the CPU,
    within SYS_PARITY; the counts within SYS_PARITY_COUNTS."""
    ref, ref_c = systems_parity_values(torch, "cpu", torch.float64)
    got, got_c = systems_parity_values(torch, dev, torch.float32)
    errs = parity_errors(ref, got)
    for name, e in errs.items():
        bound = SYS_PARITY[name]
        print(f"[systems parity] {name}: {e:.3e} of scale (<= {bound:.1e}) "
              f"{'ok' if e <= bound else 'FAIL'} [{card}]")
        check(e <= bound, f"systems parity: {name} {e:.3e} over {bound:.1e}")
    for name, r in ref_c.items():
        d = int(np.max(np.abs(got_c[name].astype(np.int64) - r.astype(np.int64))))
        slack = SYS_PARITY_COUNTS.get(name, 0)
        print(f"[systems parity] {name}: card {got_c[name].tolist()} CPU {r.tolist()}, max "
              f"|difference| {d} (<= {slack}) {'ok' if d <= slack else 'FAIL'} [{card}]")
        check(d <= slack, f"systems parity: {name} counts differ by {d}")


def systems_demos(torch, dev, card):
    """21b: the three demos at the reference's size and depth, float32 on
    the card, with the reference's checks and the JAX package's float32
    readings (SYSTEMS_JAX_F32); returns each demo's seconds."""
    m = systems_mods()
    ref = SYSTEMS_JAX_F32
    seconds = {}
    ball = m.bouncing_ball.run(device=dev, dtype=torch.float32, steps=STEPS_BALL,
                               queries=BALL_QUERIES)
    seconds["bouncing_ball"] = ball["seconds"]
    check(ball["ok"], "the bouncing ball failed its checks")
    d_ratio = abs(ball["ratio"] - ref["ball"]["ratio"])
    d_flight = abs(ball["t_flight"] - ref["ball"]["t_flight"])
    print(f"[systems demos] bouncing ball: {len(ball['apexes'])} apexes (JAX "
          f"{ref['ball']['n_apexes']}), apex ratio {ball['ratio']!r} (JAX {ref['ball']['ratio']!r}, "
          f"|d| {d_ratio:.3e} <= {DEMO_BOUNDS['ball ratio']}), apex-to-apex {ball['t_flight']!r} "
          f"s (JAX {ref['ball']['t_flight']!r}, |d| {d_flight:.3e} <= "
          f"{DEMO_BOUNDS['ball t_flight']}), {STEPS_BALL} rk4 steps and the dense output in "
          f"{ball['seconds']!r} s [{card}]")
    check(d_ratio <= DEMO_BOUNDS["ball ratio"] and d_flight <= DEMO_BOUNDS["ball t_flight"]
          and len(ball["apexes"]) == ref["ball"]["n_apexes"], "the bouncing ball is off the JAX run")
    ball_graph_against_eager(torch, m, dev, card)
    wheel = m.rimless_wheel.run(device=dev, dtype=torch.float32)
    seconds["rimless_wheel"] = wheel["seconds"]
    check(wheel["ok"], "the rimless wheel failed its checks")
    d_w = abs(wheel["w_meas"] - ref["wheel"]["w_meas"])
    print(f"[systems demos] rimless wheel: {wheel['strikes']} strikes (JAX "
          f"{ref['wheel']['strikes']}), post-impact speed {wheel['w_meas']!r} (JAX "
          f"{ref['wheel']['w_meas']!r}, |d| {d_w:.3e} <= {DEMO_BOUNDS['wheel speed']}; closed "
          f"form {wheel['w_star']!r}), 20,000 macro steps in {wheel['seconds']!r} s [{card}]")
    check(abs(wheel["strikes"] - ref["wheel"]["strikes"]) <= DEMO_BOUNDS["strikes"]
          and d_w <= DEMO_BOUNDS["wheel speed"], "the rimless wheel is off the JAX run")
    gait = m.compass_gait.run(device=dev, dtype=torch.float32)
    seconds["compass_gait"] = gait["seconds"]
    check(gait["ok"], "the compass gait failed its checks")
    d_post = float(np.max(np.abs(gait["post"][-1] - np.asarray(ref["compass"]["post_last"]))))
    print(f"[systems demos] compass gait: {gait['strikes']} strikes (JAX "
          f"{ref['compass']['strikes']}), last post-impact state {gait['post'][-1].tolist()} "
          f"(JAX {ref['compass']['post_last']}, max |d| {d_post:.3e} <= "
          f"{DEMO_BOUNDS['gait state']}), contraction {gait['d_last']!r} (JAX "
          f"{ref['compass']['d_last']!r}), 6,000 macro steps in {gait['seconds']!r} s [{card}]")
    check(abs(gait["strikes"] - ref["compass"]["strikes"]) <= DEMO_BOUNDS["strikes"]
          and d_post <= DEMO_BOUNDS["gait state"], "the compass gait is off the JAX run")
    return seconds


def graph_and_eager(torch, run):
    """`run()` with autograd off (on the card: the CUDA graphs) and on (the
    eager loop), each with its seconds of host wall."""
    outs = []
    for grad in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.set_grad_enabled(grad):
            out = tuple(o.detach() for o in run())
        torch.cuda.synchronize()
        outs.append((out, time.perf_counter() - t0))
    return outs


def ball_graph_against_eager(torch, m, dev, card):
    """21b: the ball's graph-replayed simulate bit for bit its eager loop,
    GRAPH_BALL_STEPS rk4 steps from 2 mm above the ground, falling at 1 m/s
    and sliding at 0.3 m/s, through its first contact."""
    bb = m.bouncing_ball
    _, params, system = bb.build(torch.float32, dev)
    x0 = torch.tensor([1, 0, 0, 0, 0, 0, bb.RADIUS + 2e-3, 0, 0, 0, 0.3, 0, -1.0],
                      dtype=torch.float32, device=dev)
    us = torch.zeros((GRAPH_BALL_STEPS, 0), dtype=torch.float32, device=dev)
    (graph, t_graph), (eager, t_eager) = graph_and_eager(
        torch, lambda: m.simulator.simulate(system, params, x0, us, bb.H))
    same = torch.equal(graph[0], eager[0])
    depth = float(bb.RADIUS - graph[0][:, 6].min())
    print(f"[systems demos] bouncing ball, {GRAPH_BALL_STEPS} steps through a contact (deepest "
          f"{depth:.3e} m): graph-replayed simulate bit for bit the eager loop: {same} (graph "
          f"{t_graph!r} s, eager {t_eager!r} s) [{card}]")
    check(depth > 0, "ball graph check: no contact in its steps")
    check(same, "ball: the graph-replayed simulate differs from the eager loop")


def lane_line(torch, tag, lanes, wall, card):
    print(f"[systems lanes] {tag}: {lanes} lanes in {wall!r} s, {lanes / wall!r} lanes/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]")


def systems_lanes(torch, dev, card):
    """21c: the wheel's simulate_hybrid over HYBRID_LANES pushes, the
    adaptive integrator over ADAPTIVE_LANES oscillators and TAMSI, PGS and SAP
    over CONTACT_LANES of the bench world, each in one call; returns the
    inputs of the profile."""
    m = systems_mods()
    out = {}
    # The wheel over lanes: each lane's strikes against its one-lane run.
    pushes = torch.as_tensor(np.random.default_rng(SEED).uniform(
        *WHEEL_PUSH_RANGE, HYBRID_LANES).astype(np.float32), device=dev)
    m.rimless_wheel.rollout(pushes[:2], t_final=0.01)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xs, counts = m.rimless_wheel.rollout(pushes, t_final=HYBRID_LANE_SECONDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lane_line(torch, f"rimless wheel simulate_hybrid, {HYBRID_LANE_SECONDS} s "
              f"({int(round(HYBRID_LANE_SECONDS / 1e-3))} macro steps)", HYBRID_LANES, wall, card)
    counts = counts[:, 0].cpu()
    ref = SYSTEMS_JAX_F32["wheel_lanes"]
    jax_counts = torch.tensor([int(c) for c in ref["strikes"]], dtype=counts.dtype)
    d = (counts - jax_counts).abs()
    print(f"[systems lanes] wheel strikes: sum {int(counts.sum())} (JAX float32 CPU "
          f"{ref['strikes_sum']}), min {int(counts.min())} max {int(counts.max())} (JAX "
          f"{ref['strikes_min']}, {ref['strikes_max']}); against the JAX package lane by lane: "
          f"max |d| {int(d.max())} (<= {WHEEL_LANE_SLACK}), {int((d > 0).sum())} lanes differ "
          f"(<= {WHEEL_LANES_DIFFERING}), at lanes {torch.nonzero(d).flatten().tolist()[:16]} "
          f"[{card}]")
    check(bool(torch.isfinite(xs).all()), "wheel lanes: non-finite state")
    check(int(d.max()) <= WHEEL_LANE_SLACK and int((d > 0).sum()) <= WHEEL_LANES_DIFFERING,
          "wheel lanes: the strikes are off the JAX run")
    for lane in np.linspace(0, HYBRID_LANES - 1, LANE_CHECKS_SYS).astype(int):
        xs1, c1 = m.rimless_wheel.rollout(pushes[lane], t_final=HYBRID_LANE_SECONDS)
        d = float((xs1 - xs[lane]).abs().max())
        print(f"[systems lanes] wheel lane {lane}: {int(c1[0])} strikes alone, {int(counts[lane])} "
              f"among the lanes, max |dx| {d:.3e} [{card}]")
        check(int(c1[0]) == int(counts[lane]), f"wheel lane {lane}: its strikes differ alone")
    out["pushes"] = pushes
    del xs
    # The graph-replayed simulate_hybrid (its step and its isolation, two
    # graphs on shared buffers) bit for bit its eager loop over the lanes.
    rw = m.rimless_wheel
    wsys, touchdown = rw.make_system()
    wx0 = torch.stack([torch.full_like(pushes, rw.SLOPE - rw.ALPHA), pushes], dim=-1)
    (graph, t_graph), (eager, t_eager) = graph_and_eager(
        torch, lambda: m.simulator.simulate_hybrid(wsys, None, wx0, GRAPH_WHEEL_SECONDS, rw.DT,
                                                   witnesses=(touchdown,)))
    same = torch.equal(graph[0], eager[0]) and torch.equal(graph[2], eager[2])
    struck = int((graph[2] > 0).sum())
    print(f"[systems lanes] wheel over {HYBRID_LANES} lanes, {GRAPH_WHEEL_SECONDS} s: "
          f"{struck} lanes struck, {int(graph[2].sum())} strikes; graph-replayed simulate_hybrid "
          f"bit for bit the eager loop in xs and counts: {same} (graph {t_graph!r} s, eager "
          f"{t_eager!r} s) [{card}]")
    check(struck > 0, "wheel graph check: no lane struck")
    check(same, "wheel lanes: the graph-replayed simulate_hybrid differs from the eager loop")
    # The adaptive integrator over lanes, float32 against the card's float64.
    osc = m.ContinuousSystem(f=lambda p, x, u, t: torch.stack([x[..., 1], -x[..., 0]], -1),
                             num_states=2, num_inputs=0)
    x0 = torch.randn((ADAPTIVE_LANES, 2), generator=torch.Generator().manual_seed(SEED),
                     dtype=torch.float64).to(dev)
    res = {}
    for dtype in (torch.float64, torch.float32):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        xf, st = m.simulator.simulate_adaptive(osc, None, x0.to(dtype), lambda t, x: x[..., :0],
                                               t_final=2 * math.pi, accuracy=ADAPTIVE_ACCURACY)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res[dtype] = (xf.double(), st)
        lane_line(torch, f"simulate_adaptive {str(dtype)[6:]}, oscillator to 2 pi at accuracy "
                  f"{ADAPTIVE_ACCURACY}, {int(st['num_steps'].max())} steps at most", ADAPTIVE_LANES,
                  wall, card)
    (x64, s64), (x32, s32) = res[torch.float64], res[torch.float32]
    err = float((x32 - x0).abs().max())
    dsteps = int((s32["num_steps"] - s64["num_steps"]).abs().max())
    print(f"[systems lanes] adaptive: x(2 pi) - x0 max {err:.3e} (float64 "
          f"{float((x64 - x0).abs().max()):.3e}; <= {ADAPTIVE_RETURN_BOUND}), steps a lane "
          f"float32 {int(s32['num_steps'].min())}-{int(s32['num_steps'].max())}, float64 "
          f"{int(s64['num_steps'].min())}-{int(s64['num_steps'].max())}, max |d steps| {dsteps} "
          f"(<= {ADAPTIVE_STEP_SLACK}) [{card}]")
    check(err <= ADAPTIVE_RETURN_BOUND and int(s32["num_steps"].max()) < 500,
          "adaptive lanes: the oscillator did not return")
    check(dsteps <= ADAPTIVE_STEP_SLACK, "adaptive lanes: float32 steps off the float64 run")
    out["adaptive"] = (osc, x0.float())
    # TAMSI, PGS (both sweeps) and SAP on the same SapData of the bench
    # world; the first CONTACT_CHECK_LANES held to the CPU's float64 solves.
    sols = {}
    for dtype, device, first in ((torch.float32, dev, None),
                                 (torch.float64, "cpu", CONTACT_CHECK_LANES)):
        data, contact = contact_lanes_sys(torch, m, CONTACT_LANES, device, dtype, first=first)
        for name, solve in contact_solvers(m, data, contact):
            with torch.no_grad():
                if device == dev:
                    solve()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                sols[name, device] = solve()
                if device == dev:
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    lane_line(torch, f"{name} on the bench world (9 contacts, float32)",
                              CONTACT_LANES, wall, card)
                    check(bool(torch.isfinite(sols[name, dev].v).all()),
                          f"{name}: non-finite velocities")
        if device == dev:
            out["contact"] = (data, contact)
    for name in CONTACT_PARITY:
        ref = sols[name, "cpu"].v
        got = sols[name, dev].v[:CONTACT_CHECK_LANES].double().cpu()
        e = float((got - ref).abs().max() / ref.abs().max())
        print(f"[systems lanes] {name}: card float32 against CPU float64 on the first "
              f"{CONTACT_CHECK_LANES} lanes {e:.3e} of max |v| (<= {CONTACT_PARITY[name]:.1e}) "
              f"[{card}]")
        check(e <= CONTACT_PARITY[name], f"{name}: the card is off the CPU's solve")
    its = sols["tamsi", dev].iterations.cpu()
    print(f"[systems lanes] TAMSI iterations median {float(its.double().median())!r}, max "
          f"{int(its.max())}; SAP iterations median "
          f"{float(sols['sap', dev].iterations.double().median())!r} [{card}]")
    # At physics level, as tests/test_contact.py's TestPgs and TestTamsi hold
    # them: CONTACT_LANES slides of the sphere on the ground.
    sphere_physics(torch, m, dev, card)
    return out


def contact_solvers(m, data, contact):
    return (("sap", lambda: m.sap.solve_sap(data, data.v_star)),
            ("tamsi", lambda: m.tamsi.solve_tamsi(data, contact, 0.01)),
            ("pgs gs", lambda: m.pgs.solve_pgs(data, PGS_SWEEPS, "gs")),
            ("pgs jacobi", lambda: m.pgs.solve_pgs(data, PGS_SWEEPS, "jacobi")))


def sphere_physics(torch, m, dev, card):
    """TAMSI and PGS against SAP on CONTACT_LANES lanes of test_contact.py's
    sphere sliding on the ground (one contact, the unique solution), slides
    uniform in [0, 0.5] m/s, float32: PGS (both sweeps, 400) within 2 Rn
    gamma_n + 5e-3 of SAP in every lane, TAMSI (its own sphere: k 1e5,
    falling at 0.2 m/s) within 2e-2, as the JAX tests hold them."""
    from drake_tpu_torch.geometry import shapes as sh
    from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene

    vx = torch.as_tensor(np.random.default_rng(SEED).uniform(0.0, 0.5, CONTACT_LANES),
                         dtype=torch.float32, device=dev)
    zero = torch.zeros_like(vx)
    for label, (k_ball, d, k_ground, pen, vz) in (("pgs", (1e6, 10.0, 1e6, 1e-4, -0.5)),
                                                  ("tamsi", (1e5, 0.1, 1e10, 2e-4, -0.2))):
        b = m.ModelBuilder()
        b.add_body("ball", parent=None, joint_type="floating", mass=1.0,
                   inertia_com=np.eye(3) * 0.4 * 0.1**2)
        model, params = b.build(torch.float32, dev)
        scene = CollisionScene.build([
            CollisionGeometry(name="ball", body=0, shape=sh.Sphere(0.1), friction=0.5,
                              stiffness=k_ball, dissipation=d),
            CollisionGeometry(name="ground", body=-1, shape=sh.HalfSpace(), friction=0.5,
                              stiffness=k_ground, dissipation=d)])
        q = torch.stack([zero + 1, zero, zero, zero, zero, zero, zero + 0.1 - pen], -1)
        v = torch.stack([zero, zero, zero, vx, zero, zero + vz], -1)
        data, contact = m.sap.assemble(model, params, scene, q, v, torch.zeros_like(v), 0.01)
        with torch.no_grad():
            sap_sol = m.sap.solve_sap(data, data.v_star)
            if label == "pgs":
                bound = 2 * data.R[..., 0, 2] * sap_sol.gamma[..., 0, 2] + 5e-3
                for method in ("gs", "jacobi"):
                    d_v = (m.pgs.solve_pgs(data, 400, method).v - sap_sol.v).abs().amax(-1)
                    ok = bool((d_v <= bound).all())
                    print(f"[systems lanes] sphere: pgs {method} (400 sweeps) against SAP max "
                          f"|dv| {float(d_v.max()):.3e}, every lane within 2 Rn gamma_n + 5e-3: "
                          f"{ok} [{card}]")
                    check(ok, f"sphere: pgs {method} is off SAP")
            else:
                d_v = (m.tamsi.solve_tamsi(data, contact, 0.01).v - sap_sol.v).abs().amax(-1)
                ok = bool((d_v <= 2e-2).all())
                print(f"[systems lanes] sphere: tamsi against SAP max |dv| {float(d_v.max()):.3e} "
                      f"(<= 2e-2 in every lane: {ok}) [{card}]")
                check(ok, "sphere: tamsi is off SAP")


def systems_comms(torch, dev, card):
    """21d: a publishing rollout and a closed loop with comms through the
    port's copy of pubsub, on the card and on the CPU: the messages must
    be equal."""
    m = systems_mods()
    from drake_tpu_torch.io.pubsub import PubSub, deserialize_arrays, serialize_arrays

    def double_integrator(h=0.1):
        return m.DiscreteSystem(g=lambda p, x, u, t: torch.stack([x[0] + h * x[1],
                                                                  x[1] + h * u[0]]),
                                num_states=2, num_inputs=1, time_step=h)

    def run(device, tag):
        bus = f"memq://smoke_{tag}"
        node, listener, remote = PubSub(bus), PubSub(bus), PubSub(bus)
        sub = listener.subscribe("STATE*")
        us = torch.as_tensor(np.random.default_rng(SEED).standard_normal((30, 1)),
                             dtype=torch.float32, device=device)
        xs = m.comms.publishing_rollout(double_integrator(), None,
                                        torch.tensor([0.5, -0.2], device=device), us, node,
                                        "STATE_PUB", publish_every=3)
        remote.publish("CMD", serialize_arrays(u=np.array([1.0], np.float32)))
        cmd = m.comms.SubscriberState(node, "CMD", shape=(1,), field="u")
        xs2, us2 = m.comms.closed_loop_rollout_with_comms(
            double_integrator(), None, torch.zeros(2, device=device),
            lambda p, x, u_ext, t: u_ext - 0.1 * x[:1], 30, node, "STATE_HIL",
            command_sub=cmd, publish_every=2)
        msgs = []
        while True:
            msg = listener.receive(sub)
            if msg is None:
                break
            msgs.append((msg[0], deserialize_arrays(msg[1])))
        return xs.cpu(), xs2.cpu(), msgs

    t0 = time.perf_counter()
    card_run = run(dev, "card")
    seconds = time.perf_counter() - t0
    cpu_run = run("cpu", "cpu")
    same = (len(card_run[2]) == len(cpu_run[2]) and all(
        a[0] == b[0] and sorted(a[1]) == sorted(b[1])
        and all(np.array_equal(a[1][k], b[1][k]) for k in a[1])
        for a, b in zip(card_run[2], cpu_run[2])))
    print(f"[systems comms] {len(card_run[2])} messages on the card ({len(cpu_run[2])} on the "
          f"CPU), channels {sorted({c for c, _ in card_run[2]})}, equal to the CPU run's: {same}; "
          f"states max |d| {float((card_run[0] - cpu_run[0]).abs().max()):.3e} and "
          f"{float((card_run[1] - cpu_run[1]).abs().max()):.3e}; {seconds!r} s [{card}]")
    check(len(card_run[2]) == 11 + 15 and same, "comms: the card's messages differ from the CPU's")


def systems_profile(torch, lanes, dev, card):
    """21 --profile: the ranges tamsi.newton, pgs.sweep, adaptive.step,
    hybrid.macro and hybrid.isolate (the wheel over its lanes, 200 macro
    steps), read as phases 8 and 20d read theirs."""
    m = systems_mods()
    data, contact = lanes["contact"]
    profile_layers(torch, lambda: m.tamsi.solve_tamsi(data, contact, 0.01), 1, ("tamsi.newton",),
                   ("tamsi.newton",), f"solve_tamsi L={CONTACT_LANES}", "solve", card)

    def pgs():
        with torch.no_grad():
            m.pgs.solve_pgs(data, PGS_SWEEPS, "gs")

    profile_layers(torch, pgs, 1, ("pgs.sweep",), ("pgs.sweep",),
                   f"solve_pgs gs L={CONTACT_LANES}", "solve", card)
    osc, x0 = lanes["adaptive"]
    profile_layers(torch, lambda: m.simulator.simulate_adaptive(
        osc, None, x0, lambda t, x: x[..., :0], t_final=2 * math.pi,
        accuracy=ADAPTIVE_ACCURACY), 1, ("adaptive.step",), ("adaptive.step",),
        f"simulate_adaptive L={ADAPTIVE_LANES}", "solve", card)
    steps = 200
    profile_layers(torch, lambda: m.rimless_wheel.rollout(lanes["pushes"], t_final=steps * 1e-3),
                   steps, ("hybrid.macro", "hybrid.isolate"), ("hybrid.macro",),
                   f"rimless wheel L={HYBRID_LANES}", "macro step", card)


def systems_phase(torch, mk, dev, card, profile):
    """Phase 21 (21a-21d, and the profile with `profile`); returns the
    kernels' launches in it (none: no kernel lies on this path)."""
    mk.reset_launch_counts()
    t = [time.perf_counter()]
    systems_parity(torch, dev, card)
    t.append(time.perf_counter())
    systems_demos(torch, dev, card)
    t.append(time.perf_counter())
    lanes = systems_lanes(torch, dev, card)
    t.append(time.perf_counter())
    systems_comms(torch, dev, card)
    t.append(time.perf_counter())
    launches = dict(mk.LAUNCHES)
    if profile:
        systems_profile(torch, lanes, dev, card)
        t.append(time.perf_counter())
    print("[systems (phase 21)] seconds of host wall of 21a-21d" + (", the profile" if profile
                                                                   else "") + ": "
          + json.dumps([round(b - a, 1) for a, b in zip(t, t[1:])]))
    return launches


# ---------------------------------------------------------------------------
# Phase 22: the discrete plant's constraints and the rigid-contact demos.
# ---------------------------------------------------------------------------

# Shape kinds of 22a's pairs: (class name, fields, size for the poses).
RIGID_SHAPES = {
    "sphere": ("Sphere", dict(radius=0.1), 0.1),
    "box": ("Box", dict(size=(0.3, 0.2, 0.1)), 0.19),
    "capsule": ("Capsule", dict(radius=0.05, length=0.3), 0.2),
    "cylinder": ("Cylinder", dict(radius=0.08, length=0.2), 0.13),
    "ellipsoid": ("Ellipsoid", dict(radii=(0.12, 0.08, 0.06)), 0.1),
    "halfspace": ("HalfSpace", dict(), 0.0),
}
# Every primitive pair of the scene's table, and hydro patches (modulus,
# rings) on each kind of carrier.
RIGID_PAIRS = [(a, b, None) for a, b in (
    ("sphere", "halfspace"), ("sphere", "sphere"), ("sphere", "box"), ("capsule", "halfspace"),
    ("capsule", "sphere"), ("capsule", "capsule"), ("box", "halfspace"), ("box", "box"),
    ("capsule", "box"), ("sphere", "cylinder"), ("capsule", "cylinder"), ("box", "cylinder"),
    ("cylinder", "halfspace"), ("cylinder", "cylinder"), ("sphere", "ellipsoid"),
    ("capsule", "ellipsoid"), ("box", "ellipsoid"), ("ellipsoid", "halfspace"))] + [
    ("sphere", "halfspace", (2e5, 3)), ("box", "box", (1e6, 1)), ("capsule", "halfspace", (5e5, 2)),
    ("cylinder", "halfspace", (3e5, 2)), ("ellipsoid", "sphere", (3e5, 1))]


def rigid_mods():
    from drake_tpu_torch.contact import plant as cplant
    from drake_tpu_torch.contact import sap
    from drake_tpu_torch.geometry import shapes as sh
    from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
    from drake_tpu_torch.multibody import dynamics as dyn
    from drake_tpu_torch.multibody import force_elements as fel
    from drake_tpu_torch.multibody import kinematics as kin
    from drake_tpu_torch.multibody import topology as topo
    from drake_tpu_torch.multibody.model import ModelBuilder

    return types.SimpleNamespace(**{k: v for k, v in locals().items()})


def pair_world(m, torch, pair, device):
    """Two geometries of `pair` on floating bodies (a halfspace on the world)."""
    a, b, hydro = pair
    builder = m.ModelBuilder()
    geoms = []
    for name, kind in (("A", a), ("B", b)):
        cls, fields, _ = RIGID_SHAPES[kind]
        body = -1 if kind == "halfspace" else builder.add_body(
            name, parent=None, joint_type="floating", mass=1.0, inertia_com=np.eye(3) * 0.01)
        extra = {} if hydro is None or name == "B" else dict(hydroelastic_modulus=hydro[0],
                                                             hydro_rings=hydro[1])
        geoms.append(m.CollisionGeometry(name=name, body=body, shape=getattr(m.sh, cls)(**fields),
                                         stiffness=1e5 if name == "A" else 4e5,
                                         friction=0.6 if name == "A" else 0.9, **extra))
    model, params = builder.build(torch.float64, device)
    return model, params, m.CollisionScene.build(geoms)


def pair_lanes(pair, model, lanes, seed):
    """(q, v) float64 numpy: random orientations, the first body about the
    second at 0.6-1.1 times the sum of their sizes (two boxes 0.3-0.8)."""
    a, b, _ = pair
    rng = np.random.default_rng(seed)
    q = np.zeros((lanes, model.num_positions))
    floating = [k for k in (a, b) if k != "halfspace"]
    for j in range(len(floating)):
        quat = rng.standard_normal((lanes, 4))
        q[:, 7 * j : 7 * j + 4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    size = {k: RIGID_SHAPES[k][2] for k in (a, b)}
    if len(floating) == 2:
        u = rng.standard_normal((lanes, 3))
        lo, hi = (0.3, 0.8) if a == b == "box" else (0.6, 1.1)
        q[:, 4:7] = u / np.linalg.norm(u, axis=1, keepdims=True) * (
            (size[a] + size[b]) * rng.uniform(lo, hi, (lanes, 1)))
    else:
        q[:, 4:6] = rng.uniform(-0.2, 0.2, (lanes, 2))
        q[:, 6] = size[floating[0]] * rng.uniform(0.4, 1.1, lanes)
    return q, 0.3 * rng.standard_normal((lanes, model.num_velocities))


def arm_world(m, torch, device):
    """The constraint world of tests/test_torch_sap_constraints.py: a
    revolute-revolute-prismatic arm with a pad and a free ball over the
    ground."""
    ey = np.eye(3)
    b = m.ModelBuilder()
    b.add_body("l1", parent=None, joint_type="revolute", mass=1.0, com=(0, 0, -0.15),
               inertia_com=ey * 0.01, axis=(0, 1, 0), X_PJ_xyz=(0, 0, 0.6), joint_name="j1",
               damping=0.2)
    b.add_body("l2", parent="l1", joint_type="revolute", mass=0.8, com=(0, 0, -0.15),
               inertia_com=ey * 0.008, axis=(0, 1, 0), X_PJ_xyz=(0, 0, -0.3), joint_name="j2")
    b.add_body("l3", parent="l2", joint_type="prismatic", mass=0.3, inertia_com=ey * 1e-3,
               axis=(0, 0, -1), X_PJ_xyz=(0, 0, -0.25), joint_name="j3", damping=0.5)
    b.add_body("ball", parent=None, joint_type="floating", mass=0.5, inertia_com=ey * 2e-3)
    model, params = b.build(torch.float64, device)
    geoms = [m.CollisionGeometry("pad", 2, m.sh.Sphere(0.04), p_BG=np.array([0.0, 0.0, -0.1]),
                                 stiffness=2e4, dissipation=0.1, friction=0.8),
             m.CollisionGeometry("ball", 3, m.sh.Sphere(0.05), stiffness=1e4, dissipation=0.2,
                                 friction=0.5),
             m.CollisionGeometry("ground", -1, m.sh.HalfSpace(), stiffness=1e8, dissipation=0.05,
                                 friction=0.7)]
    return model, params, m.CollisionScene.build(geoms)


def arm_lanes(lanes, seed=0):
    rng = np.random.default_rng(seed)
    q = np.zeros((lanes, 10))
    q[:, 0] = rng.uniform(-0.5, 0.6, lanes)
    q[:, 1] = rng.uniform(-0.7, 0.8, lanes)
    q[:, 2] = rng.uniform(-0.07, 0.1, lanes)
    quat = np.array([1.0, 0, 0, 0]) + 0.3 * rng.standard_normal((lanes, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:9] = rng.uniform(0.3, 0.9, (lanes, 2)) * [1, 0.1]
    q[:, 9] = 0.05 + rng.uniform(-0.004, 0.003, lanes)
    v = 0.5 * rng.standard_normal((lanes, 9))
    tau = np.concatenate([3.0 * rng.standard_normal((lanes, 3)), np.zeros((lanes, 6))], axis=1)
    return q, v, tau, rng.uniform(-0.5, 0.5, (lanes, 2))


ARM_LIMITS = ([-0.4, -0.6, -0.05, 0, 0, 0, 0, 0, 0], [0.5, 0.7, 0.08, 0, 0, 0, 0, 0, 0])
ARM_CASES = {
    "limits": ("cone", dict(joint_limits=ARM_LIMITS)),
    "coupler": ("cone", dict(couplers=[("j1", "j2", -0.5, 0.1)])),
    "ball": ("cone", dict(ball_constraints=[(2, (0.0, 0.0, -0.1), -1, (0.45, 0.0, 0.3))])),
    "distance": ("cone", dict(distance_constraints=[(3, (0.0, 0.0, 0.0), 1, (0.1, 0.0, 0.0),
                                                     0.6)])),
    "weld": ("cone", dict(weld_constraints=[(3, np.eye(3), (0.0, 0.0, 0.0), -1, np.eye(3),
                                             (0.8, 0.0, 0.06))])),
    "pd": ("cone", dict(pd_controllers=True)),
    "hc_lagged": ("hc_lagged", {}),
    "hc_similar": ("hc_similar", {}),
}


def joints_world(m, torch, device):
    """Every joint type (tests/test_torch_joints.py's model) with a sphere
    pad on the prismatic tip and the screw body over the ground."""
    ey = np.eye(3)
    b = m.ModelBuilder()
    b.add_body("a", parent=None, joint_type="revolute", mass=1.0, com=(0.1, 0, 0),
               inertia_com=ey * 0.02, axis=(0, 0, 1), damping=0.1, X_PJ_xyz=(0, 0, 0.6))
    b.add_body("b", parent="a", joint_type="ball", mass=0.7, com=(0, 0.05, -0.1),
               inertia_com=np.diag([0.01, 0.02, 0.015]), X_PJ_xyz=(0.3, 0, 0),
               X_PJ_rpy=(0.1, -0.2, 0.3), damping=0.05)
    b.add_body("u", parent="b", joint_type="universal", mass=0.4, com=(0, 0, -0.1),
               inertia_com=ey * 0.004, axis=(1, 0, 0), axis2=(0, 1, 0), X_PJ_xyz=(0, 0, -0.25),
               damping=0.02, rotor_inertia=1e-4, gear_ratio=30.0)
    b.add_body("e", parent="u", joint_type="prismatic", mass=0.2, inertia_com=ey * 1e-3,
               axis=(0, 0, 1), X_PJ_xyz=(0, 0, -0.2))
    b.add_body("p", parent=None, joint_type="planar", mass=1.5, com=(0.02, 0, 0.01),
               inertia_com=np.diag([0.03, 0.02, 0.04]), X_PJ_xyz=(1.0, 0, 0.12))
    b.add_body("s", parent="p", joint_type="screw", mass=0.3, inertia_com=ey * 2e-3,
               axis=(0, 0.6, 0.8), screw_pitch=0.1, X_PJ_xyz=(0, 0.1, 0))
    model, params = b.build(torch.float64, device)
    geoms = [m.CollisionGeometry("tip", model.body_index("e"), m.sh.Sphere(0.05)),
             m.CollisionGeometry("s", model.body_index("s"), m.sh.Sphere(0.1)),
             m.CollisionGeometry("ground", -1, m.sh.HalfSpace(), stiffness=1e8)]
    return model, params, m.CollisionScene.build(geoms)


def rigid_parity_values(torch, device, nudge=0.0):
    """Phase 22a's quantities, float64 on `device`: (values {name: numpy},
    counts {name: numpy of Newton iterations})."""
    m = rigid_mods()
    lanes = RIGID_PARITY_LANES
    values, counts = {}, {}

    def t(x):
        return torch.as_tensor(np.asarray(x) * (1.0 + nudge), dtype=torch.float64, device=device)

    def step(name, model, params, scene, q, v, tau, sp=None, **opts):
        sp = sp or m.sap.SapParameters(**RIGID_SAP)
        data, contact = m.sap.assemble(model, params, scene, t(q), t(v), t(tau), 0.01, sp, **opts)
        sol = m.sap.solve_sap(data, data.v_star, sp)
        q_next = m.cplant.advance_positions(model, params, t(q), sol.v, 0.01)
        values[f"{name} v"] = sol.v.cpu().numpy()
        values[f"{name} q"] = q_next.cpu().numpy()
        if contact.phi.shape[-1]:
            values[f"{name} phi"] = contact.phi.cpu().numpy()
        counts[name] = sol.iterations.cpu().numpy()

    model, params, scene = joints_world(m, torch, device)
    rng = np.random.default_rng(11)
    q = rng.uniform(-1.0, 1.0, (lanes, model.num_positions))
    o = model.q_offsets[model.body_index("b")]
    quat = rng.standard_normal((lanes, 4))
    q[:, o : o + 4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    v = rng.standard_normal((lanes, model.num_velocities))
    step("joints", model, params, scene, q, v, rng.standard_normal(v.shape))
    values["joints M"] = m.dyn.mass_matrix(model, params, t(q)).cpu().numpy()
    values["joints p_WB"] = m.kin.forward_kinematics(model, params, t(q))[1].cpu().numpy()

    for seed, pair in enumerate(RIGID_PAIRS):
        model, params, scene = pair_world(m, torch, pair, device)
        q, v = pair_lanes(pair, model, lanes, seed)
        name = ("hydro " if pair[2] else "") + f"{pair[0]}-{pair[1]}"
        step(name, model, params, scene, q, v, np.zeros_like(v))

    model, params, scene = arm_world(m, torch, device)
    q, v, tau, qd = arm_lanes(lanes)
    for case, (contact_model, opts) in ARM_CASES.items():
        opts = dict(opts)
        if opts.pop("pd_controllers", False):
            zero = t(np.zeros_like(qd))
            opts["pd_controllers"] = ((("j1", 40.0, 2.0, 3.0), ("j2", 25.0, 1.0, 0.5)), t(qd),
                                      zero, zero)
        step(case, model, params, scene, q, v, tau,
             m.sap.SapParameters(contact_model=contact_model, **RIGID_SAP), **opts)

    model = m.ModelBuilder()
    model.add_body("anchor", parent=None, joint_type="weld", mass=0.0)
    model.add_body("block", parent="anchor", joint_type="floating", mass=2.0,
                   inertia_com=np.diag([0.02, 0.03, 0.04]))
    model, params = model.build(torch.float64, device)
    feb = m.fel.ForceElementBuilder(model)
    feb.add_bushing("anchor", "block", X_AF_xyz=(0.0, 0.0, 0.5), X_AF_rpy=(0.1, 0.0, -0.2),
                    torque_stiffness=(6.0, 6.0, 4.0), torque_damping=(0.5, 0.5, 0.3),
                    force_stiffness=(300.0, 300.0, 250.0), force_damping=(8.0, 8.0, 6.0))
    feb.add_linear_spring_damper("anchor", (0.4, 0.0, 0.5), "block", (0.1, 0.0, 0.0),
                                 free_length=0.3, stiffness=80.0, damping=2.0)
    fe, fp = feb.build(torch.float64, device)
    q = np.zeros((lanes, 7))
    quat = np.array([1.0, 0, 0, 0]) + 0.3 * rng.standard_normal((lanes, 4))
    q[:, :4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 4:7] = [0.1, -0.05, 0.35] + 0.1 * rng.standard_normal((lanes, 3))
    v = rng.standard_normal((lanes, 6))
    values["force elements tau"] = m.fel.generalized_forces(model, params, fe, fp, t(q),
                                                            t(v)).cpu().numpy()

    g = m.topo.LinkGraph()
    rod = lambda L: np.diag([L**2 / 12, L**2 / 12, 1e-3])  # noqa: E731
    for name, com, L in (("crank", (0, 0, -0.5), 1.0), ("coupler", (1.0, 0, 0), 2.0),
                         ("rocker", (0, 0, 0.5), 1.0)):
        g.add_link(name, mass=1.0, com=com, inertia_com=rod(L))
    g.add_joint("ground_crank", parent=m.topo.WORLD, child="crank", axis=(0, 1, 0))
    g.add_joint("crank_coupler", parent="crank", child="coupler", axis=(0, 1, 0),
                p_PJ=(0, 0, -1.0))
    g.add_joint("coupler_rocker", parent="coupler", child="rocker", axis=(0, 1, 0),
                p_PJ=(2.0, 0, 0))
    g.add_joint("rocker_ground", parent="rocker", child=m.topo.WORLD, axis=(0, 1, 0),
                p_PJ=(0, 0, 1.0), p_CJ=(2.0, 0, 0))
    model, params, balls, _ = g.build(torch.float64, device)
    q0, _ = m.topo.assemble(model, params, balls, t([0.3, -0.25, 0.2]))
    values["topology assemble"] = q0.cpu().numpy()
    return values, counts


def rigid_parity(torch, dev, card):
    """22a: card float64 against the port's CPU float64, within
    RIGID_PARITY of each quantity's scale; Newton iteration counts equal, or
    within the CPU's own spread under RIGID_NUDGES."""
    ref, ref_c = rigid_parity_values(torch, "cpu")
    got, got_c = rigid_parity_values(torch, dev)
    spread = {name: np.zeros_like(c) for name, c in ref_c.items()}
    for nudge in RIGID_NUDGES:
        nudged = rigid_parity_values(torch, "cpu", nudge)[1]
        for name, c in nudged.items():
            spread[name] = np.maximum(spread[name], np.abs(c - ref_c[name]))
    # The cylinder's patch is not comparable across devices: its points are
    # Newton projections onto the surface, where the reference's cylinder
    # normal vanishes for a point 1e-17 outside (ROADMAP.md, Queue 3), so a
    # 1e-15 change of the pose moves them.  It runs, finite, all the same.
    apart = [name for name in ref if name.startswith("hydro cylinder")]
    for name in apart:
        check(np.isfinite(got.pop(name)).all(), f"rigid parity: {name} not finite")
        ref.pop(name)
    ref_c = {k: v for k, v in ref_c.items() if not k.startswith("hydro cylinder")}
    errs = parity_errors(ref, got)
    worst = max(errs, key=errs.get)
    bad = {name: e for name, e in errs.items() if not e <= RIGID_PARITY}
    bad_c = {name: (got_c[name].tolist(), r.tolist()) for name, r in ref_c.items()
             if np.any(np.abs(got_c[name] - r) > spread[name])}
    for name, e in bad.items():
        print(f"[rigid parity] {name}: {e:.3e} of scale over {RIGID_PARITY:.0e} FAIL")
    for name, (g, r) in bad_c.items():
        print(f"[rigid parity] {name}: iterations {g} on the card, {r} on the CPU, nudged "
              f"spread {spread[name].tolist()} FAIL")
    check(not bad and not bad_c, f"rigid parity: {sorted(bad) + sorted(bad_c)}")
    print(f"[rigid parity] {', '.join(apart)}: finite on the card, not compared (the "
          f"reference's cylinder normal, ROADMAP.md Queue 3)")
    total = sum(int(c.sum()) for c in ref_c.values())
    lanes = sum(c.size for c in ref_c.values())
    equal = sum(int((got_c[name] == r).sum()) for name, r in ref_c.items())
    moved = sum(int((spread[name] > 0).sum()) for name in ref_c)
    max_d = max(int(np.abs(got_c[name] - r).max()) for name, r in ref_c.items())
    print(f"[rigid parity] {len(errs)} quantities of {len(ref_c)} SAP steps x "
          f"{RIGID_PARITY_LANES} lanes (each joint type, {len(RIGID_PAIRS)} pairs and patches, "
          f"limits, a coupler, ball, distance and weld constraints, PD, both HC models, force "
          f"elements, a topology assemble): card float64 against CPU float64, worst {worst} "
          f"{errs[worst]:.3e} of scale (<= {RIGID_PARITY:.0e}); Newton iterations equal in {equal} "
          f"of {lanes} lane solves ({total} on the CPU), the others within the CPU's own "
          f"spread under nudges of {RIGID_NUDGES} (which move {moved} lane counts; max "
          f"|card - CPU| {max_d}) [{card}]")


def rigid_demo(name, device, torch):
    """22b's worker: demo `name` at its depth, float32 on `device`: its
    final states (lists), the checks the depth reaches, and its seconds."""
    import importlib

    demo = importlib.import_module(f"drake_tpu_torch.examples.{name}")
    start = time.perf_counter()
    states, checks = demo.smoke(RIGID_DEPTHS[name], device, torch.float32)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"states": {k: v.double().cpu().numpy().tolist() for k, v in states.items()},
            "checks": {k: bool(ok) for k, ok in checks.items()},
            "finite": all(bool(torch.isfinite(v).all()) for v in states.values()),
            "seconds": time.perf_counter() - start}


def in_background(args, workers=1):
    """Runs ``chip_smoke.py ARGS`` for each entry of `args` ({key: ARGS})
    in processes of their own, `workers` at a time in that order, from
    threads that wait on them (the output is read as it comes, so no pipe
    fills): ({key: a future of the CompletedProcess}, the host clock at
    the start)."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(workers)
    jobs = {key: pool.submit(subprocess.run, [sys.executable, __file__, *a],
                             capture_output=True, text=True, timeout=1000)
            for key, a in args.items()}
    pool.shutdown(wait=False)
    return jobs, time.perf_counter()


def background_output(job, what):
    """The last line of a background process's output as JSON, after
    printing the lines before it; fails if the process failed."""
    proc = job.result()
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    if proc.returncode != 0:
        print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
    check(proc.returncode == 0, f"{what} exited {proc.returncode}")
    return json.loads(lines[-1])


def rigid_demos_start():
    """22b's processes: one a demo, RIGID_WORKERS at a time."""
    return in_background({name: ("--rigid-demo", name) for name in RIGID_DEPTHS}, RIGID_WORKERS)


def rigid_demos(workers, card):
    """22b: the demos at RIGID_DEPTHS, float32 on the card, a process each
    (started by rigid_demos_start); each final state within
    RIGID_FLOOR_FACTOR times the JAX package's float32 floor of the JAX
    package's float32 CPU reading at the same step, each check the depth
    reaches passed.  Returns each demo's seconds."""
    jobs, start = workers
    ref = json.loads((pathlib.Path(__file__).parent / RIGID_REFERENCE).read_text())
    check(ref["depths"] == RIGID_DEPTHS, "tests/contact_reference.json is of other depths")
    results = {name: background_output(job, f"22b's {name}") for name, job in jobs.items()}
    wall = time.perf_counter() - start
    for name, r in results.items():
        check(r["finite"], f"{name}: a state is not finite")
        failed = [k for k, ok in r["checks"].items() if not ok]
        check(not failed, f"{name}: failed its checks {failed} at depth {RIGID_DEPTHS[name]}")
        lines = []
        for run, want in ref["demos"][name].items():
            bound = max(RIGID_FLOOR_FACTOR * want["floor"], RIGID_MIN_BOUND)
            d = float(np.max(np.abs(np.asarray(r["states"][run]) - np.asarray(want["f32"]))))
            lines.append(f"{run} {d:.3e} (<= {bound:.3e})")
            check(d <= bound, f"{name} {run}: {d:.3e} off the JAX package's float32 reading")
        print(f"[rigid demos] {name} at depth {RIGID_DEPTHS[name]}: checks "
              f"{json.dumps(r['checks'])}; max |card - JAX CPU float32| {'; '.join(lines)}; "
              f"{r['seconds']!r} s [{card}]")
    print(f"[rigid demos] {len(results)} demos in {wall!r} s of wall, {RIGID_WORKERS} processes "
          f"at a time [{card}]")
    return {name: r["seconds"] for name, r in results.items()}


def grasp_targets(torch, lanes, dev):
    """22c's targets (lanes, 12): the demo's plus 0.05 N(0, 1) from a
    torch.Generator seeded 0, drawn on the CPU in float32."""
    from drake_tpu_torch.examples import allegro_hand

    g = torch.Generator().manual_seed(0)
    base = torch.tensor(np.tile(allegro_hand.TARGETS, allegro_hand.N_FINGERS),
                        dtype=torch.float32)
    return (base + 0.05 * torch.randn((lanes, base.shape[0]), generator=g)).to(dev)


def grasp_phase(torch, dev, card):
    """22c: the allegro PD grasp at GRASP_LANES lanes in one call, timed:
    lanes/s, peak memory; every lane finite, every joint within its limits
    by the SAP limit's slack, every lane's grasp closed and caged, the
    first GRASP_CHECK_LANES lanes against the JAX package's float32 CPU
    run.  Returns (the final states, the targets)."""
    from drake_tpu_torch.contact import sap
    from drake_tpu_torch.examples import allegro_hand

    ref = json.loads((pathlib.Path(__file__).parent / RIGID_REFERENCE).read_text())["grasp_lanes"]
    check(ref["steps"] == GRASP_LANE_STEPS, "tests/contact_reference.json: other grasp depth")
    targets = grasp_targets(torch, GRASP_LANES, dev)
    allegro_hand.grasp_lanes(targets[:2], 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    x, _ = allegro_hand.grasp_lanes(targets, GRASP_LANE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    n = allegro_hand.N_FINGERS * allegro_hand.N_JOINTS
    finite = bool(torch.isfinite(x).all())
    check(finite, "22c: a lane is not finite")
    # The limits are compliant: at rest a limit row's impulse gamma balances
    # at most the servo's effort limit plus gravity over a step, and its
    # regularization lets the joint sit past the stop by h R gamma <= h^2 R
    # (e_lim + 1 N m) at most; R from the assembled limit rows at the final
    # state.  The targets sit 0.5 rad inside the stops, so this gate fails
    # only if a servo overshoots that far; the grasp's own checks (closed,
    # caged) are the ones this depth reaches.
    model, params, system = allegro_hand.grasp_system(x.dtype, dev)
    nq = model.num_positions
    scene = allegro_hand.build(x.dtype, dev, with_ball=True)[2]
    data, _ = sap.assemble(model, params, scene, x[:, :nq], x[:, nq:],
                           torch.zeros_like(x[:, nq:]), allegro_hand.H,
                           joint_limits=allegro_hand.limits(n, x.dtype, dev))
    slack = (allegro_hand.H**2 * (allegro_hand.PD_GAINS[2] + 1.0)
             * torch.maximum(data.R_lim[:, :n], data.R_lim[:, n:]))
    q = x[:, :n]
    over = torch.maximum(allegro_hand.Q_LO - q, q - allegro_hand.Q_HI) - slack
    worst = float(over.max())
    check(worst <= 0.0, f"22c: a joint is past its limit by {worst:.3e} beyond the slack")
    grasp = allegro_hand.grasp_checks(x)
    held = {k: int(grasp[k].sum()) for k in ("closed", "caged")}
    check(all(c == GRASP_LANES for c in held.values()), f"22c: lanes closed and caged {held}")
    got = x[:GRASP_CHECK_LANES].double().cpu().numpy()
    d = float(np.max(np.abs(got - np.asarray(ref["f32"]))))
    bound = max(RIGID_FLOOR_FACTOR * ref["floor"], RIGID_MIN_BOUND)
    check(d <= bound, f"22c: the first lanes {d:.3e} off the JAX package's float32 run")
    ball_z = x[:, nq - 1]
    print(f"[grasp lanes] allegro PD grasp, {GRASP_LANES} lanes x {GRASP_LANE_STEPS} steps in one "
          f"call, alone: {wall!r} s, {GRASP_LANES * GRASP_LANE_STEPS / wall!r} lane-steps/s, "
          f"{wall / GRASP_LANE_STEPS * 1e3!r} ms a step; peak {peak / 2**20:.1f} MiB above the "
          f"inputs; finite {finite}; worst joint past its stop beyond the slack {worst:.3e} "
          f"(<= 0); lanes closed {held['closed']}, caged {held['caged']} of {GRASP_LANES} "
          f"(finger mean {float(q.mean(-1).min()):.3f}-{float(q.mean(-1).max()):.3f} rad); "
          f"ball z {float(ball_z.min()):.4f}-{float(ball_z.max()):.4f} m; first "
          f"{GRASP_CHECK_LANES} lanes max |card - JAX CPU float32| {d:.3e} (<= {bound:.3e}) "
          f"[{card}]")
    return x, targets


def grasp_profile(torch, x, targets, card):
    """22d: per step of 22c, sap.assemble and sap.newton as read off the
    device timeline."""
    from drake_tpu_torch.examples import allegro_hand
    from drake_tpu_torch.systems.simulator import simulate_discrete

    _, params, system = allegro_hand.grasp_system(x.dtype, x.device)

    def run():
        with torch.no_grad():
            simulate_discrete(system, params, x, targets, steps=RIGID_PROFILE_STEPS)

    profile_layers(torch, run, RIGID_PROFILE_STEPS, RIGID_LAYERS, RIGID_LAYERS,
                   f"allegro grasp L={GRASP_LANES}", "step", card)


def rigid_phase(torch, mk, dev, card, profile, demos=None, beside=None):
    """Phase 22 (22a-22c, and 22d with `profile`), with 22b's processes
    `demos` (started here if None) and, if given, phase 19's process
    `beside`, whose output is read before 22c so that 22c runs alone;
    returns the kernels' launches in it (none: no kernel lies on this path)
    and phase 19's."""
    mk.reset_launch_counts()
    t = [time.perf_counter()]
    failed = []
    demos = rigid_demos_start() if demos is None else demos
    acrobot = {}
    # Each part runs even if an earlier one failed; the phase fails at its end.
    for part in ("22a", "19", "22b"):
        try:
            if part == "22a":
                rigid_parity(torch, dev, card)
            elif part == "19" and beside is not None:
                acrobot = background_output(beside[0]["19"], "phase 19")
            elif part == "22b":
                rigid_demos(demos, card)
        except SmokeFailure as e:
            print(f"[rigid (phase 22)] FAIL: {e}")
            failed.append(str(e))
        t.append(time.perf_counter())
    check(not failed, f"phase 22: {failed}")
    x, targets = grasp_phase(torch, dev, card)
    t.append(time.perf_counter())
    launches = dict(mk.LAUNCHES)
    if profile:
        grasp_profile(torch, x, targets, card)
        t.append(time.perf_counter())
    del x, targets
    torch.cuda.empty_cache()
    print("[rigid (phase 22)] seconds of host wall of 22a, the wait for phase 19, the wait "
          "for 22b, 22c" + (", 22d" if profile else "")
          + ": " + json.dumps([round(b - a, 1) for a, b in zip(t, t[1:])]))
    return launches, acrobot


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    if "--rigid-demo" in argv:  # a process of phase 22b: its demo's readings as JSON
        torch.backends.cuda.matmul.allow_tf32 = False
        name = argv[argv.index("--rigid-demo") + 1]
        print(json.dumps(rigid_demo(name, torch.device("cuda", 0), torch)))
        return 0
    from drake_tpu_torch import bench
    from drake_tpu_torch.benchmarks import (bench_coupled_mpc, bench_coupled_world,
                                            bench_dircol_f32, bench_quadrotor_mpc, paddle_blob)
    from drake_tpu_torch.control import mpc, mppi
    from drake_tpu_torch.examples import mpm_bagging, mpm_cloth_demo, pendulum_dircol
    from drake_tpu_torch.mpm import cloth, coupling, grid_contact, tiles
    from drake_tpu_torch.mpm import solver as mpm
    from drake_tpu_torch.ops import _build
    from drake_tpu_torch.ops import mpm_kernels as mk
    from drake_tpu_torch.solvers import ipm, sqp
    from drake_tpu_torch.trajopt import dircol, ilqr
    from drake_tpu_torch.utils.struct import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_start = {}  # phase -> host clock at its start, for the closing line of times
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    if "--acrobot-only" in argv:  # phase 19 in a process of its own: its launches as JSON
        t0 = time.perf_counter()
        by_path = acrobot_phase(torch, mk, dev, card, "--profile" in argv)
        print(f"[acrobot (phase 19)] {time.perf_counter() - t0!r} s of host wall in a process "
              f"of its own [{card}]")
        print(json.dumps(by_path))
        return 0
    print(card)  # the card's name and power limit, as nvidia-smi prints them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    if "--opt-only" in argv:  # phase 20 alone, with no result line
        opt_phase(torch, mk, dev, card, "--profile" in argv)
        return 0
    if "--systems-only" in argv:  # phase 21 alone, with no result line
        systems_phase(torch, mk, dev, card, "--profile" in argv)
        return 0
    if "--contact-only" in argv:  # phase 22 alone, with no result line
        rigid_phase(torch, mk, dev, card, "--profile" in argv)
        return 0

    phase_start["1"] = time.perf_counter()
    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> {lib.name}")
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {line.strip()}")

    scales = {1: scene(mpm, 1, dev), 2: scene(mpm, 2, dev)}
    errs = {name: 0.0 for name in KERNELS}
    timed = {}

    phase_start["2"] = time.perf_counter()
    # ---- 2. per-kernel parity ---------------------------------------------
    def parity(scale, config, state):
        tag = (f"scale={scale} n={state.x.shape[0]} A={config.max_active_blocks} "
               f"pmax={config.block_capacity}")
        dropped = int(mpm.sort_particles(config, state).dropped)
        for name, kernel, plain, bounds, _, _, _, rows in kernel_cases(
                torch, np, mpm, mk, config, state):
            # kernel_parity synchronises: a fault shows at the kernel at fault.
            err, ok, detail = kernel_parity(torch, name, kernel, plain, bounds, rows)
            errs[name] = max(errs[name], err)
            print(f"[parity {tag} dropped={dropped}] {name}: max|kernel - plain| "
                  f"= {err:.3e} ({detail}) {'ok' if ok else 'FAIL'}")
            check(ok, f"{name} disagrees with its plain version at {tag}")
        return dropped

    # Capacities cut at the small size: every full block overflows a pmax of
    # 200 (no multiple of 32), and with 8 active blocks the others are left out.
    config1, state1 = scales[1]
    for cut in (dict(block_capacity=200), dict(max_active_blocks=8)):
        dropped = parity(1, dataclasses.replace(config1, **cut), state1)
        check(dropped > 0, f"{cut} dropped no particle: the case tests nothing")
    order_contract(torch, mpm, mk, config1, state1)
    for scale, (config, state) in scales.items():
        check(parity(scale, config, state) == 0, "the bench scene dropped particles")
        # Warm-up of every path before the counted run.
        for path in MPM_PATHS:
            for cfg in (config, dataclasses.replace(config, xla_only=True)):
                run_path(torch, mpm, path, cfg, state, WARMUP_SUBSTEPS)
    torch.cuda.synchronize()

    phase_start["3"] = time.perf_counter()
    # ---- 3. main path, counted ---------------------------------------------
    mk.reset_launch_counts()
    results = {}
    per_substep = {name: {} for name in KERNELS}
    for scale, (config, state) in scales.items():
        plain_cfg = dataclasses.replace(config, xla_only=True)
        for path in MPM_PATHS:
            before = dict(mk.LAUNCHES)
            out_k, ms_k = run_path(torch, mpm, path, config, state, SUBSTEPS)
            mid = dict(mk.LAUNCHES)
            out_p, ms_p = run_path(torch, mpm, path, plain_cfg, state, SUBSTEPS)
            torch.cuda.synchronize()
            launched = {k: mid[k] - before[k] for k in mk.LAUNCHES}
            check(dict(mk.LAUNCHES) == mid, f"plain {path} path launched a kernel")
            # The substeps take K1 from block windows, the hand-composed
            # transfers the dense K1.
            dense = SUBSTEPS if path == "dense" else 0
            want = {"update_grid": dense, "update_grid_blocks": SUBSTEPS - dense,
                    "p2g_block": SUBSTEPS, "g2p_block": SUBSTEPS if path == "blocked" else 0}
            check(launched == want, f"{path} launches {launched}, expected {want}")
            for name in KERNELS:
                per_substep[name][path] = launched[name] / SUBSTEPS
            results[(scale, path)] = (out_k, ms_k, out_p, ms_p)
    launches = dict(mk.LAUNCHES)
    print(f"[launches] main path: {json.dumps(launches)}")
    for name in KERNELS:
        check(launches[name] > 0, f"{name} was never launched by the main path")

    t = SUBSTEPS * scales[1][0].dt
    for (scale, path), (out_k, ms_k, out_p, ms_p) in results.items():
        n = out_k.x.shape[0]
        for label, out, ms in (("kernel", out_k, ms_k), ("plain", out_p, ms_p)):
            dropped = int(out.dropped)
            finite = all(bool(torch.isfinite(f).all()) for f in (out.x, out.v, out.F, out.C))
            vz = float(out.v[:, 2].double().mean())
            rel = abs(vz - (-9.81 * t)) / (9.81 * t)
            print(f"[run scale={scale} n={n}] {path} {label}: {SUBSTEPS} substeps, "
                  f"dropped={dropped}, finite={finite}, mean v_z={vz!r} "
                  f"(-g t={-9.81 * t!r}, rel {rel:.2e}), "
                  f"{SUBSTEPS / (ms / 1e3)!r} substeps/s ({ms / SUBSTEPS!r} ms/substep) "
                  f"[{card}]")
            check(dropped == 0, f"{path} {label} dropped {dropped} particles")
            check(finite, f"{path} {label}: non-finite state")
            check(rel <= FREE_FALL_RTOL, f"{path} {label}: free fall off by {rel:.2e}")
        dx_max = float((out_k.x - out_p.x).abs().max())
        dv_max = float((out_k.v - out_p.v).abs().max())
        ok = max(dx_max, dv_max) <= MAX_DIFF_PATHS
        print(f"[run scale={scale} n={n}] {path}: max|x_kernel - x_plain| = {dx_max:.3e}, "
              f"max|v_kernel - v_plain| = {dv_max:.3e} (<= {MAX_DIFF_PATHS:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{path}: kernel and plain paths disagree")

    phase_start["4"] = time.perf_counter()
    # ---- 4. kernel times ---------------------------------------------------
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for scale, (config, state) in scales.items():
        n = state.x.shape[0]
        for name, kernel, plain, _, nbytes, flops, chain, _ in kernel_cases(
                torch, np, mpm, mk, config, state):
            timed[name], line = time_kernel(torch, kernel, plain, flush, nbytes, flops, chain)
            print(f"[time scale={scale} n={n}] {name}: {line} [{card}]")
        active = mpm.sort_particles(config, state).active
        shapes = {"update_grid": (-(-math.prod(config.grid_size) // 256), 256),
                  "update_grid_blocks": k1_blocks_launch(
                      active, config.grid_size,
                      torch.cuda.get_device_properties(dev).multi_processor_count)}
        for name, (blocks, threads) in shapes.items():
            empty = time_empty_launch(torch, mk, blocks, threads, dev)
            print(f"[time scale={scale} n={n}] empty kernel at {name}'s launch shape "
                  f"({blocks} CTAs x {threads} threads): warm {empty!r} ms, "
                  f"{empty / timed[name]['ms']:.3f} of {name}'s warm time [{card}]")
            timed[name]["empty_launch_ms"] = empty
    del flush

    phase_start["5"] = time.perf_counter()
    # ---- 5. profile (on request) --------------------------------------------
    if "--profile" in argv:
        profile_paths(torch, mpm, scales, card)

    phase_start["6-8"] = time.perf_counter()
    # ---- 6-8. the MPC of bench.py ------------------------------------------
    mpc_parity(torch, bench, ilqr, dev, card)
    res, info = mpc_main_path(torch, bench, mk, dev, card)
    if "--profile" in argv:
        mpc_profile(torch, mpc, res, info, card)
    del res, info

    phase_start["9"] = time.perf_counter()
    # ---- 9. K1 and K2 over lanes, at the coupled world's shapes -------------
    coupled_timed = {"update_grid": {}, "update_grid_blocks": {}, "p2g_block": {}}
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for lanes in COUPLED_KERNEL_LANES:
        config, state = coupled_inputs(torch, np, paddle_blob, lanes, dev)
        cases, grid_args, sort, blocks_args = lane_kernel_cases(mpm, mk, config, state)
        tag = (f"lanes L={lanes} grid {config.grid_size} A={config.max_active_blocks} "
               f"pmax={config.block_capacity} rows={sort.packed.shape[0]} "
               f"dropped={int(sort.dropped.sum())}")
        check(int(sort.dropped.sum()) == 0, f"{tag}: the coupled scene dropped particles")
        outs = {}
        for name, kernel, plain, bounds, nbytes, flops, chain in cases:
            err, ok, detail = kernel_parity(torch, name, kernel, plain, bounds)
            errs[name] = max(errs[name], err)
            print(f"[parity {tag}] {name}: max|kernel - plain| = {err:.3e} ({detail}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"{name} disagrees with its plain version at {tag}")
            coupled_timed[name][lanes], line = time_kernel(torch, kernel, plain, flush,
                                                           nbytes, flops, chain)
            coupled_timed[name][lanes]["max_abs_err"] = err
            print(f"[time {tag}] {name}: {line} [{card}]")
            if name == "p2g_block":
                live, live_bytes = k2_live_bytes(mk, sort)
                live_ms, _ = bound_ms(live_bytes, flops)
                print(f"[time {tag}] p2g_block on its {live} live blocks of "
                      f"{sort.counts.numel()} and 13 live channels of {mk.P2G_NV}: bound "
                      f"{live_ms!r} ms ({live_bytes} bytes), share of it warm "
                      f"{live_ms / coupled_timed[name][lanes]['ms']:.3f} [{card}]")
            outs[name] = kernel()
        lane_checks(torch, mpm, mk, tree_map, config, state, grid_args, sort, blocks_args,
                    outs, card)
        del cases, grid_args, sort, blocks_args, outs, state
    del flush
    torch.cuda.empty_cache()

    phase_start["10-12"] = time.perf_counter()
    # ---- 10-12. the coupled MPM + rigid world and its MPPI (config 5) ------
    coupled_parity(torch, (paddle_blob, coupling, mppi, tree_map), dev, card)
    by_path = {"mpm substep (phase 3)": launches}
    by_path["coupled world K=64 (phase 11)"] = coupled_world_phase(
        torch, mk, bench_coupled_world, dev, card)
    by_path["config 5, 32 x 8 (phase 12)"], res5 = config5_phase(
        torch, mk, bench_coupled_mpc, dev, card)
    if "--profile" in argv:
        coupled_profile(torch, bench_coupled_mpc, mppi, tree_map, res5, dev, card)
    del res5
    torch.cuda.empty_cache()

    phase_start["13"] = time.perf_counter()
    # ---- 13. the dense implicit world --------------------------------------
    (by_path["dense implicit world K=64 (phase 13)"],
     by_path["dense implicit world K=32 (phase 13)"], k1_mass, dense_final) = implicit_phase(
        torch, mpm, mk, grid_contact, paddle_blob, bench_coupled_world, dev, card,
        "--profile" in argv)
    errs["update_grid_blocks"] = max(errs["update_grid_blocks"], k1_mass["max_abs_err"])
    torch.cuda.empty_cache()

    phase_start["14"] = time.perf_counter()
    # ---- 14. the cloth: the bagging demo -----------------------------------
    (by_path["cloth bagging implicit (phase 14b)"],
     by_path["cloth bagging penalty (phase 14d)"], cloth_timed) = cloth_phase(
        torch, mpm, mk, grid_contact, cloth, mpm_bagging, mpm_cloth_demo, dev, card,
        "--profile" in argv)
    for name, res in cloth_timed.items():
        errs[name] = max(errs[name], res["max_abs_err"])

    phase_start["15"] = time.perf_counter()
    # ---- 15. the tile pipeline ---------------------------------------------
    blocked = {scale: results[(scale, "blocked")][0] for scale in scales}
    by_path["tiled MPM (phase 15)"], tiled_err = tiled_mpm_phase(
        torch, mpm, mk, tiles, scales, blocked, card)
    errs["g2p_block"] = max(errs["g2p_block"], tiled_err)
    for name in KERNELS:
        per_substep[name]["tiled"] = by_path["tiled MPM (phase 15)"][name] / (
            len(scales) * SUBSTEPS)
    del blocked, results
    k3_timed = k3_lanes(torch, np, mpm, mk, tree_map, paddle_blob, dev, card)
    errs["g2p_block"] = max(errs["g2p_block"], k3_timed["max_abs_err"])
    torch.cuda.empty_cache()

    phase_start["16"] = time.perf_counter()
    # ---- 16. the implicit world on the tile pipeline ------------------------
    by_path.update(tiled_world_phase(torch, mk, grid_contact, paddle_blob, bench_coupled_world,
                                     dense_final, dev, card, "--profile" in argv))
    del dense_final
    for name in ("update_grid_blocks", "p2g_block"):
        for path, counts in list(by_path.items())[1:]:
            check(counts[name] > 0, f"{name} was never launched by {path}")
    for path, counts in by_path.items():
        if "tiled" in path:
            check(counts["g2p_block"] > 0, f"g2p_block was never launched by {path}")

    phase_start["17"] = time.perf_counter()
    # Phase 19 and 22b's demos run in processes of their own beside phases
    # 17-22a: these phases time no kernel and are host-bound, and 22c runs
    # alone after them.
    beside = in_background({"19": ("--acrobot-only",) + (("--profile",) if "--profile" in argv
                                                          else ())})
    demos = rigid_demos_start()
    # ---- 17. the quadrotor obstacle MPC (config 3) ---------------------------
    torch.cuda.empty_cache()
    quad_parity(torch, bench_quadrotor_mpc, ilqr, dev, card)
    by_path["quadrotor MPC, 4096 lanes (phase 17b)"], quad_res = quad_main_path(
        torch, bench_quadrotor_mpc, mk, dev, card)
    if "--profile" in argv:
        quad_profile(torch, bench_quadrotor_mpc, mpc, ilqr, quad_res, dev, card)
    del quad_res
    torch.cuda.empty_cache()

    phase_start["18"] = time.perf_counter()
    # ---- 18. the pendulum dircol (config 1) ----------------------------------
    dircol_first_iteration(torch, pendulum_dircol, sqp, ipm, dev, card)
    by_path["pendulum dircol float64 (phase 18b)"] = dircol_main_path(
        torch, pendulum_dircol, dircol, sqp, mk, dev, card)
    by_path["dircol f32 bench, 32 lanes (phase 18c)"], dircol_res = dircol_bench_phase(
        torch, bench_dircol_f32, sqp, mk, dev, card)
    if "--profile" in argv:
        dircol_profile(torch, bench_dircol_f32, dircol, dircol_res, dev, card)
    del dircol_res
    # The NLP and QP stack asks for full float32 matmuls; nothing turned TF32 on.
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest", "TF32 is on")
    print("[tf32] torch.backends.cuda.matmul.allow_tf32 False, float32 matmul precision "
          "'highest' after phases 17-18")
    torch.cuda.empty_cache()

    phase_start["20"] = time.perf_counter()
    # ---- 20. the optimization layer: MathematicalProgram and its back ends --
    by_path["optimization layer (phase 20)"] = opt_phase(torch, mk, dev, card,
                                                          "--profile" in argv)
    torch.cuda.empty_cache()

    phase_start["21"] = time.perf_counter()
    # ---- 21. continuous-time and hybrid simulation, the three demos ---------
    by_path["continuous and hybrid simulation (phase 21)"] = systems_phase(
        torch, mk, dev, card, "--profile" in argv)

    phase_start["22"] = time.perf_counter()
    # ---- 22. the discrete plant's constraints and the rigid-contact demos ---
    # (19. config 2, the acrobot swing-up, and the LQR family: its process's
    # lines are printed here, when it has ended.)
    launches_22, acrobot = rigid_phase(torch, mk, dev, card, "--profile" in argv, demos, beside)
    by_path.update(acrobot)
    by_path["discrete plant constraints and rigid-contact demos (phase 22)"] = launches_22

    ends = list(phase_start.values())[1:] + [time.perf_counter()]
    print("[phases] seconds of host wall: " + json.dumps(
        {name: round(end - start, 1) for (name, start), end in zip(phase_start.items(), ends)}))
    # Times at the top level are those of the larger MPM size (the last
    # timed), under "coupled" those of phase 9 by lane count, K3's under
    # "lanes" those of phase 15c; no single PyTorch call computes any of
    # these functions, so library_ms is null.
    print(json.dumps({"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": sum(counts[name] for counts in by_path.values()),
         "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
         "launches_per_substep": per_substep[name],
         "max_abs_err": errs[name], **timed[name], "library_ms": None,
         **({"coupled": coupled_timed[name]} if name in coupled_timed else {}),
         **({"with_mass": k1_mass} if name == "update_grid_blocks" else {}),
         **({"lanes": k3_timed} if name == "g2p_block" else {}),
         **({"cloth": cloth_timed[name]} if name in cloth_timed else {})}
        for name, (route, source, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    except Exception:  # any failed phase: report and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        code = 1
    sys.exit(code)
