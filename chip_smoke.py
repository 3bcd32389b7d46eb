#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gtsam_petercdev_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 everything below
    python3 chip_smoke.py --kernels-only  phases 1-3: checks at a dozen shapes and
                                          the iSAM2 path's, times over the bench
                                          plans' buckets; no result line (a check
                                          after a kernel edit)
    python3 chip_smoke.py --isam2-only    phases 1-2, the iSAM2 path's d = 3 shapes
                                          of phase 3, then phase 6; no result line
    python3 chip_smoke.py --smart-only    phases 1-2, then phase 7; no result line
    python3 chip_smoke.py --optimizers-only  phases 1-2, the sphere's plans, then
                                          phase 8; no result line
    python3 chip_smoke.py --isam2-family-only  phases 1-2, the iSAM2 path's d = 3
                                          shapes of phase 3, then phase 9 (after
                                          an unprofiled run c) of phase 6); no
                                          result line
    python3 chip_smoke.py --partitioned-only  phases 1-2, the sphere's plans, then
                                          phase 11; no result line
    python3 chip_smoke.py --navigation-only  phases 1-2, then phase 12; no result line
    python3 chip_smoke.py --init-only     phases 1-2, then phase 13; no result line
    python3 chip_smoke.py --robust-only   phases 1-2, then phase 14; no result line
    python3 chip_smoke.py --geometry-only phases 1-2, then phase 15; no result line
    python3 chip_smoke.py --hybrid-only   phases 1-2, then phase 16; no result line

Phases, in order; any failure raises and the script exits non-zero without
a result line:
  1. card    name and power limit (nvidia-smi); TF32 off for matmul and cuDNN
  2. build   g++ builds the host libraries (csrc/host: the AMD ordering, the
             host engine's native sweeps), then nvcc every kernel of the
             paths from gtsam_petercdev_torch/csrc, each source its own
             process, all started together
  3. kernels each of the four CUDA kernels against its plain PyTorch version
             on the card, in float64 and float32: K1 (bucket partial Cholesky
             for large fronts: factor, column-slab solve and tiled Schur
             update, three launches) and K2 (fused backsolve) at every bucket
             shape of the sphere and bundle-adjustment plans, K3 (per-clique
             partial Cholesky in shared memory, then the tiled Schur update)
             and K4 (its block-pool variant) at every such shape that fits
             shared memory, plus K1 fronts past shared memory (one whose
             packed F11 exceeds it; nf = 32 at d = 16, whose column-slab
             solve exceeds it too) and indefinite buckets with the bad
             pivot in the first and in a later diagonal block (equal
             bad-pivot counts); kernel and plain times per sweep of the
             buckets the routing gives each kernel, and per bucket (events,
             device time, bound) for all four; composites of library calls
             beside K1 (sphere root) and K2 (sphere root, BA leaf),
             informational. The iSAM2 path's d = 3 buckets (tests/data/
             isam2_bucket_shapes.json: the level steps' shapes for K4 / K1,
             the wildfire rounds' for K2, a d = 3 indefinite bucket) are
             checked the same way, and each kernel is timed over a sweep of
             the ones it takes
  4. sphere  the synthetic 2,500-pose / 4,949-factor Pose3 sphere through the
             port's entry points: gauss_newton (f64, solver="multifrontal")
             and levenberg_marquardt, launch counters reset just before and
             read just after; the first GN step against the dense Cholesky
             oracle; a small graph against the CPU path; ms per chained GN
             iteration in float32 and float64. Its plan line: the F_size of
             each of best_ordering's four candidates (ND, the port's AMD,
             the COLAMD proxy, degree-ascending), the one chosen, cliques,
             levels, buckets and their routing; gate: the chosen ordering
             fills at most 1.20x the JAX package's CCOLAMD on the same graph
             (tests/data/ordering_reference.json, tools/ordering_reference.py)
  5. BA      synthetic bundle adjustment, 1000 cameras / 50,000 points / 4
             observations each, through levenberg_marquardt with
             solver="multifrontal" and solver="schur", float32 and float64,
             counters reset just before and read just after; the first damped
             multifrontal step against the Schur solver's; a small rig against
             the CPU path; LM iterations per second by bench.py's protocol;
             at the shape of tests/data/ba_synth_lm_reference.json
             (tools/ba_reference.py), the f32 and f64 LM histories beside the
             JAX package's and the port's CPU f32 (gate: f64 = JAX's, rel 1e-8);
             its plan line and fill gate as phase 4's
  6. iSAM2   float64, through run_city10000 / ISAM2.update on a synthetic
             City10000-like stream (utils/synthetic.city_stream), each local
             problem ordered by the port's AMD (the plan line: the batch City
             graph of the stream's first 1,500 lines on it, its fill against
             CCOLAMD's, gated
             as phase 4's; run c) prints its separator widths: the largest
             class, the level steps by ns and kernel, the share at ns >= 64): a) its
             first 150 lines on the card and on the CPU path, final
             estimates within rel 1e-9, identical Bayes-tree counters and
             wildfire rounds update by update, and a second card run's
             estimates bitwise equal to the first's;
             b) the reference contract (no relinearization, wildfire 0, 60
             poses: the delta after every 6th update = the dense solve,
             atol 1e-9); c) CITY_LINES lines at City10000's parameters,
             counters reset just before and read just after: per-update ms,
             launches per update, a profiled window of 25 updates (CUDA
             launches, device busy share), device->host reads per update,
             re-eliminated cliques, peak device memory, ATE against the
             stream's ground truth, the final error beside a batch GN of the
             final graph from the iSAM2 estimate; gates: finite errors, no
             bad pivots, K2 and K4 launched; it saves the whole ISAM2 at
             line 500 (phase 9 d))
  7. smart   smart-factor BA through smart_levenberg_marquardt (dense
             library algebra, no bucket kernel, as in the JAX package): a
             ragged 20-camera / 500-track rig with a behind-camera and a
             single-view track, card = CPU path (LM history rel 1e-9, equal
             VALID tracks at every entry), and on it the HESSIAN solve =
             smart_pcg (rel 1e-6) and JACOBIAN_Q / SVD's A^T A, A^T b = H, g
             (rel 1e-9); then the BA cell's scene (ba_synth.smart_scene:
             1000 cameras, 50,000 tracks of 4 views) in f64 and f32, 4 LM
             iterations beside tests/data/smart_ba_reference.json
             (tools/smart_reference.py; gates: finite, the f64 error falls,
             the start's VALID tracks = the JAX package's), LM iterations
             per second, one iteration's device time and launches, peak
             memory, and the linearization-mode checks on the first
             linearization, reported
  8. optimizers  on the sphere: Gauss-Newton f64 to convergence; mixed-
             precision GN (f32 through K1-K4 on the card, f64 residual and
             retract on the host) reaching it (<= rel 1e-9 above), with ms
             and kernel launches per iteration; dogleg and LM on PCG within
             rel 1e-8 of it; the first PCG step = the multifrontal step (rel
             1e-6); factor / apply = solve (rel 1e-10) and the log-determinant
             = slogdet (rel 1e-10); NCG's error falls in 50 iterations on a
             20-pose graph
  9. iSAM2 family  float64 unless stated, right after phase 6 on its tree
             and stream: a) on the stream's first 120 lines, card = CPU path:
             every pose's tree covariance (rel 1e-9), run_city10000_fixed_lag
             at lag 50 (identical marginalized and deferred keys in every
             update, window estimates rel 1e-9), a checkpoint at line 100
             resumed to 120 bitwise equal on each device; b) run c)'s final
             tree (465 poses): TreeMarginals of every pose against H's
             exact inverse and against dense Marginals with its 1e-10 jitter's
             first-order term added back (both <= 1e-8 x the largest entry),
             the sweep's ms, launches and device time, adjacent poses sharing
             a clique; c) fixed lag 100 poses over 200 lines (loop closures
             to marginalized poses dropped): per-update ms split into
             ISAM2.update and marginalize_leaves, live cliques (gate: at most
             the window's variables), launches per update, the window against
             a batch GN of the kept history; d) run c)'s checkpoint at line
             500 loaded onto the card and fed to line 600: bitwise run
             c)'s estimate, the file's bytes, save and load ms; e) the
             concurrent incremental pair against the batch pair over 30
             lines, lag 15, a synchronize every 15 updates (5e-3); f)
             NonlinearISAM over 20 lines, reorder interval 10, within 1e-6
             of a batch GN of its graph; g) float32 iSAM2 over 100 lines:
             finite, ATE within 10% of float64's, bad pivots, ms, launches;
             h) K4 / K1 / K2 against their plain versions at every shape
             they took in b)-g)
 10. host engine  the host engine (engine_backend="numpy": per-clique numpy
             payloads, the native sweeps) on the card machine's CPU, right
             after phase 9, on phase 6's stream and ordering: a) its first
             150 lines against the card engine and against the card engine
             on the CPU (estimates rel 1e-9, the same n_reeliminated in
             every update), the three timed per update; b) CITY_LINES lines at
             City10000's parameters: ms per update beside run c)'s, the
             native sweeps' share of an update, ATE (gate: within 0.1% of
             run c)'s) and the largest pose difference to run c)'s estimate;
             c) a checkpoint at line 100 resumed to 150, bitwise
 11. partitioned  the separator-Schur solver (parallel/partition.py), float64
             unless stated, right after phase 8 on phase 4's sphere: a) the
             damped solve (lambda 1e-5) at P = 1, 2, 4, 8 parts folded onto
             the card against multifrontal_solve (gate 1e-8 x the largest
             entry), a repeat bitwise equal, counters reset just before and
             read just after: every level one launch of K4 / K3 / K1 and one
             of K2, no plain version called; b) levenberg_marquardt(solver=
             "partitioned", partition_devices=4) against phase 4's
             multifrontal LM (final error rel 1e-9), and one float32 solve
             no further from the float64 solve than the JAX
             PartitionedSolver's on the same system (PART_F32_REF); a) and
             c) time each P in rounds alternated with the multifrontal
             solve; c) the 48-camera / 1,600-point BA rig through d = 3
             sub-blocks at P = 1, 2, 4 against the mixed multifrontal solve
             (the gates of a)); d) a one-rank NCCL process group (a FileStore
             in a temporary directory): distributed_normal_equations against
             assemble_dense, the solver over the group against a)'s P = 4
             solve (1e-12 x the largest entry); e) K4 / K3 / K1 / K2 against
             their plain versions at every level shape of a)-d); the
             scaling table (parallel/scaling.py's)
 12. navigation  float64, after phase 7, on utils/synthetic.imu_gps_drive(1000
             keyframes, a 200 Hz IMU; seed SEED): a) its 199,800 IMU samples
             through one batched preintegrate pass (ms, CUDA launches),
             every PIM field against the CPU path (rel 1e-12) and 5
             intervals integrated one at a time (rel 1e-13); b) batch
             levenberg_marquardt (solver="multifrontal") over its 3,000
             variables, 999 CombinedImuFactors, 1,000 GPSFactors and 3
             priors: the plan line (best_ordering's four candidates, cliques,
             levels, buckets, routing), the first damped step against the
             dense oracle (1e-8 x its largest entry), launches (counters
             reset just before, read just after), no trial with bad pivots,
             no plain version, ms per chained LM iteration and the device's
             busy share, ATE, and its first 50 keyframes on the card against
             the CPU path (LM history rel 1e-9); c) IMUKittiExampleGPS's loop
             (models/imu_gps.py) through ISAM2 at ISAM2Params() defaults (d =
             6, the CombinedImuFactor in row blocks) over the first 150
             keyframes: per-update ms, launches per update, ATE, the first 50
             updates against the card engine on the CPU (estimates rel 1e-9,
             equal n_reeliminated), no bad pivots, K4 and K2 launched, the
             final error over the final graph's optimum against the JAX
             ISAM2's on the same loop (NAV_ISAM2_REF: rel 1e-6 on the proxy
             ordering's tree, 1e-3 on its CCOLAMD tree), batch GN of
             the final graph from the iSAM2 estimate printed, and batch LM
             from the drive's start reaching the stored optimum (rel 1e-5); d) K4 / K3 / K1 / K2 against their plain
             versions at every shape b) and c) gave them, float64 and float32
 13. init    initialization and the linear extras, float64, after phase 12:
             a) chordal initialization (slam/initialize.py) of phase 4's
             sphere (its between factors): ms and PCG iterations of each
             stage, the card against the CPU (translations 1e-6 x max|t|,
             rotation entries 1e-6), its error below the perturbed start's;
             GN (multifrontal) from it with a Pose3 prior on pose 0, beside
             GN from the perturbed start; b) LAGO on the whole
             city_stream(3687) graph (3,687 poses, 5,714 between factors),
             the card against the CPU (rel 1e-9), its ATE below dead
             reckoning's; LM (multifrontal) from LAGO and from dead
             reckoning: the plan line, iterations, final error, ATE,
             launches per iteration; c) SubgraphSolver (linear/subgraph.py:
             the tree factored once through K4 / K3 / K1, applied through
             K2 on every PCG step) on a 500-pose sphere (20 x 25 rings)
             linearized at its perturbed start: PCG iterations, ms with the tree factor and an apply
             apart, the tree plan line, launches for a solve, the factor and
             an apply; against the multifrontal solve (1e-8 x max|x|; PCG
             at tol 1e-9, at most 2,000 iterations); d) the exact constrained dense LM (linear/qr.py) on
             the stream's first 1,000 poses, pose 0 pinned by
             nonlinear_equality: the pin at every accepted step (1e-12), the
             card against the CPU on 200 poses (LM history rel 1e-9), ms an
             iteration; e) the unstable factors: e1) BetweenFactorEM on every
             loop closure of the sphere with 10% of them outliers against
             plain factors (ATE below; the first damped step = the dense
             oracle, 1e-8); e2) a rolling-shutter BA scene (200 keyframes,
             10,000 points) and e3) an inverse-depth scene (200 poses, 5,000
             landmarks; dims 6 / 5 / 1 padded to 6) through LM: plan lines,
             launches, and on 20-keyframe cuts the dense oracle (1e-8) and
             card = CPU (rel 1e-9); every LM of a)-e) with no bad pivot and
             no plain version; f) a Kalman filter + RTS over 10,000
             constant-velocity tracks x 1,000 steps (100 tracks on the CPU,
             rel 1e-12), the EKF Pose2 localization over 100 steps (card =
             CPU, rel 1e-12), min_eigenvalue_shifted of the sphere's H with
             the hvp matvec (iterations, ms; card = CPU on sphere_rings(10,
             10), rel 1e-9, eigvalsh beside it), 10^6 draws of
             sample_sqrt_info from a full 6 x 6 sqrt-information (sample
             covariance within 1% of sqrt(Sigma_ii Sigma_jj)); g) K4 / K3 /
             K1 / K2 against their plain versions at every shape b), c) and
             e) gave them, float64 and float32
 14. robust  the robust and global front end, float64, after phase 13: a)
             GNC-TLS (nonlinear/gnc.py, its dense inner solve) on the 2,500-
             pose sphere with 245 of its 2,450 loop closures corrupted, the
             prior and odometry pinned: outer and inner iterations, ms an
             inner iteration (assembly, solve), recall and precision of the
             weights < 0.5, ATE; card = CPU on a 40-pose cut (1e-8); b) the
             Shonan staircase (sfm/shonan.py) on the sphere's 4,949 rotation
             measurements, p 3..6, every level through LM (solver=
             "multifrontal": SO(p) blocks of d = 3, 6, 10, 15 on K1-K4): per
             level LM iterations, trials with bad pivots and rejected, the
             lambdas, ms an iteration, an LM step's device busy, launches,
             the plan and its routing, the certificate's lambda_min beside
             eigvalsh of the dense 7,500 x 7,500 S, rotation errors against
             the truth; the default route (pcg) card = CPU on a 100-pose cut;
             c) MFAS (host) and translation recovery (sfm/translation.py) on
             the sphere's 4,949 directions with 5% reversed: flagged edges,
             the dense and multifrontal routes (1e-6 x max|t|), ATE; card =
             CPU on a 100-node cut (1e-9); d) the sphere's between factors
             through custom_factor (forward mode) against the built-in batch
             (final error rel 1e-4, ms an LM iteration of both) and one GN
             step of their linear containers against the multifrontal step
             (1e-8); e) K4 / K3 / K1 / K2 against their plain versions at
             every shape b) and c) gave them, float64 and float32
 15. geometry  the extended geometry, float64, after phase 14: a) planar
             landmark SLAM (utils/synthetic.planar_slam: city_stream(3687)'s
             Pose2 walk at City10000's odometry sigmas, 920 of 1,000 Point2
             landmarks seen, bearing-range / range / bearing factors; d = 3);
             b) sim3_sphere(50, 50) (2,500 Sim3 values, 4,949 BetweenSim3 and a
             prior; d = 7); c) plane_slam(1000, 60) (1,000 Pose3 keyframes room
             to room, 60 OrientedPlane3 landmarks, 6,000 OrientedPlane3Factors,
             a direction prior a plane; d = 6); d) two_view_pairs(1000, 100)
             (1,000 EssentialMatrix values, 100,000 EssentialMatrixFactors, one
             level of K4 leaves; d = 5): each through LM multifrontal, its plan
             line, LM iterations, ms an iteration, an LM step's device busy
             share, launches, bad pivots, ATE / epipolar / rotation gates, and
             card = CPU on a cut (LM histories rel 1e-9); e) the other factor
             types (Frobenius, Karcher mean, pose rotation / translation
             priors, rotate, rotate directions, essential-matrix constraint,
             reference frame, planar projection, range and bearing in 3-D) on
             10-50-variable graphs card = CPU, an anti-factor's exact
             cancellation (dense H, g and the multifrontal step), the spherical
             camera, fundamental, Sim2 and SO(n) functions card = CPU (1e-12);
             f) augmented_lagrangian_optimize and penalty_optimize on phase
             4's sphere with 2,500 constraints ||t_i|| = r (inner LM
             multifrontal): outer and inner iterations, the violation, the ms
             of each part, AL card = CPU on a cut; FitBasis and an
             evaluation-factor graph (Chebyshev2, N = 32) on the drive's
             199,800 positions at 200 Hz, card = CPU on every 10th sample;
             one host solve_qp and solve_lp timed; g) K4 / K3 / K1 / K2 against their plain versions
             at every bucket shape a)-f) gave them (d = 3, 5, 6, 7), float64
             within 1e-14
 16. hybrid  discrete and hybrid inference and the utilities, float64, after
             phase 15: a) a 60-variable DiscreteFactorGraph (cards 2-4): MPE,
             every marginal, k_best(10) card = CPU, and brute force over its
             first 12 variables' joint table; b) the dense hybrid path on a
             30-variable switching chain with 10 binary modes (M = 1,024 in
             one batched Cholesky) card = CPU; c) eliminate_sparse on
             city_stream(1000)'s graph at dead reckoning with its first 8 loop
             closures binary hybrids: M = 256 hypotheses folded into each
             bucket (one K1 / K3 / K4 and one K2 launch a bucket for all of
             them), its plan, launches against one hypothesis's
             multifrontal_solve and a Python loop over all 256, ms and busy
             share; 8 hypotheses against their own multifrontal_solve, a
             40-pose cut against the dense path on the CPU, the kernels at
             every folded bucket shape; d) HybridSmoother over 100 Hybrid City
             lines as linear slices (max_leaves 10) card = CPU; e)
             run_hybrid_city (max_hypotheses 10) against the host engine on
             the CPU, and a forking run; f) write_g2o / read_g2o, the solver
             comparer on a 600-line City file, a timing span
 17. result  a `kernels` JSON line, the card line, then the last line
             {"ok": true, "device": {...}}

Needs one CUDA device and the CUDA toolkit (nvcc); it fails without either,
and in a directory that holds no gtsam_petercdev_torch package.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

SEED = 0
N_RINGS = N_PER_RING = 50  # 2,500 poses, 4,949 between factors
GN_ITERS = 3
LM_ITERS = 3
BA_SHAPE = (1000, 50_000, 4)  # cameras, points, observations per point
BA_LM_ITERS = {"float32": 3, "float64": 2}
# kernel vs plain version on random SPD buckets (entries O(1), well
# conditioned): float64 agrees to rounding; float32 sums over up to
# fd = 216 terms per entry
TOL = {"float64": 1e-9, "float32": 2e-3}
# least-time bounds: H100 SXM, 3.35 TB/s HBM3; 67 TFLOP/s float32 (vector)
# and 67 TFLOP/s float64 (tensor core), NVIDIA's data sheet
MEM_BPS = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
# shapes of the JAX package's Pallas kernel tests, (B, nf, ns, d)
PALLAS_TEST_SHAPES = [(3, 2, 1, 6), (4, 1, 0, 6), (2, 4, 3, 6), (5, 3, 2, 3)]
# K1 fronts past shared memory in float64: packed F11 too large (the global
# branch of the factor stage); nf = 32 (the planner's max_supernode) at
# d = 16, whose slab and staged block columns are too large as well (the
# in-place branch of the solve stage); and the sphere plan's root
EXTRA_SHAPES = [(1, 30, 8, 9), (1, 32, 8, 16), (1, 32, 96, 6)]
SPHERE_ROOT = (1, 32, 96, 6)
BA_LEAF = (50_000, 1, 4, 9)
# the bench plans' bucket shapes and routes, as tools/bench_bucket_shapes.py
# wrote them (the --kernels-only sweeps)
BENCH_SHAPES = "tests/data/bench_bucket_shapes.json"
# indefinite buckets (B, nf, ns, d, diagonal entry set to -5): the bad pivot
# in the first diagonal block, and in a later one (at d = 6, 9, and 3 as the
# iSAM2 path has it)
INDEFINITE = [(3, 2, 1, 6, 0), (2, 3, 2, 9, 10), (4, 3, 2, 3, 4)]
FACTOR_KEYS = ("L", "Linv", "W", "y", "U", "ug")
# the iSAM2 path (phase 6): a city_stream of CITY_POSES poses (seed SEED),
# cut at CITY_LINES lines for the full run, at City10000's parameters
# (wildfire 0.0, relinearize threshold 0.01, skip 1); the card-vs-CPU gate
# on its first CITY_GATE_LINES lines; the reference contract on
# CONTRACT_POSES poses; a profiled window of PROFILE_UPDATES updates ending
# 10 updates before the last. Run c) was cut from 1,500 lines to make room
# for phase 12 (its later updates are its slowest: on an H100, 169.9 s for
# 1,500 lines, 112.4 s for 1,000, 65.1 s for 750; then to 600 to make room
# for phase 14); the plan line still
# orders the batch graph of the stream's first CITY_PLAN_LINES lines, the
# graph of the JAX package's CCOLAMD reference
# (tests/data/ordering_reference.json)
CITY_POSES = 3687
CITY_LINES = 600
CITY_PLAN_LINES = 1500
CITY_GATE_LINES = 150
# where the card's wildfire descent and the CPU's part, the change one of
# them saw must be below this (a rounding-size change, against poses of
# size 1-100): see phase 6 gate a)
ROUNDING_CHANGE = 1e-12
CONTRACT_POSES = 60
PROFILE_UPDATES = 25
# run c) saves the whole ISAM2 at every CITY_PROGRESS lines: its save at
# line 500 is the one phase 9 d) resumes from to CITY_LINES (at 450 until
# PR 15: 150 lines resumed, ~17 s; cut to make room for phase 16)
CITY_PROGRESS = 500
# phase 9 (the iSAM2 family, float64 unless stated), on the same stream: a)
# card = CPU over FAMILY_GATE_LINES lines (fixed lag FAMILY_GATE_LAG poses,
# a checkpoint at FAMILY_GATE_CKPT); c) fixed-lag smoothing over
# FIXED_LAG_LINES lines, lag FIXED_LAG poses; e) the concurrent pairs over
# CONCURRENT_LINES lines, lag CONCURRENT_LAG, a synchronize every
# CONCURRENT_SYNC updates; f) NonlinearISAM over NISAM_LINES lines, reorder
# interval NISAM_REORDER; g) float32 iSAM2 over F32_LINES lines. c), e), f)
# and g) are cut for the script's time (a) from 150 lines and c) from 250
# for phase 14; c) from 1,000 lines, which saves
# ~40 s against a 1,200 s limit that the uncut script came within 124 s of,
# and from 400 to make room for phase 12; e) from 300 lines at lag 50 and a
# synchronize every 25, then from 60, then from 45 to make room for phase
# 14; f) from 200 lines, then from 40; g) from 500 lines, then from 300,
# then from 200 for phase 14): the batch filter, the batch smoother and
# NonlinearISAM hold one factor batch per update, and each linearization
# walks them all: their time grows with the stream's length (PERF.md
# section 4)
FAMILY_GATE_LINES = 120
FAMILY_GATE_LAG = 50
FAMILY_GATE_CKPT = 100
FIXED_LAG_LINES = 200
FIXED_LAG = 100
CONCURRENT_LINES = 30
CONCURRENT_LAG = 15
CONCURRENT_SYNC = 15
NISAM_LINES = 20
NISAM_REORDER = 10
F32_LINES = 100
# the d = 3 bucket shapes of that run's level steps and wildfire rounds, as
# tools/bench_bucket_shapes.py wrote them
ISAM2_SHAPES = "tests/data/isam2_bucket_shapes.json"
# phase 5: LM histories of the JAX package (f32, f64) and of the port's CPU
# path (f32) at a fifth of the BA cell, from tools/ba_reference.py
BA_REF = "tests/data/ba_synth_lm_reference.json"
# phase 7: the JAX package's smart-factor LM on the BA cell's scene, from
# tools/smart_reference.py; the small rig (cameras, tracks) of the
# card-vs-CPU gate; the camera priors' sigma (as the reference tool)
SMART_REF = "tests/data/smart_ba_reference.json"
SMART_RIG = (20, 500)
SMART_PRIOR_SIGMA = 1e-4
# phases 4-6: the JAX package's CCOLAMD (and COLAMD proxy) plans of the
# sphere, BA and City graphs, from tools/ordering_reference.py; the ordering
# each phase plans with may fill at most FILL_GATE x CCOLAMD's F_size
ORDERING_REF = "tests/data/ordering_reference.json"
FILL_GATE = 1.20
# phase 10 (the host engine, engine_backend="numpy", on the card machine's
# CPU) on phase 6's stream: a) CITY_GATE_LINES lines against the card
# engine; b) CITY_LINES lines, ATE within HOST_ATE_GATE (relative) of the
# card's run c); c) a checkpoint at FAMILY_GATE_CKPT resumed to
# CITY_GATE_LINES
HOST_ATE_GATE = 1e-3
# phase 11 (the partitioned solver) on phase 4's sphere: the part counts of
# a) and of the sub-block BA rig of c) (parallel/scaling.py's), the damping;
# gates: solve = multifrontal to PART_GATE x its largest entry (the JAX
# package's scaling run measured <= 9.6e-9 absolute at sphere2500,
# SCALING.md); LM's final error rel PART_LM_GATE; the float32 partitioned
# solve no further from the float64 solve (x the largest entry) than the
# JAX package's PartitionedSolver is on the same float32 system
# (PART_F32_REF, tools/partitioned_f32_reference.py: 1.144e-3; the port on
# the CPU 6.44e-4, the float32 multifrontal solve 9.29e-5); the one-rank
# group's normal equations and solve to PART_NE_GATE x the largest entry
# (assemble_dense sums with atomics)
PARTS = (1, 2, 4, 8)
BA_PARTS = (1, 2, 4)
PART_LAM = 1e-5
PART_GATE = 1e-8
PART_LM_GATE = 1e-9
PART_F32_REF = "tests/data/partitioned_f32_reference.json"
PART_NE_GATE = 1e-12
# phase 12 (navigation, float64): utils/synthetic.imu_gps_drive of
# NAV_KEYFRAMES keyframes (one a second) at a NAV_RATE Hz IMU; a) the
# batched preintegrate pass against NAV_ONE_AT_A_TIME intervals integrated
# one at a time; b) batch LM of at most NAV_LM_ITERS iterations (cut from 30,
# of which it ran 16, to make room for phase 14), its
# iteration timed NAV_CHAIN chained (cut from 4 to make room for phase 14),
# and the first NAV_CUT keyframes on the
# card against the CPU path over NAV_CUT_ITERS LM iterations; c) ISAM2 over
# the first NAV_ISAM2_KEYFRAMES keyframes (cut from 300 to make room for
# phase 14: its updates grow with the keyframes on this chain), its first
# NAV_ISAM2_GATE updates
# against the card engine on the CPU; its final error over the final graph's
# optimum against the JAX ISAM2's on the same loop, both read from
# NAV_ISAM2_REF (tools/imu_isam2_reference.py, CPU: the optimum is LM to
# convergence polished by dense GN): to NAV_ISAM2_REF_GATE (relative; the
# margin covers the drive's PIMs made on the card, within 1e-12 of the
# CPU's) against the JAX ISAM2 with its tree ordered by the proxy COLAMD
# (the port's AMD tree gives the same error on this chain, rel ~1e-11 on
# the CPU), and to NAV_ORDERING_GATE against the JAX ISAM2 on its own
# CCOLAMD tree (where the wildfire stops elsewhere: rel 1.9e-4 on the CPU
# at 300 keyframes);
# batch LM (NAV_ISAM2_LM_ITERS iterations) from the drive's start reaches
# that optimum to NAV_OPT_GATE (relative)
NAV_KEYFRAMES = 1000
NAV_RATE = 200
NAV_ONE_AT_A_TIME = 5
NAV_LM_ITERS = 8
NAV_CHAIN = 2
NAV_CUT = 50
NAV_CUT_ITERS = 4
NAV_ISAM2_KEYFRAMES = 150
NAV_ISAM2_GATE = 50
NAV_ISAM2_LM_ITERS = 25
NAV_OPT_GATE = 1e-5
NAV_ISAM2_REF = "tests/data/imu_isam2_reference.json"
NAV_ISAM2_REF_GATE = 1e-6
NAV_ORDERING_GATE = 1e-3
NAV_PROGRESS = 25

# phase 13 (initialization and the linear extras, float64): a) chordal on the
# phase-4 sphere, GN of at most INIT_GN_ITERS iterations from it; b) LAGO on
# the whole city_stream(INIT_CITY_POSES) graph, LM of at most
# INIT_CITY_LM_ITERS iterations from it and from dead reckoning; d) the
# constrained dense LM over the stream's first INIT_DENSE_POSES poses (at
# most INIT_DENSE_ITERS iterations), card = CPU on INIT_DENSE_CUT poses; e1)
# INIT_OUTLIER_SHARE of the sphere's loop closures outliers, LM of at most
# INIT_EM_ITERS; e2) the rolling-shutter scene (keyframes, points,
# observations a point) and e3) the inverse-depth scene (poses, landmarks,
# observations), LM of at most INIT_CAM_ITERS (cut from 10 to make room for
# phase 14), the dense-oracle and card =
# CPU gates (INIT_CAM_CUT_ITERS iterations) on INIT_CAM_CUT keyframes; c)
# the subgraph PCG on sphere_rings(INIT_SUBGRAPH_SPHERE) at its start (cut
# from the whole sphere at the chordal estimate, ~900 PCG steps and ~20 s of
# a host-bound apply, to make room for phase 16) at tol INIT_SUBGRAPH_TOL
# and at most INIT_SUBGRAPH_MAX_ITERS iterations (at its defaults, tol 1e-8
# and 500 iterations, it stopped 7.6e-6 x max|x| from the multifrontal solve
# on the whole sphere; tol 1e-8 took 834 iterations on an H100 and landed
# 5.3e-9 away, half the gate);
# the filters' card = CPU gate on
# INIT_KF_CPU_TRACKS of the tracks (they are independent); f)
# INIT_KF (tracks, steps) of the Kalman filter, INIT_EKF_STEPS of the EKF
# (1,000 took 16.1 s on the card and as long again on its host's CPU: each
# step is two forward-mode Jacobians of a 3-vector chart, ~45 small ops; cut
# from 250 to make room for phase 14),
# the power methods' card = CPU gate on sphere_rings(INIT_EIG_CUT),
# INIT_SAMPLES draws of the sampler
INIT_SPHERE = (N_RINGS, N_PER_RING)
INIT_GN_ITERS = 5
INIT_CITY_POSES = 3687
INIT_CITY_LM_ITERS = 30
INIT_DENSE_POSES = 1000
INIT_DENSE_CUT = 200
INIT_DENSE_ITERS = 20
INIT_OUTLIER_SHARE = 0.1
INIT_EM_ITERS = 20
INIT_RS = (200, 10_000, 4)
INIT_INV_DEPTH = (200, 5_000, 4)
INIT_CAM_ITERS = 5
INIT_CAM_CUT = 20
INIT_CAM_CUT_ITERS = 4
INIT_KF = (10_000, 1_000)
INIT_KF_CPU_TRACKS = 100
INIT_SUBGRAPH_SPHERE = (20, 25)
INIT_SUBGRAPH_TOL = 1e-9
INIT_SUBGRAPH_MAX_ITERS = 2000
INIT_EKF_STEPS = 100
INIT_EIG_CUT = (10, 10)
INIT_SAMPLES = 1_000_000

# phase 14 (the robust and global front end, float64): a) GNC-TLS on
# sphere_rings_outliers(ROBUST_SPHERE)'s plain factors (prior, odometry and
# loop closures as three batches), known_inliers pinning the prior and the
# odometry, the JAX defaults otherwise (dense inner solve); card = CPU on
# sphere_rings_outliers(ROBUST_GNC_CUT) to ROBUST_GNC_GATE (weights, poses);
# b) Shonan averaging on sphere_rings(ROBUST_SPHERE)'s rotations at p
# ROBUST_SHONAN_P, LM multifrontal (at most ROBUST_SHONAN_ITERS iterations),
# the staircase made to climb every level (optimality_threshold +inf: at the
# default -1e-4 it stops at the first level the certificate passes; each
# level's verdict at -1e-4 is printed), each level's certificate beside
# eigvalsh of the dense S; the default route (pcg) card = CPU on
# sphere_rings(ROBUST_SHONAN_CUT): rotations to ROBUST_ROT_GATE, lambda_min
# to 1e-9 x the Gershgorin scale, p_final equal; c) translation recovery
# from utils/synthetic.sphere_directions (angular noise DIRECTION_SIGMA,
# REVERSED_SHARE reversed), MFAS over 8 axes, edges whose weight exceeds
# ROBUST_MFAS_THRESHOLD dropped (GTSAM's translation-averaging example's
# 0.1), the dense and the multifrontal route to ROBUST_TRANS_GATE x max|t|,
# card = CPU on sphere_directions(ROBUST_TRANS_CUT); d) the sphere's between
# factors through custom_factor, LM multifrontal (tolerances
# ROBUST_CUSTOM_TOL) to the built-in batch's error within ROBUST_CUSTOM_GATE
# (rel), and one GN step of its linear containers to the multifrontal step
# within ROBUST_STEP_GATE x its largest entry
ROBUST_SPHERE = (N_RINGS, N_PER_RING)
ROBUST_GNC_CUT = (5, 8)
ROBUST_GNC_GATE = 1e-8
ROBUST_SHONAN_P = (3, 6)
ROBUST_SHONAN_ITERS = 60
ROBUST_SHONAN_CUT = (10, 10)
ROBUST_ROT_GATE = 1e-6
ROBUST_MFAS_THRESHOLD = 0.1
ROBUST_TRANS_CUT = (10, 10)
ROBUST_TRANS_GATE = 1e-6
ROBUST_CUSTOM_TOL = 1e-10
ROBUST_CUSTOM_GATE = 1e-4
ROBUST_STEP_GATE = 1e-8
# phase 13 e1)'s ATE on sphere_rings_outliers(50, 50) on an H100 (PERF.md,
# section 6): with BetweenFactorEMPose3, and with plain factors
EM_ATE, PLAIN_ATE = 0.265666, 1.067634

# phase 15 (the extended geometry, float64, seed SEED), scenes from
# utils/synthetic: a) planar_slam(*GEO_PLANAR) (poses, landmarks); b)
# sim3_sphere(*GEO_SIM3); c) plane_slam(*GEO_PLANE) (keyframes, planes); d)
# two_view_pairs(*GEO_TWO_VIEW) (pairs, correspondences); each through LM
# multifrontal (at most GEO_LM_ITERS iterations) and card = CPU on its cut
# (GEO_*_CUT, at most GEO_CUT_ITERS iterations; LM histories rel
# GEO_CPU_GATE); e) extra_factor_scenes's graphs card = CPU (their
# histories within GEO_CPU_GATE of the start's error: noise-free, they fall
# to ~1e-25); f) the
# sphere's Pose3 graph with one ||t_i|| = radius constraint a pose through
# augmented_lagrangian_optimize and penalty_optimize (inner LM multifrontal,
# at most GEO_INNER_ITERS iterations; gate: each one's final violation at
# most GEO_VIOLATION_DROP x its start's), AL card = CPU on
# sphere_rings(GEO_CONSTRAINT_CUT); FitBasis and a graph of
# evaluation_factors (Chebyshev2, GEO_BASIS_N) on drive_positions(
# *GEO_BASIS_DRIVE), card = CPU on every GEO_BASIS_CUT-th sample; g) the
# kernels at every bucket shape of
# a)-f), f64 max abs difference <= GEO_KERNEL_GATE
GEO_PLANAR = (3687, 1000)
GEO_PLANAR_CUT = (200, 60)
GEO_SIM3 = (N_RINGS, N_PER_RING)
GEO_SIM3_CUT = (10, 10)
GEO_PLANE = (1000, 60)
GEO_PLANE_CUT = (60, 12)
GEO_TWO_VIEW = (1000, 100)
GEO_TWO_VIEW_CUT = (20, 100)
GEO_LM_ITERS = 10
GEO_CUT_ITERS = 5
GEO_CPU_GATE = 1e-9
GEO_CONSTRAINT_SPHERE = (N_RINGS, N_PER_RING)
GEO_CONSTRAINT_CUT = (5, 6)
GEO_INNER_ITERS = 10
GEO_VIOLATION_DROP = 1e-3
GEO_BASIS_DRIVE = (1000, 200)
GEO_BASIS_N = 32
GEO_BASIS_CUT = 10
GEO_KERNEL_GATE = 1e-14

# phase 16 (discrete and hybrid inference, float64, seed SEED): a) a
# DiscreteFactorGraph of HYB_DISCRETE_VARS variables (cards 2-4; unary
# factors, a chain, triplets within a window of four), MPE, every marginal
# and k_best(HYB_K_BEST) card = CPU, and against brute force (the joint
# table) over the factors of the first HYB_BRUTE_VARS variables; b) the
# dense path on a switching chain of HYB_DENSE (3-dim variables, binary
# modes): M = 2^modes assignments, card = CPU; c) city_stream(
# HYB_CITY_POSES)'s graph at dead reckoning, its first HYB_SPARSE_LOOPS loop
# closures binary hybrids (M = 2^loops) through eliminate_sparse's folded
# plan, HYB_SPARSE_SAMPLES hypotheses against one multifrontal_solve each,
# a Python loop of multifrontal_solve over HYB_LOOP_HYPOTHESES of them
# timed (all 256: 25.7 s on an H100, PR 15 call 1, against 79.6 ms folded),
# the HYB_SPARSE_CUT-pose cut against the dense path on the CPU; d)
# HybridSmoother (max_leaves HYB_SMOOTHER_LEAVES) over the first
# HYB_SMOOTHER_LINES lines of hybrid_city_stream(HYB_CITY_POSES, p_false_loop
# HYB_FALSE_LOOPS) as linear slices, card = CPU; e) run_hybrid_city over its
# first HYB_CITY_LINES lines (max_hypotheses HYB_CITY_HYPOTHESES) against the
# host engine on the CPU, and HYB_FORK_LINES lines with ambiguous odometry;
# f) the sphere through write_g2o / read_g2o, solver_comparer on a
# HYB_COMPARER_LINES-line City file. Gates: card = CPU within HYB_GATE
# (rel, or abs on log probabilities).
HYB_DISCRETE_VARS = 60
HYB_BRUTE_VARS = 12
HYB_K_BEST = 10
HYB_DENSE = (30, 10)
HYB_CITY_POSES = 1000
HYB_SPARSE_LOOPS = 8
HYB_SPARSE_SAMPLES = 8
HYB_SPARSE_CUT = 40
HYB_LOOP_HYPOTHESES = 16
HYB_SMOOTHER_LINES = 100
HYB_SMOOTHER_LEAVES = 10
HYB_FALSE_LOOPS = 0.1
HYB_CITY_LINES = 100
HYB_CITY_HYPOTHESES = 10
HYB_FORK_LINES = 12
HYB_COMPARER_LINES = 600
HYB_GATE = 1e-9

KERNELS = {
    # name: (source, TPU kernel it replaces, CUDA kernel names in the profile)
    "partial_cholesky": ("gtsam_petercdev_torch/csrc/partial_cholesky.cu",
                         "gtsam_petercdev_tpu/ops/cholesky_v2.py:256",
                         ("factor_kernel", "solve_kernel", "schur_update_kernel")),
    "backsolve_bucket": ("gtsam_petercdev_torch/csrc/backsolve.cu",
                         "gtsam_petercdev_tpu/ops/cholesky_v2.py:347",
                         ("backsolve_warp_kernel", "backsolve_cluster_kernel")),
    "partial_cholesky_smem": ("gtsam_petercdev_torch/csrc/partial_cholesky_smem.cu",
                              "gtsam_petercdev_tpu/ops/cholesky.py:197",
                              ("partial_cholesky_smem_kernel", "schur_update_kernel")),
    "partial_cholesky_blocks": ("gtsam_petercdev_torch/csrc/partial_cholesky_smem.cu",
                                "gtsam_petercdev_tpu/ops/cholesky.py:369",
                                ("partial_cholesky_blocks_kernel",)),
}
# the Schur-complement stage K1 and K3 launch after their factor stages
STAGE_SOURCES = {"partial_cholesky": ["gtsam_petercdev_torch/csrc/schur_update.cu"],
                 "partial_cholesky_smem": ["gtsam_petercdev_torch/csrc/schur_update.cu"]}
ROUTE_KERNEL = {"global": "partial_cholesky", "smem": "partial_cholesky_smem",
                "blocks": "partial_cholesky_blocks"}


T_START = time.perf_counter()
# (B, nf, ns, d) the kernels were held against their plain versions at, in
# float64 and float32, so far in this run (check_kernels)
CHECKED_SHAPES = set()


def log(msg):
    """A line of the run's log, after the script's clock in seconds."""
    print(f"[{time.perf_counter() - T_START:7.1f}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --- phase 3: kernels against their plain versions -----------------------------


def spd_bucket(torch, gen, B, m, dtype):
    A = torch.randn(B, m, m, generator=gen, dtype=torch.float64, device="cuda")
    F = A @ A.transpose(1, 2) / m + torch.eye(m, dtype=torch.float64, device="cuda")
    g = torch.randn(B, m, generator=gen, dtype=torch.float64, device="cuda")
    return F.to(dtype).contiguous(), g.to(dtype).contiguous()


def factor_cost(B, nf, ns, d, itemsize):
    """Bytes and flops of one partial Cholesky of a bucket from a dense
    [B, m, m] F (K1 and K3): F and g read, L, Linv, W, y, U, ug and the
    pivot counts written."""
    fd, sd = nf * d, ns * d
    m = fd + sd
    nbytes = itemsize * B * (m * m + m + fd * fd + nf * d * d + fd * sd + fd + sd * sd + sd) + 4 * B
    flops = B * (fd**3 / 3.0 + fd * fd * sd + fd * sd * sd)  # plan_flop_stats' count
    return nbytes, flops


def blocks_cost(B, nf, ns, d, itemsize):
    """K4's bytes and flops: of the pool slice it must read only the first
    nf block rows ([F11 | F12]) and F22 — F21 is F12's transpose and is
    never read — and g; it writes what factor_cost counts."""
    fd, sd = nf * d, ns * d
    m = fd + sd
    nbytes = itemsize * B * (fd * m + sd * sd + m + fd * fd + nf * d * d + fd * sd + fd
                             + sd * sd + sd) + 4 * B
    return nbytes, factor_cost(B, nf, ns, d, itemsize)[1]


def backsolve_cost(B, nf, ns, d, itemsize):
    """K2's bytes (L below its diagonal blocks, Linv, W, y, xs read; x
    written) and flops."""
    fd, sd = nf * d, ns * d
    lower = fd * (fd - d) // 2  # the part of L below the diagonal blocks
    nbytes = itemsize * B * (lower + nf * d * d + fd * sd + fd + sd + fd)
    flops = B * (2.0 * fd * sd + 2.0 * lower + 2.0 * fd * d)
    return nbytes, flops


def bound(costs, dtype_name):
    """Sum over launches of max(bytes / rate, flops / peak), in ms, and
    which of the two dominates the sum."""
    t_b = sum(b / MEM_BPS for b, _ in costs)
    t_f = sum(f / PEAK_FLOPS[dtype_name] for _, f in costs)
    total = sum(max(b / MEM_BPS, f / PEAK_FLOPS[dtype_name]) for b, f in costs)
    return total * 1e3, "bytes" if t_b >= t_f else "operations"


def event_ms(torch, sweep, reps):
    sweep()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        sweep()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profiled_kernel_ms(torch, sweep, kernel_names):
    """Device time of the named kernels in one sweep from torch.profiler,
    None when the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sweep()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if any(name in evt.key for name in kernel_names):
            total += getattr(evt, "device_time_total", 0.0) or getattr(evt, "cuda_time_total", 0.0)
    return total / 1e3 if total > 0 else None


def max_err(got, ref, keys, tol, what):
    """Largest abs difference over `keys`; raises beyond tol * max(1, |ref|)."""
    worst = 0.0
    for k in keys:
        if ref[k].numel():
            e = (got[k] - ref[k]).abs().max().item()
            if not e <= tol * max(1.0, ref[k].abs().max().item()):
                raise AssertionError(f"{what} {k}: err {e:.3e}")
            worst = max(worst, e)
    if int(got["bad"]) != int(ref["bad"]):
        raise AssertionError(f"{what}: bad pivots {int(got['bad'])} != {int(ref['bad'])}")
    return worst


def check_kernels(torch, mods, cases, timed, extras=True, errs_out=None):
    """Hold the four kernels against their plain versions at every case
    (B, nf, ns, d) and time them. timed: dtype name -> kernel name -> the
    cases of one sweep (the buckets the routing gives that kernel in the two
    bench plans, each once, in plan order). extras: the indefinite buckets
    and the library composites too. errs_out: a dict that gets each dtype's
    largest differences by kernel. A case an earlier call of this run
    checked (both dtypes) is not checked again (CHECKED_SHAPES)."""
    v2, v1, kernels = mods
    repeat = [c for c in cases if c in CHECKED_SHAPES]
    cases = [c for c in dict.fromkeys(cases) if c not in CHECKED_SHAPES]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    res = {k: {} for k in KERNELS}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[1]
        itemsize = torch.finfo(dtype).bits // 8
        errs = dict.fromkeys(KERNELS, 0.0)
        n_smem = 0
        for B, nf, ns, d in cases:
            what = f"{name} B={B} nf={nf} ns={ns} d={d}"
            mb = nf + ns
            F, g = spd_bucket(torch, gen, B, mb * d, dtype)
            ref = kernels.partial_cholesky(F, g, nf, d)
            errs["partial_cholesky"] = max(errs["partial_cholesky"], max_err(
                v2.partial_cholesky(F, g, nf, d), ref, FACTOR_KEYS, TOL[name], "K1 " + what))
            xs = torch.randn(B, ns * d, generator=gen, dtype=torch.float64, device="cuda").to(dtype)
            args2 = (ref["L"], ref["Linv"], ref["W"].contiguous(), ref["y"].contiguous(), xs, nf, d)
            x_k, x_p = v2.backsolve_bucket(*args2), v2.backsolve_plain(*args2)
            e = (x_k - x_p).abs().max().item()
            if not e <= TOL[name] * max(1.0, x_p.abs().max().item()):
                raise AssertionError(f"K2 {what}: err {e:.3e}")
            errs["backsolve_bucket"] = max(errs["backsolve_bucket"], e)
            if not v1.fits_smem(nf, ns, d, itemsize):
                continue
            n_smem += 1
            errs["partial_cholesky_smem"] = max(errs["partial_cholesky_smem"], max_err(
                v1.partial_cholesky(F, g, nf, d), ref, FACTOR_KEYS, TOL[name], "K3 " + what))
            Fb = v1.blocks_from_dense(F, mb, d).contiguous().view(-1, d, d)
            gb = g.view(B, mb, d)
            errs["partial_cholesky_blocks"] = max(errs["partial_cholesky_blocks"], max_err(
                v1.partial_cholesky_blocks(Fb, gb, nf, ns, d),
                v1.partial_cholesky_blocks_plain(Fb, gb, nf, ns, d),
                ("L", "Linv", "W", "y", "U_blocks", "ug_blocks"), TOL[name], "K4 " + what))
        torch.cuda.synchronize()
        if errs_out is not None:
            errs_out[name] = dict(errs)

        # indefinite buckets: clamped pivots counted identically by the plain
        # version and all three factor kernels, the bad pivot in the first
        # diagonal block and in a later one
        for B, nf, ns, d, row in INDEFINITE if extras else ():
            F, g = spd_bucket(torch, gen, B, (nf + ns) * d, dtype)
            F[0, row, row] = -5.0
            Fb = v1.blocks_from_dense(F, nf + ns, d).contiguous().view(-1, d, d)
            bad = [int(kernels.partial_cholesky(F, g, nf, d)["bad"]),
                   int(v2.partial_cholesky(F, g, nf, d)["bad"]),
                   int(v1.partial_cholesky(F, g, nf, d)["bad"]),
                   int(v1.partial_cholesky_blocks(Fb, g.view(B, nf + ns, d), nf, ns, d)["bad"])]
            if not (bad[0] >= 1 and len(set(bad)) == 1):
                raise AssertionError(f"indefinite case {(B, nf, ns, d)} entry {row}: bad "
                                     f"(plain, K1, K3, K4) = {bad}")
            log(f"indefinite {name} {(B, nf, ns, d)}, -5 on diagonal entry {row} (block "
                f"{row // d}): bad pivots (plain, K1, K3, K4) = {bad}")

        # times: plain, kernel, kernel, plain within this one call
        for kname in timed[name]:
            sweep_cases = timed[name][kname]
            inputs = []
            for B, nf, ns, d in sweep_cases:
                mb = nf + ns
                F, g = spd_bucket(torch, gen, B, mb * d, dtype)
                if kname == "backsolve_bucket":
                    ref = kernels.partial_cholesky(F, g, nf, d)
                    xs = torch.randn(B, ns * d, generator=gen, dtype=torch.float64,
                                     device="cuda").to(dtype)
                    inputs.append((ref["L"], ref["Linv"], ref["W"].contiguous(),
                                   ref["y"].contiguous(), xs, nf, d))
                elif kname == "partial_cholesky_blocks":
                    inputs.append((v1.blocks_from_dense(F, mb, d).contiguous().view(-1, d, d),
                                   g.view(B, mb, d), nf, ns, d))
                else:
                    inputs.append((F, g, nf, d))
            fn, plain, cost = {
                "partial_cholesky": (v2.partial_cholesky, kernels.partial_cholesky, factor_cost),
                "backsolve_bucket": (v2.backsolve_bucket, v2.backsolve_plain, backsolve_cost),
                "partial_cholesky_smem": (v1.partial_cholesky, v1.partial_cholesky_plain,
                                          factor_cost),
                "partial_cholesky_blocks": (v1.partial_cholesky_blocks,
                                            v1.partial_cholesky_blocks_plain, blocks_cost),
            }[kname]
            sweep_k = lambda: [fn(*a) for a in inputs]
            sweep_p = lambda: [plain(*a) for a in inputs]
            p1 = event_ms(torch, sweep_p, 1)
            k_1 = event_ms(torch, sweep_k, 10)
            k_2 = event_ms(torch, sweep_k, 10)
            p2 = event_ms(torch, sweep_p, 1)
            b_ms, b_by = bound([cost(B, nf, ns, d, itemsize) for B, nf, ns, d in sweep_cases], name)
            v1.reset_launch_counts()
            sweep_k()
            calls, cuda = v1.launch_counts()[kname], v1.cuda_launch_counts()[kname]
            r = dict(max_abs_err=errs[kname], ms=min(k_1, k_2), plain_ms=min(p1, p2),
                     device_ms=profiled_kernel_ms(torch, sweep_k, KERNELS[kname][2]),
                     bound_ms=b_ms, bound_by=b_by, buckets_timed=len(sweep_cases),
                     sweep_cuda_launches_per_bucket=cuda / calls if calls else None)
            # each bucket alone: CUDA events over 10 back-to-back calls
            # (the host's time where it exceeds the card's), and the
            # device time of its kernels (torch.profiler, 3 calls), against
            # the bucket's bound
            r["per_bucket"] = [
                dict(shape=c, ms=event_ms(torch, lambda a=a: fn(*a), 10),
                     device_ms=(profiled_kernel_ms(torch, lambda a=a: [fn(*a) for _ in range(3)],
                                                   KERNELS[kname][2]) or 0.0) / 3,
                     bound_ms=bound([cost(*c, itemsize)], name)[0])
                for c, a in zip(sweep_cases, inputs)]
            log(f"per-bucket {kname} {name} (B, nf, ns, d): ms / device ms [bound ms] (device "
                f"sum {sum(b['device_ms'] for b in r['per_bucket']):.4f} ms): "
                + "; ".join(f"{tuple(b['shape'])} {b['ms']:.4f} / {b['device_ms']:.4f} "
                            f"[{b['bound_ms']:.4f}]" for b in r["per_bucket"]))
            if kname in ("partial_cholesky_smem", "partial_cholesky_blocks"):
                # the same buckets through K1 (for K4: the relayout to
                # [B, m, m] that K4 saves, then K1), as the path ran them before
                if kname == "partial_cholesky_blocks":
                    k1_in = [(a[0], a[1], a[2], a[2] + a[3], a[4]) for a in inputs]
                    sweep_1 = lambda: [v2.partial_cholesky(
                        v1.dense_from_blocks(Fb, gb.shape[0], mb, d), gb.reshape(gb.shape[0], -1),
                        nf, d) for Fb, gb, nf, mb, d in k1_in]
                else:
                    sweep_1 = lambda: [v2.partial_cholesky(*a) for a in inputs]
                r["k1_same_buckets_ms"] = event_ms(torch, sweep_1, 10)
            res[kname][name] = r
            del inputs
        log(f"kernels {name} ({len(cases)} shapes checked, {n_smem} fit shared memory, "
            f"{len(repeat)} checked earlier in this run): "
            + "; ".join(
            f"{k} err {v[name]['max_abs_err']:.2e} ms {v[name]['ms']:.3f} "
            f"(device {v[name]['device_ms']}) plain {v[name]['plain_ms']:.3f} "
            f"bound {v[name]['bound_ms']:.4f} ({v[name]['bound_by']}) over "
            f"{v[name]['buckets_timed']} buckets, {v[name]['sweep_cuda_launches_per_bucket']} CUDA "
            f"launches a bucket"
            + (f" K1 on the same buckets {v[name]['k1_same_buckets_ms']:.3f}"
               if "k1_same_buckets_ms" in v[name] else "")
            for k, v in res.items() if name in v))
        if not extras:
            continue
        # the sphere root: K1 beside a composite of library calls computing
        # the same outputs (informational; the port never calls it)
        B, nf, ns, d = SPHERE_ROOT
        F, g = spd_bucket(torch, gen, B, (nf + ns) * d, dtype)
        fd = nf * d

        def composite():
            L, _ = torch.linalg.cholesky_ex(F[:, :fd, :fd])
            R = torch.linalg.solve_triangular(
                L, torch.cat([F[:, :fd, fd:], g[:, :fd, None]], dim=2), upper=False)
            W, y = R[:, :, :-1], R[:, :, -1:]
            return (torch.baddbmm(F[:, fd:, fd:], W.transpose(1, 2), W, alpha=-1.0),
                    torch.baddbmm(g[:, fd:, None], W.transpose(1, 2), y, alpha=-1.0))

        c_ms = event_ms(torch, composite, 10)
        k_ms = event_ms(torch, lambda: v2.partial_cholesky(F, g, nf, d), 10)
        res["partial_cholesky"][name]["library_composite_ms_sphere_root"] = c_ms
        res["partial_cholesky"][name]["sphere_root_ms"] = k_ms
        log(f"sphere root {SPHERE_ROOT} {name}: K1 {k_ms:.4f} ms; library composite ms "
            f"{c_ms:.4f} (cholesky_ex + solve_triangular + baddbmm; informational)")

        # K2 beside a composite of library calls computing the same x:
        # baddbmm for y - W xs, then solve_triangular with L^T (informational;
        # the port never calls it), at the sphere root and the BA leaf
        for label, (B, nf, ns, d) in (("sphere_root", SPHERE_ROOT), ("ba_leaf", BA_LEAF)):
            F, g = spd_bucket(torch, gen, B, (nf + ns) * d, dtype)
            ref = kernels.partial_cholesky(F, g, nf, d)
            del F, g
            L, Linv, W, y = ref["L"], ref["Linv"], ref["W"].contiguous(), ref["y"].contiguous()
            xs = torch.randn(B, ns * d, generator=gen, dtype=torch.float64, device="cuda").to(dtype)

            def composite2():
                r = torch.baddbmm(y[:, :, None], W, xs[:, :, None], alpha=-1.0)
                return torch.linalg.solve_triangular(L.transpose(1, 2), r, upper=True)[:, :, 0]

            kern2 = lambda: v2.backsolve_bucket(L, Linv, W, y, xs, nf, d)
            x_k = kern2()
            rel = ((composite2() - x_k).abs().max() / x_k.abs().max().clamp_min(1.0)).item()
            c_ms, k_ms = event_ms(torch, composite2, 10), event_ms(torch, kern2, 10)
            res["backsolve_bucket"][name][f"library_composite_ms_{label}"] = c_ms
            res["backsolve_bucket"][name][f"{label}_ms"] = k_ms
            log(f"{label} {(B, nf, ns, d)} {name}: K2 {k_ms:.4f} ms; library composite ms "
                f"{c_ms:.4f} (baddbmm + solve_triangular; informational; agrees to rel {rel:.1e})")
            del ref, L, Linv, W, y, xs
    CHECKED_SHAPES.update(cases)
    return res


# --- phases 4 and 5: the paths ----------------------------------------------------


def chained_ms(torch, step, values, n_chain):
    """bench.py's protocol: n_chain chained steps, one synchronize, median of 3."""
    cur = step(step(values))
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        cur = values
        t0 = time.perf_counter()
        for _ in range(n_chain):
            cur = step(cur)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / n_chain)
    return sorted(times)[1], cur


def profile_once(torch, fn):
    """fn() once under torch.profiler (after a warm call): (device busy ms,
    CUDA kernel launches), or None when the profiler shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    k = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
    if not k:
        return None
    return sum(e.self_device_time_total for e in k) / 1e3, sum(e.count for e in k)


def profile_step(torch, step, values, top=12, reps=2, host=True):
    """One step under torch.profiler: (device busy ms, kernel launches,
    [(kernel, ms, calls)], [(host op, self ms, calls)]), or None when the
    profiler shows no device time. host=False records the device alone (no
    host ops: their events are most of a long step's post-processing)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(values)
    torch.cuda.synchronize()
    # `reps` times, keeping the profile that saw more launches: the profiler
    # can drop a share of a long step's kernel events
    kern, avgs = [], None
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    for _ in range(reps):
        with profile(activities=acts) as p:
            step(values)
            torch.cuda.synchronize()
        a = p.key_averages()
        k = [e for e in a if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in k) > sum(e.count for e in kern):
            kern, avgs = k, a
    if not kern:
        return None
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in kern),
                  key=lambda r: -r[1])
    host_rows = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in avgs
                        if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:top], host_rows[:top]


def time_step(torch, v1, label, unit, step, graph, values, n_chain, prof_out=None,
              profile_host=True):
    """Chained time of `step`, its launches per step, and its profile
    (`prof_out`, a dict, gets its device busy ms and kernel launches; two
    profiled steps, the fuller kept; `profile_host`: the host ops too)."""
    v1.reset_launch_counts()
    step(values)
    per_step = v1.launch_counts()
    ms, out = chained_ms(torch, step, values, n_chain)
    err = float(graph.error(out))
    log(f"{label}: {ms:.3f} ms/{unit} (chained x{n_chain}, median of 3); launches per "
        f"{unit} {per_step}; error after {n_chain} steps {err:.6e}")
    if not err == err:
        raise AssertionError(f"{label}: steps gave a non-finite error")
    prof = profile_step(torch, step, values, host=profile_host)
    if prof is None:
        log(f"{label} device time: not measured (no device events)")
        return ms, per_step
    busy, n_launch, rows, host = prof
    if prof_out is not None:
        prof_out.update(busy_ms=busy, launches=n_launch)
    log(f"{label} device busy {busy:.3f} ms of {ms:.3f} ms ({100.0 * busy / ms:.1f}%); "
        f"top kernels by device time:")
    for key, kms, calls in rows:
        log(f"  {kms:9.3f} ms  {calls:5d}x  {key[:100]}")
    if host:
        log(f"{label} host ops by self CPU time (profiled step, {n_launch} kernel launches):")
    for key, hms, calls in host:
        log(f"  {hms:9.3f} ms  {calls:5d}x  {key[:100]}")
    return ms, per_step


def finite_json(obj):
    """obj with every non-finite float as None (the result line is strict
    JSON) and every dict key a string."""
    if isinstance(obj, float):
        return obj if obj == obj and abs(obj) != float("inf") else None
    if isinstance(obj, dict):
        return {str(k): finite_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite_json(v) for v in obj]
    return obj


def check_result(res, what):
    hist = res.error_history
    if not (res.error < hist[0] and all(e == e and abs(e) != float("inf") for e in hist)):
        raise AssertionError(f"{what}: error did not fall or is not finite: {hist}")


@contextlib.contextmanager
def plain_kernels(names):
    """Within the block, the bucket wrappers `names` (keys of KERNELS) run
    their plain PyTorch versions on the card's tensors: the control that
    tells a kernel's rounding from the problem's conditioning."""
    from gtsam_petercdev_torch.inference import kernels
    from gtsam_petercdev_torch.ops import cholesky, cholesky_v2

    plain = {"partial_cholesky": (cholesky_v2, "partial_cholesky", kernels.partial_cholesky),
             "backsolve_bucket": (cholesky_v2, "backsolve_bucket", cholesky_v2.backsolve_plain),
             "partial_cholesky_smem": (cholesky, "partial_cholesky",
                                       cholesky.partial_cholesky_plain),
             "partial_cholesky_blocks": (cholesky, "partial_cholesky_blocks",
                                         cholesky.partial_cholesky_blocks_plain)}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in (plain[n] for n in names)]
    for n in names:
        mod, attr, fn = plain[n]
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def routing(elimination, maps, itemsize):
    d = maps.plan.d
    return [(bm.B, bm.nf, bm.ns, elimination.bucket_route(bm, d, itemsize)) for bm in maps.buckets]


def log_routing(elimination, label, maps):
    r64, r32 = routing(elimination, maps, 8), routing(elimination, maps, 4)
    log(f"{label}: {len(r64)} buckets (B, nf, ns) -> kernel in float64 [float32 where it differs]:")
    log("  " + " ".join(
        f"({B},{nf},{ns})->{ROUTE_KERNEL[a]}" + ("" if a == b else f"[{ROUTE_KERNEL[b]}]")
        for (B, nf, ns, a), (_, _, _, b) in zip(r64, r32)))


def ordering_line(symbolic, label, n, edges, d, ref, cands=None, chosen=None):
    """Phases 4-6: the plan's ordering. F_size (padded frontal entries of
    the plan at block dimension d, the planner's defaults) of each of
    best_ordering's four candidates, the one chosen (best_ordering's, the
    first of least F_size, or `chosen` by name), beside the JAX package's
    CCOLAMD and proxy on the same graph; gate: chosen <= FILL_GATE x
    CCOLAMD. Returns (the chosen perm, a summary)."""
    if cands is None:
        cands = symbolic.ordering_candidates(n, edges)
    F = {name: d * d * (f - 1) + 1 for name, _, f in cands}  # F_size is d^2 (F_1 - 1) + 1
    best = min(cands, key=lambda c: c[2])
    name, perm = (best[0], best[1]) if chosen is None else next(
        (c[0], c[1]) for c in cands if c[0] == chosen)
    ccol, proxy = ref["ccolamd"]["F_size"], ref["proxy"]["F_size"]
    ratio = F[name] / ccol
    log(f"{label} ordering: {name} (F_size {F[name]}, {ratio:.4f} x the JAX package's CCOLAMD "
        f"{ccol}, gate <= {FILL_GATE}; its proxy {proxy}); candidates "
        + ", ".join(f"{k} {v}" for k, v in F.items())
        + f"; JAX CCOLAMD plan {ref['ccolamd']['cliques']} cliques {ref['ccolamd']['levels']} "
          f"levels")
    if not ratio <= FILL_GATE:
        raise AssertionError(f"{label}: the {name} ordering fills {ratio:.3f} x CCOLAMD")
    return perm, dict(chosen=name, F_size=F, ratio_to_ccolamd=ratio, ccolamd_F_size=ccol,
                      proxy_F_size=proxy, best=best[0])


def plan_facts(elimination, maps):
    """Cliques, levels, buckets and the bucket routing of a batch plan."""
    st = maps.plan.stats()
    routes = {}
    for name, itemsize in (("float64", 8), ("float32", 4)):
        r = [ROUTE_KERNEL[x[3]] for x in routing(elimination, maps, itemsize)]
        routes[name] = {k: r.count(k) for k in dict.fromkeys(r)}
    return dict(cliques=st["n_cliques"], levels=st["n_levels"], buckets=len(maps.buckets),
                routes=routes)


def ordering_ref(here):
    with open(os.path.join(here, ORDERING_REF)) as f:
        return json.load(f)["graphs"]


# --- phase 6: iSAM2 ------------------------------------------------------------------


def isam2_shapes(here):
    """The iSAM2 path's d = 3 buckets from ISAM2_SHAPES: (level [(B, nf,
    ns, route f64, route f32)], wildfire [(B, nf, ns)]), the most frequent
    first."""
    with open(os.path.join(here, ISAM2_SHAPES)) as f:
        rec = json.load(f)
    return ([tuple(b[:5]) for b in rec["level"]], [tuple(b[:3]) for b in rec["wildfire"]])


def write_stream(here, lines, n):
    """The first n lines of the stream as a file in the build directory."""
    path = os.path.join(here, "gtsam_petercdev_torch", "_build", f"city_stream_{n}.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines[:n]) + "\n")
    return path


class WildfireRecorder:
    """Every wildfire round's per-clique changes, by update: `updates` is
    [[{clique id: change}, ...] per update] while the context is open."""

    def __enter__(self):
        from gtsam_petercdev_torch.inference import incremental

        E = self.E = incremental.IncrementalEngine
        self.saved = (E._wildfire, E._wild_round)
        self.updates = []
        wildfire, wild_round = self.saved

        def recorded_wildfire(eng, *a, **k):
            self.updates.append([])
            return wildfire(eng, *a, **k)

        def recorded_round(eng, cids):
            out = wild_round(eng, cids)
            self.updates[-1].append(dict(out))
            return out

        E._wildfire, E._wild_round = recorded_wildfire, recorded_round
        return self

    def __exit__(self, *exc):
        self.E._wildfire, self.E._wild_round = self.saved

    @staticmethod
    def divergences(a, b):
        """For each update whose descents differ: (update, round, [(clique,
        change in a, change in b)]) of its first round whose cliques, or
        whose cliques with a change > 0, differ (None: not in that round)."""
        out = []
        for u, (ra, rb) in enumerate(zip(a, b)):
            for k, (ca, cb) in enumerate(zip(ra, rb)):
                pa = {c for c, v in ca.items() if v > 0}
                pb = {c for c, v in cb.items() if v > 0}
                if ca.keys() != cb.keys() or pa != pb:
                    odd = sorted((ca.keys() ^ cb.keys()) | (pa ^ pb))
                    out.append((u, k, [(c, ca.get(c), cb.get(c)) for c in odd]))
                    break
            else:
                if len(ra) != len(rb):
                    out.append((u, min(len(ra), len(rb)), []))
        return out


class LevelWidths:
    """The engine's level steps (K4 or K1, by `level_route`) counted by
    separator class and kernel while the context is open."""

    def __enter__(self):
        from collections import Counter

        from gtsam_petercdev_torch.inference import incremental as inc

        self.inc, self.saved, self.count = inc, inc._level, Counter()
        level = self.saved

        def counted(pool, gp, boff, goff, B, nf, ns, d, *rest):
            route = inc.level_route(nf, ns, d, pool.element_size())
            self.count[ns, ROUTE_KERNEL[route]] += 1
            return level(pool, gp, boff, goff, B, nf, ns, d, *rest)

        inc._level = counted
        return self

    def __exit__(self, *exc):
        self.inc._level = self.saved

    def summary(self, wide=64):
        """Max separator class, and per kernel its launches and the share
        of them at ns >= wide."""
        out = dict(max_ns=max((ns for ns, _ in self.count), default=0), by_ns={})
        for (ns, k), c in sorted(self.count.items()):
            out["by_ns"].setdefault(k, {})[ns] = c
        for k, by in out["by_ns"].items():
            tot = sum(by.values())
            out[k] = dict(launches=tot, share_ns_ge_64=sum(c for ns, c in by.items()
                                                           if ns >= wide) / tot)
        return out


class LayerTimer:
    """Host wall time of an iSAM2 update by layer, each layer's call
    wrapped in torch.cuda.synchronize() on both sides so its device work is
    its own: linearize (new and relinearized factor rows), the
    relinearization scan, the host plan (cache misses), the pool scatters,
    the level steps (K4 / K1 and the extend-add), the payload writes, the
    wildfire rounds (gathers, K2, one read each), the whole update; the
    rest of the update is host bookkeeping. Inside the host plan, the time
    spent splitting the pool sums into rounds of unique destinations
    (`_plan_rounds`, host clock, no synchronize) is reported on its own, and
    the pool sums are counted: calls, rounds (an `index_add_` each) and
    gathers (an `index_select` each, for rounds that take a subset of their
    source). The layers are wrapped between start() and stop() only."""

    def __init__(self, torch):
        from gtsam_petercdev_torch.inference import incremental
        from gtsam_petercdev_torch.nonlinear import isam2

        self.torch = torch
        E, I = incremental.IncrementalEngine, isam2.ISAM2
        self.targets = [
            ("linearize", I, "_linearize_rows"), ("relinearization scan", E, "var_max_delta"),
            ("host plan", E, "_build_plan"), ("scatters", incremental, "_scatter_group"),
            ("scatters", incremental, "_scatter_msg_class"),
            ("scatters", incremental, "_scatter_eye"), ("level steps", incremental, "_level"),
            ("payload writes", incremental, "_scatter_pool"),
            ("wildfire rounds", E, "_wildfire"), ("update", I, "update")]
        self.ms = {}
        self.saved = []
        self.sums = dict(calls=0, rounds=0, gathers=0)
        self.incremental = incremental

    def _wrap(self, name, fn):
        sync = self.torch.cuda.synchronize

        def timed(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        return timed

    def start(self):
        for name, owner, attr in self.targets:
            fn = owner.__dict__[attr]
            self.saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(name, fn))
        inc = self.incremental
        plan_rounds, add_rounds = inc._plan_rounds, inc._add_rounds

        def planned(*a):
            t0 = time.perf_counter()
            out = plan_rounds(*a)
            self.ms["rounds planning"] = (self.ms.get("rounds planning", 0.0)
                                          + (time.perf_counter() - t0) * 1e3)
            return out

        def added(dst, plan, src):
            self.sums["calls"] += 1
            self.sums["rounds"] += len(plan.rounds)
            self.sums["gathers"] += sum(pos is not None for pos, _ in plan.rounds)
            return add_rounds(dst, plan, src)

        self.saved += [(inc, "_plan_rounds", plan_rounds), (inc, "_add_rounds", add_rounds)]
        inc._plan_rounds, inc._add_rounds = planned, added

    def stop(self):
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)
        self.saved = []

    def report(self, n_updates):
        out = {k: v / n_updates for k, v in self.ms.items()}
        out["other host"] = out["update"] - sum(
            v for k, v in out.items() if k not in ("update", "rounds planning"))
        out.update({f"pool sum {k} per update": v / n_updates for k, v in self.sums.items()})
        return out


def run_isam2(torch, here, v1):
    """Phase 6: the gates (card vs CPU, the reference contract), then the
    full City10000-parameter run on the card with its profile."""
    import numpy as np

    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.models.city10000 import run_city10000
    from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
    from gtsam_petercdev_torch.nonlinear.isam2 import ISAM2, ISAM2Params
    from gtsam_petercdev_torch.nonlinear.optimizers import OptimizerParams, gauss_newton
    from gtsam_petercdev_torch.nonlinear.values import Values
    from gtsam_petercdev_torch.slam.factors import between_factor, prior_factor
    from gtsam_petercdev_torch.utils import synthetic

    from gtsam_petercdev_torch.inference import symbolic

    lines, gt = synthetic.city_stream(CITY_POSES, seed=SEED)
    # the plan line: the City graph of the stream's first CITY_PLAN_LINES
    # lines (the reference's graph), ordered as the engine orders each local
    # problem (ccolamd_ordering: the port's AMD)
    e = np.array([[int(ln.split()[1]), int(ln.split()[3])] for ln in lines[:CITY_PLAN_LINES]])
    amd, city_order = ordering_line(symbolic, f"City ({CITY_PLAN_LINES} lines, batch)",
                                    int(e.max()) + 1, e, 3, ordering_ref(here)["city"],
                                    chosen="amd")
    cp = symbolic.symbolic_eliminate(int(e.max()) + 1, [e], 3, ordering=amd)
    city_order.update(cliques=len(cp.cliques), levels=len(cp.levels))
    log(f"City graph on AMD: {len(cp.cliques)} cliques, {len(cp.levels)} levels (batch plan)")
    # the Bayes tree's counters: the card's tree must be the CPU path's
    counters = ("n_relinearized", "n_new_factors", "n_affected_cliques", "n_orphans",
                "n_reeliminated", "n_cliques")

    # a) the card against the CPU path on the stream's first lines, each
    # wildfire round's changes recorded (update, round, {clique: change})
    path = write_stream(here, lines, CITY_GATE_LINES)
    t0 = time.perf_counter()
    runs, changes = {}, {}
    for dev in ("cuda", "cpu"):
        with WildfireRecorder() as rec:
            runs[dev] = run_city10000(path, device=dev)
        changes[dev] = rec.updates
    a, b = runs["cuda"].estimate, runs["cpu"].estimate
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    ups = list(zip(runs["cuda"].updates, runs["cpu"].updates))
    diff = [(i, k, getattr(u, k), getattr(v, k)) for i, (u, v) in enumerate(ups)
            for k in counters if getattr(u, k) != getattr(v, k)]
    # wildfire 0.0 descends while a clique's change is > 0, so a descent ends
    # where the propagated change rounds to nothing: a question of ulps that
    # the card's kernels (FMA, their own order of sums) and the CPU's plain
    # versions answer each their own way, however the pool sums are ordered.
    # Gated: the descents part only over such a change; each device answers
    # the same way every time (the second run below)
    rounds = [(i, u.wildfire_rounds, v.wildfire_rounds) for i, (u, v) in enumerate(ups)
              if u.wildfire_rounds != v.wildfire_rounds]
    div = WildfireRecorder.divergences(changes["cuda"], changes["cpu"])
    # where two descents part, they part over a change of rounding size: a
    # clique that one device moved by at most ROUNDING_CHANGE and the other
    # not at all, in a round both devices reached with the same cliques
    parted = [c for _, _, odd in div for c in odd]
    part_max = max((abs(x) for _, x, y in parted for x in (x, y) if x is not None), default=0.0)
    rounding_only = all(odd and all(x is not None and y is not None for _, x, y in odd)
                        for _, _, odd in div) and part_max <= ROUNDING_CHANGE
    bad = [sum(int(u.bad_pivots) for u in r.updates) for r in runs.values()]
    log(f"iSAM2 gate a) {CITY_GATE_LINES} lines, card vs CPU: estimates rel {rel:.3e}; per-update "
        f"tree counters {counters} identical in {len(ups) - len({d[0] for d in diff})} of "
        f"{len(ups)} updates (differences (update, counter, card, CPU): {diff[:8]}); wildfire "
        f"rounds differ in {len(rounds)} updates {rounds[:8]} (card "
        f"{sum(u.wildfire_rounds for u, _ in ups)}, CPU {sum(v.wildfire_rounds for _, v in ups)} "
        f"in all); the descents part in {len(div)} updates, at (update counted from 0 = the "
        f"prior's, round, [(clique, card change, CPU change)]) {div[:4]}; largest change where "
        f"they part {part_max:.3e} (gate <= {ROUNDING_CHANGE:g}); "
        f"bad pivots (card, CPU) {bad}; "
        f"{runs['cuda'].n_poses} poses {runs['cuda'].n_loop_closures} loops "
        f"({time.perf_counter() - t0:.1f} s)")
    if not (rel <= 1e-9 and not diff and bad == [0, 0] and rounding_only):
        raise AssertionError("iSAM2: the card and the CPU path disagree")
    # the same lines on the card again: bit for bit the same run
    with WildfireRecorder() as rec:
        again = run_city10000(path, device="cuda")
    same = bool(np.array_equal(again.estimate, runs["cuda"].estimate)) and [
        u.wildfire_rounds for u in again.updates] == [u.wildfire_rounds for u, _ in ups] \
        and rec.updates == changes["cuda"]
    log(f"iSAM2 gate a) a second card run of the {CITY_GATE_LINES} lines: estimates bitwise "
        f"equal, the same wildfire rounds and the same change of every clique in every round: "
        f"{same}")
    if not same:
        raise AssertionError("iSAM2: two card runs of the same lines differ")
    card_gate = runs["cuda"]
    a_out = dict(estimate_rel=rel, rounds_card=sum(u.wildfire_rounds for u, _ in ups),
                 rounds_cpu=sum(v.wildfire_rounds for _, v in ups), rounds_differ=rounds,
                 divergences=div, largest_change_where_they_part=part_max,
                 card_repeats_bitwise=same)
    del runs, again, changes

    # b) the reference contract (tests/test_isam2.py:102-146) on the card:
    # no relinearization, wildfire 0; after every 6th update the delta is
    # the dense solve of the same linearized system
    rng = np.random.default_rng(SEED)
    gtc = [np.zeros(3)]
    for _ in range(1, CONTRACT_POSES):
        gtc.append(synthetic.pose2_compose_np(gtc[-1], np.array([1.0, 0.0, rng.normal() * 0.3])))
    info = torch.eye(3, dtype=torch.float64, device="cuda")
    isam = ISAM2(ISAM2Params(enable_relinearization=False, wildfire_threshold=0.0, device="cuda"))
    full_g, full_v = NonlinearFactorGraph(device="cuda"), Values(device="cuda")
    worst = 0.0
    for i in range(CONTRACT_POSES):
        nf, nv = NonlinearFactorGraph(device="cuda"), Values(device="cuda")
        if i == 0:
            guess = gtc[0]
            facs = [(prior_factor("Pose2"), [0], gtc[0], info / 0.05)]
        else:
            guess = synthetic.pose2_compose_np(gtc[i], rng.normal(size=3) * 0.1)
            facs = [(between_factor("Pose2"), [i - 1, i],
                     synthetic.pose2_between_np(gtc[i - 1], gtc[i]), info / 0.1)]
            if i % 5 == 0 and i >= 10:
                facs.append((between_factor("Pose2"), [i - 10, i],
                             synthetic.pose2_between_np(gtc[i - 10], gtc[i]), info / 0.1))
        for vals in (nv, full_v):
            vals.insert(i, "Pose2", guess)
        for graph in (nf, full_g):
            for f in facs:
                graph.add(*f)
        isam.update(nf, nv)
        if i % 6 == 0 or i == CONTRACT_POSES - 1:
            H, g = linsolve.assemble_dense(full_g.linearize(full_v))
            xb = linsolve.dense_solve(H, g, 0.0).reshape(-1, 3)
            worst = max(worst, (isam.delta()["Pose2"] - xb).abs().max().item())
    log(f"iSAM2 gate b) reference contract, {CONTRACT_POSES} poses on the card: delta vs dense "
        f"oracle max abs {worst:.3e} (atol 1e-9)")
    if not worst <= 1e-9:
        raise AssertionError(f"iSAM2: delta differs from the dense oracle by {worst:.3e}")
    del isam, full_g, full_v

    # c) the full run at City10000's parameters; counters reset just before.
    # Two windows of PROFILE_UPDATES updates near the end: one timed by
    # layer (synchronized timers), then one under torch.profiler recording
    # the device alone (the window reads kernels only; with the host ops its
    # ~82,000 launches took most of a minute to post-process: cut to make
    # room for phase 14)
    path = write_stream(here, lines, CITY_LINES)
    first = CITY_LINES - 10 - PROFILE_UPDATES
    split = first - 10 - PROFILE_UPDATES
    from torch.profiler import ProfilerActivity, profile

    window = {}
    timer = LayerTimer(torch)

    def step_cb(k, isam):
        window["isam"] = isam
        if k == split:
            timer.start()
        elif k == split + PROFILE_UPDATES:
            timer.stop()
        elif k == first:
            torch.cuda.synchronize()
            window["prof"] = profile(activities=[ProfilerActivity.CUDA])
            window["prof"].start()
            window["t0"] = time.perf_counter()
        elif k == first + PROFILE_UPDATES:
            torch.cuda.synchronize()
            window["ms"] = (time.perf_counter() - window["t0"]) * 1e3
            window["prof"].stop()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    v1.reset_launch_counts()
    ckpt = checkpoint_path(here)
    t0 = time.perf_counter()
    with LevelWidths() as lw:
        res = run_city10000(path, device="cuda", progress_every=CITY_PROGRESS, step_cb=step_cb,
                            checkpoint_path=ckpt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    widths = lw.summary()
    launches, cuda_launches = v1.launch_counts(), v1.cuda_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    isam = window["isam"]
    n_up = len(res.updates)
    # per-update times outside the two windows (their timers and profiler
    # slow the updates they cover)
    st = np.asarray([t for k, t in enumerate(res.step_times)
                     if not (split <= k < split + PROFILE_UPDATES
                             or first <= k < first + PROFILE_UPDATES)]) * 1e3
    layers = timer.report(PROFILE_UPDATES)
    bad = int(sum(u.bad_pivots for u in res.updates if torch.is_tensor(u.bad_pivots)))
    reelim = [u.n_reeliminated for u in res.updates]
    reads = isam.engine.n_reads / (n_up + 1)  # the prior's update too
    from torch.autograd import DeviceType

    kern = [e for e in window["prof"].key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    n_kern = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    ate = res.ate_rmse(gt)
    err = isam.error()
    graph, est = isam._as_graph(), isam.calculate_estimate()
    gn = gauss_newton(graph, est, OptimizerParams(solver="multifrontal", max_iterations=5),
                      device="cuda")
    out = dict(
        lines=n_up, poses=res.n_poses, loops=res.n_loop_closures, wall_s=wall,
        step_ms=dict(mean=float(st.mean()), p50=float(np.percentile(st, 50)),
                     p90=float(np.percentile(st, 90)), p99=float(np.percentile(st, 99)),
                     max=float(st.max())),
        launches=launches, cuda_launches=cuda_launches,
        launches_per_update={k: v / n_up for k, v in launches.items()},
        layers_ms_per_update=layers,
        window_updates=PROFILE_UPDATES, window_ms=window["ms"], window_busy_ms=busy,
        window_busy_share=busy / window["ms"],
        window_cuda_launches_per_update=n_kern / PROFILE_UPDATES,
        reads_per_update=reads, reelim_mean=float(np.mean(reelim)), reelim_max=int(max(reelim)),
        peak_mib=peak, ate_rmse=ate, error=err, batch_gn_error=gn.error,
        batch_gn_history=gn.error_history, bad_pivots=bad, gate_a=a_out, ordering=city_order,
        level_widths=widths)
    log(f"iSAM2 run c) {n_up} lines ({res.n_poses} poses, {res.n_loop_closures} loop closures) in "
        f"{wall:.1f} s: per-update ms mean {st.mean():.3f} p50 {out['step_ms']['p50']:.3f} p90 "
        f"{out['step_ms']['p90']:.3f} p99 {out['step_ms']['p99']:.3f} max {st.max():.3f}")
    per = ", ".join(f"{k} {v / n_up:.3f}" for k, v in launches.items())
    log(f"iSAM2 run c) wrapper launches {launches} ({per} per update); CUDA launches "
        f"{cuda_launches}")
    log(f"iSAM2 run c) separator widths: max ns class {widths['max_ns']}; level-step launches "
        + "; ".join(f"{k} {widths[k]['launches']} ({100.0 * widths[k]['share_ns_ge_64']:.1f}% at "
                    f"ns >= 64), by ns {widths['by_ns'][k]}" for k in widths["by_ns"]))
    log(f"iSAM2 run c) by layer, {PROFILE_UPDATES} updates from update {split} (synchronized "
        f"timers; ms per update, share of the update): "
        + "; ".join(f"{k} {v:.3f} ({100.0 * v / layers['update']:.1f}%)"
                    for k, v in layers.items() if not k.startswith("pool sum"))
        + "; rounds planning is inside the host plan; pool sums per update: "
        + ", ".join(f"{k[9:-11]} {v:.1f}" for k, v in layers.items() if k.startswith("pool sum")))
    log(f"iSAM2 run c) profiled window of {PROFILE_UPDATES} updates (from update {first}): "
        f"{window['ms']:.1f} ms wall (profiler on), device busy {busy:.3f} ms = "
        f"{100.0 * busy / window['ms']:.2f}%, {n_kern} kernel launches = "
        f"{n_kern / PROFILE_UPDATES:.1f} per update; top kernels by device time:")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:100]}")
    log(f"iSAM2 run c) device->host reads per update {reads:.2f}; n_reeliminated mean "
        f"{out['reelim_mean']:.2f} max {out['reelim_max']}; peak device memory {peak:.1f} MiB; "
        f"bad pivots {bad}; ATE-RMSE {ate:.4f} (stream ground truth)")
    log(f"iSAM2 run c) final error {err:.6e}; batch GN (multifrontal, card) of the final graph from "
        f"the iSAM2 estimate: {['%.6e' % e for e in gn.error_history]}")
    finite = all(x == x and abs(x) != float("inf") for x in [err, ate] + list(gn.error_history))
    if not (finite and bad == 0 and launches["backsolve_bucket"] > 0
            and launches["partial_cholesky_blocks"] > 0):
        raise AssertionError(f"iSAM2 run c) failed its gates: finite {finite}, bad pivots {bad}, "
                             f"launches {launches}")
    if not (np.isfinite(res.estimate).all() and res.estimate.shape == (res.n_poses, 3)):
        raise AssertionError("iSAM2 run c) estimate is not finite poses")
    return out, dict(isam=isam, estimate=res.estimate, checkpoint=ckpt, path=path,
                     card_gate=card_gate)


# --- phase 9: the iSAM2 family ---------------------------------------------------------


def checkpoint_path(here):
    path = os.path.join(here, "gtsam_petercdev_torch", "_build", "city_isam2.ckpt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def remove_checkpoints(here):
    """Delete the ISAM2 checkpoints the run wrote into the build directory
    (phase 6 c)'s holds ~225 MB), whether the run passed or not."""
    build = os.path.join(here, "gtsam_petercdev_torch", "_build")
    if os.path.isdir(build):
        for name in os.listdir(build):
            if name.endswith(".ckpt"):
                os.remove(os.path.join(build, name))


class ShapeRecorder:
    """Every (B, nf, ns, d, dtype) the engine's level steps (K4 or K1, by
    `level_route`) and wildfire rounds (K2) launch while the context is
    open, by kernel."""

    def __enter__(self):
        from gtsam_petercdev_torch.inference import incremental as inc

        self.inc, self.saved = inc, (inc._level, inc._wild)
        self.shapes = {"partial_cholesky_blocks": set(), "partial_cholesky": set(),
                       "backsolve_bucket": set()}
        level, wild = self.saved

        def recorded_level(pool, gp, boff, goff, B, nf, ns, d, *rest):
            route = inc.level_route(nf, ns, d, pool.element_size())
            k = "partial_cholesky_blocks" if route == "blocks" else "partial_cholesky"
            self.shapes[k].add((B, nf, ns, d, str(pool.dtype).split(".")[1]))
            return level(pool, gp, boff, goff, B, nf, ns, d, *rest)

        def recorded_wild(pc, rows, sep_idx, fro_idx, x, nf, ns, d):
            self.shapes["backsolve_bucket"].add((rows.shape[0], nf, ns, d,
                                                 str(x.dtype).split(".")[1]))
            return wild(pc, rows, sep_idx, fro_idx, x, nf, ns, d)

        inc._level, inc._wild = recorded_level, recorded_wild
        return self

    def __exit__(self, *exc):
        self.inc._level, self.inc._wild = self.saved


class SyncedTimer:
    """Host wall time of named methods, sync() (the card's synchronize) on
    both sides of each call, summed into the slot that `next()` opened."""

    def __init__(self, sync, targets):
        self.sync, self.targets, self.saved, self.slots = sync, targets, [], []

    def next(self):
        self.slots.append({})

    def __enter__(self):
        sync = self.sync
        for name, owner, attr in self.targets:
            fn = owner.__dict__[attr]
            self.saved.append((owner, attr, fn))

            def timed(*a, _fn=fn, _name=name, **k):
                sync()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                sync()
                slot = self.slots[-1] if self.slots else {}
                slot[_name] = slot.get(_name, 0.0) + (time.perf_counter() - t0) * 1e3
                return out

            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)


def stats_ms(xs):
    import numpy as np

    a = np.asarray(xs, dtype=float)
    return dict(mean=float(a.mean()), p50=float(np.percentile(a, 50)),
                p99=float(np.percentile(a, 99)), max=float(a.max()))


def tangent_gaps(torch, a, b):
    """||local(a_i, b_i)|| per row of two [n, 3] Pose2 arrays."""
    from gtsam_petercdev_torch.geometry import pose2

    d = pose2.local(torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64))
    return d.norm(dim=1).numpy()


def add_city_factor(graph, keyS, keyT, meas):
    """One city stream line's between factor at the harness's noise models
    (odometry sigmas (1/30, 1/30, 1/100), loop closures 10)."""
    import numpy as np

    from gtsam_petercdev_torch.linear import noise
    from gtsam_petercdev_torch.slam.factors import between_factor

    sig = [1 / 30.0, 1 / 30.0, 1 / 100.0] if keyS == keyT - 1 else [10.0] * 3
    graph.add(between_factor("Pose2"), [keyS, keyT], np.asarray(meas[0]),
              noise.diagonal_sigmas(np.asarray(sig)))


def city_graph(torch, path, applied, dev):
    """The prior and the lines `applied` (indices) of a city stream file as
    a graph."""
    import numpy as np

    from gtsam_petercdev_torch.linear import noise
    from gtsam_petercdev_torch.models.city10000 import parse_city10000
    from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
    from gtsam_petercdev_torch.slam.factors import prior_factor

    g = NonlinearFactorGraph(device=dev)
    g.add(prior_factor("Pose2"), [0], np.zeros(3), noise.diagonal_sigmas(np.full(3, 1e-4)))
    parsed = parse_city10000(path, None)
    for i in applied:
        add_city_factor(g, *parsed[i])
    return g


def pose_values(torch, keys, poses, dev):
    from gtsam_petercdev_torch.nonlinear.values import Values

    v = Values(device=dev)
    v.insert_batch(list(keys), "Pose2", torch.as_tensor(poses, dtype=torch.float64))
    return v


def pose_array(values, keys):
    import numpy as np

    rows = np.asarray([values.row_of(k) for k in keys], dtype=np.int64)
    return values.params("Pose2").cpu().numpy()[rows]


def run_concurrent(torch, path, incremental, dev):
    """The concurrent pair over a city stream file: new poses from the
    filter's estimate composed with the odometry, timestamps = pose index,
    a loop closure to a pose more than CONCURRENT_LAG behind the newest
    dropped (it would not be in the filter), a synchronize every
    CONCURRENT_SYNC updates. Returns (filter, smoother, ms per filter
    update, ms per synchronize, loop closures dropped)."""
    import numpy as np

    from gtsam_petercdev_torch.geometry import pose2
    from gtsam_petercdev_torch.models.city10000 import parse_city10000
    from gtsam_petercdev_torch.nonlinear import concurrent as cc
    from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
    from gtsam_petercdev_torch.nonlinear.isam2 import ISAM2Params
    from gtsam_petercdev_torch.nonlinear.values import Values

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    if incremental:
        ip = lambda: ISAM2Params(relinearize_threshold=1e-4, relinearize_skip=1)
        filt = cc.ConcurrentIncrementalFilter(CONCURRENT_LAG, ip(), device=dev)
        smoother = cc.ConcurrentIncrementalSmoother(ip(), device=dev)
        synchronize = cc.synchronize_incremental
        at = lambda k: filt.isam.calculate_estimate_key(k)
    else:
        filt = cc.ConcurrentBatchFilter(CONCURRENT_LAG, device=dev)
        smoother = cc.ConcurrentBatchSmoother(device=dev)
        synchronize = cc.synchronize
        at = lambda k: filt.values.at(k)
    filt.update(city_graph(torch, path, [], dev), pose_values(torch, [0], np.zeros((1, 3)), dev),
                {0: 0.0})
    upd_ms, sync_ms, dropped, newest, n = [], [], 0, 0, 0
    for keyS, keyT, meas in parse_city10000(path, None):
        g, v = NonlinearFactorGraph(device=dev), Values(device=dev)
        odom = torch.as_tensor(meas[0], dtype=torch.float64, device=dev)
        stamps = None
        if keyS == keyT - 1:
            v.insert(keyT, "Pose2", pose2.compose(at(keyS), odom))
            stamps, newest = {keyT: float(keyT)}, keyT
        elif min(keyS, keyT) < newest - CONCURRENT_LAG:
            dropped += 1
            continue
        add_city_factor(g, keyS, keyT, meas)
        sync()
        t0 = time.perf_counter()
        filt.update(g, v, stamps)
        sync()
        upd_ms.append((time.perf_counter() - t0) * 1e3)
        n += 1
        if n % CONCURRENT_SYNC == 0:
            t0 = time.perf_counter()
            synchronize(filt, smoother)
            sync()
            sync_ms.append((time.perf_counter() - t0) * 1e3)
    return filt, smoother, upd_ms, sync_ms, dropped


def run_isam2_family(torch, here, v1, city=None, dev="cuda"):
    """Phase 9: the iSAM2 family (leaf marginalization, Bayes-tree
    marginals, fixed-lag and concurrent smoothing, NonlinearISAM, engine
    checkpoints, a float32 run). `city`: phase 6 c)'s final tree, its
    estimate and its checkpoint at line CITY_PROGRESS; without it (the
    --isam2-family-only run) that run is made here, unprofiled. `dev`: the
    device of every path but a)'s CPU reference (a rehearsal passes "cpu")."""
    import numpy as np

    from gtsam_petercdev_torch.inference.treemarg import TreeMarginals
    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.models.city10000 import (
        parse_city10000, run_city10000, run_city10000_fixed_lag)
    from gtsam_petercdev_torch.nonlinear import isam2 as isam2_mod
    from gtsam_petercdev_torch.nonlinear.marginals import Marginals
    from gtsam_petercdev_torch.nonlinear.nonlinear_isam import NonlinearISAM
    from gtsam_petercdev_torch.nonlinear.optimizers import OptimizerParams, gauss_newton
    from gtsam_petercdev_torch.utils import serialization, synthetic

    lines, gt = synthetic.city_stream(CITY_POSES, seed=SEED)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    out = {}
    counts = lambda: dict(v1.launch_counts())
    diff = lambda a, b: {k: b[k] - a[k] for k in a}
    if city is None:
        path = write_stream(here, lines, CITY_LINES)
        hold = {}
        ckpt = checkpoint_path(here)
        res = run_city10000(path, device=dev, progress_every=CITY_PROGRESS, checkpoint_path=ckpt,
                            step_cb=lambda k, isam: hold.__setitem__("isam", isam))
        city = dict(isam=hold["isam"], estimate=res.estimate, checkpoint=ckpt, path=path)
    v1.reset_launch_counts()
    with ShapeRecorder() as rec:
        # a) the card against the CPU path: tree marginals, fixed-lag
        # smoothing, a checkpoint resumed bitwise on each device
        t0 = time.perf_counter()
        path = write_stream(here, lines, FAMILY_GATE_LINES)
        ck = os.path.join(os.path.dirname(path), "family_gate.ckpt")
        got = {}
        for d in (dev, "cpu"):
            hold = {}
            full = run_city10000(path, device=d, progress_every=FAMILY_GATE_CKPT, checkpoint_path=ck,
                                 step_cb=lambda k, isam: hold.__setitem__("isam", isam))
            resumed = run_city10000(path, device=d, resume_from=ck)
            isam = hold["isam"]
            tm = TreeMarginals(isam.engine)
            covs = torch.stack([tm.covariance_gid(isam._key_gid[k])[:3, :3]
                                for k in range(full.n_poses)]).cpu().numpy()
            fl = run_city10000_fixed_lag(path, FAMILY_GATE_LAG, device=d)
            got[d] = dict(covs=covs, fl=fl, resume_bitwise=bool(np.array_equal(
                resumed.estimate, full.estimate)))
        a, b = got[dev], got["cpu"]
        cov_rel = float(np.abs(a["covs"] - b["covs"]).max() / np.abs(b["covs"]).max())
        fa, fb = a["fl"], b["fl"]
        same_lists = fa.marginalized == fb.marginalized and fa.deferred == fb.deferred
        fl_rel = (float(np.abs(fa.estimate - fb.estimate).max() / np.abs(fb.estimate).max())
                  if fa.keys == fb.keys else float("inf"))
        out["a"] = dict(cov_rel=cov_rel, fixed_lag_lists_equal=same_lists, fixed_lag_rel=fl_rel,
                        resume_bitwise={d: got[d]["resume_bitwise"] for d in got},
                        marginalized=sum(map(len, fb.marginalized)),
                        deferred_events=sum(map(len, fb.deferred)), dropped=fb.n_dropped)
        log(f"family a) {FAMILY_GATE_LINES} lines, card vs CPU: every pose's tree covariance rel "
            f"{cov_rel:.3e}; fixed lag {FAMILY_GATE_LAG}: marginalized and deferred lists "
            f"identical in every update {same_lists} ({out['a']['marginalized']} keys marginalized, "
            f"{out['a']['deferred_events']} deferrals, {fb.n_dropped} loop closures dropped), window "
            f"estimates rel {fl_rel:.3e}; checkpoint at line {FAMILY_GATE_CKPT} resumed to "
            f"{FAMILY_GATE_LINES} bitwise equal (card, CPU): "
            f"{[got[d]['resume_bitwise'] for d in got]} ({time.perf_counter() - t0:.1f} s)")
        if not (cov_rel <= 1e-9 and same_lists and fl_rel <= 1e-9
                and all(g["resume_bitwise"] for g in got.values())):
            raise AssertionError("family a): the card and the CPU path disagree")
        del got

        # b) marginals at full width: every pose of run c)'s final tree, the
        # top-down sweep against dense Marginals of its graph at theta
        isam = city["isam"]
        keys = sorted(k for k in isam._key_gid)
        sweep = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            tm = TreeMarginals(isam.engine)
            sync()
            sweep.append((time.perf_counter() - t0) * 1e3)
        sweep_launches = sweep_dev_ms = None
        if dev == "cuda":
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                TreeMarginals(isam.engine)
                sync()
            kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            sweep_launches = sum(e.count for e in kern)
            sweep_dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
        tree = torch.stack([tm.covariance_gid(isam._key_gid[k])[:3, :3] for k in keys])
        sync()
        t0 = time.perf_counter()
        graph, theta = isam._as_graph(), isam.theta
        dense = Marginals(graph, theta, device=dev)
        dcov = torch.stack(dense.batch_marginal_covariances(keys))
        sync()
        dense_ms = (time.perf_counter() - t0) * 1e3
        # Marginals(method="dense") factors H + 1e-10 I (the JAX package's
        # jitter), which moves Sigma by -1e-10 Sigma^2 to first order: at
        # these conditionings (prior information 1e8, covariances to ~1e2)
        # more than 1e-8 of the largest entry. So the gate's oracle is H's
        # exact inverse (one Cholesky, no jitter), and the class is held to
        # the tree once its jitter's first-order term is added back
        H, _ = linsolve.assemble_dense(graph.linearize(theta))
        S = torch.cholesky_inverse(torch.linalg.cholesky(H))
        idx = torch.as_tensor(np.stack([np.arange(dense._slice(k)[0], dense._slice(k)[0] + 3)
                                        for k in keys]), device=S.device)
        rows = lambda M: M[idx[:, :, None], idx[:, None, :]]
        exact, bias = rows(S), 1e-10 * rows(S @ S)
        scale = exact.abs().max().item()
        err = (tree - exact).abs().max().item()
        err_class = (tree - (dcov + bias)).abs().max().item()
        raw = (tree - dcov).abs().max().item()
        adj = sum(tm.joint_gids([isam._key_gid[k], isam._key_gid[k + 1]]) is not None
                  for k in keys[:-1])
        out["b"] = dict(poses=len(keys), cliques=isam.engine.n_live, sweep_ms=min(sweep),
                        sweep_ms_first=sweep[0], sweep_steps=tm.n_steps,
                        sweep_cuda_launches=sweep_launches, sweep_device_ms=sweep_dev_ms,
                        dense_ms=dense_ms, max_abs_err=err, max_abs_err_marginals_class=err_class,
                        max_abs_diff_marginals_class_raw=raw, largest_cov=scale,
                        adjacent_joints_in_one_clique=adj)
        log(f"family b) marginals of {len(keys)} poses on run c)'s tree ({isam.engine.n_live} "
            f"cliques): tree sweep {min(sweep):.3f} ms (first {sweep[0]:.3f}), {tm.n_steps} "
            f"batched steps, {sweep_launches} CUDA launches, device ms {sweep_dev_ms}, no "
            f"bucket kernel; dense Marginals {dense_ms:.3f} ms; the largest covariance entry "
            f"{scale:.3e}; max abs difference tree vs H's exact inverse {err:.3e}, vs dense "
            f"Marginals with its jitter's first-order term added back {err_class:.3e} (gates <= "
            f"1e-8 x the largest entry), vs dense Marginals as it is {raw:.3e}; adjacent pose "
            f"pairs sharing a clique scope {adj} of {len(keys) - 1}")
        if not (err <= 1e-8 * scale and err_class <= 1e-8 * scale):
            raise AssertionError("family b): tree and dense marginals disagree")
        del tm, dense, tree, dcov, H, S, exact, bias

        # c) fixed-lag smoothing on the card, lag FIXED_LAG poses
        path = write_stream(here, lines, FIXED_LAG_LINES)
        timer = SyncedTimer(sync, [("update", isam2_mod.ISAM2, "update"),
                                    ("marginalize", isam2_mod.ISAM2, "marginalize_leaves")])
        c0 = counts()
        t0 = time.perf_counter()
        with timer:
            fl = run_city10000_fixed_lag(path, FIXED_LAG, device=dev,
                                         step_cb=lambda k, sm: timer.next())
        wall = time.perf_counter() - t0
        c1 = counts()
        n_up = len(fl.step_times)
        launches = diff(c0, c1)
        kept = parse_city10000(path, None)
        g = city_graph(torch, path, fl.applied, dev)
        v = pose_values(torch, range(fl.n_poses), gt[: fl.n_poses], dev)
        gn = gauss_newton(g, v, OptimizerParams(solver="multifrontal", max_iterations=10),
                          device=dev)
        gaps = tangent_gaps(torch, fl.estimate, pose_array(gn.values, fl.keys))
        max_def = max(map(len, fl.deferred))
        out["c"] = dict(
            lines=len(kept), updates=n_up, poses=fl.n_poses, loops=fl.n_loop_closures,
            dropped=fl.n_dropped, wall_s=wall,
            ms=stats_ms([1e3 * t for t in fl.step_times]),
            update_ms=stats_ms([s.get("update", 0.0) for s in timer.slots]),
            marginalize_ms=stats_ms([s.get("marginalize", 0.0) for s in timer.slots]),
            live_cliques_max=max(fl.live_cliques), window_keys=len(fl.keys),
            deferred_max=max_def, deferrals=sum(map(len, fl.deferred)),
            marginalized=sum(map(len, fl.marginalized)),
            launches=launches, launches_per_update={k: x / n_up for k, x in launches.items()},
            batch_gn_gap_max=float(gaps.max()), batch_gn_gap_mean=float(gaps.mean()),
            batch_gn_history=gn.error_history)
        c = out["c"]
        log(f"family c) fixed lag {FIXED_LAG} poses over {len(kept)} lines ({fl.n_poses} poses, "
            f"{fl.n_loop_closures} loop closures fed, {fl.n_dropped} dropped: older pose already "
            f"marginalized) in {wall:.1f} s: per update ms mean {c['ms']['mean']:.3f} p50 "
            f"{c['ms']['p50']:.3f} p99 {c['ms']['p99']:.3f} max {c['ms']['max']:.3f}; of it "
            f"ISAM2.update {c['update_ms']['mean']:.3f} (p99 {c['update_ms']['p99']:.3f}) and "
            f"marginalize_leaves {c['marginalize_ms']['mean']:.3f} (p99 "
            f"{c['marginalize_ms']['p99']:.3f}) (synchronized timers); live cliques max "
            f"{c['live_cliques_max']}; deferred keys max {max_def}, {c['deferrals']} deferrals; "
            f"{c['marginalized']} keys marginalized; launches per update "
            f"{ {k: round(x, 3) for k, x in c['launches_per_update'].items()} }")
        log(f"family c) window of {len(fl.keys)} poses against a batch GN of the whole kept "
            f"history (multifrontal, card, from the stream's truth: "
            f"{['%.6e' % e for e in gn.error_history]}): tangent distance max {gaps.max():.3e} "
            f"mean {gaps.mean():.3e} (the JAX test's bound on its chain: 1e-3)")
        finite = bool(np.isfinite(fl.estimate).all())
        if not (finite and max(fl.live_cliques) <= FIXED_LAG + 1 + max_def
                and launches["backsolve_bucket"] > 0):
            raise AssertionError(f"family c): live cliques {max(fl.live_cliques)}, finite {finite}, "
                                 f"launches {launches}")
        del fl, g, v, gn

        # d) phase 6 c)'s checkpoint at line CITY_PROGRESS, onto the card, fed to
        # the end: bitwise the uninterrupted run
        ck = city["checkpoint"]
        sync()
        t0 = time.perf_counter()
        loaded = serialization.load_isam2(ck, device=dev)
        sync()
        load_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        serialization.save_isam2(ck, loaded)  # the loaded state, saved anew and resumed below
        save_ms = (time.perf_counter() - t0) * 1e3
        done = loaded._update_count - 1
        del loaded
        resumed = run_city10000(city["path"], device=dev, resume_from=ck)
        same = bool(np.array_equal(resumed.estimate, city["estimate"]))
        out["d"] = dict(checkpoint_line=done, bytes=os.path.getsize(ck), save_ms=save_ms,
                        load_ms=load_ms, resumed_updates=len(resumed.updates), bitwise=same)
        log(f"family d) checkpoint at line {done} ({os.path.getsize(ck)} bytes; save {save_ms:.1f} "
            f"ms, load onto the card {load_ms:.1f} ms) resumed for {len(resumed.updates)} lines: "
            f"final estimate bitwise equal to run c)'s {same}")
        if not same:
            raise AssertionError("family d): the resumed run differs from the uninterrupted one")

        # e) the concurrent pairs on the card, incremental against batch
        path = write_stream(here, lines, CONCURRENT_LINES)
        e0 = counts()
        fi, si, upd_i, sync_i, dropped = run_concurrent(torch, path, True, dev)
        e1 = counts()
        fb, sb, upd_b, sync_b, _ = run_concurrent(torch, path, False, dev)
        sep = set(si.separator)
        win = [k for k in fi.values.keys() if k in fb.values and k not in sep]
        hist = [k for k in si.values.keys() if k in sb.values]
        gap_f = tangent_gaps(torch, pose_array(fi.values, win), pose_array(fb.values, win))
        gap_s = tangent_gaps(torch, pose_array(si.values, hist), pose_array(sb.values, hist))
        worst = float(max(gap_f.max(), gap_s.max()))
        out["e"] = dict(filter_update_ms=stats_ms(upd_i), synchronize_ms=stats_ms(sync_i),
                        batch_filter_update_ms=stats_ms(upd_b), batch_synchronize_ms=stats_ms(sync_b),
                        dropped=dropped, window=len(win), history=len(hist), max_gap=worst,
                        launches=diff(e0, e1))
        log(f"family e) concurrent pairs over {CONCURRENT_LINES} lines, lag {CONCURRENT_LAG}, a "
            f"synchronize every {CONCURRENT_SYNC} updates ({dropped} loop closures dropped): "
            f"incremental filter update ms mean {np.mean(upd_i):.3f} p99 "
            f"{np.percentile(upd_i, 99):.3f}, synchronize mean {np.mean(sync_i):.3f}; batch filter "
            f"update mean {np.mean(upd_b):.3f}, synchronize mean {np.mean(sync_b):.3f}; incremental "
            f"against batch: {len(win)} window and {len(hist)} history poses, largest tangent gap "
            f"{worst:.3e} (gate 5e-3); launches {diff(e0, e1)}")
        if not worst <= 5e-3:
            raise AssertionError("family e): the incremental pair differs from the batch pair")
        del fi, si, fb, sb

        # f) NonlinearISAM against a batch GN of its graph
        from gtsam_petercdev_torch.geometry import pose2
        from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph

        nis = NonlinearISAM(NISAM_REORDER, device=dev)
        nis.update(city_graph(torch, path, [], dev), pose_values(torch, [0], np.zeros((1, 3)), dev))
        t0 = time.perf_counter()
        for keyS, keyT, meas in parse_city10000(path, NISAM_LINES):
            g = NonlinearFactorGraph(device=dev)
            add_city_factor(g, keyS, keyT, meas)
            new = ([], np.zeros((0, 3)))
            if keyS == keyT - 1:
                x = pose2.compose(nis.estimate().at(keyS),
                                  torch.as_tensor(meas[0], dtype=torch.float64, device=dev))
                new = ([keyT], x[None].cpu().numpy())
            nis.update(g, pose_values(torch, *new, dev))
        sync()
        nis_s = time.perf_counter() - t0
        est = nis.estimate()
        nkeys = sorted(est.keys())
        gn = gauss_newton(nis.factors, est, OptimizerParams(max_iterations=20), device=dev)
        gaps = tangent_gaps(torch, pose_array(est, nkeys), pose_array(gn.values, nkeys))
        out["f"] = dict(lines=NISAM_LINES, poses=len(nkeys), seconds=nis_s, max_gap=float(gaps.max()),
                        batch_gn_history=gn.error_history)
        log(f"family f) NonlinearISAM, reorder interval {NISAM_REORDER}, over {NISAM_LINES} lines "
            f"({len(nkeys)} poses) in {nis_s:.1f} s: against a batch GN of its graph "
            f"({['%.6e' % e for e in gn.error_history]}) tangent distance max {gaps.max():.3e} "
            f"(gate 1e-6)")
        if not gaps.max() <= 1e-6:
            raise AssertionError("family f): NonlinearISAM ends away from the batch optimum")

        # g) float32 iSAM2 against the float64 run over the same lines
        path = write_stream(here, lines, F32_LINES)
        g0 = counts()
        r32 = run_city10000(path, device=dev, dtype=torch.float32)
        sync()
        g1 = counts()
        r64 = run_city10000(path, device=dev)
        ate32, ate64 = r32.ate_rmse(gt), r64.ate_rmse(gt)
        bad32 = int(sum(int(u.bad_pivots) for u in r32.updates))
        launches = diff(g0, g1)
        out["g"] = dict(lines=F32_LINES, ate_f32=ate32, ate_f64=ate64, bad_pivots=bad32,
                        ms=stats_ms([1e3 * t for t in r32.step_times]),
                        ms_f64=stats_ms([1e3 * t for t in r64.step_times]),
                        launches_per_update={k: x / len(r32.updates) for k, x in launches.items()},
                        max_pose_gap_to_f64=float(np.abs(r32.estimate - r64.estimate).max()))
        log(f"family g) float32 iSAM2 over {F32_LINES} lines: ATE {ate32:.6f} against float64 "
            f"{ate64:.6f} (gate within 10%); bad pivots {bad32}; per update ms mean "
            f"{out['g']['ms']['mean']:.3f} p99 {out['g']['ms']['p99']:.3f} (float64 "
            f"{out['g']['ms_f64']['mean']:.3f}); launches per update "
            f"{ {k: round(x, 3) for k, x in out['g']['launches_per_update'].items()} }; largest "
            f"pose difference to float64 {out['g']['max_pose_gap_to_f64']:.3e}")
        if not (np.isfinite(r32.estimate).all() and abs(ate32 - ate64) <= 0.1 * ate64):
            raise AssertionError("family g): the float32 run is not finite or its ATE is off")
        out["launches"] = counts()  # b)-g) and a)'s card runs: reset before a)

    # h) the three kernels at every shape they took in b)-g), against their
    # plain versions (phase 3's checks and tolerances)
    from gtsam_petercdev_torch.inference import kernels
    from gtsam_petercdev_torch.ops import cholesky_v2 as v2

    cases = sorted({s[:4] for shapes in rec.shapes.values() for s in shapes})
    errs = {}
    t0 = time.perf_counter()
    check_kernels(torch, (v2, v1, kernels), cases, {"float64": {}, "float32": {}}, extras=False,
                  errs_out=errs)
    out["h"] = dict(shapes={k: len(v) for k, v in rec.shapes.items()}, distinct=len(cases),
                    max_abs_err=errs)
    log(f"family h) {len(cases)} distinct (B, nf, ns, d) shapes of K4 / K1 / K2 in b)-g) "
        f"({out['h']['shapes']} with dtype), each kernel against its plain version in float64 "
        f"and float32: max abs err {errs} ({time.perf_counter() - t0:.1f} s)")
    return out


# --- phase 11: the partitioned solver ----------------------------------------------------------


@contextlib.contextmanager
def counting_plain():
    """Within the block, count the calls of the four bucket kernels' plain
    versions (a wrapper's branch for CPU tensors) by name: a path on the
    card's tensors must make none."""
    from gtsam_petercdev_torch.inference import kernels
    from gtsam_petercdev_torch.ops import cholesky, cholesky_v2

    calls = {}
    targets = [(kernels, "partial_cholesky"), (cholesky, "partial_cholesky_plain"),
               (cholesky, "partial_cholesky_blocks_plain"), (cholesky_v2, "backsolve_plain")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in targets]
    for mod, attr, fn in saved:
        def counted(*args, _fn=fn, _name=f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}", **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)

        setattr(mod, attr, counted)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def check_rows(rows, what, dev):
    """Phase 11's gates on scaling.partitioned_rows: the solve = the
    multifrontal solve to PART_GATE x its largest entry, a repeat bitwise
    equal, and (on the card) every level one launch of K4 / K3 / K1 and
    one of K2."""
    for r in rows:
        la = r["launches"]
        factor = sum(la[k] for k in ("partial_cholesky", "partial_cholesky_smem",
                                     "partial_cholesky_blocks"))
        if not r["max_abs_diff"] <= PART_GATE * r["max_abs_x"]:
            raise AssertionError(f"partitioned {what} P={r['parts']}: differs from the "
                                 f"multifrontal solve by {r['max_abs_diff']:.3e}")
        if not r["bitwise_repeat"]:
            raise AssertionError(f"partitioned {what} P={r['parts']}: a repeat differs")
        if dev == "cuda" and not (factor == r["levels"] and la["backsolve_bucket"] == r["levels"]):
            raise AssertionError(f"partitioned {what} P={r['parts']}: {r['levels']} levels, "
                                 f"launches {la}")


def run_partitioned(torch, v1, g64, v64, g32, v32, lg0, opt_maps, lm_ref=None, dev="cuda"):
    """Phase 11 on phase 4's sphere (float64 unless stated): a) the damped
    solve at P = PARTS folded onto the card against multifrontal_solve; b)
    LM on solver="partitioned" against phase 4's multifrontal LM, and one
    float32 solve against the float32 multifrontal solve; c) the sub-block
    BA rig at P = BA_PARTS against the mixed multifrontal solve; d) a
    one-rank NCCL group: the normal equations and the solver over it; e)
    K4 / K3 / K1 / K2 at every level shape of a)-d) against their plain
    versions. lm_ref: phase 4's multifrontal LM (run here when None).
    dev: "cpu" for a rehearsal (gloo for NCCL, no kernel gates)."""
    import tempfile

    import torch.distributed as dist

    from gtsam_petercdev_torch.inference import elimination, kernels
    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.nonlinear.optimizers import LMParams, levenberg_marquardt
    from gtsam_petercdev_torch.ops import cholesky_v2 as v2
    from gtsam_petercdev_torch.parallel import mesh, partition, scaling

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    out, shapes = {}, set()
    counts = {k: 0 for k in KERNELS}  # one run of each a)-d) solve, b)'s LM

    def add(la):
        for k in counts:
            counts[k] += la[k]

    # a) the sphere at P = PARTS, every level on the kernels
    t0 = time.perf_counter()
    Ab = tuple((lb.A, lb.b) for lb in lg0.batches)
    structure, _ = partition.linearized_structure(lg0)
    n = len(v64)
    ref = lambda: elimination.multifrontal_solve(opt_maps, Ab, PART_LAM)
    x_ref = ref()
    with counting_plain() as plain:
        rows = scaling.partitioned_rows("sphere", Ab, structure, n, 6, ref, PART_LAM, PARTS)
    sync()
    for r in rows:
        add(r["launches"])
        shapes.update(map(tuple, r.pop("shapes")))
    log(f"partitioned a) the sphere at P = {PARTS}, lambda {PART_LAM} "
        f"({time.perf_counter() - t0:.1f} s; plain versions called: {plain}):")
    for r in rows:
        log(f"  P={r['parts']}: S {r['S']}, {r['levels']} levels, plan {r['plan_s']:.2f} s, solve "
            f"{r['ms']:.3f} ms (multifrontal {r['multifrontal_ms']:.3f}, ratio of alternated "
            f"rounds {r['ratio']:.3f}), padded GFLOP a part "
            f"{r['gflop_per_part']:.3f} (+ separator "
            f"{r['gflop_separator']:.3f}), launches {r['launches']}, max abs diff "
            f"{r['max_abs_diff']:.3e} (max |x| {r['max_abs_x']:.3e}), bitwise repeat "
            f"{r['bitwise_repeat']}")
    check_rows(rows, "sphere", dev)
    if plain and dev == "cuda":
        raise AssertionError(f"partitioned a): plain versions ran on the card: {plain}")
    out["a"] = rows

    # b) LM through the optimizer hook, then one float32 solve
    t0 = time.perf_counter()
    if lm_ref is None:
        lm_ref = levenberg_marquardt(g64, v64, LMParams(solver="multifrontal",
                                                        max_iterations=LM_ITERS), device=dev)
    v1.reset_launch_counts()
    with counting_plain() as plain:
        lm = levenberg_marquardt(g64, v64, LMParams(solver="partitioned", partition_devices=4,
                                                    max_iterations=LM_ITERS), device=dev)
        sync()
    lm_launches = v1.launch_counts()
    add(lm_launches)
    rel = abs(lm.error - lm_ref.error) / abs(lm_ref.error)
    log(f"partitioned b) LM (P = 4): {['%.12e' % e for e in lm.error_history]}; multifrontal LM "
        f"{['%.12e' % e for e in lm_ref.error_history]}; final rel {rel:.3e} (gate "
        f"{PART_LM_GATE}); launches {lm_launches}; {time.perf_counter() - t0:.1f} s")
    check_result(lm, "partitioned LM")
    if not rel <= PART_LM_GATE or (plain and dev == "cuda"):
        raise AssertionError(f"partitioned b): LM final error rel {rel:.3e}, plain {plain}")
    plan4 = partition.build_partitioned_plan(structure, n, 6, 4)
    solver4 = partition.PartitionedSolver(plan4, device=dev)
    prof = profile_step(torch, lambda _: solver4.solve(Ab, PART_LAM), None, top=8) \
        if dev == "cuda" else None
    if prof is not None:  # where a) P = 4's time goes
        busy, n_launch, krows, _ = prof
        p4_ms = rows[PARTS.index(4)]["ms"]
        out["p4_profile"] = dict(device_busy_ms=busy, solve_ms=p4_ms, cuda_launches=n_launch,
                                 top_kernels=[(k[:80], kms, c) for k, kms, c in krows])
        log(f"partitioned P = 4 solve under torch.profiler: device busy {busy:.3f} ms of "
            f"{p4_ms:.3f} ms ({100.0 * busy / p4_ms:.1f}%), {n_launch} CUDA kernel launches; "
            "top kernels: " + "; ".join(f"{kms:.3f} ms {c}x {k[:60]}" for k, kms, c in krows))
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), PART_F32_REF)) as fh:
        f32_ref = json.load(fh)
    if (f32_ref["shape"] != [N_RINGS, N_PER_RING] or f32_ref["seed"] != SEED
            or f32_ref["lam"] != PART_LAM or f32_ref["parts"] != 4):
        raise AssertionError(f"{PART_F32_REF} is not this system: {f32_ref}")
    f32_gate = f32_ref["rel_to_float64"]["jax_partitioned_float32"]
    lg32 = g32.linearize(v32)
    Ab32 = tuple((lb.A, lb.b) for lb in lg32.batches)
    x32_mf = elimination.multifrontal_solve(opt_maps, Ab32, PART_LAM)
    v1.reset_launch_counts()
    x32 = solver4.solve(Ab32, PART_LAM)
    sync()
    add(v1.launch_counts())
    e32 = ((x32 - x32_mf).abs().max() / x32_mf.abs().max()).item()
    e32_mf = ((x32_mf.double() - x_ref).abs().max() / x_ref.abs().max()).item()
    e32_p = ((x32.double() - x_ref).abs().max() / x_ref.abs().max()).item()
    log(f"partitioned b) float32 solve (P = 4), x the largest entry: against the float64 solve "
        f"{e32_p:.3e} (gate {f32_gate:.3e}, the JAX PartitionedSolver's on this system; the "
        f"port on the CPU {f32_ref['rel_to_float64']['port_partitioned_float32']:.3e}); the "
        f"float32 multifrontal solve against the float64 {e32_mf:.3e}; partitioned against "
        f"multifrontal in float32 {e32:.3e}")
    if not e32_p <= f32_gate:
        raise AssertionError(f"partitioned b): the float32 solve is {e32_p:.3e} from float64, "
                             f"further than the JAX package's {f32_gate:.3e}")
    out["b"] = dict(lm_history=lm.error_history, lm_ref_history=lm_ref.error_history,
                    final_rel=rel, launches=lm_launches, f32_vs_f32_multifrontal=e32,
                    f32_partitioned_vs_f64=e32_p, f32_multifrontal_vs_f64=e32_mf)
    del lg32, Ab32, x32, x32_mf

    # c) the sub-block BA rig at P = BA_PARTS
    t0 = time.perf_counter()
    with counting_plain() as plain:
        ba_rows = scaling.ba_rows(torch.device(dev), BA_PARTS)
    for r in ba_rows:
        add(r["launches"])
        shapes.update(map(tuple, r.pop("shapes")))
    log(f"partitioned c) the {scaling.BA} BA rig through d = 3 sub-blocks at P = {BA_PARTS} "
        f"({time.perf_counter() - t0:.1f} s; plain versions called: {plain}):")
    for r in ba_rows:
        log(f"  P={r['parts']}: S {r['S']}, {r['levels']} levels, plan {r['plan_s']:.2f} s, solve "
            f"{r['ms']:.3f} ms (multifrontal {r['multifrontal_ms']:.3f}, ratio of alternated "
            f"rounds {r['ratio']:.3f}), padded GFLOP a part {r['gflop_per_part']:.3f} (+ "
            f"separator {r['gflop_separator']:.3f}), launches "
            f"{r['launches']}, max abs diff {r['max_abs_diff']:.3e} (max |x| "
            f"{r['max_abs_x']:.3e}), bitwise repeat {r['bitwise_repeat']}")
    check_rows(ba_rows, "BA", dev)
    if plain and dev == "cuda":
        raise AssertionError(f"partitioned c): plain versions ran on the card: {plain}")
    out["c"] = ba_rows

    # d) a one-rank NCCL process group (runs over several cards need a
    # machine with several)
    t0 = time.perf_counter()
    x4 = solver4.solve(Ab, PART_LAM)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                                store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                                world_size=1)
        try:
            group = dist.group.WORLD
            H, g = mesh.distributed_normal_equations(g64, v64, group, device=dev)[0](v64)
            H0, g0 = linsolve.assemble_dense(lg0)
            eH = ((H - H0).abs().max() / H0.abs().max()).item()
            eg = ((g - g0).abs().max() / g0.abs().max()).item()
            del H, H0, g, g0
            v1.reset_launch_counts()
            xg = partition.PartitionedSolver(plan4, group, device=dev).solve(Ab, PART_LAM)
            sync()
            add(v1.launch_counts())
            ex = ((xg - x4).abs().max() / x4.abs().max()).item()
            bitwise = torch.equal(xg, x4)
        finally:
            dist.destroy_process_group()
    log(f"partitioned d) one-rank NCCL group: distributed_normal_equations against "
        f"assemble_dense H {eH:.3e}, g {eg:.3e} x the largest entry (gate {PART_NE_GATE}); the "
        f"solver over the group against a)'s P = 4 solve {ex:.3e} (bitwise {bitwise}; gate "
        f"{PART_NE_GATE}); {time.perf_counter() - t0:.1f} s")
    if not (eH <= PART_NE_GATE and eg <= PART_NE_GATE and ex <= PART_NE_GATE):
        raise AssertionError("partitioned d): the one-rank group differs")
    out["d"] = dict(H_rel=eH, g_rel=eg, solve_rel=ex, solve_bitwise=bitwise)

    # e) the four kernels at every level shape of a)-d)
    cases = sorted(shapes)
    errs = {}
    t0 = time.perf_counter()
    if dev == "cuda":
        check_kernels(torch, (v2, v1, kernels), cases, {"float64": {}, "float32": {}},
                      extras=False, errs_out=errs)
    out["e"] = dict(distinct=len(cases), max_abs_err=errs)
    log(f"partitioned e) {len(cases)} distinct (Bt, nf, ns, d) level shapes of a)-d), each "
        f"kernel against its plain version in float64 and float32: max abs err {errs} "
        f"({time.perf_counter() - t0:.1f} s)")

    from gtsam_petercdev_torch.parallel.scaling import table

    log("partitioned scaling table (phase 11 a) and c); card: "
        f"{card_line()}):")
    for line in table(rows + ba_rows):
        log("  " + line)
    out["launches"] = counts
    return out


# --- phase 10: the host engine ------------------------------------------------------------


class NativeTimer:
    """Host time inside the host engine's two native sweeps (the whole
    level sweep, eliminate_sweep; the whole wildfire descent,
    wildfire_sweep) while the context is open."""

    def __enter__(self):
        from gtsam_petercdev_torch.inference import incremental as inc

        self.ms = {"eliminate_sweep": 0.0, "wildfire_sweep": 0.0}
        self.saved = [(inc.IncrementalEngine, "_native_eliminate"), (inc._NativeTree, "sweep")]
        self.saved = [(o, a, o.__dict__[a]) for o, a in self.saved]
        for (owner, attr, fn), name in zip(self.saved, self.ms):
            def timed(*a, _fn=fn, _name=name, **k):
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                self.ms[_name] += (time.perf_counter() - t0) * 1e3
                return out
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)


def run_host_engine(torch, here, isam2, card_gate=None, dev="cuda"):
    """Phase 10: the host engine (engine_backend="numpy": exact per-clique
    payloads, the native sweeps of csrc/host/solve_native.cpp) on the card
    machine's CPU, on phase 6's stream and ordering (the port's AMD).
    `card_gate`: phase 6 a)'s card run of the first CITY_GATE_LINES lines."""
    import numpy as np

    from gtsam_petercdev_torch.models.city10000 import run_city10000
    from gtsam_petercdev_torch.utils import synthetic

    lines, gt = synthetic.city_stream(CITY_POSES, seed=SEED)
    out = {}

    # a) the first lines, host engine against the card engine (phase 6
    # a)'s card run of the same lines, or a run on `dev` here) and against
    # the card engine on this machine's CPU ("torch" on device "cpu"): the
    # two engines a user without a card can choose between, timed apart
    path = write_stream(here, lines, CITY_GATE_LINES)
    t0 = time.perf_counter()
    host = run_city10000(path, device="cpu", engine_backend="numpy")
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_torch = run_city10000(path, device="cpu")
    t_cpu_torch = time.perf_counter() - t0
    card = card_gate if card_gate is not None else run_city10000(path, device=dev)
    rels, diffs = {}, {}
    for name, other in (("card engine", card), ("card engine on the CPU", cpu_torch)):
        rels[name] = float(np.linalg.norm(host.estimate - other.estimate)
                           / np.linalg.norm(other.estimate))
        diffs[name] = [i for i, (u, v) in enumerate(zip(host.updates, other.updates, strict=True))
                       if u.n_reeliminated != v.n_reeliminated]
    ms = {name: np.asarray(r.step_times) * 1e3 for name, r in
          (("host", host), ("torch_cpu", cpu_torch), ("card", card))}
    out["a"] = dict(estimate_rel=rels, reeliminated_differ=diffs, wall_s=dict(
        host=t_host, torch_cpu=t_cpu_torch), step_ms={k: dict(stats_ms(v), p90=float(
            np.percentile(v, 90))) for k, v in ms.items()})
    log(f"host engine a) {CITY_GATE_LINES} lines, host engine vs " + "; vs ".join(
        f"{k}: estimates rel {rels[k]:.3e}, n_reeliminated identical in "
        f"{len(host.updates) - len(diffs[k])} of {len(host.updates)} updates" for k in rels)
        + " (gate 1e-9, all identical); per-update ms mean / p50 / p99 / max: " + "; ".join(
        f"{k} {v.mean():.3f} / {np.percentile(v, 50):.3f} / {np.percentile(v, 99):.3f} / "
        f"{v.max():.3f}" for k, v in ms.items()) + f"; wall host {t_host:.2f} s, card engine "
        f"on the CPU {t_cpu_torch:.2f} s")
    if not (all(r <= 1e-9 for r in rels.values()) and not any(diffs.values())):
        raise AssertionError("host engine a): the host and the card engine disagree")

    # b) the full run at City10000's parameters beside run c)'s card numbers
    path = write_stream(here, lines, CITY_LINES)
    t0 = time.perf_counter()
    with NativeTimer() as nat:
        res = run_city10000(path, device="cpu", engine_backend="numpy")
    wall = time.perf_counter() - t0
    st = np.asarray(res.step_times) * 1e3
    ate, ate_card = res.ate_rmse(gt), isam2["ate_rmse"]
    dpose = res.estimate - isam2["final_estimate"]
    dpose[:, 2] = np.arctan2(np.sin(dpose[:, 2]), np.cos(dpose[:, 2]))
    largest = float(np.abs(dpose).max())
    native = sum(nat.ms.values())
    out["b"] = dict(lines=len(res.updates), wall_s=wall,
                    step_ms=dict(stats_ms(st), p90=float(np.percentile(st, 90))),
                    native_ms_per_update={k: v / len(st) for k, v in nat.ms.items()},
                    native_share=float(native / st.sum()), ate_rmse=ate, ate_rmse_card=ate_card,
                    largest_pose_difference_to_card=largest,
                    reelim_mean=float(np.mean([u.n_reeliminated for u in res.updates])),
                    wildfire_cliques_mean=float(np.mean([u.wildfire_rounds for u in res.updates])))
    c = isam2["step_ms"]
    log(f"host engine b) {len(res.updates)} lines in {wall:.1f} s on the CPU: per-update ms mean "
        f"{st.mean():.3f} p50 {np.percentile(st, 50):.3f} p90 {np.percentile(st, 90):.3f} p99 "
        f"{np.percentile(st, 99):.3f} max {st.max():.3f} (card engine, run c): mean "
        f"{c['mean']:.3f} p50 {c['p50']:.3f} p90 {c['p90']:.3f} p99 {c['p99']:.3f} max "
        f"{c['max']:.3f}); native sweeps {100.0 * native / st.sum():.1f}% of the update time "
        f"(eliminate_sweep {nat.ms['eliminate_sweep'] / len(st):.3f}, wildfire_sweep "
        f"{nat.ms['wildfire_sweep'] / len(st):.3f} ms per update); n_reeliminated mean "
        f"{out['b']['reelim_mean']:.2f}, wildfire cliques solved mean "
        f"{out['b']['wildfire_cliques_mean']:.1f}; ATE-RMSE {ate:.6f} (card {ate_card:.6f}, gate "
        f"rel {HOST_ATE_GATE:g}); largest pose difference to the card's estimate {largest:.3e}")
    finite = bool(np.isfinite(res.estimate).all()) and res.estimate.shape == (res.n_poses, 3)
    if not (finite and abs(ate - ate_card) <= HOST_ATE_GATE * ate_card
            and all(int(u.bad_pivots) == 0 for u in res.updates)):
        raise AssertionError(f"host engine b): finite {finite}, ATE {ate} against {ate_card}")

    # c) a host checkpoint resumed bitwise
    path = write_stream(here, lines, CITY_GATE_LINES)
    ckpt = os.path.join(here, "gtsam_petercdev_torch", "_build", "host_isam2.ckpt")
    with contextlib.redirect_stdout(io.StringIO()):  # its progress lines
        full = run_city10000(path, device="cpu", engine_backend="numpy",
                             progress_every=FAMILY_GATE_CKPT, checkpoint_path=ckpt)
    rest = run_city10000(path, device="cpu", engine_backend="numpy", resume_from=ckpt)
    same = bool(np.array_equal(rest.estimate, full.estimate)) and bool(
        np.array_equal(full.estimate, host.estimate))
    out["c"] = dict(bytes=os.path.getsize(ckpt), bitwise=same)
    log(f"host engine c) a checkpoint at line {FAMILY_GATE_CKPT} ({out['c']['bytes']} bytes) "
        f"resumed to line {CITY_GATE_LINES}: bitwise the uninterrupted run: {same}")
    if not same:
        raise AssertionError("host engine c): the resumed run differs")
    return out


# --- phase 12: navigation --------------------------------------------------------------------


def nav_rel(a, b):
    """Largest |a - b| over b's largest entry, leafwise over two PIMs."""
    return max(((x.double().cpu() - y.double().cpu()).abs().max()
                / y.double().cpu().abs().max().clamp_min(1e-300)).item() for x, y in zip(a, b))


def lm_counts(fn):
    """(fn(), how far it moved the port's LM counters lm.trials and
    lm.bad_pivot_trials)."""
    from gtsam_petercdev_torch.utils import timing

    before = timing.counters()
    out = fn()
    after = timing.counters()
    return out, {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("lm.trials", "lm.bad_pivot_trials")}


def lm_bad_pivot_trials(levenberg_marquardt, graph, values, params, device):
    """(levenberg_marquardt's result, the count of its trials rejected for
    clamped pivots)."""
    res, counts = lm_counts(lambda: levenberg_marquardt(graph, values, params, device=device))
    return res, counts["lm.bad_pivot_trials"]


def nav_flat(torch, values):
    """{type: [N, k] CPU tensor} of a Values, each variable's leaves flattened."""
    out = {}
    for t in values.types():
        p = values.params(t)
        n = len(values.type_keys(t))
        out[t] = torch.cat([x.reshape(n, -1) for x in (p if isinstance(p, tuple) else (p,))],
                           1).cpu()
    return out


def run_navigation(torch, v1, dev="cuda"):
    """Phase 12 (float64) on imu_gps_drive(NAV_KEYFRAMES, NAV_RATE): a) the
    whole drive's IMU samples through one batched preintegrate pass; b)
    batch LM over the drive (solver="multifrontal"); c) IMUKittiExampleGPS's
    loop through ISAM2 over its first NAV_ISAM2_KEYFRAMES keyframes; d) the
    four kernels at every shape they took in b) and c)."""
    import numpy as np

    from gtsam_petercdev_torch.inference import elimination, kernels, symbolic
    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.models import imu_gps
    from gtsam_petercdev_torch.navigation import preintegration as pre
    from gtsam_petercdev_torch.nonlinear.optimizers import (
        LMParams, OptimizerParams, gauss_newton, levenberg_marquardt)
    from gtsam_petercdev_torch.ops import cholesky_v2 as v2
    from gtsam_petercdev_torch.utils import convert, synthetic

    out = {}
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    va, fa, truth = synthetic.imu_gps_drive(NAV_KEYFRAMES, NAV_RATE, seed=SEED, device=dev)
    K = NAV_KEYFRAMES
    log(f"navigation drive: {K} keyframes, {K - 1} intervals of {NAV_RATE} IMU samples "
        f"({(K - 1) * NAV_RATE} in all), {K} GPS fixes, made on {dev} in "
        f"{time.perf_counter() - t0:.1f} s")

    # a) the whole drive's samples through one batched preintegrate pass
    secs = {}
    t_sub = time.perf_counter()
    params = pre.default_params(device=dev)
    imu = [torch.as_tensor(truth["imu"][k]).to(dev) for k in ("acc", "omega", "dts")]
    pass_ = lambda: pre.preintegrate(params, *imu)
    pim = pass_()
    sync()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        pass_()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    pass_ms = sorted(ms)[1]
    prof = profile_once(torch, pass_) if dev == "cuda" else None
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # CPU bmm of [999, 9, 9] costs ms a call across threads
    t0 = time.perf_counter()
    cpu = pre.preintegrate(pre.default_params(device="cpu"), *(a.cpu() for a in imu))
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    rel_cpu = nav_rel(pim, cpu)
    pick = np.linspace(0, K - 2, NAV_ONE_AT_A_TIME).round().astype(int)
    rel_one = max(nav_rel([f[i] for f in pim], pre.preintegrate(params, *(a[i] for a in imu)))
                  for i in pick)
    drive_rel = nav_rel(pim, [torch.as_tensor(f) for f in fa[3][2]["pim"]])
    out["a"] = dict(intervals=K - 1, samples=(K - 1) * NAV_RATE, pass_ms=pass_ms,
                    device_busy_ms=prof[0] if prof else None,
                    cuda_launches=prof[1] if prof else None, cpu_s=cpu_s, rel_cpu=rel_cpu,
                    rel_one_at_a_time=rel_one, intervals_one_at_a_time=pick.tolist())
    log(f"navigation a) preintegrate: {K - 1} intervals x {NAV_RATE} samples in one batched "
        f"pass: {pass_ms:.3f} ms (median of 3)"
        + (f", device busy {prof[0]:.3f} ms, {prof[1]} CUDA kernel launches "
           f"({prof[1] / NAV_RATE:.1f} a sample step)" if prof else "")
        + f"; every PIM field against the CPU path ({cpu_s:.1f} s, one thread) rel "
          f"{rel_cpu:.3e} (gate 1e-12); intervals "
          f"{pick.tolist()} integrated one at a time rel {rel_one:.3e} (gate 1e-13); the "
          f"drive's own PIMs rel {drive_rel:.3e}")
    if not (rel_cpu <= 1e-12 and rel_one <= 1e-13 and drive_rel <= 1e-13):
        raise AssertionError("navigation a): preintegration differs")

    secs["a"] = time.perf_counter() - t_sub
    t_sub = time.perf_counter()

    # b) batch LM over the whole drive, solver="multifrontal"
    g = convert.graph_from_arrays(fa, device=dev)
    v = convert.values_from_arrays(va, device=dev)
    n_fac = {name: len(k) for name, k, _, _ in fa}
    t0 = time.perf_counter()
    structure = elimination.graph_structure(g, v)
    lg0 = g.linearize(v)
    plan, maps = elimination._graph_plan(g, lg0)
    n_vars = len(v)
    edges = np.concatenate([np.zeros((0, 2), dtype=np.int64)]
                           + [np.stack([s.gids[a], s.gids[b]], axis=1) for s in structure
                              for a in range(len(s.gids)) for b in range(a + 1, len(s.gids))])
    cands = symbolic.ordering_candidates(n_vars, edges)
    F = {name: 36 * (f - 1) + 1 for name, _, f in cands}
    best = min(cands, key=lambda c: c[2])
    if not np.array_equal(best[1], plan.perm):
        raise AssertionError("navigation b): the plan's ordering is not best_ordering's")
    facts = plan_facts(elimination, maps)
    out["b"] = dict(variables=n_vars, factors=n_fac, ordering=dict(chosen=best[0], F_size=F),
                    plan=facts, plan_s=time.perf_counter() - t0)
    log(f"navigation b) graph: {n_vars} variables (Pose3 / Vector3 / ConstantBias, d = 6), "
        f"factors {n_fac}; plan ({out['b']['plan_s']:.1f} s): ordering {best[0]} (F_size "
        + ", ".join(f"{k} {x}" for k, x in F.items()) + f"), {facts['cliques']} cliques, "
        f"{facts['levels']} levels, {facts['buckets']} buckets, routing {facts['routes']}")
    log_routing(elimination, "navigation b) plan", maps)

    # the first damped step against the dense oracle
    lam = LMParams().lambda_initial
    t0 = time.perf_counter()
    cache = {"mf_lg": lg0}
    delta, _ = elimination.solve_linearized(g, v, lam, cache=cache)
    bad0 = int(cache["bad_pivots"])
    H, gvec = linsolve.assemble_dense(lg0)
    x_dense = linsolve.dense_solve(H, gvec, lam)
    x_mf = linsolve.flatten_delta(lg0, delta)
    step_err = ((x_mf - x_dense).abs().max() / x_dense.abs().max()).item()
    del H, gvec, x_dense, x_mf
    log(f"navigation b) first damped step (lambda {lam:g}) against the dense oracle: max abs "
        f"difference {step_err:.3e} x its largest entry (gate 1e-8); bad pivots {bad0} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not (step_err <= 1e-8 and bad0 == 0):
        raise AssertionError("navigation b): the first damped step differs from the dense oracle")

    # LM through the entry point; counters reset just before, read just after
    lm_params = LMParams(solver="multifrontal", max_iterations=NAV_LM_ITERS)
    v1.reset_launch_counts()
    t0 = time.perf_counter()
    with counting_plain() as plain_calls:
        lm, bad_trials = lm_bad_pivot_trials(levenberg_marquardt, g, v, lm_params, dev)
        sync()
    lm_s = time.perf_counter() - t0
    lm_launches = v1.launch_counts()
    check_result(lm, "navigation b) LM")
    ate_lm = imu_gps.ate(lm.values, truth)
    out["b"].update(lm_history=lm.error_history, lm_iterations=lm.iterations, lm_s=lm_s,
                    launches=lm_launches, launches_per_iteration={
                        k: x / max(1, lm.iterations) for k, x in lm_launches.items()},
                    bad_pivot_trials=bad_trials, plain_calls=dict(plain_calls), ate=ate_lm,
                    first_step_rel=step_err)
    log(f"navigation b) LM: error {lm.error_history[0]:.6e} -> {lm.error:.6e} in "
        f"{lm.iterations} iterations ({lm_s:.2f} s); launches {lm_launches}; trials with bad "
        f"pivots {bad_trials}; plain versions called {dict(plain_calls)}; ATE {ate_lm:.6f} m "
        f"(start {imu_gps.ate(v, truth):.6f})")
    if bad_trials or (dev == "cuda" and plain_calls):
        raise AssertionError("navigation b): bad pivots or a plain version on the card")
    if dev == "cuda" and not lm_launches["backsolve_bucket"] > 0:
        raise AssertionError(f"navigation b): K2 never launched: {lm_launches}")

    # ms per LM iteration: linearize, damped multifrontal solve, retract
    types = sorted(lg0.type_counts)
    offs = elimination.type_offsets(lg0.type_counts)
    dims = {t: x.shape[1] for t, x in delta.items()}

    def lm_step(values):
        lg = g.linearize(values)
        x = elimination.multifrontal_solve(maps, tuple((lb.A, lb.b) for lb in lg.batches), lam)
        return values.retract({t: x[offs[t]: offs[t] + lg0.type_counts[t], : dims[t]]
                               for t in types})

    if dev == "cuda":
        t0 = time.perf_counter()
        prof = {}
        # the iteration profiled twice (the fuller kept), its device alone:
        # the post-processing of an iteration's ~33,000 launches took ~30 s
        # a profile with the host ops (its host table: PERF.md, section 5)
        it_ms, per_it = time_step(torch, v1, "navigation b) LM iteration", "iter", lm_step, g, v,
                                  NAV_CHAIN, prof_out=prof, profile_host=False)
        busy = prof.get("busy_ms")
        out["b"].update(ms_per_iteration=it_ms, launches_per_step=per_it, device_busy_ms=busy,
                        device_busy_share=busy / it_ms if busy else None,
                        timing_s=time.perf_counter() - t0)

    # the drive's first NAV_CUT keyframes: the card against the CPU path
    t0 = time.perf_counter()
    va_c, fa_c, _ = synthetic.imu_gps_drive(NAV_CUT, NAV_RATE, seed=SEED, device="cpu")
    hist = {}
    for d in dict.fromkeys((dev, "cpu")):
        hist[d] = levenberg_marquardt(convert.graph_from_arrays(fa_c, device=d),
                                      convert.values_from_arrays(va_c, device=d),
                                      LMParams(solver="multifrontal", max_iterations=NAV_CUT_ITERS),
                                      device=d).error_history
    cut_rel = max(abs(a - b) / abs(b) for a, b in zip(hist[dev], hist["cpu"]))
    out["b"].update(cut_keyframes=NAV_CUT, cut_history=hist[dev], cut_rel=cut_rel)
    log(f"navigation b) {NAV_CUT} keyframes, LM on {dev} against the CPU path: "
        f"{['%.9e' % e for e in hist[dev]]}, rel {cut_rel:.3e} (gate 1e-9; "
        f"{time.perf_counter() - t0:.1f} s)")
    if not (len(hist[dev]) == len(hist["cpu"]) and cut_rel <= 1e-9):
        raise AssertionError("navigation b): the card's LM history differs from the CPU path's")
    shapes = {(bm.B, bm.nf, bm.ns, maps.plan.d) for bm in maps.buckets}
    del g, v, lg0, lm, structure

    secs["b"] = time.perf_counter() - t_sub
    t_sub = time.perf_counter()

    # c) IMUKittiExampleGPS's loop through ISAM2 (ISAM2Params() defaults, d = 6)
    n_is = NAV_ISAM2_KEYFRAMES
    snap = {}

    t_c = time.perf_counter()

    def cb(k, isam, res):
        if k == NAV_ISAM2_GATE - 1:
            snap["est"] = isam.calculate_estimate()
        snap.setdefault("rounds", []).append(res.wildfire_rounds)
        if (k + 1) % NAV_PROGRESS == 0:
            log(f"navigation c) update {k + 1}: {time.perf_counter() - t_c:.1f} s; the last "
                f"{NAV_PROGRESS}: wildfire rounds mean {np.mean(snap['rounds'][-NAV_PROGRESS:]):.1f}, "
                f"cliques {res.n_cliques}, n_reeliminated {res.n_reeliminated}")

    v1.reset_launch_counts()
    t0 = time.perf_counter()
    with ShapeRecorder() as rec:
        run = imu_gps.run_imu_gps_isam2(va, fa, truth, n_is, device=dev, step_cb=cb)
    sync()
    is_s = time.perf_counter() - t0
    is_launches = v1.launch_counts()
    est = run.estimate()
    err = float(run.graph.error(est))
    bad = sum(int(u.bad_pivots) for u in run.updates)
    ate_is = imu_gps.ate(est, truth, n_is)
    st = stats_ms(run.update_ms[1:])  # the first update holds the priors and the warm-up
    cpu_run = imu_gps.run_imu_gps_isam2(va, fa, truth, NAV_ISAM2_GATE, device="cpu")
    cpu_est = cpu_run.estimate()
    a, b = nav_flat(torch, snap["est"]), nav_flat(torch, cpu_est)
    gate_rel = (max((a[t] - b[t]).abs().max().item() for t in b)
                / max(x.abs().max().item() for x in b.values()))
    re_card = [u.n_reeliminated for u in run.updates[:NAV_ISAM2_GATE]]
    re_cpu = [u.n_reeliminated for u in cpu_run.updates]
    # the JAX ISAM2 on this loop and the final graph's optimum, on the CPU
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), NAV_ISAM2_REF)) as fh:
        ref = json.load(fh)
    if (ref["drive_keyframes"], ref["isam2_keyframes"], ref["rate_hz"], ref["seed"],
            ref["bias_walk"]) != (K, n_is, NAV_RATE, SEED, list(synthetic.DRIVE_BIAS_WALK)):
        raise AssertionError(f"{NAV_ISAM2_REF} is not this loop: {ref}")
    optimum, ratio_jax = ref["optimum"], ref["jax_isam2_proxy_over_optimum"]
    ratio_rel = abs(err / optimum - ratio_jax) / ratio_jax
    ratio_own = ref["jax_isam2_over_optimum"]
    ratio_rel_own = abs(err / optimum - ratio_own) / ratio_own
    # the final graph by batch GN (as phase 6 c)) from the iSAM2 estimate,
    # and by batch LM from the drive's start cut to the same keyframes
    gn = gauss_newton(run.graph, est, OptimizerParams(solver="multifrontal", max_iterations=5),
                      device=dev)
    t0 = time.perf_counter()
    lm_start = levenberg_marquardt(run.graph, imu_gps.start_values(va, n_is, dev), LMParams(
        solver="multifrontal", max_iterations=NAV_ISAM2_LM_ITERS, relative_error_tol=1e-12,
        absolute_error_tol=1e-12), device=dev)
    lm_s = time.perf_counter() - t0
    opt_rel = (lm_start.error - optimum) / optimum
    out["c"] = dict(keyframes=n_is, wall_s=is_s, update_ms=st, launches=is_launches,
                    launches_per_update={k: x / n_is for k, x in is_launches.items()},
                    error=err, optimum=optimum, isam2_over_optimum=err / optimum,
                    jax_isam2_proxy_over_optimum=ratio_jax, ratio_rel=ratio_rel,
                    jax_isam2_over_optimum=ratio_own, ratio_rel_own_ordering=ratio_rel_own,
                    batch_gn_history=gn.error_history,
                    batch_lm_from_start=lm_start.error_history, optimum_rel=opt_rel,
                    lm_s=lm_s, ate=ate_is,
                    ate_optimum=imu_gps.ate(lm_start.values, truth, n_is), bad_pivots=bad,
                    gate_keyframes=NAV_ISAM2_GATE, gate_rel=gate_rel,
                    gate_reeliminated_equal=re_card == re_cpu,
                    n_reeliminated_mean=float(np.mean([u.n_reeliminated for u in run.updates])),
                    row_blocks=run.isam.row_blocks(convert.factor_type("CombinedImuFactor")))
    log(f"navigation c) ISAM2 over {n_is} keyframes ({is_s:.1f} s): per-update ms mean "
        f"{st['mean']:.3f} p50 {st['p50']:.3f} p99 {st['p99']:.3f} max {st['max']:.3f} (updates "
        f"2-{n_is}); launches {is_launches} ("
        + ", ".join(f"{k} {x / n_is:.3f}" for k, x in is_launches.items()) + " per update); "
        f"CombinedImuFactor in {out['c']['row_blocks']} row blocks; n_reeliminated mean "
        f"{out['c']['n_reeliminated_mean']:.2f}; bad pivots {bad}; ATE {ate_is:.6f} m")
    log(f"navigation c) first {NAV_ISAM2_GATE} updates, card against the card engine on the "
        f"CPU: estimates rel {gate_rel:.3e} (gate 1e-9), n_reeliminated equal in every update "
        f"{re_card == re_cpu}")
    log(f"navigation c) final error {err:.9e}, {err / optimum:.9f} x the final graph's optimum "
        f"{optimum:.9e}; the JAX ISAM2 on this loop (CPU, {NAV_ISAM2_REF}) on the proxy "
        f"ordering {ratio_jax:.9f} x: rel {ratio_rel:.3e} (gate {NAV_ISAM2_REF_GATE}); on its "
        f"own CCOLAMD tree {ratio_own:.9f} x: rel {ratio_rel_own:.3e} (gate {NAV_ORDERING_GATE}); "
        f"batch GN of the final graph from the iSAM2 estimate "
        f"{['%.6e' % e for e in gn.error_history]}; batch LM from the drive's start "
        f"{lm_start.error:.9e} after {lm_start.iterations} iterations ({lm_s:.1f} s; ATE "
        f"{out['c']['ate_optimum']:.6f} m), rel {opt_rel:.3e} above the optimum (gate "
        f"{NAV_OPT_GATE})")
    finite = all(x == x and abs(x) != float("inf") for x in [err, ate_is, lm_start.error])
    if not (finite and bad == 0 and gate_rel <= 1e-9 and re_card == re_cpu
            and ratio_rel <= NAV_ISAM2_REF_GATE and ratio_rel_own <= NAV_ORDERING_GATE
            and -1e-9 <= opt_rel <= NAV_OPT_GATE):
        raise AssertionError("navigation c) failed its gates")
    if dev == "cuda" and not (is_launches["backsolve_bucket"] > 0
                              and is_launches["partial_cholesky_blocks"] > 0):
        raise AssertionError(f"navigation c): K4 or K2 never launched: {is_launches}")
    for k in rec.shapes.values():
        shapes.update(s[:4] for s in k)

    secs["c"] = time.perf_counter() - t_sub
    t_sub = time.perf_counter()

    # d) the four kernels at every shape of b) and c), float64 and float32
    cases = sorted(shapes)
    errs = {}
    t0 = time.perf_counter()
    if dev == "cuda":
        check_kernels(torch, (v2, v1, kernels), cases, {"float64": {}, "float32": {}},
                      extras=False, errs_out=errs)
    out["d"] = dict(distinct=len(cases), shapes=cases, max_abs_err=errs)
    log(f"navigation d) {len(cases)} distinct (B, nf, ns, d) shapes of b) and c), each kernel "
        f"against its plain version in float64 and float32: max abs err {errs} "
        f"({time.perf_counter() - t0:.1f} s)")
    secs["d"] = time.perf_counter() - t_sub
    out["launches"] = {k: lm_launches[k] + is_launches[k] for k in lm_launches}
    out["phase_s"] = time.perf_counter() - t_phase
    out["seconds"] = secs
    log(f"navigation phase: {out['phase_s']:.1f} s (" + ", ".join(
        f"{k}) {x:.1f} s" for k, x in secs.items()) + ")")
    return out


# --- phase 13: initialization and the linear extras ----------------------------------------


class PcgRecorder:
    """Each `linear/solve.pcg_solve` call's ms (the card synchronized on
    both sides) and the operator products (`hvp`, one a CG step) made while
    the context is open."""

    def __init__(self, sync):
        self.sync, self.stages, self.hvps = sync, [], 0

    def __enter__(self):
        from gtsam_petercdev_torch.linear import solve as linsolve

        self.mod, self.saved = linsolve, (linsolve.pcg_solve, linsolve.hvp)
        pcg_solve, hvp = self.saved

        def counted_hvp(*a, **k):
            self.hvps += 1
            return hvp(*a, **k)

        def timed_pcg_solve(*a, **k):
            self.sync()
            t0, n0 = time.perf_counter(), self.hvps
            out = pcg_solve(*a, **k)
            self.sync()
            self.stages.append(((time.perf_counter() - t0) * 1e3, self.hvps - n0))
            return out

        linsolve.pcg_solve, linsolve.hvp = timed_pcg_solve, counted_hvp
        return self

    def __exit__(self, *exc):
        self.mod.pcg_solve, self.mod.hvp = self.saved


class EliminationRecorder:
    """Every bucket shape (B, nf, ns, d) the multifrontal eliminations (solve
    and factor) run while the context is open, and their clamped pivots (one
    device read an elimination: for the gate runs, never a timed one)."""

    def __enter__(self):
        from gtsam_petercdev_torch.inference import elimination

        self.mod, self.saved = elimination, elimination._eliminate
        self.shapes, self.bad = set(), 0
        orig = self.saved

        def recorded(maps, dm, pool, gp):
            self.shapes.update((bm.B, bm.nf, bm.ns, maps.plan.d) for bm in maps.buckets)
            outs, bad = orig(maps, dm, pool, gp)
            self.bad += int(bad)
            return outs, bad

        elimination._eliminate = recorded
        return self

    def __exit__(self, *exc):
        self.mod._eliminate = self.saved


class ErrorRecorder:
    """Every `graph.error(values)` while the context is open as (error,
    what(values)), so each entry of an error history finds its values."""

    def __init__(self, graph, what):
        self.graph, self.what, self.evals = graph, what, []

    def __enter__(self):
        error = self.graph.error

        def recorded(values):
            e = error(values)
            self.evals.append((float(e), self.what(values)))
            return e

        self.graph.error = recorded
        return self

    def __exit__(self, *exc):
        del self.graph.error

    def at(self, history):
        """what(values) at each history entry."""
        out, k = [], 0
        for h in history:
            while self.evals[k][0] != h:
                k += 1
            out.append(self.evals[k][1])
        return out


def pose2_ate(values, gt):
    """RMSE of the Pose2 positions (keys 0..n-1) against the truth [n, 3]."""
    import numpy as np

    keys = values.type_keys("Pose2")
    p = values.params("Pose2").double().cpu().numpy()[np.argsort(keys)]
    d = p[:, :2] - gt[: len(p), :2]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def pose3_ate(values, t_true):
    import numpy as np

    keys = values.type_keys("Pose3")
    t = values.params("Pose3").t.double().cpu().numpy()[np.argsort(keys)]
    d = t - t_true[: len(t)]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def dense_step_rel(torch, elimination, linsolve, graph, values, lam):
    """The first damped multifrontal step against the dense oracle: max abs
    difference over the dense step's largest entry."""
    lg = graph.linearize(values)
    cache = {"mf_lg": lg}
    delta, _ = elimination.solve_linearized(graph, values, lam, cache=cache)
    H, g = linsolve.assemble_dense(lg)
    x_dense = linsolve.dense_solve(H, g, lam)
    x_mf = linsolve.flatten_delta(lg, delta)
    return ((x_mf - x_dense).abs().max() / x_dense.abs().max()).item(), int(cache["bad_pivots"])


def plan_line(elimination, symbolic, graph, values, label):
    """A graph's optimizer plan (best_ordering's four candidates, cliques,
    levels, buckets, routing), set on the graph and logged; returns (maps,
    facts)."""
    import numpy as np

    from gtsam_petercdev_torch.core import manifold

    structure = elimination.graph_structure(graph, values)
    lg0 = graph.linearize(values)
    t0 = time.perf_counter()
    edges = np.concatenate([np.zeros((0, 2), dtype=np.int64)]
                           + [np.stack([s.gids[a], s.gids[b]], axis=1) for s in structure
                              for a in range(len(s.gids)) for b in range(a + 1, len(s.gids))])
    cands = symbolic.ordering_candidates(len(values), edges)
    best = min(cands, key=lambda c: c[2])
    # the optimizer's plan on best_ordering's choice, its candidates made once
    dims = {t: manifold.get(t).dim for t in lg0.type_counts}
    d = max(dims.values())
    offs = elimination.type_offsets(lg0.type_counts)
    var_dims = np.full(len(values), d, dtype=np.int64)
    for t, k in lg0.type_counts.items():
        var_dims[offs[t]: offs[t] + k] = dims[t]
    plan = elimination.build_plan_for_graph(structure, len(values), d, ordering=best[1])
    maps = elimination.build_numeric_maps(plan, structure, var_dims=var_dims)
    elimination.set_graph_plan(graph, lg0, plan, maps)
    plan_s = time.perf_counter() - t0
    F = {name: d * d * (f - 1) + 1 for name, _, f in cands}
    facts = dict(plan_facts(elimination, maps), ordering=best[0], F_size=F, d=d, plan_s=plan_s)
    log(f"{label} plan ({plan_s:.1f} s, d = {d}): ordering {best[0]} (F_size "
        + ", ".join(f"{k} {x}" for k, x in F.items()) + f"), {facts['cliques']} cliques, "
        f"{facts['levels']} levels, {facts['buckets']} buckets, routing {facts['routes']}")
    return maps, facts


def city_edges(lines):
    """(keys [E, 2], measured [E, 3]) of city stream lines."""
    import numpy as np

    rows = [ln.split() for ln in lines]
    return (np.array([[int(r[1]), int(r[3])] for r in rows]),
            np.array([[float(x) for x in r[6:9]] for r in rows]))


def dead_reckoning(synthetic, keys, meas, n):
    """Poses 0..n-1 composed from the odometry lines, pose 0 at the origin."""
    import numpy as np

    odo = {int(a): m for (a, b), m in zip(keys, meas) if b == a + 1}
    poses = [np.zeros(3)]
    for i in range(1, n):
        poses.append(synthetic.pose2_compose_np(poses[-1], odo[i - 1]))
    return np.stack(poses)


def run_init(torch, v1, here, dev="cuda"):
    """Phase 13 (float64 unless stated): a) chordal initialization of the
    sphere, then GN from it; b) LAGO on the whole City graph, then LM from it
    and from dead reckoning; c) the subgraph-preconditioned solve; d) the
    exact constrained dense LM; e) the unstable factors (EM on the sphere
    with outliers, rolling-shutter BA, inverse-depth SLAM); f) the Kalman
    filter / RTS smoother, the EKF, the power methods, the sampler; g) the
    four kernels at every bucket shape b), c) and e) gave them."""
    import numpy as np

    from gtsam_petercdev_torch.inference import elimination, kernels, symbolic
    from gtsam_petercdev_torch.linear import kalman, noise, sampler, spectral
    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.linear.subgraph import SubgraphSolver
    from gtsam_petercdev_torch.nonlinear import ekf
    from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
    from gtsam_petercdev_torch.nonlinear.optimizers import (
        LMParams, OptimizerParams, gauss_newton, levenberg_marquardt)
    from gtsam_petercdev_torch.geometry import pose2
    from gtsam_petercdev_torch.ops import cholesky_v2 as v2
    from gtsam_petercdev_torch.slam import initialize
    from gtsam_petercdev_torch.slam.factors import nonlinear_equality
    from gtsam_petercdev_torch.utils import convert, synthetic

    out, secs, launches = {}, {}, {k: 0 for k in KERNELS}
    shapes = set()
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t_phase = t_sub = time.perf_counter()

    def count_launches():
        for k, x in v1.launch_counts().items():
            launches[k] += x

    def lap(key):
        nonlocal t_sub
        secs[key] = time.perf_counter() - t_sub
        t_sub = time.perf_counter()

    # a) chordal initialization of the sphere (its between factors), CPU beside
    n_rings, n_per = INIT_SPHERE
    va, fa = synthetic.sphere_rings(n_rings, n_per, seed=SEED)
    g_btw = convert.graph_from_arrays(fa[1:], device=dev)
    v_start = convert.values_from_arrays(va, device=dev)
    sync()
    with PcgRecorder(sync) as rec:
        t0 = time.perf_counter()
        chordal = initialize.initialize_pose3_chordal(g_btw)
        sync()
        chordal_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with PcgRecorder(lambda: None) as rec_cpu:
        chordal_cpu = initialize.initialize_pose3_chordal(
            convert.graph_from_arrays(fa[1:], device="cpu"))
    cpu_s = time.perf_counter() - t0
    pc, pcc = chordal.params("Pose3"), chordal_cpu.params("Pose3")
    t_gap = ((pc.t.cpu() - pcc.t).abs().max() / pcc.t.abs().max()).item()
    r_gap = (pc.R.cpu() - pcc.R).abs().max().item()
    e_chordal, e_start = float(g_btw.error(chordal)), float(g_btw.error(v_start))
    out["a"] = dict(poses=n_rings * n_per, factors=len(fa[1][1]), ms=chordal_ms,
                    stages=[dict(ms=ms, pcg_iterations=it) for ms, it in rec.stages],
                    cpu_stages_iterations=[it for _, it in rec_cpu.stages], cpu_s=cpu_s,
                    t_rel=t_gap, R_abs=r_gap, error_chordal=e_chordal, error_start=e_start)
    log(f"init a) chordal on sphere_rings({n_rings}, {n_per}): {chordal_ms:.3f} ms in all; "
        + "; ".join(f"stage {i + 1} {ms:.3f} ms, {it} PCG iterations"
                    for i, (ms, it) in enumerate(rec.stages))
        + f" (CPU {cpu_s:.1f} s, iterations {[it for _, it in rec_cpu.stages]}); card against "
        f"the CPU: translations {t_gap:.3e} x max|t| (gate 1e-6), rotation entries {r_gap:.3e} "
        f"(gate 1e-6); between factors' error {e_chordal:.6e} at the chordal estimate, "
        f"{e_start:.6e} at the sphere's perturbed start")
    if not (t_gap <= 1e-6 and r_gap <= 1e-6 and e_chordal < e_start):
        raise AssertionError("init a): the chordal estimate failed its gates")
    del chordal_cpu

    # GN from the chordal estimate (a Pose3 prior on pose 0 at it), beside GN
    # from the perturbed start on the sphere's own graph
    p0 = chordal.at(0)
    g_init = convert.graph_from_arrays(
        [("PriorPose3", np.zeros((1, 1), dtype=np.int64),
          (p0.R[None].cpu().numpy(), p0.t[None].cpu().numpy()),
          noise.isotropic(6, 0.1, np.float64)[None])] + fa[1:], device=dev)
    g_full = convert.graph_from_arrays(fa, device=dev)
    # one structure (the sphere's: the prior's batch, then the betweens'): one plan
    lg_full = g_full.linearize(v_start)
    elimination.set_graph_plan(g_init, lg_full, *elimination._graph_plan(g_full, lg_full))
    del lg_full
    gn_p = OptimizerParams(solver="multifrontal", max_iterations=INIT_GN_ITERS)
    v1.reset_launch_counts()
    with counting_plain() as plain_a, EliminationRecorder() as er_a:
        gn_init = gauss_newton(g_init, chordal, gn_p, device=dev)
        gn_start = gauss_newton(g_full, v_start, gn_p, device=dev)
    sync()
    count_launches()
    out["a"].update(gn_chordal=dict(iterations=gn_init.iterations, history=gn_init.error_history),
                    gn_start=dict(iterations=gn_start.iterations, history=gn_start.error_history),
                    bad_pivots=er_a.bad, plain_calls=dict(plain_a))
    log(f"init a) GN from the chordal estimate: {gn_init.error_history[0]:.6e} -> "
        f"{gn_init.error:.6e} in {gn_init.iterations} iterations; GN from the perturbed start "
        f"(the sphere's prior): {gn_start.error_history[0]:.6e} -> {gn_start.error:.6e} in "
        f"{gn_start.iterations}; bad pivots {er_a.bad}; plain versions {dict(plain_a)}")
    check_result(gn_init, "init a) GN from chordal")
    if er_a.bad or (dev == "cuda" and plain_a):
        raise AssertionError("init a): bad pivots or a plain version on the card")
    lap("a")

    # b) LAGO on the whole City graph, then LM from it and from dead reckoning
    lines, gt = synthetic.city_stream(INIT_CITY_POSES, seed=SEED)
    path = write_stream(here, lines, len(lines))
    keys, meas = city_edges(lines)
    n_loop = int(np.sum(keys[:, 1] != keys[:, 0] + 1))
    g_city = city_graph(torch, path, range(len(lines)), dev)
    t0 = time.perf_counter()
    lago = initialize.initialize_pose2_lago(g_city)
    sync()
    lago_ms = (time.perf_counter() - t0) * 1e3
    lago_cpu = initialize.initialize_pose2_lago(city_graph(torch, path, range(len(lines)), "cpu"))
    a_, b_ = lago.params("Pose2").cpu(), lago_cpu.params("Pose2")
    lago_rel = ((a_ - b_).abs().max() / b_.abs().max()).item()
    dr = pose_values(torch, range(INIT_CITY_POSES),
                     dead_reckoning(synthetic, keys, meas, INIT_CITY_POSES), dev)
    e_lago, e_dr = float(g_city.error(lago)), float(g_city.error(dr))
    maps_b, facts_b = plan_line(elimination, symbolic, g_city, lago, "init b) City")
    out["b"] = dict(poses=INIT_CITY_POSES, factors=len(lines), loop_closures=n_loop,
                    lago_ms=lago_ms, lago_rel_cpu=lago_rel, error_lago=e_lago,
                    error_dead_reckoning=e_dr, ate_lago=pose2_ate(lago, gt),
                    ate_dead_reckoning=pose2_ate(dr, gt), plan=facts_b)
    log(f"init b) City: {INIT_CITY_POSES} poses, {len(lines)} between factors ({n_loop} loop "
        f"closures); LAGO {lago_ms:.3f} ms, card against the CPU rel {lago_rel:.3e} (gate "
        f"1e-9); error at LAGO {e_lago:.6e} (ATE {out['b']['ate_lago']:.6f} m), at dead "
        f"reckoning {e_dr:.6e} (ATE {out['b']['ate_dead_reckoning']:.6f} m; gate: LAGO's ATE "
        f"below; LAGO weighs every edge alike, the graph's loop closures sigma 10)")
    if not (lago_rel <= 1e-9 and out["b"]["ate_lago"] < out["b"]["ate_dead_reckoning"]):
        raise AssertionError("init b): LAGO failed its gates")
    lm_p = LMParams(solver="multifrontal", max_iterations=INIT_CITY_LM_ITERS)
    for name, start in (("lago", lago), ("dead_reckoning", dr)):
        v1.reset_launch_counts()
        t0 = time.perf_counter()
        with counting_plain() as plain_b, EliminationRecorder() as er_b:
            res = levenberg_marquardt(g_city, start, lm_p, device=dev)
            sync()
        lm_s = time.perf_counter() - t0
        lc = v1.launch_counts()
        count_launches()
        shapes |= er_b.shapes
        check_result(res, f"init b) LM from {name}")
        per_it = {k: x / max(1, res.iterations) for k, x in lc.items()}
        out["b"]["lm_" + name] = dict(iterations=res.iterations, error=res.error,
                                      history=res.error_history, s=lm_s,
                                      ate=pose2_ate(res.values, gt), launches=lc,
                                      launches_per_iteration=per_it, bad_pivots=er_b.bad,
                                      plain_calls=dict(plain_b))
        log(f"init b) LM from {name}: {res.error_history[0]:.6e} -> {res.error:.6e} in "
            f"{res.iterations} iterations ({lm_s:.2f} s, {1e3 * lm_s / max(1, res.iterations):.1f}"
            f" ms an iteration), ATE {out['b']['lm_' + name]['ate']:.6f} m; launches {lc} ("
            + ", ".join(f"{k} {x:.1f}" for k, x in per_it.items()) + " an iteration); bad "
            f"pivots {er_b.bad}; plain versions {dict(plain_b)}")
        if er_b.bad or (dev == "cuda" and plain_b):
            raise AssertionError(f"init b): bad pivots or a plain version on the card ({name})")
    del g_city, lago, lago_cpu, dr
    lap("b")

    # c) the subgraph-preconditioned solve of sphere_rings(
    # INIT_SUBGRAPH_SPHERE) (its prior: one variable type) linearized at its
    # perturbed start
    lam = 1e-6
    va_s, fa_s = synthetic.sphere_rings(*INIT_SUBGRAPH_SPHERE, seed=SEED)
    g_sub = convert.graph_from_arrays(fa_s, device=dev)
    lg = g_sub.linearize(convert.values_from_arrays(va_s, device=dev))
    t0 = time.perf_counter()
    sol = SubgraphSolver(lg)
    setup_s = time.perf_counter() - t0
    tree_facts = plan_facts(elimination, sol.maps)
    log(f"init c) subgraph: tree of {int(sum(m.sum() for m in sol.masks))} factors "
        f"(set-up {setup_s:.1f} s): {tree_facts['cliques']} cliques, {tree_facts['levels']} "
        f"levels, {tree_facts['buckets']} buckets, routing {tree_facts['routes']}")
    with counting_plain() as plain_c, EliminationRecorder() as er_c:
        v1.reset_launch_counts()
        chol = sol.factor(lam)
        sync()
        factor_launches = v1.launch_counts()
        r = linsolve.gradient(lg)["Pose3"]
        v1.reset_launch_counts()
        elimination.multifrontal_apply(sol.maps, chol, r)
        sync()
        apply_launches = v1.launch_counts()
        v1.reset_launch_counts()
        with PcgRecorder(sync) as rec_c:
            t0 = time.perf_counter()
            x_sub = sol.solve(lam, tol=INIT_SUBGRAPH_TOL, max_iters=INIT_SUBGRAPH_MAX_ITERS)
            sync()
            solve_ms = (time.perf_counter() - t0) * 1e3
        solve_launches = v1.launch_counts()
        count_launches()
    shapes |= er_c.shapes

    def med_ms(fn, reps=5):
        ts = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[reps // 2]

    factor_ms = med_ms(lambda: sol.factor(lam))
    apply_ms = med_ms(lambda: elimination.multifrontal_apply(sol.maps, chol, r))
    _, maps_sph = elimination._graph_plan(g_sub, lg)
    x_mf = elimination.multifrontal_solve(maps_sph, tuple((lb.A, lb.b) for lb in lg.batches), lam)
    mf_ms = med_ms(lambda: elimination.multifrontal_solve(
        maps_sph, tuple((lb.A, lb.b) for lb in lg.batches), lam))
    sub_gap = ((x_sub["Pose3"] - x_mf).abs().max() / x_mf.abs().max()).item()
    out["c"] = dict(lam=lam, pcg_iterations=rec_c.hvps, tol=INIT_SUBGRAPH_TOL,
                    max_iters=INIT_SUBGRAPH_MAX_ITERS,
                    solve_ms=solve_ms, factor_ms=factor_ms,
                    apply_ms=apply_ms, multifrontal_ms=mf_ms, rel_multifrontal=sub_gap,
                    tree_plan=tree_facts, setup_s=setup_s, launches_solve=solve_launches,
                    launches_factor=factor_launches, launches_apply=apply_launches,
                    bad_pivots=er_c.bad, plain_calls=dict(plain_c))
    log(f"init c) SubgraphSolver.solve(lam={lam:g}, tol {INIT_SUBGRAPH_TOL:g}, max_iters "
        f"{INIT_SUBGRAPH_MAX_ITERS}): {rec_c.hvps} PCG iterations, {solve_ms:.3f} ms (the tree "
        f"factor {factor_ms:.3f} ms, an apply {apply_ms:.3f} ms, median of 5; the multifrontal "
        f"solve {mf_ms:.3f} ms); against the multifrontal solve {sub_gap:.3e} x max|x| (gate "
        f"1e-8); launches a solve {solve_launches}, the factor {factor_launches}, "
        f"an apply {apply_launches}; bad pivots {er_c.bad}; plain versions {dict(plain_c)}")
    if not (sub_gap <= 1e-8 and er_c.bad == 0 and not (dev == "cuda" and plain_c)):
        raise AssertionError("init c): the subgraph solve failed its gates")
    del sol, chol, lg, x_mf, g_sub
    lap("c")

    # d) the exact constrained dense LM: the first INIT_DENSE_POSES poses of
    # the City stream, pose 0 pinned by nonlinear_equality
    def pinned_city(n, device):
        ft, sq, mask = nonlinear_equality("Pose2")
        g = NonlinearFactorGraph(device=device)
        g.add(ft, [0], np.zeros(3), sq, constrained_mask=mask)
        for (a, b), m in zip(keys, meas):
            if a < n and b < n:
                add_city_factor(g, int(a), int(b), (m,))
        return g, pose_values(torch, range(n), dead_reckoning(synthetic, keys, meas, n), device)

    g_d, v_d = pinned_city(INIT_DENSE_POSES, dev)
    pin = lambda v: v.at(0).double().cpu().numpy()
    dense_p = LMParams(solver="dense", max_iterations=INIT_DENSE_ITERS)
    t0 = time.perf_counter()
    with ErrorRecorder(g_d, pin) as er_d:
        res_d = levenberg_marquardt(g_d, v_d, dense_p, device=dev)
        sync()
    dense_s = time.perf_counter() - t0
    pin_gap = max(np.abs(p).max() for p in er_d.at(res_d.error_history))
    check_result(res_d, "init d) constrained LM")
    hist = {}
    for d_ in dict.fromkeys((dev, "cpu")):
        hist[d_] = levenberg_marquardt(*pinned_city(INIT_DENSE_CUT, d_), dense_p,
                                       device=d_).error_history
    d_rel = max(abs(a - b) / abs(b) for a, b in zip(hist[dev], hist["cpu"]))
    out["d"] = dict(poses=INIT_DENSE_POSES, iterations=res_d.iterations,
                    history=res_d.error_history, s=dense_s,
                    ms_per_iteration=1e3 * dense_s / max(1, res_d.iterations), pin_abs=pin_gap,
                    cut_poses=INIT_DENSE_CUT, cut_history=hist[dev], cut_rel=d_rel,
                    ate=pose2_ate(res_d.values, gt))
    log(f"init d) constrained dense LM, {INIT_DENSE_POSES} poses, pose 0 pinned by "
        f"nonlinear_equality: {res_d.error_history[0]:.6e} -> {res_d.error:.6e} in "
        f"{res_d.iterations} iterations ({out['d']['ms_per_iteration']:.1f} ms an iteration); "
        f"pose 0 at every accepted step within {pin_gap:.3e} of its pin (gate 1e-12); "
        f"{INIT_DENSE_CUT} poses on {dev} against the CPU: rel {d_rel:.3e} (gate 1e-9)")
    if not (pin_gap <= 1e-12 and len(hist[dev]) == len(hist["cpu"]) and d_rel <= 1e-9):
        raise AssertionError("init d): the constrained LM failed its gates")
    del g_d, v_d, res_d
    lap("d")

    # e1) BetweenFactorEM on the sphere with outliers, beside plain factors
    va_o, plain_fa, em_fa, truth_o, outliers = synthetic.sphere_rings_outliers(
        n_rings, n_per, seed=SEED, share=INIT_OUTLIER_SHARE)
    v_o = convert.values_from_arrays(va_o, device=dev)
    em_p = LMParams(solver="multifrontal", max_iterations=INIT_EM_ITERS)
    e_res = {}
    for name, fa_ in (("em", em_fa), ("plain", plain_fa)):
        g_ = convert.graph_from_arrays(fa_, device=dev)
        if name == "em":
            step_rel, bad0 = dense_step_rel(torch, elimination, linsolve, g_, v_o,
                                            LMParams().lambda_initial)
            lg_em = g_.linearize(v_o)
            em_plan = elimination._graph_plan(g_, lg_em)
        else:  # one structure (prior, odometry, loop closures): the EM graph's plan
            elimination.set_graph_plan(g_, lg_em, *em_plan)
        v1.reset_launch_counts()
        t0 = time.perf_counter()
        with counting_plain() as plain_e, EliminationRecorder() as er_e:
            res = levenberg_marquardt(g_, v_o, em_p, device=dev)
            sync()
        count_launches()
        shapes |= er_e.shapes
        check_result(res, f"init e1) LM {name}")
        e_res[name] = dict(iterations=res.iterations, history=res.error_history,
                           s=time.perf_counter() - t0, ate=pose3_ate(res.values, truth_o[1]),
                           bad_pivots=er_e.bad, plain_calls=dict(plain_e))
        if er_e.bad or (dev == "cuda" and plain_e):
            raise AssertionError(f"init e1): bad pivots or a plain version ({name})")
    out["e1"] = dict(outliers=len(outliers), step_rel=step_rel, step_bad_pivots=bad0,
                     ate_start=pose3_ate(v_o, truth_o[1]), **e_res)
    log(f"init e1) {len(outliers)} of {len(em_fa[2][1])} loop closures outliers; LM with "
        f"BetweenFactorEMPose3: {e_res['em']['history'][0]:.6e} -> {e_res['em']['history'][-1]:.6e}"
        f" in {e_res['em']['iterations']} iterations ({e_res['em']['s']:.1f} s), ATE "
        f"{e_res['em']['ate']:.6f} m; with plain between factors: ATE {e_res['plain']['ate']:.6f} m "
        f"in {e_res['plain']['iterations']} iterations (start {out['e1']['ate_start']:.6f} m); "
        f"first damped step against the dense oracle {step_rel:.3e} x its largest entry (gate "
        f"1e-8), bad pivots {bad0}")
    if not (e_res["em"]["ate"] < e_res["plain"]["ate"] and step_rel <= 1e-8 and bad0 == 0):
        raise AssertionError("init e1): EM failed its gates")
    del v_o, lg_em, em_plan
    lap("e1")

    # e2) rolling-shutter BA, e3) inverse-depth SLAM: the scene, then its cut
    for key, make, full, label in (
            ("e2", synthetic.rolling_shutter_scene, INIT_RS, "rolling-shutter BA"),
            ("e3", synthetic.inv_depth_scene, INIT_INV_DEPTH, "inverse-depth SLAM")):
        va_s, fa_s, truth_s = make(*full, seed=SEED)
        g_s = convert.graph_from_arrays(fa_s, device=dev)
        v_s = convert.values_from_arrays(va_s, device=dev)
        maps_s, facts_s = plan_line(elimination, symbolic, g_s, v_s, f"init {key}) {label}")
        v1.reset_launch_counts()
        t0 = time.perf_counter()
        with counting_plain() as plain_s, EliminationRecorder() as er_s:
            res = levenberg_marquardt(g_s, v_s, LMParams(solver="multifrontal",
                                                         max_iterations=INIT_CAM_ITERS),
                                      device=dev)
            sync()
        lm_s = time.perf_counter() - t0
        lc = v1.launch_counts()
        count_launches()
        shapes |= er_s.shapes
        check_result(res, f"init {key}) LM")
        cut_n = (INIT_CAM_CUT, full[1] * INIT_CAM_CUT // full[0], full[2])
        va_c, fa_c, _ = make(*cut_n, seed=SEED)
        step_rel, bad0 = dense_step_rel(torch, elimination, linsolve,
                                        convert.graph_from_arrays(fa_c, device=dev),
                                        convert.values_from_arrays(va_c, device=dev),
                                        LMParams().lambda_initial)
        hist = {}
        for d_ in dict.fromkeys((dev, "cpu")):
            hist[d_] = levenberg_marquardt(
                convert.graph_from_arrays(fa_c, device=d_), convert.values_from_arrays(va_c, device=d_),
                LMParams(solver="multifrontal", max_iterations=INIT_CAM_CUT_ITERS),
                device=d_).error_history
        c_rel = max(abs(a - b) / abs(b) for a, b in zip(hist[dev], hist["cpu"]))
        per_it = {k: x / max(1, res.iterations) for k, x in lc.items()}
        out[key] = dict(shape=full, variables=len(v_s), factors={n: len(k) for n, k, _, _ in fa_s},
                        plan=facts_s, iterations=res.iterations, history=res.error_history,
                        s=lm_s, ms_per_iteration=1e3 * lm_s / max(1, res.iterations),
                        launches=lc, launches_per_iteration=per_it, bad_pivots=er_s.bad,
                        plain_calls=dict(plain_s), cut=cut_n, step_rel=step_rel,
                        step_bad_pivots=bad0, cut_history=hist[dev], cut_rel=c_rel)
        log(f"init {key}) {label} {full}: LM {res.error_history[0]:.6e} -> {res.error:.6e} in "
            f"{res.iterations} iterations ({lm_s:.2f} s); launches {lc} ("
            + ", ".join(f"{k} {x:.1f}" for k, x in per_it.items()) + " an iteration); bad pivots "
            f"{er_s.bad}; plain versions {dict(plain_s)}; the cut {cut_n}: first damped step "
            f"against the dense oracle {step_rel:.3e} x its largest entry (gate 1e-8, bad pivots "
            f"{bad0}), LM on {dev} against the CPU rel {c_rel:.3e} (gate 1e-9)")
        if not (er_s.bad == 0 and not (dev == "cuda" and plain_s) and step_rel <= 1e-8
                and bad0 == 0 and len(hist[dev]) == len(hist["cpu"]) and c_rel <= 1e-9):
            raise AssertionError(f"init {key}): {label} failed its gates")
        del g_s, v_s, res
        lap(key)

    # f) Kalman filter + RTS over a bank of constant-velocity tracks
    T, B = INIT_KF[1], INIT_KF[0]
    rng = np.random.default_rng(SEED)
    F = np.eye(4)
    F[0, 2] = F[1, 3] = 0.1
    Qn, Hm, Rn = np.diag([1e-4, 1e-4, 1e-2, 1e-2]), np.eye(2, 4), 0.05 * np.eye(2)
    z = rng.normal(size=(T, B, 2)) * 0.2 + np.cumsum(rng.normal(size=(T, B, 2)) * 0.1, axis=0)

    def kf_bank(device, tracks=slice(None)):
        t = lambda a: torch.as_tensor(a, dtype=torch.float64).to(device)
        Ft, Qt, Ht, Rt, zt = t(F), t(Qn), t(Hm), t(Rn), t(z[:, tracks])
        n = zt.shape[1]
        s = kalman.init(torch.zeros((n, 4), dtype=torch.float64, device=device),
                        torch.eye(4, dtype=torch.float64, device=device).expand(n, 4, 4))
        mf, Pf, mp, Pp = [], [], [], []
        for k in range(T):
            sp = kalman.predict(s, Ft, Q=Qt)
            s = kalman.update(sp, Ht, zt[k], Rt)
            mp.append(sp.mean), Pp.append(sp.cov), mf.append(s.mean), Pf.append(s.cov)
        filt = kalman.GaussianState(torch.stack(mf), torch.stack(Pf))
        pred = kalman.GaussianState(torch.stack(mp), torch.stack(Pp))
        return kalman.smooth_rts(filt, pred, Ft.expand(T, 4, 4))

    kf_bank(dev)
    sync()
    t0 = time.perf_counter()
    sm = kf_bank(dev)
    sync()
    kf_ms = (time.perf_counter() - t0) * 1e3
    # the tracks are independent: the CPU filters a spread of them alone
    pick = np.linspace(0, B - 1, INIT_KF_CPU_TRACKS).round().astype(np.int64)
    t0 = time.perf_counter()
    sm_cpu = kf_bank("cpu", pick)
    kf_cpu_s = time.perf_counter() - t0
    kf_rel = max(((a[:, pick].cpu() - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(sm, sm_cpu))
    del sm, sm_cpu

    def ekf_run(device):
        rng_e = np.random.default_rng(1)
        t = lambda a: torch.as_tensor(a, dtype=torch.float64).to(device)
        x, odo = t([0.0, 0.0, 0.0]), t([1.0, 0.0, 0.1])
        belief = ekf.ManifoldBelief(x, t(0.01 * np.eye(3)))
        Q, R = t(0.001 * np.eye(3)), t(0.01 * np.eye(2))
        zs = t(rng_e.normal(size=(INIT_EKF_STEPS, 2)) * 0.01)
        for k in range(INIT_EKF_STEPS):
            x = pose2.compose(x, odo)
            belief = ekf.predict(belief, "Pose2", lambda p: pose2.compose(p, odo), Q)
            belief = ekf.update(belief, "Pose2", lambda p: p[:2], x[:2] + zs[k], R)
        return belief

    t0 = time.perf_counter()
    bel = ekf_run(dev)
    sync()
    ekf_ms = (time.perf_counter() - t0) * 1e3
    bel_cpu = ekf_run("cpu")
    ekf_rel = max(((a.cpu() - b).abs().max() / b.abs().max()).item()
                  for a, b in ((bel.value, bel_cpu.value), (bel.cov, bel_cpu.cov)))
    log(f"init f) Kalman filter + RTS, {B} constant-velocity tracks x {T} steps batched over "
        f"the tracks: {kf_ms:.1f} ms; {len(pick)} of the tracks on the CPU ({kf_cpu_s:.1f} s) "
        f"against the card's rel "
        f"{kf_rel:.3e} (gate 1e-12); EKF Pose2 localization over {INIT_EKF_STEPS} steps: "
        f"{ekf_ms:.1f} ms, card against the CPU rel {ekf_rel:.3e} (gate 1e-12)")
    if not (kf_rel <= 1e-12 and ekf_rel <= 1e-12):
        raise AssertionError("init f): the filters differ between the card and the CPU")

    # the power methods over the sphere's H (matrix-free: linear/solve.hvp)
    def hvp_matvec(lg_):
        return lambda x: linsolve.flatten_delta(lg_, linsolve.hvp(lg_, linsolve.unflatten_delta(lg_, x)))

    lg_s = g_full.linearize(v_start)
    D = linsolve.offsets(lg_s)[1]
    v0 = torch.ones(D, dtype=torch.float64, device=g_full.device)
    sync()
    t0 = time.perf_counter()
    eig = spectral.min_eigenvalue_shifted(hvp_matvec(lg_s), D, v0)
    sync()
    eig_ms = (time.perf_counter() - t0) * 1e3
    del lg_s
    va_e, fa_e = synthetic.sphere_rings(*INIT_EIG_CUT, seed=SEED)
    eig_cut = {}
    for d_ in dict.fromkeys((dev, "cpu")):
        lg_e = convert.graph_from_arrays(fa_e, device=d_).linearize(
            convert.values_from_arrays(va_e, device=d_))
        De = linsolve.offsets(lg_e)[1]
        eig_cut[d_] = spectral.min_eigenvalue_shifted(
            hvp_matvec(lg_e), De, torch.ones(De, dtype=torch.float64, device=lg_e.batches[0].b.device))
        if d_ == "cpu":
            ev = torch.linalg.eigvalsh(linsolve.assemble_dense(lg_e)[0])
    ec, ep = float(eig_cut[dev].eigenvalue), float(eig_cut["cpu"].eigenvalue)
    eig_rel = abs(ec - ep) / abs(ep)
    eig_true = float(ev[0])
    log(f"init f) min_eigenvalue_shifted of the sphere's H ({D} x {D}, hvp matvec): "
        f"{float(eig.eigenvalue):.9e} after {eig.iterations} iterations (converged "
        f"{eig.converged}), {eig_ms:.1f} ms; on sphere_rings{INIT_EIG_CUT}: card {ec:.9e}, CPU "
        f"{ep:.9e} ({eig_cut[dev].iterations} / {eig_cut['cpu'].iterations} iterations): rel "
        f"{eig_rel:.3e} (gate 1e-9); eigvalsh of the dense H: min {eig_true:.9e}, max "
        f"{float(ev[-1]):.9e} (the JAX package's estimated beta leaves the accelerated method "
        f"unconverged: rel {abs(ec - eig_true) / eig_true:.3e} from eigvalsh, reported)")
    if not (eig_rel <= 1e-9 and eig_cut[dev].iterations == eig_cut["cpu"].iterations):
        raise AssertionError("init f): the power methods differ between the card and the CPU")

    # the sampler: 10^6 draws from a full 6 x 6 Pose3 sqrt-information
    rng_s = np.random.default_rng(SEED)
    Lc = np.tril(rng_s.normal(size=(6, 6)) * 0.3) + np.diag([0.01] * 3 + [0.05] * 3)
    Sigma = Lc @ Lc.T
    Rs = np.linalg.cholesky(np.linalg.inv(Sigma)).T
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Rt = torch.as_tensor(Rs, dtype=torch.float64).to(dev)
    sync()
    t0 = time.perf_counter()
    eps = sampler.sample_sqrt_info(gen, Rt, shape=(INIT_SAMPLES,))
    sync()
    samp_ms = (time.perf_counter() - t0) * 1e3
    cov = torch.cov(eps.T).cpu().numpy()
    scale = np.sqrt(np.outer(np.diag(Sigma), np.diag(Sigma)))
    samp_gap = float(np.max(np.abs(cov - Sigma) / scale))
    del eps
    out["f"] = dict(kf_tracks=B, kf_steps=T, kf_ms=kf_ms, kf_cpu_s=kf_cpu_s, kf_rel=kf_rel,
                    ekf_steps=INIT_EKF_STEPS, ekf_ms=ekf_ms, ekf_rel=ekf_rel,
                    eig=dict(value=float(eig.eigenvalue), iterations=eig.iterations,
                             converged=eig.converged, ms=eig_ms),
                    eig_cut=dict(card=ec, cpu=ep, rel=eig_rel, eigvalsh_min=eig_true,
                                 eigvalsh_max=float(ev[-1])),
                    samples=INIT_SAMPLES, sample_ms=samp_ms, sample_cov_gap=samp_gap)
    log(f"init f) sample_sqrt_info: {INIT_SAMPLES} draws in {samp_ms:.1f} ms; sample covariance "
        f"against Sigma: largest |difference| / sqrt(Sigma_ii Sigma_jj) {samp_gap:.3e} (gate 1e-2)")
    if not samp_gap <= 1e-2:
        raise AssertionError("init f): the sampler's covariance is off")
    lap("f")

    # g) the four kernels at every bucket shape of b), c) and e)
    cases = sorted(shapes)
    errs = {}
    t0 = time.perf_counter()
    if dev == "cuda":
        check_kernels(torch, (v2, v1, kernels), cases, {"float64": {}, "float32": {}},
                      extras=False, errs_out=errs)
    out["g"] = dict(distinct=len(cases), shapes=cases, max_abs_err=errs)
    log(f"init g) {len(cases)} distinct (B, nf, ns, d) shapes of b), c) and e), each kernel "
        f"against its plain version in float64 and float32: max abs err {errs} "
        f"({time.perf_counter() - t0:.1f} s)")
    lap("g")
    out["launches"] = launches
    log(f"init launches (counters reset before each run of a)-e), read after): {launches}")
    if dev == "cuda" and not all(n > 0 for n in launches.values()):
        raise AssertionError(f"init: a kernel was never launched on the init path: {launches}")
    out["phase_s"] = time.perf_counter() - t_phase
    out["seconds"] = secs
    log(f"init phase: {out['phase_s']:.1f} s (" + ", ".join(
        f"{k}) {x:.1f} s" for k, x in secs.items()) + ")")
    return out


# --- phase 14: the robust and global front end ----------------------------------------------


def parse_lm_lambdas(text):
    """The lambda of each trial in LM's verbose lines."""
    return [float(ln.split("lam=")[1].split(":")[0]) for ln in text.splitlines()
            if ln.startswith("LM iter ")]


class LMRecorder:
    """Each `levenberg_marquardt` call while the context is open (the entry
    points call it through its module): the result, the wall seconds (the
    card synchronized after it), the graph, its launches (the counters set
    to 0 just before it and read just after), its trials, those rejected
    for bad pivots and those rejected by the model fidelity or a rise (the
    port's LM counters), and each trial's lambda (LM run verbose: its lines
    print floats the loop reads anyway)."""

    def __init__(self, v1, sync):
        self.v1, self.sync, self.calls = v1, sync, []

    def __enter__(self):
        import dataclasses

        from gtsam_petercdev_torch.nonlinear import optimizers

        self.mod, self.saved = optimizers, optimizers.levenberg_marquardt
        orig = self.saved

        def recorded(graph, values, params=None, *, device="cuda"):
            params = dataclasses.replace(params or optimizers.LMParams(), verbose=True)
            buf = io.StringIO()
            self.sync()
            self.v1.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res, counts = lm_counts(lambda: orig(graph, values, params, device=device))
            self.sync()
            trials, bad = counts["lm.trials"], counts["lm.bad_pivot_trials"]
            self.calls.append(dict(
                result=res, s=time.perf_counter() - t0, graph=graph,
                launches=self.v1.launch_counts(), trials=trials, bad_pivot_trials=bad,
                rejected_trials=trials - bad - (len(res.error_history) - 1),
                lambdas=parse_lm_lambdas(buf.getvalue())))
            return res

        optimizers.levenberg_marquardt = recorded
        return self

    def __exit__(self, *exc):
        self.mod.levenberg_marquardt = self.saved


class GncRecorder:
    """The ms of each weighted assembly (linearize, row scaling, the dense
    (H, g)) and each dense solve of `gnc`'s inner iterations while the
    context is open (the card synchronized on both sides)."""

    def __init__(self, sync):
        self.sync, self.assemble_ms, self.solve_ms = sync, [], []

    def __enter__(self):
        from gtsam_petercdev_torch.linear import solve as linsolve
        from gtsam_petercdev_torch.nonlinear import gnc

        self.mods = (gnc, linsolve)
        self.saved = (gnc._weighted_assemble, linsolve.dense_solve)

        def timed(fn, out):
            def run(*a, **k):
                self.sync()
                t0 = time.perf_counter()
                r = fn(*a, **k)
                self.sync()
                out.append((time.perf_counter() - t0) * 1e3)
                return r

            return run

        gnc._weighted_assemble = timed(self.saved[0], self.assemble_ms)
        linsolve.dense_solve = timed(self.saved[1], self.solve_ms)
        return self

    def __exit__(self, *exc):
        self.mods[0]._weighted_assemble, self.mods[1].dense_solve = self.saved


def gauged_angles(np, R, R_true):
    """Angles (rad) between R_i and the truth's gauged R_0^T R_i."""
    g = np.einsum("ij,njk->nik", R_true[0].T, R_true)
    c = (np.einsum("nij,nij->n", g, R) - 1.0) / 2.0
    return np.arccos(np.clip(c, -1.0, 1.0))


def dense_certificate(torch, shonan, m, Y):
    """lambda_min of the certificate S = L - blockdiag(Lambda) (3N x 3N)
    assembled dense at Y [N, 3, p], by torch.linalg.eigvalsh."""
    N = Y.shape[0]
    LY = shonan._connection_laplacian_matvec(m, N)(Y)
    Lam = torch.einsum("nap,nbp->nab", LY, Y)
    Lam = 0.5 * (Lam + Lam.transpose(-1, -2))
    dev, dt = Y.device, Y.dtype
    i = torch.as_tensor(m.i, dtype=torch.int64).to(dev)
    j = torch.as_tensor(m.j, dtype=torch.int64).to(dev)
    k = m.kappa[:, None, None].to(dt)
    eye = torch.eye(3, dtype=dt, device=dev).expand(len(i), 3, 3)
    a3 = torch.arange(3, device=dev)
    S = torch.zeros((3 * N, 3 * N), dtype=dt, device=dev)

    def put(r, c, blk):
        rows = (3 * r)[:, None, None] + a3[None, :, None]
        cols = (3 * c)[:, None, None] + a3[None, None, :]
        S.index_put_((rows.expand_as(blk), cols.expand_as(blk)), blk, accumulate=True)

    put(i, i, k * eye)
    put(j, j, k * eye)
    put(i, j, -k * m.R)
    put(j, i, -k * m.R.transpose(-1, -2))
    nn = torch.arange(N, device=dev)
    put(nn, nn, -Lam)
    lam = float(torch.linalg.eigvalsh(S)[0])
    del S
    return lam


def run_robust(torch, v1, dev="cuda"):
    """Phase 14 (float64): a) GNC-TLS on the sphere with outlier loop
    closures; b) the Shonan staircase on the sphere's rotations through the
    multifrontal route, level by level, and its default route card = CPU;
    c) MFAS and translation recovery on the sphere's directions; d) custom
    and linear-container factors on the sphere; e) the four kernels at
    every bucket shape b) and c) gave them (d)'s are phase 4's plan's,
    checked in phase 3)."""
    import numpy as np

    from gtsam_petercdev_torch.inference import elimination, kernels
    from gtsam_petercdev_torch.nonlinear import custom, gnc, optimizers
    from gtsam_petercdev_torch.nonlinear.optimizers import LMParams, OptimizerParams, gauss_newton
    from gtsam_petercdev_torch.ops import cholesky_v2 as v2
    from gtsam_petercdev_torch.geometry import pose3
    from gtsam_petercdev_torch.sfm import shonan, translation
    from gtsam_petercdev_torch.utils import convert, synthetic

    out, secs, launches = {}, {}, {k: 0 for k in KERNELS}
    shapes = set()
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t_phase = t_sub = time.perf_counter()

    def add_launches(counts):
        for k, x in counts.items():
            launches[k] += x

    def lap(key):
        nonlocal t_sub
        secs[key] = time.perf_counter() - t_sub
        t_sub = time.perf_counter()

    # a) GNC-TLS on the sphere's plain factors with outlier loop closures
    def gnc_run(shape, device):
        va, plain, _, truth, outl = synthetic.sphere_rings_outliers(*shape, seed=SEED)
        g = convert.graph_from_arrays(plain, device=device)
        v = convert.values_from_arrays(va, device=device)
        known = convert.gnc_known_inliers({0: np.ones(1), 1: np.ones(len(plain[1][1]))})
        return gnc.gnc(g, v, gnc.GncParams(known_inliers=known), device=device), truth, outl

    sync()
    t0 = time.perf_counter()
    with GncRecorder(sync) as rec:
        res, truth, outliers = gnc_run(ROBUST_SPHERE, dev)
    gnc_s = time.perf_counter() - t0
    n_inner = len(rec.solve_ms)
    flagged = np.flatnonzero(res.weights[2].cpu().numpy() < 0.5)
    hit = len(np.intersect1d(flagged, outliers))
    recall, precision = hit / max(1, len(outliers)), hit / max(1, len(flagged))
    ate = pose3_ate(res.values, truth[1])
    cut = {}
    for d_ in dict.fromkeys((dev, "cpu")):
        r_, _, _ = gnc_run(ROBUST_GNC_CUT, d_)
        p_ = r_.values.params("Pose3")
        cut[d_] = (r_.iterations, torch.cat([w.cpu() for w in r_.weights]),
                   p_.R.cpu(), p_.t.cpu())
    w_gap = (cut[dev][1] - cut["cpu"][1]).abs().max().item()
    p_gap = max((cut[dev][k] - cut["cpu"][k]).abs().max().item() for k in (2, 3))
    D = 6 * ROBUST_SPHERE[0] * ROBUST_SPHERE[1]
    out["a"] = dict(poses=D // 6, D=D, outer_iterations=res.iterations, inner_iterations=n_inner,
                    s=gnc_s, assemble_ms=float(np.mean(rec.assemble_ms)),
                    solve_ms=float(np.mean(rec.solve_ms)),
                    ms_per_inner=1e3 * gnc_s / max(1, n_inner), error=res.error,
                    outliers=len(outliers), flagged=len(flagged), recall=recall,
                    precision=precision, ate=ate, ate_em_phase13=EM_ATE,
                    ate_plain_phase13=PLAIN_ATE,
                    cut=ROBUST_GNC_CUT, cut_iterations=[cut[dev][0], cut["cpu"][0]],
                    cut_weights_abs=w_gap, cut_poses_abs=p_gap)
    log(f"robust a) GNC-TLS on sphere_rings_outliers{ROBUST_SPHERE} (D = {D}, dense): "
        f"{res.iterations} outer, {n_inner} inner iterations in {gnc_s:.2f} s "
        f"({out['a']['ms_per_inner']:.1f} ms an inner iteration: assembly "
        f"{out['a']['assemble_ms']:.3f} ms, dense solve {out['a']['solve_ms']:.3f} ms); weights "
        f"< 0.5 on {len(flagged)} loop closures: recall {recall:.4f}, precision {precision:.4f} "
        f"against the {len(outliers)} corrupted; ATE {ate:.6f} m (phase 13 e1): "
        f"BetweenFactorEMPose3 {EM_ATE} m, plain factors {PLAIN_ATE} m); "
        f"sphere_rings_outliers{ROBUST_GNC_CUT} card "
        f"against the CPU: outer iterations {cut[dev][0]} / {cut['cpu'][0]}, weights {w_gap:.3e}, "
        f"poses {p_gap:.3e} (gate {ROBUST_GNC_GATE})")
    if not (np.isfinite(res.error) and np.isfinite(ate) and cut[dev][0] == cut["cpu"][0]
            and w_gap <= ROBUST_GNC_GATE and p_gap <= ROBUST_GNC_GATE):
        raise AssertionError("robust a): GNC failed its gates")
    del res, cut
    lap("a")

    # b) the Shonan staircase on the sphere's rotations, every level
    va, fa = synthetic.sphere_rings(*ROBUST_SPHERE, seed=SEED)
    m = shonan.measurements_from_between_graph(convert.graph_from_arrays(fa, device=dev))
    R_true = synthetic.sphere_truth(*ROBUST_SPHERE)[0]
    certs = []
    orig_cert = shonan.certificate_min_eigenvalue

    def cert(m_, Y, iters=300, seed=0):
        sync()
        t0 = time.perf_counter()
        lam = orig_cert(m_, Y, iters, seed)
        certs.append(dict(p=Y.shape[-1], lam=lam, ms=(time.perf_counter() - t0) * 1e3, Y=Y))
        return lam

    lm_p = LMParams(solver="multifrontal", max_iterations=ROBUST_SHONAN_ITERS)
    shonan.certificate_min_eigenvalue = cert
    try:
        t0 = time.perf_counter()
        with LMRecorder(v1, sync) as lm_rec, counting_plain() as plain_b, \
                EliminationRecorder() as er_b:
            sres = shonan.shonan_averaging(m, *ROBUST_SHONAN_P, optimality_threshold=float("inf"),
                                           lm_params=lm_p, seed=SEED)
        staircase_s = time.perf_counter() - t0
    finally:
        shonan.certificate_min_eigenvalue = orig_cert
    shapes |= er_b.shapes
    levels = []
    for call, c in zip(lm_rec.calls, certs):
        r, p = call["result"], c["p"]
        add_launches(call["launches"])
        maps = next(iter(call["graph"]._mf_plans.values()))[1]
        log_routing(elimination, f"robust b) SO({p}) plan", maps)
        graph, vals = call["graph"], r.values

        def step(v, graph=graph):
            return v.retract(elimination.solve_linearized(graph, v, 1e-5)[0])

        prof = profile_step(torch, step, vals, top=5, reps=1, host=False) if dev == "cuda" else None
        t0 = time.perf_counter()
        lam_dense = dense_certificate(torch, shonan, m, c["Y"])
        eig_s = time.perf_counter() - t0
        ang = gauged_angles(np, shonan.round_solution(vals.params(f"SOn{p}")).cpu().numpy(), R_true)
        lev = dict(p=p, d=p * (p - 1) // 2, iterations=r.iterations, s=call["s"],
                   ms_per_iteration=1e3 * call["s"] / max(1, r.iterations),
                   error=[r.error_history[0], r.error], trials=call["trials"],
                   bad_pivot_trials=call["bad_pivot_trials"],
                   rejected_trials=call["rejected_trials"],
                   lambdas=call["lambdas"], launches=call["launches"],
                   plan=plan_facts(elimination, maps),
                   device_busy_ms=prof[0] if prof else None,
                   step_launches=prof[1] if prof else None,
                   lam_min=c["lam"], certificate_ms=c["ms"], lam_min_eigvalsh=lam_dense,
                   eigvalsh_s=eig_s, certified_default=c["lam"] >= -1e-4,
                   angle_max=float(ang.max()), angle_rms=float(np.sqrt(np.mean(ang * ang))))
        levels.append(lev)
        log(f"robust b) SO({p}) (d = {lev['d']}): LM {r.error_history[0]:.6e} -> {r.error:.6e} in "
            f"{r.iterations} iterations ({call['s']:.2f} s, {lev['ms_per_iteration']:.1f} ms an "
            f"iteration), {lev['trials']} trials ({lev['bad_pivot_trials']} with bad pivots, "
            f"{lev['rejected_trials']} rejected), lambda {lev['lambdas'][0]:.1e} .. "
            f"{min(lev['lambdas']):.1e} .. {lev['lambdas'][-1]:.1e}; launches {call['launches']}; "
            f"plan {lev['plan']}; "
            + (f"an LM step's device busy {prof[0]:.3f} ms, {prof[1]} kernels; " if prof else "")
            + f"certificate lambda_min {c['lam']:.9e} ({c['ms']:.1f} ms, 300 power steps), "
            f"eigvalsh of the dense S {lam_dense:.9e} ({eig_s:.2f} s); certified at -1e-4 "
            f"{lev['certified_default']}; rotations against the truth (gauged): max "
            f"{lev['angle_max']:.3e} rad, RMS {lev['angle_rms']:.3e} rad")
        check_result(r, f"robust b) SO({p}) LM")
    # the clamped pivots (EliminationRecorder: pivots) come from the trials LM
    # rejected for them, and only from those
    if (er_b.bad > 0) != any(lv["bad_pivot_trials"] for lv in levels) or (dev == "cuda" and plain_b):
        raise AssertionError("robust b): clamped pivots outside the rejected trials, or a plain "
                             "version on the card")
    del lm_rec, certs

    # the default route (pcg) card = CPU on a cut
    va_c, fa_c = synthetic.sphere_rings(*ROBUST_SHONAN_CUT, seed=SEED)
    sh = {}
    for d_ in dict.fromkeys((dev, "cpu")):
        m_c = shonan.measurements_from_between_graph(convert.graph_from_arrays(fa_c, device=d_))
        t0 = time.perf_counter()
        sh[d_] = (shonan.shonan_averaging(m_c, *ROBUST_SHONAN_P, seed=SEED),
                  time.perf_counter() - t0)
    deg = np.zeros(ROBUST_SHONAN_CUT[0] * ROBUST_SHONAN_CUT[1])
    kk = m_c.kappa.cpu().numpy()
    np.add.at(deg, m_c.i, kk)
    np.add.at(deg, m_c.j, kk)
    a_, b_ = sh[dev][0], sh["cpu"][0]
    rot_gap = (a_.rotations.cpu() - b_.rotations).abs().max().item()
    lam_gap = abs(a_.min_eigenvalue - b_.min_eigenvalue)
    lam_gate = 1e-9 * 2.0 * deg.max()
    out["b"] = dict(nodes=m.num_nodes, edges=m.num_edges, staircase_s=staircase_s,
                    p_final=sres.p_final, levels=levels, bad_pivots=er_b.bad,
                    plain_calls=dict(plain_b),
                    default_route_cut=dict(shape=ROBUST_SHONAN_CUT, p_final=[a_.p_final, b_.p_final],
                                           certified=[a_.certified, b_.certified],
                                           lam_min=[a_.min_eigenvalue, b_.min_eigenvalue],
                                           rotations_abs=rot_gap, lam_abs=lam_gap,
                                           s=[sh[dev][1], sh["cpu"][1]]))
    log(f"robust b) staircase on {m.num_nodes} rotations, {m.num_edges} measurements, p "
        f"{ROBUST_SHONAN_P[0]}..{ROBUST_SHONAN_P[1]} (every level): {staircase_s:.1f} s; pivots "
        f"clamped {er_b.bad} (in the trials LM rejected for them); plain versions "
        f"{dict(plain_b)}; the default route (pcg) on "
        f"sphere_rings{ROBUST_SHONAN_CUT}: p_final {a_.p_final} / {b_.p_final}, certified "
        f"{a_.certified} / {b_.certified}, lambda_min {a_.min_eigenvalue:.9e} / "
        f"{b_.min_eigenvalue:.9e} (card / CPU, {sh[dev][1]:.1f} / {sh['cpu'][1]:.1f} s): rotations "
        f"{rot_gap:.3e} (gate {ROBUST_ROT_GATE}), lambda_min {lam_gap:.3e} (gate {lam_gate:.3e})")
    if not (a_.p_final == b_.p_final and rot_gap <= ROBUST_ROT_GATE and lam_gap <= lam_gate
            and all(np.isfinite(lv["lam_min"]) for lv in levels)):
        raise AssertionError("robust b): the Shonan staircase failed its gates")
    lap("b")

    # c) MFAS and translation recovery on the sphere's directions
    def directions(shape):
        edges, dirs, t_true, flipped = synthetic.sphere_directions(*shape, seed=SEED)
        t0 = time.perf_counter()
        w = translation.mfas_outlier_weights([tuple(e) for e in edges.tolist()], dirs)
        keep = w <= ROBUST_MFAS_THRESHOLD
        anchor = float(np.linalg.norm(t_true[edges[0, 1]] - t_true[edges[0, 0]]))
        return edges, dirs, t_true - t_true[edges[0, 0]], flipped, keep, anchor, \
            time.perf_counter() - t0

    def recover(edges, dirs, anchor, device, solver="dense"):
        vals = translation.recover_translations(
            [tuple(e) for e in edges.tolist()], dirs, scale_anchor=anchor,
            params=LMParams(solver=solver, max_iterations=60), device=device)
        keys = np.asarray(vals.type_keys("Point3"))
        return keys, vals.params("Point3").cpu().numpy()

    def t_ate(keys, est, t_true):
        d = est - t_true[keys]
        return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))

    def collapsed(edges, keys, est):
        """Edges whose ends landed within 1e-3 m of each other: the
        direction residual's zero at t_i = t_j."""
        pos = dict(zip(keys.tolist(), est))
        return int(sum(np.linalg.norm(pos[a] - pos[b]) < 1e-3 for a, b in edges.tolist()))

    edges, dirs, t_true, flipped, keep, anchor, mfas_s = directions(ROBUST_SPHERE)
    n_flag_rev = int(np.sum(~keep[flipped]))
    rec_c = {}
    with LMRecorder(v1, sync) as lm_c, counting_plain() as plain_c, EliminationRecorder() as er_c:
        for solver in ("dense", "multifrontal"):
            keys, est = recover(edges[keep], dirs[keep], anchor, dev, solver)
            rec_c[solver] = (keys, est, t_ate(keys, est, t_true))
        ok = np.ones(len(edges), dtype=bool)
        ok[flipped] = False
        keys_o, est_o = recover(edges[ok], dirs[ok], anchor, dev)
    shapes |= er_c.shapes
    for call in lm_c.calls:
        add_launches(call["launches"])
    route_gap = np.abs(rec_c["dense"][1] - rec_c["multifrontal"][1]).max() / np.abs(
        rec_c["dense"][1]).max()
    cut_c = {}
    for d_ in dict.fromkeys((dev, "cpu")):
        e_, di_, tt_, _, kp_, an_, _ = directions(ROBUST_TRANS_CUT)
        cut_c[d_] = recover(e_[kp_], di_[kp_], an_, d_)[1]
    cut_gap = np.abs(cut_c[dev] - cut_c["cpu"]).max() / np.abs(cut_c["cpu"]).max()
    calls = {k: c for k, c in zip(("dense", "multifrontal", "oracle"), lm_c.calls)}
    out["c"] = dict(edges=len(edges), reversed=len(flipped), mfas_s=mfas_s,
                    threshold=ROBUST_MFAS_THRESHOLD, flagged=int(np.sum(~keep)),
                    flagged_reversed=n_flag_rev,
                    routes={k: dict(iterations=c["result"].iterations, s=c["s"],
                                    ms_per_iteration=1e3 * c["s"] / max(1, c["result"].iterations),
                                    error=c["result"].error, launches=c["launches"])
                            for k, c in calls.items()},
                    ate=rec_c["dense"][2], ate_multifrontal=rec_c["multifrontal"][2],
                    ate_true_reversed_dropped=t_ate(keys_o, est_o, t_true),
                    collapsed_edges=collapsed(edges[keep], *rec_c["dense"][:2]),
                    route_rel=float(route_gap), cut=ROBUST_TRANS_CUT, cut_rel=float(cut_gap),
                    bad_pivots=er_c.bad, plain_calls=dict(plain_c))
    log(f"robust c) {len(edges)} directions ({len(flipped)} reversed); MFAS over 8 axes "
        f"{mfas_s:.2f} s (host): {out['c']['flagged']} edges above {ROBUST_MFAS_THRESHOLD}, "
        f"{n_flag_rev} of them reversed; recovery without them: "
        + "; ".join(f"{k} {c['result'].iterations} LM iterations, {c['s']:.2f} s "
                    f"({out['c']['routes'][k]['ms_per_iteration']:.1f} ms an iteration), "
                    f"launches {c['launches']}" for k, c in calls.items())
        + f"; ATE (anchored scale) {rec_c['dense'][2]:.6f} m (multifrontal "
        f"{rec_c['multifrontal'][2]:.6f}; without the truly reversed edges instead "
        f"{out['c']['ate_true_reversed_dropped']:.6f} m); {out['c']['collapsed_edges']} of the "
        f"{int(keep.sum())} kept edges collapsed below 1e-3 m; dense against multifrontal "
        f"{route_gap:.3e} x max|t| (gate {ROBUST_TRANS_GATE}); sphere_directions"
        f"{ROBUST_TRANS_CUT} card against the CPU {cut_gap:.3e} (gate 1e-9); bad pivots "
        f"{er_c.bad}; plain versions {dict(plain_c)}")
    if not (route_gap <= ROBUST_TRANS_GATE and cut_gap <= 1e-9 and er_c.bad == 0
            and not (dev == "cuda" and plain_c) and np.isfinite(rec_c["dense"][2])):
        raise AssertionError("robust c): translation recovery failed its gates")
    lap("c")

    # d) the sphere's between factors as a custom factor; linear containers
    def between_err(xs, measured):
        x1, x2 = xs
        return pose3.local(measured, pose3.between(x1, x2))

    g_ref = convert.graph_from_arrays(fa, device=dev)
    v0 = convert.values_from_arrays(va, device=dev)
    name, keys, (R, t), info = fa[1]
    g_cus = convert.graph_from_arrays(fa[:1], device=dev)
    g_cus.add_batch(custom.custom_factor("CustomBetweenPose3", ("Pose3", "Pose3"), 6, between_err),
                    keys, pose3.Pose3(torch.as_tensor(R), torch.as_tensor(t)), info)
    lg0 = g_ref.linearize(v0)
    plan = elimination._graph_plan(g_ref, lg0)  # one structure: one plan
    elimination.set_graph_plan(g_cus, g_cus.linearize(v0), *plan)
    tol_p = LMParams(solver="multifrontal", relative_error_tol=ROBUST_CUSTOM_TOL,
                     absolute_error_tol=ROBUST_CUSTOM_TOL)
    with LMRecorder(v1, sync) as lm_d, counting_plain() as plain_d, EliminationRecorder() as er_d:
        r_ref = optimizers.levenberg_marquardt(g_ref, v0, tol_p, device=dev)
        r_cus = optimizers.levenberg_marquardt(g_cus, v0, tol_p, device=dev)
        step, _ = elimination.solve_linearized(g_ref, v0, 0.0, cache={"mf_lg": lg0})
        g_lc = custom.linear_container_graph(g_ref, v0)
        elimination.set_graph_plan(g_lc, g_lc.linearize(v0), *plan)
        v1.reset_launch_counts()
        gn = gauss_newton(g_lc, v0, OptimizerParams(solver="multifrontal", max_iterations=1),
                          device=dev)
        sync()
        gn_launches = v1.launch_counts()
    # d)'s plan is phase 4's sphere optimizer plan: phase 3 checks its shapes
    add_launches(gn_launches)
    for call in lm_d.calls:
        add_launches(call["launches"])
    moved = v0.local(gn.values)["Pose3"]
    step_gap = ((moved - step["Pose3"]).abs().max() / step["Pose3"].abs().max()).item()
    gap = (r_cus.error - r_ref.error) / r_ref.error
    cb, cc = lm_d.calls
    out["d"] = dict(builtin=dict(iterations=r_ref.iterations, error=r_ref.error, s=cb["s"],
                                 ms_per_iteration=1e3 * cb["s"] / max(1, r_ref.iterations),
                                 launches=cb["launches"]),
                    custom=dict(iterations=r_cus.iterations, error=r_cus.error, s=cc["s"],
                                ms_per_iteration=1e3 * cc["s"] / max(1, r_cus.iterations),
                                launches=cc["launches"]),
                    rel_gap=gap, gn_step_rel=step_gap, gn_launches=gn_launches,
                    bad_pivots=er_d.bad, plain_calls=dict(plain_d))
    log(f"robust d) the sphere's between factors through custom_factor (forward mode): LM "
        f"{r_cus.error_history[0]:.9e} -> {r_cus.error:.9e} in {r_cus.iterations} iterations "
        f"({out['d']['custom']['ms_per_iteration']:.1f} ms an iteration); the built-in batch "
        f"(analytic Jacobians) -> {r_ref.error:.9e} in {r_ref.iterations} "
        f"({out['d']['builtin']['ms_per_iteration']:.1f} ms an iteration): rel {gap:.3e} (gate "
        f"{ROBUST_CUSTOM_GATE}; the built-in linearization drops the chart's Local term); one GN "
        f"step of the linear containers against the multifrontal step {step_gap:.3e} x its "
        f"largest entry (gate {ROBUST_STEP_GATE}), launches {gn_launches}; bad pivots {er_d.bad}; "
        f"plain versions {dict(plain_d)}")
    if not (abs(gap) <= ROBUST_CUSTOM_GATE and step_gap <= ROBUST_STEP_GATE and er_d.bad == 0
            and not (dev == "cuda" and plain_d)):
        raise AssertionError("robust d): the custom / linear-container factors failed their gates")
    del g_ref, g_cus, g_lc, lg0
    lap("d")

    # e) the four kernels at every bucket shape of b) and c)
    cases = sorted(shapes)
    errs = {}
    t0 = time.perf_counter()
    if dev == "cuda":
        check_kernels(torch, (v2, v1, kernels), cases, {"float64": {}, "float32": {}},
                      extras=False, errs_out=errs)
    out["e"] = dict(distinct=len(cases), shapes=cases, max_abs_err=errs)
    log(f"robust e) {len(cases)} distinct (B, nf, ns, d) shapes of b) and c) (d = "
        f"{sorted({c[3] for c in cases})}), each kernel against its plain version in float64 and "
        f"float32: max abs err {errs} ({time.perf_counter() - t0:.1f} s)")
    lap("e")
    out["launches"] = launches
    log(f"robust launches (counters reset before each solve of b)-d), read after): {launches}")
    if dev == "cuda" and not all(n > 0 for n in launches.values()):
        raise AssertionError(f"robust: a kernel was never launched on the robust path: {launches}")
    out["phase_s"] = time.perf_counter() - t_phase
    out["seconds"] = secs
    log(f"robust phase: {out['phase_s']:.1f} s (" + ", ".join(
        f"{k}) {x:.1f} s" for k, x in secs.items()) + ")")
    return out


# --- phase 15: the extended geometry, constrained optimization, bases -------------------


def radius_constraint(xs, r):
    """||t|| - r of a Pose3 batch: phase 15 f)'s constraint (one g for all)."""
    t = xs[0].t
    return (t * t).sum(dim=-1, keepdim=True).sqrt() - r[..., None]


def run_geometry(torch, v1, dev="cuda"):
    """Phase 15 (float64): a) planar landmark SLAM; b) a Sim3 pose graph; c)
    plane SLAM; d) two-view essential matrices; e) the other factor types
    and the geometry extras, small, card = CPU; f) augmented Lagrangian and
    penalty on the constrained sphere, the basis fits and the host QP / LP;
    g) the four kernels at every bucket shape a)-f) gave them."""
    import numpy as np

    from gtsam_petercdev_torch import basis, constrained
    from gtsam_petercdev_torch.constrained import constrained as con_mod
    from gtsam_petercdev_torch.constrained import qp
    from gtsam_petercdev_torch.geometry import essential, extra, pose3, so3, unit3
    from gtsam_petercdev_torch.inference import elimination, kernels, symbolic
    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.nonlinear import optimizers
    from gtsam_petercdev_torch.nonlinear.optimizers import LMParams, OptimizerParams
    from gtsam_petercdev_torch.ops import cholesky_v2 as v2
    from gtsam_petercdev_torch.slam import extra_factors, factors
    from gtsam_petercdev_torch.utils import convert, synthetic

    out, secs, launches = {}, {}, {k: 0 for k in KERNELS}
    shapes = set()
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t_phase = t_sub = time.perf_counter()

    def add_launches(counts):
        for k, x in counts.items():
            launches[k] += x

    def lap(key):
        nonlocal t_sub
        secs[key] = time.perf_counter() - t_sub
        t_sub = time.perf_counter()

    def hist_gap(a, b, to_start=False):
        """Largest relative gap of two LM error histories, entry by entry
        (atol 1e-12), or relative to the start's error (to_start: e)'s
        noise-free graphs fall 1e5x a step, so a later entry is mostly
        cancellation)."""
        if len(a) != len(b):
            return float("inf")
        return max(abs(x - y) / (abs(b[0]) if to_start else max(abs(y), 1e-12 / GEO_CPU_GATE))
                   for x, y in zip(a, b))

    def cut_gate(va, fa, what, iters=GEO_CUT_ITERS, solver="multifrontal", to_start=False):
        """The same LM on the card and on the CPU: (gap of the histories, the
        card's history); no plain version may run on the card."""
        hs = {}
        for d_ in dict.fromkeys((dev, "cpu")):
            with counting_plain() as plain:
                r_ = optimizers.levenberg_marquardt(
                    convert.graph_from_arrays(fa, device=d_),
                    convert.values_from_arrays(va, device=d_),
                    LMParams(solver=solver, max_iterations=iters), device=d_)
            hs[d_] = r_.error_history
            if d_ == "cuda" and plain:
                raise AssertionError(f"geometry {what}: a plain version ran on the card: {plain}")
        gap = hist_gap(hs[dev], hs["cpu"], to_start)
        if not gap <= GEO_CPU_GATE:
            raise AssertionError(f"geometry {what}: card and CPU LM histories part by {gap:.3e}: "
                                 f"{hs[dev]} / {hs['cpu']}")
        return gap, hs[dev]

    def solve_scene(key, label, va, fa):
        """The scene's LM (multifrontal, plan line first), an LM step's device
        busy share, launches, bad pivots, plain calls."""
        g = convert.graph_from_arrays(fa, device=dev)
        v = convert.values_from_arrays(va, device=dev)
        maps, plan = plan_line(elimination, symbolic, g, v, f"geometry {key}) {label}")
        sizes = {t: len(v.type_keys(t)) for t in v.types()}
        nf = {b.ftype.name: b.size for b in g.batches}
        with LMRecorder(v1, sync) as rec, counting_plain() as plain, EliminationRecorder() as er:
            r = optimizers.levenberg_marquardt(
                g, v, LMParams(solver="multifrontal", max_iterations=GEO_LM_ITERS), device=dev)
        shapes.update(er.shapes)
        call = rec.calls[0]
        add_launches(call["launches"])

        def step(vals):
            return vals.retract(elimination.solve_linearized(g, vals, 1e-5)[0])

        busy = wall = steps = None
        if dev == "cuda":
            prof = profile_step(torch, step, r.values, top=5, reps=1, host=False)
            sync()
            t0 = time.perf_counter()
            step(r.values)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
            if prof:
                busy, steps = prof[0], prof[1]
        res = dict(sizes=sizes, factors=nf, plan=plan, iterations=r.iterations,
                   error=[r.error_history[0], r.error], s=call["s"],
                   ms_per_iteration=1e3 * call["s"] / max(1, r.iterations),
                   trials=call["trials"], bad_pivot_trials=call["bad_pivot_trials"],
                   launches=call["launches"],
                   step_wall_ms=wall, step_device_busy_ms=busy, step_kernels=steps,
                   busy_share=(busy / wall) if (busy and wall) else None,
                   bad_pivots=er.bad, plain_calls=dict(plain))
        log(f"geometry {key}) {label}: sizes {sizes}, factors {nf}; LM {r.error_history[0]:.6e} -> "
            f"{r.error:.6e} in {r.iterations} iterations ({call['s']:.2f} s, "
            f"{res['ms_per_iteration']:.1f} ms an iteration, {res['trials']} trials, "
            f"{res['bad_pivot_trials']} with bad pivots); launches {call['launches']}; "
            + (f"an LM step {wall:.1f} ms wall, device busy {busy:.3f} ms ({steps} kernels, "
               f"{100 * res['busy_share']:.1f}%); " if busy and wall else "")
            + f"bad pivots {er.bad}; plain versions {dict(plain)}")
        check_result(r, f"geometry {key}) LM")
        if dev == "cuda" and plain:
            raise AssertionError(f"geometry {key}): a plain version ran on the card: {dict(plain)}")
        return r, res

    # a) planar landmark SLAM (d = 3)
    va, fa, truth = synthetic.planar_slam(*GEO_PLANAR, seed=SEED)
    r, res = solve_scene("a", f"planar_slam{GEO_PLANAR}", va, fa)
    lm_keys = np.asarray(r.values.type_keys("Point2"))
    lm_est = r.values.params("Point2").cpu().numpy()[np.argsort(lm_keys)]
    lm_true = truth["landmarks"][np.argsort(truth["landmark_keys"])]
    res["ate_poses"] = pose2_ate(r.values, truth["poses"])
    res["ate_start"] = pose2_ate(convert.values_from_arrays(va, device="cpu"), truth["poses"])
    res["landmark_rmse"] = float(np.sqrt(np.mean(np.sum((lm_est - lm_true) ** 2, axis=1))))
    va_c, fa_c, _ = synthetic.planar_slam(*GEO_PLANAR_CUT, seed=SEED)
    res["cut"], res["cut_gap"] = GEO_PLANAR_CUT, cut_gate(va_c, fa_c, "a)")[0]
    out["a"] = res
    log(f"geometry a) ATE {res['ate_poses']:.6f} m (start {res['ate_start']:.6f} m), landmarks "
        f"RMSE {res['landmark_rmse']:.6f} m; planar_slam{GEO_PLANAR_CUT} card = CPU, LM histories "
        f"{res['cut_gap']:.3e} (gate {GEO_CPU_GATE})")
    if not res["ate_poses"] < res["ate_start"]:
        raise AssertionError("geometry a): the ATE did not fall")
    del r
    lap("a")

    # b) a Sim3 pose graph (d = 7)
    va, fa = synthetic.sim3_sphere(*GEO_SIM3, seed=SEED)
    r, res = solve_scene("b", f"sim3_sphere{GEO_SIM3}", va, fa)
    s_est = r.values.params("Sim3").s.cpu().numpy()
    res["scale_range"] = [float(s_est.min()), float(s_est.max())]
    va_c, fa_c = synthetic.sim3_sphere(*GEO_SIM3_CUT, seed=SEED)
    res["cut"], res["cut_gap"] = GEO_SIM3_CUT, cut_gate(va_c, fa_c, "b)")[0]
    out["b"] = res
    log(f"geometry b) scales {res['scale_range'][0]:.6f} .. {res['scale_range'][1]:.6f}; "
        f"sim3_sphere{GEO_SIM3_CUT} card = CPU {res['cut_gap']:.3e}")
    del r
    lap("b")

    # c) plane SLAM (d = 6)
    va, fa, truth = synthetic.plane_slam(*GEO_PLANE, seed=SEED)
    r, res = solve_scene("c", f"plane_slam{GEO_PLANE}", va, fa)
    res["ate"] = pose3_ate(r.values, truth["t"])
    res["ate_start"] = pose3_ate(convert.values_from_arrays(va, device="cpu"), truth["t"])
    # dead reckoning: the odometry composed from keyframe 0's true pose
    (odo_R, odo_t) = fa[1][2]
    P = pose3.Pose3(torch.as_tensor(truth["R"][:1]), torch.as_tensor(truth["t"][:1]))
    t_dr = [P.t]
    for i in range(len(odo_R)):
        P = pose3.compose(P, pose3.Pose3(torch.as_tensor(odo_R[i:i + 1]),
                                         torch.as_tensor(odo_t[i:i + 1])))
        t_dr.append(P.t)
    d_dr = torch.cat(t_dr).numpy() - truth["t"]
    res["ate_dead_reckoning"] = float(np.sqrt(np.mean(np.sum(d_dr * d_dr, axis=1))))
    pn = r.values.params("OrientedPlane3").n.cpu().numpy()
    res["plane_normal_max_rad"] = float(np.arccos(np.clip(np.sum(pn * truth["n"], axis=1), -1, 1)).max())
    va_c, fa_c, _ = synthetic.plane_slam(*GEO_PLANE_CUT, seed=SEED)
    res["cut"], res["cut_gap"] = GEO_PLANE_CUT, cut_gate(va_c, fa_c, "c)")[0]
    out["c"] = res
    log(f"geometry c) ATE {res['ate']:.6f} m (dead reckoning {res['ate_dead_reckoning']:.6f}; the "
        f"start, the truth perturbed, {res['ate_start']:.6f}), plane normals within "
        f"{res['plane_normal_max_rad']:.3e} rad; plane_slam{GEO_PLANE_CUT} card = CPU "
        f"{res['cut_gap']:.3e}")
    if not res["ate"] < res["ate_dead_reckoning"]:
        raise AssertionError("geometry c): the ATE is not below dead reckoning's")
    del r
    lap("c")

    # d) two-view relative poses (d = 5)
    va, fa, truth = synthetic.two_view_pairs(*GEO_TWO_VIEW, seed=SEED)
    r, res = solve_scene("d", f"two_view_pairs{GEO_TWO_VIEW}", va, fa)
    E = r.values.params("EssentialMatrix")
    Rt = torch.as_tensor(truth["R"]).to(dev)
    ang = torch.linalg.norm(so3.logmap(Rt.transpose(-1, -2) @ E.R), dim=-1).cpu().numpy()
    ang0 = torch.linalg.norm(so3.logmap(Rt.transpose(-1, -2) @ torch.as_tensor(
        va["EssentialMatrix"][1][0]).to(dev)), dim=-1).cpu().numpy()
    res["rotation_err_rms_rad"] = [float(np.sqrt(np.mean(ang0 ** 2))), float(np.sqrt(np.mean(ang ** 2)))]
    tcos = torch.sum(E.t * torch.as_tensor(truth["t"]).to(dev), dim=-1).abs().cpu().numpy()
    pA = torch.as_tensor(fa[0][2]["pA"]).to(dev)
    pB = torch.as_tensor(fa[0][2]["pB"]).to(dev)
    rows = torch.as_tensor(np.repeat(np.arange(GEO_TWO_VIEW[0]), GEO_TWO_VIEW[1])).to(dev)
    epi = essential.epipolar_error(essential.EssentialMatrix(E.R[rows], E.t[rows]), pA, pB)
    res["epipolar_rms"] = float(torch.sqrt(torch.mean(epi * epi)))
    res["rotation_err_max_rad"] = float(ang.max())
    res["direction_err_max_rad"] = float(np.arccos(np.clip(tcos, -1, 1)).max())
    va_c, fa_c, _ = synthetic.two_view_pairs(*GEO_TWO_VIEW_CUT, seed=SEED)
    res["cut"], res["cut_gap"] = GEO_TWO_VIEW_CUT, cut_gate(va_c, fa_c, "d)")[0]
    out["d"] = res
    log(f"geometry d) epipolar residual RMS {res['epipolar_rms']:.3e} (pixel noise "
        f"{synthetic.TWO_VIEW_PIXEL} on normalized coordinates); rotation error RMS "
        f"{res['rotation_err_rms_rad'][0]:.3e} -> {res['rotation_err_rms_rad'][1]:.3e} rad, max "
        f"{res['rotation_err_max_rad']:.3e} rad, direction max {res['direction_err_max_rad']:.3e} "
        f"rad; two_view_pairs{GEO_TWO_VIEW_CUT} card = CPU {res['cut_gap']:.3e}")
    if not (res["epipolar_rms"] < 10 * synthetic.TWO_VIEW_PIXEL
            and res["rotation_err_rms_rad"][1] < res["rotation_err_rms_rad"][0]):
        raise AssertionError("geometry d): the two-view refinement missed its gates")
    del r, E
    lap("d")

    # e) the other factor types, the anti-factor and the geometry extras
    scenes = {}
    with EliminationRecorder() as er_e:
        for name, (va, fa) in synthetic.extra_factor_scenes(SEED).items():
            t0 = time.perf_counter()
            v1.reset_launch_counts()
            gap, hist = cut_gate(va, fa, f"e) {name}", iters=GEO_LM_ITERS, to_start=True)
            add_launches(v1.launch_counts())
            scenes[name] = dict(history=[hist[0], hist[-1]], iterations=len(hist) - 1, gap=gap,
                                s=time.perf_counter() - t0)
            if not hist[-1] <= 1e-6 * hist[0]:
                raise AssertionError(f"geometry e) {name}: LM did not reach the truth: {hist}")
        # the anti-factor: a between factor and its anti-factor cancel exactly
        anti = {}
        for d_ in dict.fromkeys((dev, "cpu")):
            vals = convert.values_from_arrays({"Pose2": (np.arange(2), np.array(
                [[0.0, 0.0, 0.0], [1.1, 0.1, 0.05]]))}, device=d_)
            g1, g2 = (convert.graph_from_arrays(
                [("PriorPose2", np.array([[0], [1]]), np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]),
                  np.stack([np.eye(3) / 0.1, np.eye(3) / 0.5]))], device=d_) for _ in range(2))
            meas = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64)
            bf = factors.between_factor("Pose2")
            g2.add_batch(bf, [[0, 1]], meas, np.eye(3)[None] / 0.2)
            g2.add_batch(extra_factors.anti_factor(bf), [[0, 1]], meas, np.eye(3)[None] / 0.2, sign=-1.0)
            H1, gg1 = linsolve.assemble_dense(g1.linearize(vals))
            H2, gg2 = linsolve.assemble_dense(g2.linearize(vals))
            with counting_plain() as plain_anti:
                x1 = elimination.solve_linearized(g1, vals, 1e-3)[0]["Pose2"]
                x2 = elimination.solve_linearized(g2, vals, 1e-3)[0]["Pose2"]
            if d_ == "cuda" and plain_anti:
                raise AssertionError(f"geometry e): a plain version ran on the card: {plain_anti}")
            anti[d_] = dict(H=(H1 - H2).abs().max().item(), g=(gg1 - gg2).abs().max().item(),
                            step=(x1 - x2).abs().max().item())
        # the geometry extras on a batch, card against CPU
        rng = np.random.default_rng(SEED)
        pose_np = (rng.normal(size=(64, 6)) * 0.5)
        pts_np = rng.normal(size=(64, 3)) * 3 + np.array([0, 0, 6.0])
        xi4, xi5 = rng.normal(size=(64, 6)) * 0.4, rng.normal(size=(64, 10)) * 0.4
        K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
        ex = {}
        for d_ in dict.fromkeys((dev, "cpu")):
            T = lambda a: torch.as_tensor(a).to(d_)
            P = pose3.expmap(T(pose_np))
            b = extra.spherical_project(P, T(pts_np))
            Eb = essential.essential_matrix(essential.EssentialMatrix(P.R, unit3.normalize(P.t)))
            F = extra.fundamental_from_essential(T(K).expand(64, 3, 3), Eb, T(K).expand(64, 3, 3))
            U, sv, V = extra.fundamental_params(F)
            g_ = extra.sim2(0.4, [1.0, -2.0], 1.5, device=d_)
            R4, R5 = extra.son_expmap(T(xi4), 4), extra.son_expmap(T(xi5), 5)
            ex[d_] = [b, extra.spherical_reprojection_error(P, T(pts_np), unit3.normalize(b + 0.01)),
                      extra.fundamental_matrix(U, sv, V),  # free of the SVD's signs
                      extra.sim2_transform_from(extra.sim2_compose(g_, extra.sim2_inverse(g_)),
                                                T(pts_np[:, :2])),
                      R4, extra.son_logmap(R4, 4), R5, extra.son_logmap(R5, 5)]
    shapes.update(er_e.shapes)
    ex_gap = max((a.cpu() - b_.cpu()).abs().max().item() for a, b_ in zip(ex[dev], ex["cpu"]))
    out["e"] = dict(scenes=scenes, anti=anti, extras_abs=ex_gap, bad_pivots=er_e.bad)
    log("geometry e) " + "; ".join(
        f"{k} {v['iterations']} LM iterations {v['history'][0]:.3e} -> {v['history'][1]:.3e} "
        f"(card = CPU {v['gap']:.1e}, {v['s']:.2f} s)" for k, v in scenes.items())
        + f"; anti-factor: |H - H'| {anti[dev]['H']:.1e}, |g - g'| {anti[dev]['g']:.1e}, the "
          f"multifrontal steps {anti[dev]['step']:.1e}; spherical / fundamental / Sim2 / SO(4), "
          f"SO(5) card against CPU {ex_gap:.3e} (gate 1e-12); bad pivots {er_e.bad}; no plain "
          f"version on the card")
    if not (max(anti[dev].values()) <= 1e-12 and ex_gap <= 1e-12):
        raise AssertionError("geometry e): the anti-factor or the geometry extras missed a gate")
    lap("e")

    # f) constrained optimization on the sphere; the basis fits; the host QP / LP
    def constrained_run(shape, device, method):
        va, fa = synthetic.sphere_rings(*shape, seed=SEED)
        g = convert.graph_from_arrays(fa, device=device)
        v = convert.values_from_arrays(va, device=device)
        radius = shape[1] / (2.0 * np.pi)
        cons = [constrained.EqualityConstraint("radius", ("Pose3",), 1, radius_constraint, [int(k)],
                                               radius) for k in va["Pose3"][0]]
        params = constrained.PenaltyParams(
            inner=LMParams(solver="multifrontal", max_iterations=GEO_INNER_ITERS))
        groups = con_mod._groups(cons, g)
        viol0 = con_mod._violation(groups, con_mod._constraint_values(groups, v))
        t0 = time.perf_counter()
        r = getattr(constrained, method)(g, cons, v, params, device=device)
        sync()
        s = time.perf_counter() - t0
        viol = con_mod._violation(groups, con_mod._constraint_values(groups, r.values))
        return r, s, viol0, viol

    runs = {}
    with counting_plain() as plain_f, EliminationRecorder() as er_f:
        for method in ("augmented_lagrangian_optimize", "penalty_optimize"):
            with LMRecorder(v1, sync) as rec:
                r, s, viol0, viol = constrained_run(GEO_CONSTRAINT_SPHERE, dev, method)
            for c in rec.calls:
                add_launches(c["launches"])
            lm_s = sum(c["s"] for c in rec.calls)
            runs[method] = dict(outer=len(rec.calls),
                                inner=[c["result"].iterations for c in rec.calls],
                                violation=[viol0, viol], error=r.error, s=s, lm_s=lm_s,
                                other_s=s - lm_s,
                                ms_per_inner=1e3 * lm_s / max(1, sum(c["result"].iterations
                                                                     for c in rec.calls)))
            log(f"geometry f) {method} on sphere_rings{GEO_CONSTRAINT_SPHERE} with "
                f"{GEO_CONSTRAINT_SPHERE[0] * GEO_CONSTRAINT_SPHERE[1]} constraints ||t_i|| = r: "
                f"{len(rec.calls)} outer iterations, inner LM iterations "
                f"{runs[method]['inner']}, violation {viol0:.3e} -> {viol:.3e}, error {r.error:.6e}; "
                f"{s:.2f} s ({lm_s:.2f} s inner LM, {runs[method]['ms_per_inner']:.1f} ms an inner "
                f"iteration; {s - lm_s:.2f} s staging and violation reads)")
    al_cut = {}
    with EliminationRecorder() as er_fc:
        for d_ in dict.fromkeys((dev, "cpu")):
            r_c = constrained_run(GEO_CONSTRAINT_CUT, d_, "augmented_lagrangian_optimize")[0]
            al_cut[d_] = r_c.values.params("Pose3").t.cpu()
    shapes.update(er_f.shapes | er_fc.shapes)
    al_gap = (al_cut[dev] - al_cut["cpu"]).abs().max().item()
    al, pen = runs["augmented_lagrangian_optimize"], runs["penalty_optimize"]
    log(f"geometry f) AL on sphere_rings{GEO_CONSTRAINT_CUT} card = CPU {al_gap:.3e} (gate "
        f"{GEO_CPU_GATE}); bad pivots {er_f.bad}; plain versions {dict(plain_f)}")
    if not (al["violation"][1] <= GEO_VIOLATION_DROP * al["violation"][0]
            and pen["violation"][1] <= GEO_VIOLATION_DROP * pen["violation"][0]
            and al_gap <= GEO_CPU_GATE and not (dev == "cuda" and plain_f)):
        raise AssertionError("geometry f): the constrained solves missed their gates")

    # the basis fits on the drive's 200 Hz positions (card = CPU on every
    # GEO_BASIS_CUT-th sample: the CPU's forward mode over the whole graph
    # costs ~20 s)
    def basis_fit(device, stride):
        ts, pos = synthetic.drive_positions(*GEO_BASIS_DRIVE, device=device)
        x, pos = (2.0 * ts / ts[-1] - 1.0)[::stride], pos[::stride]
        sync()
        t0 = time.perf_counter()
        fb = basis.FitBasis(x, pos, GEO_BASIS_N, basis.chebyshev2_weights, device=device)
        sync()
        fit_s = time.perf_counter() - t0
        resid = fb(x) - pos
        ft = basis.evaluation_factor(GEO_BASIS_N, basis.chebyshev2_weights)
        g = convert.graph_from_arrays([(ft.name, np.zeros((len(x), 1), np.int64),
                                        {"x": x, "y": pos[:, 0]}, np.ones((len(x), 1, 1)))],
                                      device=device)
        v = convert.values_from_arrays({f"Vector{GEO_BASIS_N}": (np.array([0]),
                                                                 np.zeros((1, GEO_BASIS_N)))},
                                       device=device)
        t0 = time.perf_counter()
        gn = optimizers.gauss_newton(g, v, OptimizerParams(max_iterations=3), device=device)
        sync()
        return dict(samples=len(x), c=fb.coefficients.cpu(), c_graph=gn.values.at(0).cpu(),
                    fit_s=fit_s, graph_s=time.perf_counter() - t0, gn_iterations=gn.iterations,
                    rms=float(torch.sqrt(torch.mean(resid * resid))))

    full = basis_fit(dev, 1)
    cut = {d_: basis_fit(d_, GEO_BASIS_CUT) for d_ in dict.fromkeys((dev, "cpu"))}
    c_scale = cut["cpu"]["c"].abs().max().item()
    fit_gap = (cut[dev]["c"] - cut["cpu"]["c"]).abs().max().item() / c_scale
    graph_gap = (cut[dev]["c_graph"] - cut["cpu"]["c_graph"]).abs().max().item() / c_scale
    graph_fit = ((full["c_graph"] - full["c"][:, 0]).abs().max() / full["c"].abs().max()).item()
    t0 = time.perf_counter()
    qp_res = qp.solve_qp(2 * np.eye(2), np.array([-2.0, -5.0]),
                         CI=np.array([[1.0, -2.0], [-1.0, -2.0], [-1.0, 2.0], [1.0, 0.0], [0.0, 1.0]]),
                         ci=np.array([-2.0, -6.0, -2.0, 0.0, 0.0]))
    qp_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    lp_res = qp.solve_lp(np.array([-1.0, -1.0]),
                         CI=np.array([[-1.0, -2.0], [-4.0, -2.0], [1.0, 0.0], [0.0, 1.0]]),
                         ci=np.array([-4.0, -12.0, 0.0, 0.0]))
    lp_ms = (time.perf_counter() - t0) * 1e3
    out["f"] = dict(runs=runs, al_cut=GEO_CONSTRAINT_CUT, al_cut_abs=al_gap, bad_pivots=er_f.bad,
                    plain_calls=dict(plain_f),
                    basis=dict(samples=full["samples"], N=GEO_BASIS_N, rms=full["rms"],
                               fit_ms=1e3 * full["fit_s"], graph_s=full["graph_s"],
                               gn_iterations=full["gn_iterations"], cut_samples=cut[dev]["samples"],
                               card_cpu_rel=fit_gap, graph_card_cpu_rel=graph_gap,
                               graph_vs_fit_rel=graph_fit),
                    qp=dict(ms=qp_ms, x=qp_res.x.tolist(), iterations=qp_res.iterations),
                    lp=dict(ms=lp_ms, x=lp_res.x.tolist(), iterations=lp_res.iterations))
    log(f"geometry f) FitBasis (Chebyshev2, N = {GEO_BASIS_N}) on {full['samples']} positions at "
        f"{GEO_BASIS_DRIVE[1]} Hz: {1e3 * full['fit_s']:.2f} ms, RMS {full['rms']:.3e} m; the "
        f"evaluation-factor graph (x): GN {full['gn_iterations']} iterations in "
        f"{full['graph_s']:.2f} s, against FitBasis {graph_fit:.3e}; on every {GEO_BASIS_CUT}th "
        f"sample card = CPU {fit_gap:.3e} (FitBasis), {graph_gap:.3e} (the graph) (rel, gate "
        f"{GEO_CPU_GATE}); host solve_qp {qp_ms:.3f} ms "
        f"({qp_res.iterations} iterations, x {qp_res.x}), solve_lp {lp_ms:.3f} ms "
        f"({lp_res.iterations} iterations, x {lp_res.x})")
    if not (fit_gap <= GEO_CPU_GATE and graph_gap <= GEO_CPU_GATE and graph_fit <= 1e-6
            and np.allclose(qp_res.x, [1.4, 1.7], atol=1e-8)
            and np.allclose(lp_res.x, [8.0 / 3.0, 2.0 / 3.0], atol=1e-5)):
        raise AssertionError("geometry f): the basis fits or the host QP / LP missed their gates")
    lap("f")

    # g) the four kernels at every bucket shape of a)-f)
    cases = sorted(shapes)
    errs = {}
    t0 = time.perf_counter()
    if dev == "cuda":
        check_kernels(torch, (v2, v1, kernels), cases, {"float64": {}, "float32": {}},
                      extras=False, errs_out=errs)
    out["g"] = dict(distinct=len(cases), shapes=cases, max_abs_err=errs)
    log(f"geometry g) {len(cases)} distinct (B, nf, ns, d) shapes of a)-f) (d = "
        f"{sorted({c[3] for c in cases})}), each kernel against its plain version in float64 and "
        f"float32: max abs err {errs} ({time.perf_counter() - t0:.1f} s)")
    if errs and not max(errs["float64"].values()) <= GEO_KERNEL_GATE:
        raise AssertionError(f"geometry g): a kernel parts from its plain version by more than "
                             f"{GEO_KERNEL_GATE} in float64: {errs['float64']}")
    lap("g")
    out["launches"] = launches
    log(f"geometry launches (counters reset before each solve of a)-f), read after): {launches}")
    if dev == "cuda" and not all(n > 0 for n in launches.values()):
        raise AssertionError(f"geometry: a kernel was never launched on the geometry path: {launches}")
    out["phase_s"] = time.perf_counter() - t_phase
    out["seconds"] = secs
    log(f"geometry phase: {out['phase_s']:.1f} s (" + ", ".join(
        f"{k}) {x:.1f} s" for k, x in secs.items()) + ")")
    return out


# --- phase 16: discrete and hybrid inference, the utilities -----------------------------


def city_lines_parsed(lines):
    """City-format EDGE2 lines as (keyS, keyT, [candidate measurements])."""
    import numpy as np

    out = []
    for ln in lines:
        p = ln.split()
        out.append((int(p[1]), int(p[3]), [np.array([float(v) for v in p[6 + 3 * i : 9 + 3 * i]])
                                            for i in range(int(p[5]))]))
    return out


def city_jacobians(torch, parsed, n_poses, dev):
    """Every (line, candidate) Pose2 between factor of `parsed`, and a prior
    on pose 0, linearized at dead reckoning (each odometry line's first
    candidate composed), unwhitened, on `dev`: (prior (A, b), between (A_S,
    A_T, b) with one row per candidate in line order)."""
    import numpy as np

    from gtsam_petercdev_torch.utils import convert, synthetic

    x = np.zeros((n_poses, 3))
    for a, b, ms in parsed:
        if b == a + 1:
            x[b] = synthetic.pose2_compose_np(x[a], ms[0])
    keys = np.array([[a, b] for a, b, ms in parsed for _ in ms], dtype=np.int64)
    meas = np.stack([m for _, _, ms in parsed for m in ms])
    g = convert.graph_from_arrays(
        [("PriorPose2", np.zeros((1, 1), dtype=np.int64), np.zeros((1, 3)), np.eye(3)[None]),
         ("BetweenPose2", keys, meas, np.broadcast_to(np.eye(3), (len(keys), 3, 3)).copy())],
        device=dev)
    lg = g.linearize(convert.values_from_arrays({"Pose2": (np.arange(n_poses), x)}, device=dev))
    (pA,), pb = lg.batches[0].A, lg.batches[0].b
    (sA, tA), bb = lg.batches[1].A, lg.batches[1].b
    return (pA[0], pb[0]), (sA, tA, bb)


def hybrid_city_slices(torch, parsed, jac, n_loop_modes, dev, disc_base=10_000):
    """One HybridGaussianFactorGraph per line of `parsed` (the prior in the
    first), whitened at the City10000 harness's sigmas: an odometry line of
    one candidate a Gaussian (odometry sigmas), of several a hybrid term with
    a component per candidate; of the loop closures the first `n_loop_modes`
    a binary hybrid (open loop, sigmas 10, against accept, the odometry
    sigmas), the rest a Gaussian under the loop sigmas (the harness's), as in
    models/hybrid_city. Discrete key of line i: disc_base + i."""
    import numpy as np

    from gtsam_petercdev_torch.hybrid.hybrid import HybridGaussianFactorGraph
    from gtsam_petercdev_torch.utils.synthetic import CITY_SIGMAS

    (pA, pb), (sA, tA, bb) = jac
    pose_s, open_s = np.asarray(CITY_SIGMAS), np.full(3, 10.0)
    w = {k: torch.as_tensor(1.0 / s, dtype=torch.float64, device=dev)
         for k, s in (("pose", pose_s), ("open", open_s), ("prior", np.full(3, 1e-4)))}
    ln = {"pose": -float(np.log(pose_s).sum()), "open": -float(np.log(open_s).sum())}
    slices, row, n_modes = [], 0, 0
    for i, (a, b, ms) in enumerate(parsed):
        g = HybridGaussianFactorGraph(device=dev)
        if i == 0:
            g.add_continuous([(0, 3)], [pA * w["prior"][:, None]], pb * w["prior"])
        kd = [(a, 3), (b, 3)]
        rows = range(row, row + len(ms))
        row += len(ms)
        comp = lambda r, s: (sA[r] * w[s][:, None], tA[r] * w[s][:, None], bb[r] * w[s])
        if b == a + 1 and len(ms) == 1:
            A1, A2, rhs = comp(rows[0], "pose")
            g.add_continuous(kd, [A1, A2], rhs)
        elif b == a + 1 or n_modes < n_loop_modes:
            pairs = ([(r, "pose") for r in rows] if b == a + 1
                     else [(rows[0], "open"), (rows[0], "pose")])
            cs = [comp(r, s) for r, s in pairs]
            g.add_hybrid(kd, [(disc_base + i, len(cs))], [torch.stack([c[0] for c in cs]),
                                                          torch.stack([c[1] for c in cs])],
                         torch.stack([c[2] for c in cs]), log_norm=[ln[s] for _, s in pairs])
            n_modes += b != a + 1
        else:
            A1, A2, rhs = comp(rows[0], "open")
            g.add_continuous(kd, [A1, A2], rhs)
        slices.append(g)
    return slices


def merged(slices, dev):
    """The slices' terms in one HybridGaussianFactorGraph."""
    from gtsam_petercdev_torch.hybrid.hybrid import HybridGaussianFactorGraph

    g = HybridGaussianFactorGraph(device=dev)
    for s in slices:
        g.gaussians += s.gaussians
        g.discrete += s.discrete
        g.cont_dims.update(s.cont_dims)
        g.disc_cards.update(s.disc_cards)
    return g


def run_hybrid(torch, v1, here, dev="cuda"):
    """Phase 16 (float64): a) a discrete factor graph: MPE, every marginal,
    k-best, card = CPU and brute force; b) the dense hybrid path at M = 1,024
    in one batched Cholesky, card = CPU; c) eliminate_sparse on the City
    graph with M = 256 hypotheses folded into each bucket: plan, launches,
    ms and busy share, gates against one multifrontal solve a hypothesis,
    the dense path on a cut, and the kernels at every folded bucket shape;
    d) HybridSmoother over Hybrid City lines, card = CPU; e) run_hybrid_city
    against the host engine on the CPU, and a short forking run; f) g2o
    write / read, the solver comparer, a timed span."""
    import numpy as np

    from gtsam_petercdev_torch.discrete import search
    from gtsam_petercdev_torch.discrete.discrete import DiscreteFactorGraph
    from gtsam_petercdev_torch.hybrid.hybrid import (HybridGaussianFactorGraph,
                                                     SparseHypotheses, eliminate_sparse)
    from gtsam_petercdev_torch.hybrid.incremental import HybridSmoother
    from gtsam_petercdev_torch.inference import elimination, kernels
    from gtsam_petercdev_torch.models.hybrid_city import run_hybrid_city
    from gtsam_petercdev_torch.ops import cholesky_v2 as v2
    from gtsam_petercdev_torch.utils import convert, dataset, solver_comparer, synthetic, timing

    out, secs, launches = {}, {}, {k: 0 for k in KERNELS}
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    card = card_line() if dev == "cuda" else "cpu"
    t_phase = t_sub = time.perf_counter()
    rng = np.random.default_rng(SEED)
    work = os.path.join(here, "gtsam_petercdev_torch", "_build")
    os.makedirs(work, exist_ok=True)

    def lap(key):
        nonlocal t_sub
        secs[key] = time.perf_counter() - t_sub
        log(f"hybrid {key}) {secs[key]:.1f} s on {card}")
        t_sub = time.perf_counter()

    def count_launches():
        """The launches since the last reset, added to the phase's total;
        the counters are reset after the read."""
        got = dict(v1.launch_counts())
        for k, x in got.items():
            launches[k] += x
        v1.reset_launch_counts()
        return got

    def rel(a, b):
        a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()

    # a) a discrete factor graph: a chain and triplets within a window of four
    n = HYB_DISCRETE_VARS
    cards = rng.integers(2, 5, size=n)
    facs = [([(i, int(cards[i]))], rng.uniform(0.1, 1.0, cards[i])) for i in range(n)]
    facs += [([(i, int(cards[i])), (i + 1, int(cards[i + 1]))],
              rng.uniform(0.1, 1.0, (cards[i], cards[i + 1]))) for i in range(n - 1)]
    for i in range(0, n - 3, 2):
        ks = (i, i + 1 + int(rng.integers(2)), i + 3)
        facs.append(([(k, int(cards[k])) for k in ks], rng.uniform(0.1, 1.0, [cards[k] for k in ks])))
    # k_best's best-first bound is the JAX package's (a product of per-factor
    # maxima): on the whole graph it expands past 20,000 nodes, so it runs
    # on the subgraph of the first HYB_BRUTE_VARS variables, which brute
    # force checks too (their joint table on the card)
    nb = HYB_BRUTE_VARS
    sub_facs = [f for f in facs if max(k for k, _ in f[0]) < nb]
    res = {}
    for d_ in dict.fromkeys((dev, "cpu")):
        g = convert.discrete_graph_from_arrays(facs, device=d_)
        t0 = time.perf_counter()
        mpe = g.optimize()
        marg = [g.marginal(k).cpu().numpy() for k in range(n)]
        t1 = time.perf_counter()
        kb = search.k_best(convert.discrete_graph_from_arrays(sub_facs, device=d_), HYB_K_BEST)
        res[d_] = dict(mpe=mpe, marg=marg, kb=kb, ms=(t1 - t0) * 1e3,
                       kb_ms=(time.perf_counter() - t1) * 1e3)
    a_, b_ = res[dev], res["cpu"]
    marg_gap = max(float(np.abs(x - y).max()) for x, y in zip(a_["marg"], b_["marg"]))
    kb_gap = max(abs(x.value - y.value) / y.value for x, y in zip(a_["kb"], b_["kb"]))
    sub = convert.discrete_graph_from_arrays(sub_facs, device=dev)
    joint = sub.joint().table
    top = torch.topk(joint.reshape(-1), HYB_K_BEST)
    idx = np.stack(np.unravel_index(top.indices.cpu().numpy(), joint.shape), axis=1)
    brute_marg = max(float((sub.marginal(k) - joint.sum(dim=tuple(j for j in range(nb) if j != k))
                            / joint.sum()).abs().max()) for k in range(nb))
    brute_ok = (sub.optimize() == dict(enumerate(int(v) for v in idx[0]))
                and [s.assignment for s in a_["kb"]]
                == [dict(enumerate(int(v) for v in r)) for r in idx]
                and max(abs(s.value - float(v)) / float(v) for s, v in zip(a_["kb"], top.values))
                <= 1e-12 and brute_marg <= 1e-12)
    out["a"] = dict(variables=n, factors=len(facs), cards=np.bincount(cards).tolist(),
                    ms_card=a_["ms"], ms_cpu=b_["ms"], k_best_ms=a_["kb_ms"],
                    marginal_abs=marg_gap, k_best_rel=kb_gap, brute_vars=nb,
                    brute_joint=int(joint.numel()), brute_marginal_abs=brute_marg)
    log(f"hybrid a) DiscreteFactorGraph of {n} variables (cards 2-4), {len(facs)} factors: MPE "
        f"and every marginal {a_['ms']:.1f} ms on the card ({b_['ms']:.1f} ms CPU); card = CPU: "
        f"MPE {a_['mpe'] == b_['mpe']}, marginals {marg_gap:.3e}; on the first {nb} variables "
        f"({len(sub_facs)} factors, {joint.numel()} joint entries): k_best({HYB_K_BEST}) "
        f"{a_['kb_ms']:.1f} ms (host), card = CPU values rel {kb_gap:.3e}; brute force (the "
        f"joint table on the card): MPE, top-{HYB_K_BEST} and marginals "
        f"{'agree' if brute_ok else 'DIFFER'} (marginals {brute_marg:.3e})")
    if not (a_["mpe"] == b_["mpe"] and marg_gap <= 1e-12 and kb_gap <= 1e-12
            and [s.assignment for s in a_["kb"]] == [s.assignment for s in b_["kb"]] and brute_ok):
        raise AssertionError("hybrid a): the discrete graph failed its gates")
    del res, a_, b_, sub, joint
    lap("a")

    # b) the dense path: a switching chain of 3-dim linear variables
    nv, nm = HYB_DENSE
    mode_at = set(np.linspace(0, nv - 2, nm).round().astype(int).tolist())
    th = rng.uniform(-0.5, 0.5, nv)
    steps = rng.normal(size=(nv, 2, 3))

    def dense_graph(d_):
        g = HybridGaussianFactorGraph(device=d_)
        g.add_continuous([(0, 3)], [10.0 * np.eye(3)], np.zeros(3))
        for t in range(nv):
            g.add_continuous([(t, 3)], [0.3 * np.eye(3)], 0.3 * rng_b.normal(size=3))
        for t in range(nv - 1):
            c, s = np.cos(th[t]), np.sin(th[t])
            R = -np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            if t in mode_at:
                g.add_hybrid([(t, 3), (t + 1, 3)], [(1000 + t, 2)], [np.stack([R, R]),
                             np.stack([np.eye(3)] * 2)], steps[t], log_norm=[0.0, np.log(0.5)])
                g.add_discrete([(1000 + t, 2)], [0.5, 0.5])
            else:
                g.add_continuous([(t, 3), (t + 1, 3)], [R, np.eye(3)], steps[t, 0])
        return g

    res = {}
    for d_ in dict.fromkeys((dev, "cpu")):
        rng_b = np.random.default_rng(SEED + 1)
        g = dense_graph(d_)
        g.eliminate()
        sync()
        t0 = time.perf_counter()
        bn = g.eliminate()
        sync()
        res[d_] = (bn, (time.perf_counter() - t0) * 1e3)
    (bn_c, ms_c), (bn_h, ms_h) = res[dev], res["cpu"]
    lp_gap = float((bn_c.log_probs.cpu() - bn_h.log_probs).abs().max())
    x_gap = rel(bn_c.solutions, bn_h.solutions)
    M_b = bn_c.log_probs.shape[0]
    out["b"] = dict(variables=nv, D=3 * nv, modes=nm, M=M_b, ms_card=ms_c, ms_cpu=ms_h,
                    log_p_abs=lp_gap, x_rel=x_gap, mpe_p=float(torch.exp(bn_c.log_probs.max())))
    log(f"hybrid b) dense path: {nv} variables of dim 3 (D = {3 * nv}), {nm} binary modes, M = "
        f"{M_b} assignments in one batched Cholesky: {ms_c:.2f} ms on the card ({ms_h:.2f} ms "
        f"CPU); card = CPU: log p {lp_gap:.3e} (abs), x {x_gap:.3e} (rel); MPE probability "
        f"{out['b']['mpe_p']:.6f}")
    if not (M_b == 2 ** nm and lp_gap <= HYB_GATE and x_gap <= HYB_GATE
            and bn_c.optimize()[0] == bn_h.optimize()[0]):
        raise AssertionError("hybrid b): the dense path failed its gates")
    del res, bn_c, bn_h
    lap("b")

    # c) the sparse path: City's graph at dead reckoning, its first loop
    # closures binary hybrids, every hypothesis through the folded plan
    lines, _ = synthetic.city_stream(HYB_CITY_POSES, seed=SEED)
    parsed = city_lines_parsed(lines)

    def city_hybrid(parsed_, n_poses, d_):
        return merged(hybrid_city_slices(torch, parsed_, city_jacobians(torch, parsed_, n_poses, d_),
                                         HYB_SPARSE_LOOPS, d_), d_)

    t0 = time.perf_counter()
    g = city_hybrid(parsed, HYB_CITY_POSES, dev)
    dkeys, asg = g._asg_array(None)
    sp = SparseHypotheses(g, asg)
    plan_s = time.perf_counter() - t0
    M, d = sp.M, sp.plan.d
    routes = [(elimination.bucket_route(bm, d, 8), M * bm.B, bm.nf, bm.ns) for bm in sp.maps.buckets]
    pool_bytes = M * (sp.maps.n_blocks + 1) * d * d * 8
    log(f"hybrid c) City graph: {HYB_CITY_POSES} poses (D = {3 * HYB_CITY_POSES}), "
        f"{len(g.gaussians)} terms, {len(dkeys)} loop closures as binary hybrids: M = {M}; "
        f"graph and plan {plan_s:.1f} s (host); plan {sp.plan.stats()} {len(sp.maps.buckets)} "
        f"buckets; folded (route, M*B, nf, ns): {routes}; block pool {pool_bytes / 2**20:.1f} MiB")
    with counting_plain() as plain_c:
        sp.solve()
        sync()
        v1.reset_launch_counts()
        t0 = time.perf_counter()
        xs, Es, lds = sp.solve()
        sync()
        solve_ms = (time.perf_counter() - t0) * 1e3
        folded = count_launches()
    # the profiled solves are not counted
    prof = profile_once(torch, sp.solve) if dev == "cuda" else None
    # one hypothesis's multifrontal_solve: its launches, and the gates
    v1.reset_launch_counts()
    x1, st1 = elimination.multifrontal_solve(sp.maps, sp.hypothesis(0), 1e-10, return_logdet=True)
    sync()
    single = count_launches()

    def one(h):
        x_, st = elimination.multifrontal_solve(sp.maps, sp.hypothesis(h), 1e-10, return_logdet=True)
        return x_, st

    gaps = []
    for h in sorted(rng.choice(M, size=min(HYB_SPARSE_SAMPLES, M), replace=False).tolist()):
        x_, st = one(h)
        gaps.append((h, rel(x_.reshape(-1)[sp.flat], xs[h]),
                     abs(float(sp.energy(x_.expand(M, -1, -1))[h]) - float(Es[h])) / abs(float(Es[h])),
                     abs(float(st["logdet"]) - float(lds[h])) / abs(float(lds[h]))))
    count_launches()
    # the solves one hypothesis at a time (a Python loop), once, over the
    # first HYB_LOOP_HYPOTHESES hypotheses (each takes the folded solve's
    # launches; the whole loop is M / HYB_LOOP_HYPOTHESES times as long)
    n_loop = min(HYB_LOOP_HYPOTHESES, M)
    sync()
    t0 = time.perf_counter()
    for h in range(n_loop):
        one(h)
    sync()
    loop_ms = (time.perf_counter() - t0) * 1e3
    looped = count_launches()
    # the dense path of b)'s code on a cut, on the CPU
    cut = [(a, b, ms) for a, b, ms in parsed if a < HYB_SPARSE_CUT and b < HYB_SPARSE_CUT]
    gc_card, gc_cpu = (city_hybrid(cut, HYB_SPARSE_CUT, d_) for d_ in (dev, "cpu"))
    with counting_plain() as plain_cut:
        bc = eliminate_sparse(gc_card)
    count_launches()
    bh = gc_cpu.eliminate()
    cut_gap = float((bc.log_probs.cpu() - bh.log_probs).abs().max())
    # the kernels at every folded bucket shape
    cases = sorted({(M * bm.B, bm.nf, bm.ns, d) for bm in sp.maps.buckets})
    errs = {}
    t0 = time.perf_counter()
    if dev == "cuda":
        check_kernels(torch, (v2, v1, kernels), cases, {"float64": {}, "float32": {}},
                      extras=False, errs_out=errs)
    check_s = time.perf_counter() - t0
    worst = tuple(max(g_[i] for g_ in gaps) for i in (1, 2, 3))
    out["c"] = dict(poses=HYB_CITY_POSES, D=3 * HYB_CITY_POSES, terms=len(g.gaussians), M=M,
                    plan=sp.plan.stats(), buckets=len(sp.maps.buckets), routes=routes,
                    pool_bytes=pool_bytes, host_s=plan_s, solve_ms=solve_ms,
                    busy_ms=prof[0] if prof else None, cuda_kernels=prof[1] if prof else None,
                    launches_folded=folded, launches_single=single, launches_loop=looped,
                    loop_hypotheses=n_loop, loop_ms=loop_ms, samples=gaps, cut_poses=HYB_SPARSE_CUT,
                    cut_M=int(bc.log_probs.shape[0]), cut_log_p_abs=cut_gap,
                    kernel_shapes=cases, kernel_max_abs_err=errs, kernel_check_s=check_s,
                    plain_calls=dict(plain_c))
    busy = (f"{prof[0]:.3f} ms busy ({100.0 * prof[0] / solve_ms:.1f}%), {prof[1]} CUDA kernels"
            if prof else "busy not measured")
    log(f"hybrid c) folded solve of M = {M}: {solve_ms:.3f} ms ({busy}); launches {folded}; one "
        f"hypothesis's multifrontal_solve {single}; a Python loop over {n_loop} of the {M} "
        f"hypotheses {loop_ms:.1f} ms ({loop_ms / n_loop:.3f} ms a hypothesis), launches {looped}; {len(gaps)} sampled hypotheses against their own "
        f"multifrontal_solve: x {worst[0]:.3e}, E {worst[1]:.3e}, logdet {worst[2]:.3e} (rel); "
        f"the {HYB_SPARSE_CUT}-pose cut (M = {out['c']['cut_M']}) card sparse against CPU "
        f"dense log p {cut_gap:.3e}; {len(cases)} folded bucket shapes, kernels against plain "
        f"versions {errs} ({check_s:.1f} s); plain versions on the card {dict(plain_c)}")
    if not (all(g_ <= HYB_GATE for g_ in worst) and cut_gap <= HYB_GATE
            and (dev != "cuda" or (folded == single and not plain_c and not plain_cut
                                   and all(looped[k] == n_loop * single[k] for k in KERNELS)
                                   and max(errs["float64"].values()) <= GEO_KERNEL_GATE))):
        raise AssertionError("hybrid c): the folded sparse path failed its gates")
    del g, sp, xs, Es, lds, gc_card, gc_cpu
    lap("c")

    # d) HybridSmoother over Hybrid City lines as linear slices
    hlines, _, truth = synthetic.hybrid_city_stream(HYB_CITY_POSES, seed=SEED, p_ambiguous=0.0,
                                                    p_false_loop=HYB_FALSE_LOOPS)
    hparsed = city_lines_parsed(hlines[:HYB_SMOOTHER_LINES])
    n_sm = 1 + max(b for _, b, _ in hparsed)
    res, d_launches = {}, None
    for d_ in dict.fromkeys((dev, "cpu")):
        slices = hybrid_city_slices(torch, hparsed, city_jacobians(torch, hparsed, n_sm, d_),
                                    len(hparsed), d_)
        sm = HybridSmoother(max_leaves=HYB_SMOOTHER_LEAVES, device=d_)
        ms_, cross = [], None
        v1.reset_launch_counts()
        with counting_plain() as plain_d:
            for i, s in enumerate(slices):
                sync()
                t0 = time.perf_counter()
                sm.update(s)
                sync()
                ms_.append((time.perf_counter() - t0) * 1e3)
                if cross is None and sm.graph._cont_offsets()[1] > sm.dense_dim_limit:
                    cross = i
        if d_ == "cuda":
            d_launches = count_launches()
            if plain_d:
                raise AssertionError(f"hybrid d): a plain version ran on the card: {plain_d}")
        res[d_] = (sm.optimize(), np.asarray(ms_), cross, int(sm._hyp.shape[0]))
    (mpe_c, x_c), ms_c, cross, live = res[dev]
    (mpe_h, x_h), ms_h, _, _ = res["cpu"]
    traj_gap = rel(torch.cat([x_c[k].cpu() for k in sorted(x_h)]),
                   torch.cat([x_h[k] for k in sorted(x_h)]))
    loops_true = [bool(truth["loop_true"][i]) for i, (a, b, _) in enumerate(hparsed) if b != a + 1]
    choice = [mpe_c[10_000 + i] for i, (a, b, _) in enumerate(hparsed) if b != a + 1]
    n_false = int((~truth["loop_true"][: len(hparsed)]).sum())
    out["d"] = dict(lines=len(hparsed), poses=n_sm, modes=len(choice), max_leaves=HYB_SMOOTHER_LEAVES,
                    live=live, sparse_from_update=cross, ms_card=stats_ms(ms_c), ms_cpu=stats_ms(ms_h),
                    dense_ms_mean=float(ms_c[:cross].mean()) if cross else None,
                    sparse_ms_mean=float(ms_c[cross:].mean()) if cross is not None else None,
                    traj_rel=traj_gap, loops_accepted_true=sum(c == 1 and t for c, t in zip(choice, loops_true)),
                    loops_true=sum(loops_true), launches=d_launches)
    log(f"hybrid d) HybridSmoother (max_leaves {HYB_SMOOTHER_LEAVES}) over {len(hparsed)} Hybrid "
        f"City lines ({n_sm} poses, {len(choice)} loop modes, {n_false} false): ms per update on the "
        f"card {out['d']['ms_card']}, CPU {out['d']['ms_cpu']}; the dense limit ("
        f"{sm.dense_dim_limit} dims) crossed at update {cross} (dense mean "
        f"{out['d']['dense_ms_mean']} ms, sparse mean {out['d']['sparse_ms_mean']} ms); MPE "
        f"card = CPU {mpe_c == mpe_h}, trajectory {traj_gap:.3e} (rel); true loops accepted "
        f"{out['d']['loops_accepted_true']} of {out['d']['loops_true']}; launches on the card "
        f"{d_launches}")
    if not (mpe_c == mpe_h and traj_gap <= HYB_GATE and (
            dev != "cuda" or cross is None or d_launches["backsolve_bucket"] > 0)):
        raise AssertionError("hybrid d): the smoother failed its gates")
    del res
    lap("d")

    # e) Hybrid City on the card against the host engine on the CPU
    path = os.path.join(work, "hybrid_city_stream.txt")
    with open(path, "w") as f:
        f.write("\n".join(hlines[:HYB_CITY_LINES]) + "\n")
    runs = {}
    for d_, be in ((dev, "torch"), ("cpu", "numpy")):
        with counting_plain() as plain_e:
            v1.reset_launch_counts()
            runs[be] = run_hybrid_city(path, HYB_CITY_LINES, max_hypotheses=HYB_CITY_HYPOTHESES,
                                       progress=0, device=d_, engine_backend=be)
            if d_ == "cuda":
                e_launches = count_launches()
        if d_ == "cuda" and plain_e:
            raise AssertionError(f"hybrid e): a plain version ran on the card: {plain_e}")
    rc, rh = runs["torch"], runs["numpy"]
    traj_gap = float(np.abs(rc["traj"] - rh["traj"]).max())
    post_gap = float(np.abs(np.asarray(rc["posterior"]) - np.asarray(rh["posterior"])).max())
    n_poses = rc["poses"]
    gt_ = synthetic.city_stream(HYB_CITY_POSES, seed=SEED)[1][:n_poses]
    ate = float(np.sqrt(np.mean(np.sum((rc["traj"][:, :2] - gt_[:, :2]) ** 2, axis=1))))
    lt = [bool(truth["loop_true"][i]) for i, ln in enumerate(hlines[:HYB_CITY_LINES])
          if int(ln.split()[3]) != int(ln.split()[1]) + 1]
    right = sum((c == 1) == t for c, t in zip(rc["choices"], lt))
    # a short run with ambiguous odometry lines: forks through the serializer
    flines, _, _ = synthetic.hybrid_city_stream(HYB_CITY_POSES, seed=SEED, p_ambiguous=0.15,
                                                p_false_loop=HYB_FALSE_LOOPS)
    fpath = os.path.join(work, "hybrid_city_forks.txt")
    with open(fpath, "w") as f:
        f.write("\n".join(flines[:HYB_FORK_LINES]) + "\n")
    fr = run_hybrid_city(fpath, HYB_FORK_LINES, max_hypotheses=HYB_CITY_HYPOTHESES, progress=0,
                         device=dev)
    n_amb = sum(len(ln.split()) > 9 for ln in flines[:HYB_FORK_LINES])
    out["e"] = dict(lines=rc["lines"], poses=n_poses, modes=rc["modes"], max_hypotheses=HYB_CITY_HYPOTHESES,
                    live=rc["live_hypotheses"], p50_ms=rc["step_ms_p50"], p90_ms=rc["step_ms_p90"],
                    mean_ms=rc["step_ms_mean"], total_s=rc["total_s"], host_total_s=rh["total_s"],
                    host_p50_ms=rh["step_ms_p50"], updates_per_line=rc["updates_per_line"],
                    forks=rc["forks"], accept_frac=rc["best_loop_accept_frac"],
                    loop_choices_right=right, loops=len(lt), ate_m=ate, traj_abs=traj_gap,
                    posterior_abs=post_gap, launches=e_launches if dev == "cuda" else None,
                    fork_run=dict(lines=HYB_FORK_LINES, ambiguous=n_amb, forks=fr["forks"],
                                  live=fr["live_hypotheses"], posterior=fr["posterior"]))
    log(f"hybrid e) run_hybrid_city over {rc['lines']} lines ({n_poses} poses, {rc['modes']} loop "
        f"modes, max_hypotheses {HYB_CITY_HYPOTHESES}) on the card: {rc['total_s']:.1f} s, ms "
        f"per line p50 {rc['step_ms_p50']:.1f} p90 {rc['step_ms_p90']:.1f}, "
        f"{rc['updates_per_line']:.2f} ISAM2 updates a line, {rc['forks']} forks; best "
        f"hypothesis: loops accepted {rc['best_loop_accept_frac']:.3f}, {right} of {len(lt)} "
        f"loop choices right, ATE {ate:.4f} m; against the host engine on the CPU ("
        f"{rh['total_s']:.1f} s): choices equal {rc['choices'] == rh['choices']}, trajectory "
        f"{traj_gap:.3e}, posterior {post_gap:.3e}; forking run: {HYB_FORK_LINES} lines with "
        f"{n_amb} ambiguous odometry lines, {fr['forks']} forks, {fr['live_hypotheses']} live, "
        f"posterior {['%.6f' % p for p in fr['posterior']]}")
    if not (rc["choices"] == rh["choices"] and traj_gap <= 1e-6 and post_gap <= 1e-6
            and fr["live_hypotheses"] == min(2 ** fr["modes"], HYB_CITY_HYPOTHESES)
            and abs(sum(fr["posterior"]) - 1.0) <= 1e-9):
        raise AssertionError("hybrid e): Hybrid City failed its gates")
    lap("e")

    # f) g2o write / read, the solver comparer, a timed span
    va, fa = synthetic.sphere_rings(N_RINGS, N_PER_RING, seed=SEED)
    g64 = convert.graph_from_arrays(fa, device=dev)
    v64 = convert.values_from_arrays(va, device=dev)
    gpath = os.path.join(work, "sphere.g2o")
    timing.tictoc_reset()
    with timing.tic("write_g2o"):
        dataset.write_g2o(g64, v64, gpath)
    with timing.tic("read_g2o"):
        _, rv = dataset.read_g2o(gpath, is3D=True, device=dev)
    e0, e1 = float(g64.error(v64)), float(g64.error(rv))
    span = timing.tictoc_get("read_g2o")
    cpath = os.path.join(work, "city.g2o")
    clines = city_lines_parsed(synthetic.city_stream(3687, seed=SEED)[0][:HYB_COMPARER_LINES])
    n_c = 1 + max(b for _, b, _ in clines)
    xdr = np.zeros((n_c, 3))
    edges = []
    for a, b, ms in clines:
        if b == a + 1:
            xdr[b] = synthetic.pose2_compose_np(xdr[a], ms[0])
        info = 1.0 / np.square(synthetic.CITY_SIGMAS if b == a + 1 else (10.0, 10.0, 10.0))
        edges.append(f"EDGE_SE2 {a} {b} {ms[0][0]:.9f} {ms[0][1]:.9f} {ms[0][2]:.9f} "
                     f"{info[0]} 0 0 {info[1]} 0 {info[2]}")
    dataset.write_g2o(None, convert.values_from_arrays({"Pose2": (np.arange(n_c), xdr)},
                                                       device="cpu"), cpath)
    with open(cpath, "a") as f:
        f.write("\n".join(edges) + "\n")
    sa, sb = os.path.join(work, "cmp_batch.npz"), os.path.join(work, "cmp_pert.npz")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as cmp_out:
        bres = solver_comparer.main(["--batch", "-d", cpath, "-o", sa, "--device", dev,
                                     "--iterations", "30"])
        solver_comparer.main(["--perturb", sa, "-o", sb, "--device", dev])
        diff = solver_comparer.main(["--compare", sa, sb, "--device", dev])
    cmp_s = time.perf_counter() - t0
    pert = np.random.default_rng(42).normal(scale=0.01, size=np.load(sa)["sol"].shape)
    want = np.linalg.norm(pert[:, -2:], axis=1)
    out["f"] = dict(sphere_error=e0, read_error=e1, read_rel=abs(e1 - e0) / e0,
                    write_ms=timing.tictoc_get("write_g2o").wall * 1e3, read_ms=span.wall * 1e3,
                    comparer_lines=HYB_COMPARER_LINES, comparer_poses=n_c,
                    batch_error=float(bres.error), batch_iterations=bres.iterations,
                    comparer_s=cmp_s, compare_mean=float(diff.mean()), compare_max=float(diff.max()))
    log(f"hybrid f) the phase-4 sphere through write_g2o ({out['f']['write_ms']:.1f} ms) and "
        f"read_g2o onto the card ({out['f']['read_ms']:.1f} ms, timing.tic spans): its error at "
        f"the read values {e1:.9e} against {e0:.9e} (rel {out['f']['read_rel']:.3e}; the file "
        f"keeps 6 decimals); solver_comparer on a {HYB_COMPARER_LINES}-line City file ({n_c} "
        f"poses): batch LM {bres.error:.6e} in {bres.iterations} iterations, perturb, compare "
        f"(mean {diff.mean():.6f} max {diff.max():.6f} m), {cmp_s:.1f} s; comparer output "
        f"{len(cmp_out.getvalue().splitlines())} lines")
    if not (out["f"]["read_rel"] <= 1e-3 and np.allclose(diff, want, atol=1e-12)
            and bres.error <= bres.error_history[0] and span.n == 1):
        raise AssertionError("hybrid f): the utilities failed their gates")
    for p_ in (path, fpath, gpath, cpath, sa, sb):
        os.remove(p_)
    lap("f")

    out["launches"] = launches
    log(f"hybrid launches (c)'s folded, single, sampled, looped and cut solves, d)'s and e)'s "
        f"card runs; each counted once): {launches}")
    # the City plan's fronts all fit shared memory (K1 takes none of them):
    # every kernel its routing names, and K2, must have run
    need = {"backsolve_bucket"} | {ROUTE_KERNEL[r[0]] for r in out["c"]["routes"]}
    if dev == "cuda" and not all(launches[k] > 0 for k in need):
        raise AssertionError(f"hybrid: a kernel of the hybrid path was never launched: {launches}")
    out["phase_s"] = time.perf_counter() - t_phase
    out["seconds"] = secs
    log(f"hybrid phase: {out['phase_s']:.1f} s (" + ", ".join(
        f"{k}) {x:.1f} s" for k, x in secs.items()) + f") on {card}")
    return out



# --- phase 7: smart-factor bundle adjustment --------------------------------------------


class ValidRecorder:
    """Each error evaluation of `smart_levenberg_marquardt` as (error, VALID
    tracks): `smart.total_error` and the graph's `error` are wrapped (one
    device read each), so every entry of an error history finds the
    evaluation it came from. For the gate runs only, never a timed one."""

    def __init__(self, smart, graph):
        self.smart, self.graph, self.evals = smart, graph, []
        self._pending = None

    def __enter__(self):
        smart, orig = self.smart, self.smart.total_error
        graph_error = self.graph.error

        def total_error(batch, poses):
            _, _, b, valid = smart._track_terms(batch, poses)
            e = 0.5 * (b * valid.to(b.dtype)[:, None, None]).pow(2).sum()
            self._pending = (e, int(valid.sum()))
            return e

        def error(values):
            eg = graph_error(values)
            es, n = self._pending
            self.evals.append((float(es + eg), n))
            return eg

        self._saved = orig
        smart.total_error, self.graph.error = total_error, error
        return self

    def __exit__(self, *exc):
        self.smart.total_error = self._saved
        del self.graph.error

    def valid_for(self, history):
        """VALID tracks at each history entry (NaN matches NaN)."""
        out, k = [], 0
        for h in history:
            while not (self.evals[k][0] == h or (h != h and self.evals[k][0] != self.evals[k][0])):
                k += 1
            out.append(self.evals[k][1])
        return out


def smart_problem(torch, scene, mask, dtype, device):
    """(graph with the two camera priors, initial Values, smart batch) of a
    `ba_synth.smart_scene` / `smart_rig` dict on `device` in `dtype`."""
    import numpy as np

    from gtsam_petercdev_torch.geometry.pose3 import Pose3
    from gtsam_petercdev_torch.linear import noise
    from gtsam_petercdev_torch.models import ba_synth
    from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
    from gtsam_petercdev_torch.nonlinear.values import Values
    from gtsam_petercdev_torch.slam.factors import prior_factor
    from gtsam_petercdev_torch.device import resolve_device
    from gtsam_petercdev_torch.utils import convert

    batch = convert.smart_batch_from_arrays(scene["cam_rows"], mask, scene["measured"],
                                            np.array([ba_synth.SMART_CAL]), device=device,
                                            dtype=dtype)
    t = lambda a: torch.as_tensor(a).to(resolve_device(device), dtype)
    values = Values(device=device, dtype=dtype)
    values.insert_batch(np.arange(len(scene["R0"])), "Pose3", Pose3(t(scene["R0"]), t(scene["t0"])))
    graph = NonlinearFactorGraph(device=device, dtype=dtype)
    for i in (0, 1):
        graph.add(prior_factor("Pose3"), [i], Pose3(t(scene["R"][i]), t(scene["t"][i])),
                  noise.isotropic(6, SMART_PRIOR_SIGMA, np.float64))
    return graph, values, batch


def camera_system_checks(torch, smart, batch, poses, n_cams, pcg_runs):
    """On one linearization: for each (lambda, max iterations) of pcg_runs,
    the HESSIAN-mode damped solve against smart_pcg (rel) and smart_pcg's
    device->host reads; JACOBIAN_Q / JACOBIAN_SVD's A^T A and A^T b against
    H and g (rel to max |H|, max |g|)."""
    from gtsam_petercdev_torch.linear import solve as linsolve

    H, g, _ = smart.assemble_camera_system(batch, poses, n_cams)
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    out = {"pcg": []}
    for lam, max_iters in pcg_runs:
        xh = torch.linalg.solve(H + lam * eye, g)
        reads = [0]
        orig = linsolve._cg_continues

        def counted(*a):
            reads[0] += 1
            return orig(*a)

        linsolve._cg_continues = counted
        try:
            xp = smart.smart_pcg(batch, poses, n_cams, lam=lam, max_iters=max_iters).reshape(-1)
        finally:
            linsolve._cg_continues = orig
        out["pcg"].append(dict(lam=lam, max_iters=max_iters, reads=reads[0],
                               rel=((xp - xh).norm() / xh.norm()).item()))
    T = batch.n_tracks
    cols = (batch.rows_dev[:, :, None] * 6 + torch.arange(6, device=H.device)).reshape(T, -1)
    for mode in ("jacobian_q_factors", "jacobian_svd_factors"):
        A, b = getattr(smart, mode)(batch, poses)
        Af = A.reshape(T, A.shape[1], -1)
        AtA = torch.einsum("tri,trj->tij", Af, Af)
        Hq, gq = torch.zeros_like(H), torch.zeros_like(g)
        Hq.index_put_((cols[:, :, None].expand(AtA.shape), cols[:, None, :].expand(AtA.shape)),
                      AtA, accumulate=True)
        gq.index_put_((cols,), torch.einsum("tri,tr->ti", Af, b), accumulate=True)
        out[mode] = (((Hq - H).abs().max() / H.abs().max()).item(),
                     ((gq - g).abs().max() / g.abs().max()).item())
    return out


def start_sensitivity(torch, smart, batch, poses):
    """How much the start's error moves when every camera centre is scaled
    by (1 + 1e-15), a change of one or two ulps: its relative change, and
    the tracks whose whitened residual moves by more than 1e-6 of its size
    (a triangulation on a knife edge). An error history can agree with
    another implementation's no closer than this."""
    from gtsam_petercdev_torch.geometry.pose3 import Pose3

    _, _, b0, v0 = smart._track_terms(batch, poses)
    _, _, b1, v1 = smart._track_terms(batch, Pose3(poses.R, poses.t * (1 + 1e-15)))
    e = lambda b, v: 0.5 * (b * v.to(b.dtype)[:, None, None]).pow(2).sum()
    e0, e1 = e(b0, v0), e(b1, v1)
    n0 = b0.flatten(1).norm(dim=1)
    moved = ((b1 - b0).flatten(1).norm(dim=1) > 1e-6 * n0) | (v0 != v1)
    return dict(error_rel=((e1 - e0).abs() / e0).item(), tracks_moved=int(moved.sum()),
                valid=int(v0.sum()), valid_moved=int(v1.sum()))


def run_smart(torch, here):
    """Phase 7: smart-factor BA through `smart_levenberg_marquardt`."""
    import numpy as np

    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.models import ba_synth
    from gtsam_petercdev_torch.nonlinear.optimizers import LMParams
    from gtsam_petercdev_torch.slam import smart

    with open(os.path.join(here, SMART_REF)) as f:
        ref = json.load(f)
    iters = ref["iterations"]
    out = {}

    # a) the small ragged rig: card = CPU path, history and VALID tracks
    rig = ba_synth.smart_rig(*SMART_RIG, seed=SEED)
    hist, valid = {}, {}
    for dev in ("cuda", "cpu"):
        graph, values, batch = smart_problem(torch, rig, rig["mask"], torch.float64, dev)
        with ValidRecorder(smart, graph) as rec:
            r = smart.smart_levenberg_marquardt(graph, batch, values, LMParams(max_iterations=10),
                                                device=dev)
        hist[dev], valid[dev] = r.error_history, rec.valid_for(r.error_history)
        if dev == "cuda":
            poses = smart.gather_poses(batch, values.params("Pose3"))
            rig_checks = camera_system_checks(torch, smart, batch, poses, SMART_RIG[0],
                                              [(1.0, 200)])
    rel = max(abs(a - b) / abs(b) for a, b in zip(hist["cuda"], hist["cpu"]))
    log(f"smart rig ({SMART_RIG[0]} cameras, {SMART_RIG[1]} tracks of 2-6 views + a behind-camera "
        f"and a single-view track), f64 LM card vs CPU: history rel {rel:.3e} "
        f"({len(hist['cuda'])} / {len(hist['cpu'])} entries), VALID tracks card {valid['cuda']} "
        f"CPU {valid['cpu']}; first linearization on the card: HESSIAN vs smart_pcg "
        f"{rig_checks['pcg']}, A^T A / A^T b vs H / g: "
        f"Q {rig_checks['jacobian_q_factors']}, SVD {rig_checks['jacobian_svd_factors']}")
    if not (len(hist["cuda"]) == len(hist["cpu"]) and rel <= 1e-9
            and valid["cuda"] == valid["cpu"] and valid["cuda"][0] == SMART_RIG[1]):
        raise AssertionError("smart rig: the card and the CPU path disagree")
    if not (rig_checks["pcg"][0]["rel"] <= 1e-6 and max(rig_checks["jacobian_q_factors"]) <= 1e-9
            and max(rig_checks["jacobian_svd_factors"]) <= 1e-9):
        raise AssertionError(f"smart rig: the linearization modes disagree: {rig_checks}")
    out["rig"] = dict(history_rel=rel, valid=valid["cuda"], **rig_checks)

    # b) the BA cell's scene in smart-factor form, float64 and float32
    data = ba_synth.make_synthetic_ba(*ref["shape"], seed=ref["seed"], dtype=np.float64)
    scene = ba_synth.smart_scene(data, seed=ref["scene_seed"])
    n_cams = len(scene["R"])
    mask = np.ones(scene["cam_rows"].shape, bool)
    for name, dtype in (("float64", torch.float64), ("float32", torch.float32)):
        graph, values, batch = smart_problem(torch, scene, mask, dtype, "cuda")
        params = LMParams(max_iterations=iters)
        with ValidRecorder(smart, graph) as rec:
            r = smart.smart_levenberg_marquardt(graph, batch, values, params, device="cuda")
        n_valid = rec.valid_for(r.error_history)
        jref = ref["runs"][f"jax_{name}"]
        m = min(len(r.error_history), len(jref["error_history"]))
        dist = [abs(a - b) / abs(b) if b == b else None
                for a, b in zip(r.error_history[:m], jref["error_history"][:m])]
        # the timed run: the same LM, no recorder
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r2 = smart.smart_levenberg_marquardt(graph, batch, values, params, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30

        def step(v, graph=graph, batch=batch):  # one linearization and damped solve
            H, g, _ = smart.assemble_camera_system(batch, smart.gather_poses(batch, v.params("Pose3")),
                                                   n_cams)
            H2, g2 = linsolve.assemble_dense(graph.linearize(v))
            x = linsolve.dense_solve(H + H2, g + g2, 1e-5)
            return v.retract({"Pose3": x.reshape(n_cams, 6)})

        prof = profile_step(torch, step, values, top=6)
        busy, n_launch = (prof[0], prof[1]) if prof else (None, None)
        step_ms, _ = chained_ms(torch, lambda v: (step(v), v)[1], values, 4)
        err_ms, _ = chained_ms(torch, lambda v: (smart.total_error(
            batch, smart.gather_poses(batch, v.params("Pose3"))), v)[1], values, 4)
        res = dict(history=r.error_history, valid=n_valid, jax_history=jref["error_history"],
                   jax_valid=jref["valid_tracks"], rel_to_jax=dist, iterations=r.iterations,
                   timed_run_history=r2.error_history,
                   iters_per_s=r2.iterations / wall, wall_s=wall, peak_gib=peak,
                   step_ms=step_ms, step_busy_ms=busy, step_launches=n_launch,
                   error_eval_ms=err_ms)
        log(f"smart BA {name} ({n_cams} cameras, {batch.n_tracks} tracks): LM history "
            f"{['%.9e' % e for e in r.error_history]}, VALID tracks {n_valid}; JAX package (CPU) "
            f"{['%.9e' % e for e in jref['error_history']]}, VALID {jref['valid_tracks']}; rel "
            f"{dist}; timed run (no recorder) {['%.9e' % e for e in r2.error_history]}: "
            f"{r2.iterations} iterations in {wall:.3f} s = {r2.iterations / wall:.3f} LM "
            f"iterations/s, peak device memory {peak:.2f} GiB; one linearization and damped "
            f"solve (assemble, dense Cholesky, retract) {step_ms:.3f} ms chained, device busy "
            f"{busy if busy is None else round(busy, 3)} ms, {n_launch} kernel launches; one "
            f"error evaluation (triangulation included) {err_ms:.3f} ms")
        if prof:
            log(f"smart BA {name} step, top kernels by device time: "
                + "; ".join(f"{kms:.3f} ms {calls}x {key[:70]}" for key, kms, calls in prof[2]))
            res["step_top_kernels"] = [(key[:70], kms, calls) for key, kms, calls in prof[2]]
        if not all(e == e and abs(e) != float("inf") for e in r.error_history):
            raise AssertionError(f"smart BA {name}: the error history is not finite")
        if name == "float64":
            poses = smart.gather_poses(batch, values.params("Pose3"))
            sens = res["start_sensitivity"] = start_sensitivity(torch, smart, batch, poses)
            log(f"smart BA float64 start: the camera centres scaled by (1 + 1e-15) move the "
                f"start's error by rel {sens['error_rel']:.3e}; tracks whose whitened residual "
                f"moves by more than 1e-6 of its size {sens['tracks_moved']} of "
                f"{batch.n_tracks} (VALID {sens['valid']} -> {sens['valid_moved']}); the start "
                f"vs the JAX package's rel {dist[0]:.3e} (gate <= 10x the former)")
            # the history beyond the start is reported: it can agree with
            # the JAX package's no closer than the start's sensitivity
            if not (r.error < r.error_history[0] and n_valid[0] == jref["valid_tracks"][0]
                    and dist[0] <= 10 * sens["error_rel"]):
                raise AssertionError("smart BA float64: the error did not fall, or the start "
                                     "(error, VALID tracks) differs from the JAX package's")
            res["first_step"] = camera_system_checks(torch, smart, batch, poses, n_cams,
                                                     [(1e-5, 200), (1.0, 200), (1.0, 5000)])
            log(f"smart BA float64 first linearization: {res['first_step']}")
        out[name] = res
    return out


# --- phase 8: the remaining batch optimizers -----------------------------------------------


def run_optimizers(torch, v1, fa, va, g64, v64, g32, opt_maps, lg0):
    """Phase 8 on the sphere: mixed-precision GN (float32 through K1-K4 on
    the card, float64 residual and retract on the host), dogleg, LM on PCG,
    factor / apply and the log-determinant; NCG on a small graph."""
    from gtsam_petercdev_torch.inference import elimination
    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.nonlinear.optimizers import (
        DoglegParams, LMParams, OptimizerParams, dogleg, gauss_newton,
        gauss_newton_mixed_precision, levenberg_marquardt, nonlinear_conjugate_gradient)
    from gtsam_petercdev_torch.utils import convert, synthetic

    out = {}
    t0 = time.perf_counter()
    gn = gauss_newton(g64, v64, OptimizerParams(solver="multifrontal", max_iterations=20),
                      device="cuda")
    torch.cuda.synchronize()
    log(f"GN f64 to convergence: {['%.9e' % e for e in gn.error_history]} "
        f"({time.perf_counter() - t0:.1f} s)")
    check_result(gn, "GN f64")

    gh = convert.graph_from_arrays(fa, device="cpu")
    vh = convert.values_from_arrays(va, device="cpu")
    gauss_newton_mixed_precision(g32, gh, vh, OptimizerParams(max_iterations=1), device="cuda")
    # each call plans its elimination on the host once: timed apart
    plan_s = [0.0]
    saved = [(name, getattr(elimination, name))
             for name in ("build_plan_for_graph", "build_numeric_maps")]

    def host_timed(fn):
        def timed(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            plan_s[0] += time.perf_counter() - t
            return out
        return timed

    for name, fn in saved:
        setattr(elimination, name, host_timed(fn))
    v1.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        mx = gauss_newton_mixed_precision(g32, gh, vh, OptimizerParams(max_iterations=20),
                                          device="cuda")
        torch.cuda.synchronize()
    finally:
        for name, fn in saved:
            setattr(elimination, name, fn)
    wall = time.perf_counter() - t0 - plan_s[0]
    launches, cuda_launches = v1.launch_counts(), v1.cuda_launch_counts()
    per_it = {k: n / mx.iterations for k, n in launches.items()}
    out["mixed"] = dict(history=mx.error_history, iterations=mx.iterations,
                        ms_per_iter=wall * 1e3 / mx.iterations, launches=launches,
                        cuda_launches=cuda_launches,
                        launches_per_iter=per_it, gn_f64_error=gn.error)
    out["mixed"]["plan_s"] = plan_s[0]
    log(f"mixed-precision GN (f32 on the card, f64 host): {['%.9e' % e for e in mx.error_history]}; "
        f"{mx.iterations} iterations, {wall * 1e3 / mx.iterations:.3f} ms per iteration "
        f"(host planning {plan_s[0]:.2f} s apart); launches {launches} = {per_it} per "
        f"iteration; final vs GN f64 rel {(mx.error - gn.error) / gn.error:.3e}")
    if not (mx.error <= gn.error * (1 + 1e-9) and mx.values.dtype == torch.float64
            and all(n > 0 for n in launches.values())):
        raise AssertionError("mixed-precision GN missed the f64 optimum or a kernel was not "
                             f"launched: {mx.error} vs {gn.error}, {launches}")

    t0 = time.perf_counter()
    dl = dogleg(g64, v64, DoglegParams(max_iterations=20), device="cuda")
    t_dl = time.perf_counter() - t0
    t0 = time.perf_counter()
    lp = levenberg_marquardt(g64, v64, LMParams(solver="pcg", max_iterations=20), device="cuda")
    t_lp = time.perf_counter() - t0
    rel_dl = abs(dl.error - gn.error) / gn.error
    rel_lp = abs(lp.error - gn.error) / gn.error
    dp = linsolve.pcg_solve(lg0, 1e-5, tol=1e-10, max_iters=1000)
    dm, _ = elimination.solve_linearized(g64, v64, 1e-5, cache={"mf_lg": lg0})
    rel_step = ((dp["Pose3"] - dm["Pose3"]).norm() / dm["Pose3"].norm()).item()
    log(f"dogleg: {['%.9e' % e for e in dl.error_history]} ({t_dl:.1f} s), vs GN rel {rel_dl:.3e}; "
        f"LM on PCG: {['%.9e' % e for e in lp.error_history]} ({t_lp:.1f} s), vs GN rel "
        f"{rel_lp:.3e}; first step (lambda 1e-5) PCG vs multifrontal rel {rel_step:.3e}")
    if not (rel_dl <= 1e-8 and rel_lp <= 1e-8 and rel_step <= 1e-6):
        raise AssertionError("dogleg / PCG LM disagree with GN")
    out.update(dogleg=dict(history=dl.error_history, rel_to_gn=rel_dl, s=t_dl),
               lm_pcg=dict(history=lp.error_history, rel_to_gn=rel_lp, s=t_lp),
               pcg_first_step_rel=rel_step)

    # factor once, apply to J^T b: the solve's delta; log det against slogdet
    Ab = tuple((lb.A, lb.b) for lb in lg0.batches)
    x, stats = elimination.multifrontal_solve(opt_maps, Ab, 0.0, return_logdet=True)
    chol = elimination.multifrontal_factor(opt_maps, Ab, 0.0)
    xa = elimination.multifrontal_apply(opt_maps, chol, linsolve.gradient(lg0)["Pose3"])
    rel_fa = ((xa - x).norm() / x.norm()).item()
    H, _ = linsolve.assemble_dense(lg0)
    sign, ld = torch.linalg.slogdet(H)
    rel_ld = abs(float(stats["logdet"]) - float(ld)) / abs(float(ld))
    log(f"factor / apply vs solve (f64): rel {rel_fa:.3e}; logdet {float(stats['logdet']):.12e} vs "
        f"slogdet {float(ld):.12e} (sign {float(sign)}): rel {rel_ld:.3e}")
    if not (rel_fa <= 1e-10 and rel_ld <= 1e-10 and float(sign) == 1.0):
        raise AssertionError("factor / apply or the log-determinant disagree")
    out.update(factor_apply_rel=rel_fa, logdet_rel=rel_ld)
    del H

    sva, sfa = synthetic.sphere_rings(4, 5, seed=SEED + 1)
    nc = nonlinear_conjugate_gradient(convert.graph_from_arrays(sfa, device="cuda"),
                                      convert.values_from_arrays(sva, device="cuda"),
                                      OptimizerParams(max_iterations=50), device="cuda")
    log(f"NCG (20-pose rings, 50 iterations): {nc.error_history[0]:.6e} -> {nc.error:.6e} in "
        f"{nc.iterations} iterations")
    check_result(nc, "NCG")
    out["ncg"] = dict(start=nc.error_history[0], end=nc.error, iterations=nc.iterations)
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "gtsam_petercdev_torch")):
        print("chip_smoke: gtsam_petercdev_torch/ is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    kernels_only = "--kernels-only" in sys.argv[1:]
    isam2_only = "--isam2-only" in sys.argv[1:]
    smart_only = "--smart-only" in sys.argv[1:]
    optimizers_only = "--optimizers-only" in sys.argv[1:]
    family_only = "--isam2-family-only" in sys.argv[1:]
    partitioned_only = "--partitioned-only" in sys.argv[1:]
    navigation_only = "--navigation-only" in sys.argv[1:]
    init_only = "--init-only" in sys.argv[1:]
    robust_only = "--robust-only" in sys.argv[1:]
    geometry_only = "--geometry-only" in sys.argv[1:]
    hybrid_only = "--hybrid-only" in sys.argv[1:]
    t_start = time.perf_counter()

    import numpy as np

    from gtsam_petercdev_torch.inference import elimination, kernels, symbolic
    from gtsam_petercdev_torch.linear import solve as linsolve
    from gtsam_petercdev_torch.models.ba_synth import make_synthetic_ba
    from gtsam_petercdev_torch.models.bundle_adjustment import build_ba_graph
    from gtsam_petercdev_torch.nonlinear.optimizers import (
        LMParams, OptimizerParams, gauss_newton, levenberg_marquardt)
    from gtsam_petercdev_torch.ops import build, build_host, cholesky as v1, cholesky_v2 as v2
    from gtsam_petercdev_torch.sfm import schur
    from gtsam_petercdev_torch.utils import convert, synthetic

    # 1. card
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build: the host libraries (g++), then the kernels (nvcc)
    t0 = time.perf_counter()
    build_host.build_all()
    log(f"host build (g++ {' '.join(build_host.CXX_FLAGS)}): "
        + ", ".join(os.path.basename(build_host.library_path(k)) for k in build_host.SOURCES)
        + f" in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for line in build.build_all(verbose=True):
        log(line)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    # the f64 Schur update runs on the FP64 tensor cores: DMMA in its SASS
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", build.library_path("schur_update")],
                              capture_output=True, text=True, timeout=120).stdout
        n_dmma = sum("DMMA" in ln for ln in sass.splitlines())
        log(f"schur_update SASS (cuobjdump): {n_dmma} DMMA instructions")
        if n_dmma == 0:
            raise AssertionError("the f64 Schur update has no DMMA instruction")

    # the iSAM2 path's d = 3 buckets: every recorded shape is checked in
    # phase 3, and each kernel timed over a sweep of the shapes it takes
    isam2_level, isam2_wild = isam2_shapes(here)
    isam2_cases = list(dict.fromkeys([(B, nf, ns, 3) for B, nf, ns, _, _ in isam2_level]
                                     + [(B, nf, ns, 3) for B, nf, ns in isam2_wild]))
    isam2_timed = {}
    for name, col in (("float64", 3), ("float32", 4)):
        isam2_timed[name] = {"backsolve_bucket": [(B, nf, ns, 3) for B, nf, ns in isam2_wild]}
        for b in isam2_level:
            isam2_timed[name].setdefault(ROUTE_KERNEL[b[col]], []).append(b[:3] + (3,))
    log(f"iSAM2 d = 3 buckets ({ISAM2_SHAPES}): {len(isam2_level)} level shapes, "
        f"{len(isam2_wild)} wildfire shapes, {len(isam2_cases)} distinct")

    if hybrid_only:
        # phase 16 alone; no result line
        run_hybrid(torch, v1, here)
        log(f"hybrid-only run passed in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0

    if geometry_only:
        # phase 15 alone; no result line
        run_geometry(torch, v1)
        log(f"geometry-only run passed in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0

    if robust_only:
        # phase 14 alone; no result line
        run_robust(torch, v1)
        log(f"robust-only run passed in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0

    if init_only:
        # phase 13 alone; no result line
        run_init(torch, v1, here)
        log(f"init-only run passed in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0

    if navigation_only:
        # phase 12 alone; no result line
        run_navigation(torch, v1)
        log(f"navigation-only run passed in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0

    if smart_only:
        # phase 7 alone (its path runs no bucket kernel); no result line
        run_smart(torch, here)
        log(f"smart-only run passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    if isam2_only or family_only:
        # a check of this path alone: its kernels at their d = 3
        # shapes, then phase 6 or phase 9; no result line
        check_kernels(torch, (v2, v1, kernels), isam2_cases, isam2_timed, extras=False)
        if isam2_only:
            run_isam2(torch, here, v1)
        else:
            run_isam2_family(torch, here, v1)
        log(f"iSAM2{'' if isam2_only else ' family'}-only run passed in "
            f"{time.perf_counter() - t_start:.1f} s on {card}")
        return 0

    if kernels_only:
        # checked at a dozen shapes (the BA leaf, ragged K4 groups, both K2
        # modes among them) and the iSAM2 path's; timed over the bench plans'
        # buckets as the full run times them, their shapes and routes read
        # from BENCH_SHAPES
        cases = PALLAS_TEST_SHAPES + EXTRA_SHAPES + [
            (395, 1, 4, 6), (2, 12, 16, 6), BA_LEAF, (17, 1, 4, 9), (9, 1, 3, 6), (3, 1, 0, 9),
            (2, 3, 24, 9), (1, 12, 24, 9), (1, 24, 0, 9), (5, 3, 24, 9), (2, 24, 64, 6)
        ] + isam2_cases
        with open(os.path.join(here, BENCH_SHAPES)) as f:
            plans = json.load(f)
        timed = {}
        for name, col in (("float64", 3), ("float32", 4)):
            timed[name] = {k: [] for k in KERNELS}
            for plan in ("sphere", "ba"):
                for b in plans[plan]["buckets"]:
                    shape = (b[0], b[1], b[2], plans[plan]["d"])
                    timed[name][ROUTE_KERNEL[b[col]]].append(shape)
                    timed[name]["backsolve_bucket"].append(shape)
        check_kernels(torch, (v2, v1, kernels), cases, timed)
        log(f"kernels-only check passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    # the sphere problem and its plans (host planning)
    va, fa = synthetic.sphere_rings(N_RINGS, N_PER_RING, seed=SEED)
    g64 = convert.graph_from_arrays(fa, device="cuda", dtype=torch.float64)
    v64 = convert.values_from_arrays(va, device="cuda", dtype=torch.float64)
    g32 = convert.graph_from_arrays(fa, device="cuda", dtype=torch.float32)
    v32 = convert.values_from_arrays(va, device="cuda", dtype=torch.float32)
    n_fac = sum(len(k) for name, k, _, _ in fa if name.startswith("Between"))
    log(f"sphere problem: {len(va['Pose3'][0])} poses, {n_fac} between factors + 1 prior")
    t0 = time.perf_counter()
    structure = elimination.graph_structure(g64, v64)
    bench_plan = elimination.build_plan_for_graph(structure, len(v64), 6, max_buckets_per_level=4)
    bench_maps = elimination.build_numeric_maps(bench_plan, structure)
    lg0 = g64.linearize(v64)
    opt_plan, opt_maps = elimination._graph_plan(g64, lg0)
    log(f"sphere plans: {time.perf_counter() - t0:.1f} s; bench plan {bench_plan.stats()} "
        f"{len(bench_maps.buckets)} buckets, {elimination.plan_flop_stats(bench_plan)}; "
        f"optimizer plan {len(opt_maps.buckets)} buckets")
    log_routing(elimination, "sphere bench plan", bench_maps)
    log_routing(elimination, "sphere optimizer plan", opt_maps)
    refs = ordering_ref(here)
    sphere_edges = np.concatenate([np.stack(s.gids, axis=1) for s in structure
                                   if len(s.gids) == 2])
    perm, sphere_order = ordering_line(symbolic, "sphere", len(v64), sphere_edges, 6,
                                       refs["sphere"])
    if not np.array_equal(perm, bench_plan.perm):
        raise AssertionError("the sphere plan's ordering is not best_ordering's least-fill one")
    plans = {"sphere": dict(ordering=sphere_order, bench=plan_facts(elimination, bench_maps),
                            optimizer=plan_facts(elimination, opt_maps))}
    log(f"sphere plans: bench {plans['sphere']['bench']}; optimizer {plans['sphere']['optimizer']}")

    if optimizers_only:
        # phase 8 alone on the sphere; no result line
        run_optimizers(torch, v1, fa, va, g64, v64, g32, opt_maps, lg0)
        log(f"optimizers-only run passed in {time.perf_counter() - t_start:.1f} s")
        return 0

    if partitioned_only:
        # phase 11 alone on the sphere; no result line
        run_partitioned(torch, v1, g64, v64, g32, v32, lg0, opt_maps)
        log(f"partitioned-only run passed in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0

    # the bundle-adjustment problem and its plans: one ordering, two
    # bucketings (bench.py's 4 per level, the optimizers' default 2), shared
    # by the float32 and float64 graphs (a plan depends on structure alone)
    n_cams, n_pts, n_obs = BA_SHAPE
    t0 = time.perf_counter()
    ba = {}
    for name, dtype, np_dtype in (("float32", torch.float32, np.float32),
                                  ("float64", torch.float64, np.float64)):
        data = make_synthetic_ba(n_cams, n_pts, n_obs, seed=SEED, dtype=np_dtype)
        ba[name] = build_ba_graph(data, dtype=dtype, device="cuda")
    del data
    log(f"BA problem: {n_cams} cameras, {n_pts} points, {n_pts * n_obs} observations "
        f"+ 2 priors; generated and uploaded (float32 and float64) in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bg64, bv64 = ba["float64"]
    ba_struct = elimination.graph_structure(bg64, bv64)
    ba_lg0 = bg64.linearize(bv64)
    types = sorted(ba_lg0.type_counts)
    offs = elimination.type_offsets(ba_lg0.type_counts)
    n_vars = sum(ba_lg0.type_counts.values())
    var_dims = np.full(n_vars, 9, dtype=np.int64)
    var_dims[offs["Point3"] : offs["Point3"] + n_pts] = 3
    edges = np.stack(ba_struct[0].gids, axis=1)
    perm, ba_order = ordering_line(symbolic, "BA", n_vars, edges, 9, refs["ba"])
    t_order = time.perf_counter() - t0
    ba_maps = {}
    for per_level in (4, 2):
        plan = elimination.build_plan_for_graph(ba_struct, n_vars, 9, ordering=perm,
                                                max_buckets_per_level=per_level)
        ba_maps[per_level] = elimination.build_numeric_maps(plan, ba_struct, var_dims=var_dims)
    ba_bench_maps = ba_maps[4]
    for graph, values in ba.values():
        elimination.set_graph_plan(graph, graph.linearize(values), ba_maps[2].plan, ba_maps[2])
    flop = elimination.plan_flop_stats(ba_bench_maps.plan, var_dims)
    log(f"BA plans: host planning {time.perf_counter() - t0:.1f} s (ordering {t_order:.1f} s); "
        f"bench plan {ba_bench_maps.plan.stats()} {len(ba_bench_maps.buckets)} buckets, {flop}; "
        f"optimizer plan {len(ba_maps[2].buckets)} buckets; largest front m = "
        f"{max(bm.mb for bm in ba_bench_maps.buckets) * 9}")
    log_routing(elimination, "BA bench plan", ba_bench_maps)
    log_routing(elimination, "BA optimizer plan", ba_maps[2])
    plans["ba"] = dict(ordering=ba_order, bench=plan_facts(elimination, ba_bench_maps),
                       optimizer=plan_facts(elimination, ba_maps[2]))
    log(f"BA plans: bench {plans['ba']['bench']}; optimizer {plans['ba']['optimizer']}")

    # 3. kernels against their plain versions
    all_maps = ((bench_maps, 6), (opt_maps, 6), (ba_bench_maps, 9), (ba_maps[2], 9))
    cases = list(dict.fromkeys(
        [(bm.B, bm.nf, bm.ns, d) for maps, d in all_maps for bm in maps.buckets]
        + PALLAS_TEST_SHAPES + EXTRA_SHAPES + isam2_cases))
    timed = {}
    for name, itemsize in (("float64", 8), ("float32", 4)):
        timed[name] = {k: [] for k in KERNELS}
        for maps, d in ((bench_maps, 6), (ba_bench_maps, 9)):
            for B, nf, ns, route in routing(elimination, maps, itemsize):
                timed[name][ROUTE_KERNEL[route]].append((B, nf, ns, d))
                timed[name]["backsolve_bucket"].append((B, nf, ns, d))
    t0 = time.perf_counter()
    kres = check_kernels(torch, (v2, v1, kernels), cases, timed)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ires = check_kernels(torch, (v2, v1, kernels), [], isam2_timed, extras=False)
    log(f"iSAM2 d = 3 sweeps: {time.perf_counter() - t0:.1f} s")

    # 4. the sphere path, through the entry points
    v1.reset_launch_counts()
    gn = gauss_newton(g64, v64, OptimizerParams(solver="multifrontal", max_iterations=GN_ITERS),
                      device="cuda")
    lm = levenberg_marquardt(g64, v64, LMParams(solver="multifrontal", max_iterations=LM_ITERS),
                             device="cuda")
    torch.cuda.synchronize()
    sphere_launches = v1.launch_counts()
    sphere_cuda = v1.cuda_launch_counts()
    log(f"GN: error {gn.error_history[0]:.6e} -> {gn.error:.6e} in {gn.iterations} iterations")
    log(f"LM: error {lm.error_history[0]:.6e} -> {lm.error:.6e} in {lm.iterations} iterations")
    log(f"launches on the sphere path: {sphere_launches}; CUDA launches {sphere_cuda}")
    check_result(gn, "sphere GN")
    check_result(lm, "sphere LM")
    p = gn.values.params("Pose3")
    n_poses = N_RINGS * N_PER_RING
    if not (p.R.shape == (n_poses, 3, 3) and torch.isfinite(p.R).all() and torch.isfinite(p.t).all()):
        raise AssertionError(f"GN result is not {n_poses} finite poses")

    # first GN step against the dense Cholesky oracle (float64)
    delta, _ = elimination.solve_linearized(g64, v64, 0.0, cache={"mf_lg": lg0})
    H, g = linsolve.assemble_dense(lg0)
    x_dense = linsolve.dense_solve(H, g, 0.0).reshape(-1, 6)
    rel = ((delta["Pose3"] - x_dense).norm() / x_dense.norm()).item()
    log(f"first GN step vs dense oracle: rel {rel:.3e}")
    if not rel <= 1e-8:
        raise AssertionError(f"GN step differs from the dense oracle: rel {rel:.3e}")
    del H, g, x_dense

    # a small graph: the card's path against the CPU path (plain kernels)
    sva, sfa = synthetic.sphere_rings(4, 5, seed=SEED + 1)
    small = []
    for dev in ("cuda", "cpu"):
        r = gauss_newton(convert.graph_from_arrays(sfa, device=dev),
                         convert.values_from_arrays(sva, device=dev),
                         OptimizerParams(solver="multifrontal", max_iterations=10), device=dev)
        small.append(r.error)
    log(f"small ring graph GN: cuda {small[0]:.12e} cpu {small[1]:.12e}")
    if not abs(small[0] - small[1]) <= 1e-9 * abs(small[1]):
        raise AssertionError("card and CPU paths disagree on the small graph")

    # ms per chained GN iteration (bench.py's protocol), float32 and float64
    def gn_step_fn(graph):
        def step(values):
            lg = graph.linearize(values)
            x = elimination.multifrontal_solve(
                bench_maps, tuple((lb.A, lb.b) for lb in lg.batches), 1e-5)
            return values.retract({"Pose3": x})

        return step

    step_ms = {}
    for name, graph, values in (("float32", g32, v32), ("float64", g64, v64)):
        step_ms[name], _ = time_step(torch, v1, f"GN iteration {name}", "iter",
                                     gn_step_fn(graph), graph, values, 10)

    # 8. (on the sphere, while its graphs live) mixed-precision GN, dogleg,
    # PCG LM, factor / apply, NCG
    v1.reset_launch_counts()
    opt_res = run_optimizers(torch, v1, fa, va, g64, v64, g32, opt_maps, lg0)
    mixed_launches = opt_res["mixed"]["launches"]

    # 11. (on the sphere, while its graphs live) the partitioned solver
    t0 = time.perf_counter()
    part_res = run_partitioned(torch, v1, g64, v64, g32, v32, lg0, opt_maps, lm)
    log(f"partitioned phase: {time.perf_counter() - t0:.1f} s")
    del g32, v32, g64, v64, lg0
    log(f"sphere phases done at {time.perf_counter() - t_start:.1f} s")

    # 5. the bundle-adjustment path, through the entry points
    torch.cuda.reset_peak_memory_stats()
    v1.reset_launch_counts()
    ba_res = {}
    for name in ("float32", "float64"):
        graph, values = ba[name]
        for solver in ("multifrontal", "schur"):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = levenberg_marquardt(
                graph, values, LMParams(solver=solver, max_iterations=BA_LM_ITERS[name]),
                device="cuda")
            torch.cuda.synchronize()
            ba_res[name, solver] = res
            log(f"BA LM {name} {solver}: error {res.error_history[0]:.6e} -> {res.error:.6e} in "
                f"{res.iterations} iterations, {time.perf_counter() - t0:.2f} s, history "
                f"{['%.6e' % e for e in res.error_history]}, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            check_result(res, f"BA LM {name} {solver}")
            cam = res.values.params("SfmCamera")
            pts = res.values.params("Point3")
            if not (cam.R.shape == (n_cams, 3, 3) and pts.shape == (n_pts, 3)
                    and all(torch.isfinite(a).all() for a in (cam.R, cam.t, cam.cal, pts))):
                raise AssertionError(f"BA LM {name} {solver}: result is not finite")
    ba_launches = v1.launch_counts()
    ba_cuda = v1.cuda_launch_counts()
    log(f"launches on the BA path: {ba_launches}; CUDA launches {ba_cuda}")
    launches = {k: sphere_launches[k] + ba_launches[k] for k in KERNELS}
    cuda_launches = {k: sphere_cuda[k] + ba_cuda[k] for k in KERNELS}
    log(f"launches on the main paths: {launches}; CUDA launches {cuda_launches}")
    # each path runs all four kernels (its plan has a leaf bucket, buckets
    # that fit shared memory and, in float64, fronts that do not)
    for path, counts in (("sphere", sphere_launches), ("BA", ba_launches)):
        if not all(n > 0 for n in counts.values()):
            raise AssertionError(f"a kernel was never launched on the {path} path: {counts}")
    for name in ("float32", "float64"):
        a, b = ba_res[name, "multifrontal"].error, ba_res[name, "schur"].error
        log(f"BA LM {name}: final error multifrontal {a:.9e} schur {b:.9e}")

    # the LM histories at the shape of tools/ba_reference.py, beside the
    # JAX package's (f32, f64) and the port's CPU path (f32): the card's f32
    # against the CPU's (the same plan) and the spread of two orderings
    # (JAX's CCOLAMD plan and the port's) in f32; every f64 history agrees
    with open(os.path.join(here, BA_REF)) as f:
        bref = json.load(f)
    ba_ref = {}
    for name, dtype, np_dtype in (("float32", torch.float32, np.float32),
                                  ("float64", torch.float64, np.float64)):
        rdata = make_synthetic_ba(*bref["shape"], seed=bref["seed"], dtype=np_dtype)
        r = levenberg_marquardt(*build_ba_graph(rdata, dtype=dtype, device="cuda"),
                                LMParams(solver="multifrontal", max_iterations=bref["iterations"]),
                                device="cuda")
        ba_ref[name] = r.error_history
        log(f"BA LM {name} at {bref['shape']} on the card: {['%.9e' % e for e in r.error_history]}; "
            + "; ".join(f"{k}: {['%.9e' % e for e in v['error_history']]}"
                        for k, v in bref["runs"].items() if k.endswith(name)))
    # the control: the same f32 runs on the card with the plain PyTorch
    # versions in place of all four kernels, then of K2 alone; and each
    # variant's first damped step (lambda 1e-4) against the f64 step
    rdata = make_synthetic_ba(*bref["shape"], seed=bref["seed"], dtype=np.float32)
    r64 = make_synthetic_ba(*bref["shape"], seed=bref["seed"], dtype=np.float64)
    gv64 = build_ba_graph(r64, dtype=torch.float64, device="cuda")
    step64, _ = elimination.solve_linearized(*gv64, 1e-4)
    step64 = torch.cat([step64[t].reshape(-1) for t in sorted(step64)])
    c2_steps, c2_control, c2_trials = {}, {}, {}
    for variant, names in (("kernels", ()), ("K2 plain", ("backsolve_bucket",)),
                           ("all plain", tuple(KERNELS))):
        with plain_kernels(names):
            gv = build_ba_graph(rdata, dtype=torch.float32, device="cuda")
            st, _ = elimination.solve_linearized(*gv, 1e-4)
            st = torch.cat([st[t].reshape(-1) for t in sorted(st)]).double()
            c2_steps[variant] = ((st - step64).norm() / step64.norm()).item()
            # LM's own trial lines (lambda, bad pivots or error and rho)
            with contextlib.redirect_stdout(io.StringIO()) as trials:
                c2_control[variant] = levenberg_marquardt(
                    *gv, LMParams(solver="multifrontal", max_iterations=bref["iterations"],
                                  verbose=True), device="cuda").error_history
            c2_trials[variant] = [ln[len("LM iter 1 "):] for ln in trials.getvalue().splitlines()
                                  if ln.startswith("LM iter 1 ")]
    del gv64, step64
    log(f"BA LM float32 at {bref['shape']} on the card, control: "
        + "; ".join(f"{k}: {['%.9e' % e for e in v]}" for k, v in c2_control.items())
        + f"; first damped step (lambda 1e-4) in f32 vs the f64 step, rel: {c2_steps}; the "
        f"first iteration's trials: {c2_trials}")
    hist_rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    runs = bref["runs"]
    c2 = dict(card_vs_port_cpu_f32=hist_rel(ba_ref["float32"], runs["port_float32"]["error_history"]),
              jax_vs_port_cpu_f32=hist_rel(runs["jax_float32"]["error_history"],
                                           runs["port_float32"]["error_history"]),
              card_f64_vs_jax_f64=hist_rel(ba_ref["float64"], runs["jax_float64"]["error_history"]),
              card=ba_ref, control=c2_control, first_step_rel_f64=c2_steps,
              first_iteration_trials=c2_trials,
              control_vs_port_cpu_f32={k: hist_rel(v, runs["port_float32"]["error_history"])
                                       for k, v in c2_control.items()})
    log(f"BA LM f32 (C2): card vs the port's CPU f32 rel {c2['card_vs_port_cpu_f32']:.3e}; the JAX "
        f"package's f32 vs the port's CPU f32 rel {c2['jax_vs_port_cpu_f32']:.3e}; card f64 vs the "
        f"JAX package's f64 rel {c2['card_f64_vs_jax_f64']:.3e}; the control vs the port's CPU "
        f"f32 rel {c2['control_vs_port_cpu_f32']}")
    if not (len(ba_ref["float64"]) == len(runs["jax_float64"]["error_history"])
            and c2["card_f64_vs_jax_f64"] <= 1e-8
            and all(e == e for e in ba_ref["float32"])):
        raise AssertionError("BA LM: the card's f64 history differs from the JAX package's")

    # first damped step (lambda = 1e-4): two independent eliminations of the
    # same float64 system, the multifrontal sweep and the landmark Schur solve
    cache = {"mf_lg": ba_lg0, "schur_lg": ba_lg0}
    d_mf, _ = elimination.solve_linearized(bg64, bv64, 1e-4, cache=cache)
    if int(cache["bad_pivots"]) != 0:
        raise AssertionError("BA first step: the multifrontal factorization clamped pivots")
    d_sc, _ = schur.solve_linearized(bg64, bv64, 1e-4, cache=cache)
    num = sum((d_mf[t] - d_sc[t]).pow(2).sum() for t in types).sqrt().item()
    den = sum(d_sc[t].pow(2).sum() for t in types).sqrt().item()
    log(f"BA first damped step, multifrontal vs schur (float64): rel {num / den:.3e}")
    if not num / den <= 1e-8:
        raise AssertionError(f"BA multifrontal and schur steps differ: rel {num / den:.3e}")
    del d_mf, d_sc, cache

    # a small rig: the card's path against the CPU path, both solvers
    sdata = make_synthetic_ba(8, 60, 4, seed=SEED + 1, dtype=np.float64)
    for solver in ("multifrontal", "schur"):
        small = [levenberg_marquardt(*build_ba_graph(sdata, device=dev),
                                     LMParams(solver=solver, max_iterations=5), device=dev).error
                 for dev in ("cuda", "cpu")]
        log(f"small BA rig LM {solver}: cuda {small[0]:.12e} cpu {small[1]:.12e}")
        if not abs(small[0] - small[1]) <= 1e-9 * abs(small[1]):
            raise AssertionError(f"card and CPU paths disagree on the small BA rig ({solver})")

    # LM iterations per second, bench.py's protocol: linearize, damped
    # multifrontal solve (lambda 1e-4) on the 4-per-level plan, retract
    def ba_step_fn(graph):
        def step(values):
            lg = graph.linearize(values)
            x = elimination.multifrontal_solve(
                ba_bench_maps, tuple((lb.A, lb.b) for lb in lg.batches), 1e-4)
            return values.retract({t: x[offs[t] : offs[t] + ba_lg0.type_counts[t],
                                        : (3 if t == "Point3" else 9)] for t in types})

        return step

    ba_iters_per_s = {}
    for name in ("float32", "float64"):
        graph, values = ba[name]
        torch.cuda.reset_peak_memory_stats()
        ms, _ = time_step(torch, v1, f"BA LM step {name}", "step", ba_step_fn(graph), graph,
                          values, 4)
        ba_iters_per_s[name] = 1e3 / ms
        log(f"BA LM step {name}: {1e3 / ms:.3f} LM iterations/s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        # the step's first layer alone: linearize (forward-mode Jacobians of
        # the projection factors), so the profile above splits into it and the solve
        prof = profile_step(torch, lambda v, graph=graph: graph.linearize(v), values, top=4)
        if prof is not None:
            log(f"BA linearize {name} alone: device busy {prof[0]:.3f} ms, {prof[1]} kernel "
                f"launches; top kernels: "
                + "; ".join(f"{kms:.3f} ms {calls}x {key[:60]}" for key, kms, calls in prof[2]))
    log(f"BA phases done at {time.perf_counter() - t_start:.1f} s")

    # 6. the iSAM2 path (float64), through run_city10000 / ISAM2.update
    isam2, city = run_isam2(torch, here, v1)
    log(f"iSAM2 phase done at {time.perf_counter() - t_start:.1f} s")

    # 9. the iSAM2 family on run c)'s tree and stream (while they live)
    family = run_isam2_family(torch, here, v1, city)
    isam2["final_estimate"], card_gate = city["estimate"], city["card_gate"]
    del city
    log(f"iSAM2 family phase done at {time.perf_counter() - t_start:.1f} s")

    # 10. the host engine on the card machine's CPU, beside run c)
    host_res = run_host_engine(torch, here, isam2, card_gate)
    del isam2["final_estimate"]
    log(f"host engine phase done at {time.perf_counter() - t_start:.1f} s")

    # 7. smart-factor BA (no bucket kernel on its path: dense library algebra,
    # as in the JAX package)
    smart_res = run_smart(torch, here)
    log(f"smart phase done at {time.perf_counter() - t_start:.1f} s")

    # 12. navigation: the IMU + GPS drive through preintegrate, batch LM and ISAM2
    nav_res = run_navigation(torch, v1)
    log(f"navigation phase done at {time.perf_counter() - t_start:.1f} s")

    # 13. initialization and the linear extras
    init_res = run_init(torch, v1, here)
    log(f"init phase done at {time.perf_counter() - t_start:.1f} s")

    # 14. the robust and global front end: GNC, Shonan, translation recovery,
    # custom and linear-container factors
    robust_res = run_robust(torch, v1)
    log(f"robust phase done at {time.perf_counter() - t_start:.1f} s")

    # 15. the extended geometry and the factors on it, constrained
    # optimization and the basis fits
    geometry_res = run_geometry(torch, v1)
    log(f"geometry phase done at {time.perf_counter() - t_start:.1f} s")

    # 16. discrete and hybrid inference, the utilities
    hybrid_res = run_hybrid(torch, v1, here)
    log(f"hybrid phase done at {time.perf_counter() - t_start:.1f} s")

    log(f"total {time.perf_counter() - t_start:.1f} s")

    # 17. result lines
    out = []
    for kname, (source, replaces, _) in KERNELS.items():
        f64, f32 = kres[kname]["float64"], kres[kname]["float32"]
        for r in (f64, f32):
            r.pop("per_bucket", None)  # printed above, one line per kernel and dtype
            r.pop("sweep_cuda_launches_per_bucket")  # printed above; the main paths' count below
        isw = {}  # this kernel's sweep of the iSAM2 path's d = 3 buckets
        for name in ("float64", "float32"):
            r = ires[kname].get(name)
            if r:
                isw[name] = dict(ms=r["ms"], plain_ms=r["plain_ms"], device_ms=r["device_ms"],
                                 bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                                 buckets=r["buckets_timed"])
        out.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=(launches[kname] + isam2["launches"][kname] + mixed_launches[kname]
                      + family["launches"][kname] + part_res["launches"][kname]
                      + nav_res["launches"][kname] + init_res["launches"][kname]
                      + robust_res["launches"][kname] + geometry_res["launches"][kname]
                      + hybrid_res["launches"][kname]),
            max_abs_err=f64["max_abs_err"], ms=f64["ms"],
            plain_ms=f64["plain_ms"], bound_ms=f64["bound_ms"], bound_by=f64["bound_by"],
            library_ms=None, dtype="float64", device_ms=f64["device_ms"], float32=f32,
            launches_sphere_path=sphere_launches[kname], launches_ba_path=ba_launches[kname],
            launches_isam2_path=isam2["launches"][kname],
            launches_mixed_gn_path=mixed_launches[kname],
            mixed_gn_launches_per_iter=opt_res["mixed"]["launches_per_iter"][kname],
            isam2_launches_per_update=isam2["launches_per_update"][kname], isam2_d3_sweep=isw,
            launches_isam2_family_path=family["launches"][kname],
            fixed_lag_launches_per_update=family["c"]["launches_per_update"][kname],
            launches_partitioned_path=part_res["launches"][kname],
            partitioned_launches_per_solve_p4=part_res["a"][PARTS.index(4)]["launches"][kname],
            launches_navigation_lm=nav_res["b"]["launches"][kname],
            launches_navigation_isam2=nav_res["c"]["launches"][kname],
            launches_init_path=init_res["launches"][kname],
            launches_robust_path=robust_res["launches"][kname],
            launches_geometry_path=geometry_res["launches"][kname],
            launches_hybrid_path=hybrid_res["launches"][kname],
            hybrid_folded_launches_per_solve=hybrid_res["c"]["launches_folded"][kname],
            cuda_launches=cuda_launches[kname] + isam2["cuda_launches"][kname]
            + opt_res["mixed"]["cuda_launches"][kname],
            cuda_launches_per_bucket=(cuda_launches[kname] + isam2["cuda_launches"][kname]
                                      + opt_res["mixed"]["cuda_launches"][kname])
            / max(1, launches[kname] + isam2["launches"][kname] + mixed_launches[kname]),
            stage_sources=STAGE_SOURCES.get(kname, []),
            k1_same_buckets_ms=f64.get("k1_same_buckets_ms"),
            timed=f"one sweep of the {f64['buckets_timed']} buckets the routing gives this "
                  f"kernel in the sphere and BA bench plans",
        ))
    isam2.pop("batch_gn_history")
    print(json.dumps(finite_json({"kernels": out, "gn_ms_per_iter": step_ms,
                                  "ba_lm_iters_per_s": ba_iters_per_s, "ba_lm_reference": c2,
                                  "isam2": isam2, "isam2_family": family, "smart": smart_res,
                                  "optimizers": opt_res, "plans": plans,
                                  "host_engine": host_res, "partitioned": part_res,
                                  "navigation": nav_res, "init": init_res,
                                  "robust": robust_res, "geometry": geometry_res,
                                  "hybrid": hybrid_res}),
                     allow_nan=False), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        remove_checkpoints(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(rc)
