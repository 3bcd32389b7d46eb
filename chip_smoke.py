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
             bad pivots, K2 and K4 launched; it saves the whole ISAM2 every
             300 lines (the last save holds line 600: phase 9 d))
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
             and stream: a) on the stream's first 150 lines, card = CPU path:
             every pose's tree covariance (rel 1e-9), run_city10000_fixed_lag
             at lag 50 (identical marginalized and deferred keys in every
             update, window estimates rel 1e-9), a checkpoint at line 100
             resumed to 150 bitwise equal on each device; b) run c)'s final
             tree (573 poses): TreeMarginals of every pose against H's
             exact inverse and against dense Marginals with its 1e-10 jitter's
             first-order term added back (both <= 1e-8 x the largest entry),
             the sweep's ms, launches and device time, adjacent poses sharing
             a clique; c) fixed lag 100 poses over 250 lines (loop closures
             to marginalized poses dropped): per-update ms split into
             ISAM2.update and marginalize_leaves, live cliques (gate: at most
             the window's variables), launches per update, the window against
             a batch GN of the kept history; d) run c)'s checkpoint at line
             600 loaded onto the card and fed to line 750: bitwise run
             c)'s estimate, the file's bytes, save and load ms; e) the
             concurrent incremental pair against the batch pair over 45
             lines, lag 15, a synchronize every 15 updates (5e-3); f)
             NonlinearISAM over 20 lines, reorder interval 10, within 1e-6
             of a batch GN of its graph; g) float32 iSAM2 over 200 lines:
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
             6, the CombinedImuFactor in row blocks) over the first 300
             keyframes: per-update ms, launches per update, ATE, the first 50
             updates against the card engine on the CPU (estimates rel 1e-9,
             equal n_reeliminated), no bad pivots, K4 and K2 launched, the
             final error over the final graph's optimum against the JAX
             ISAM2's on the same loop (NAV_ISAM2_REF: rel 1e-6 on the proxy
             ordering's tree, 1e-3 on its CCOLAMD tree), batch GN of
             the final graph from the iSAM2 estimate printed, and batch LM
             from the drive's start reaching the stored optimum (rel 1e-5); d) K4 / K3 / K1 / K2 against their plain
             versions at every shape b) and c) gave them, float64 and float32
 13. result  a `kernels` JSON line, the card line, then the last line
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
# 1,500 lines, 112.4 s for 1,000, 65.1 s for 750); the plan line still
# orders the batch graph of the stream's first CITY_PLAN_LINES lines, the
# graph of the JAX package's CCOLAMD reference
# (tests/data/ordering_reference.json)
CITY_POSES = 3687
CITY_LINES = 750
CITY_PLAN_LINES = 1500
CITY_GATE_LINES = 150
# where the card's wildfire descent and the CPU's part, the change one of
# them saw must be below this (a rounding-size change, against poses of
# size 1-100): see phase 6 gate a)
ROUNDING_CHANGE = 1e-12
CONTRACT_POSES = 60
PROFILE_UPDATES = 25
# run c) saves the whole ISAM2 at every CITY_PROGRESS lines: its last save
# holds line 600, from which phase 9 d) resumes to CITY_LINES
CITY_PROGRESS = 300
# phase 9 (the iSAM2 family, float64 unless stated), on the same stream: a)
# card = CPU over FAMILY_GATE_LINES lines (fixed lag FAMILY_GATE_LAG poses,
# a checkpoint at FAMILY_GATE_CKPT); c) fixed-lag smoothing over
# FIXED_LAG_LINES lines, lag FIXED_LAG poses; e) the concurrent pairs over
# CONCURRENT_LINES lines, lag CONCURRENT_LAG, a synchronize every
# CONCURRENT_SYNC updates; f) NonlinearISAM over NISAM_LINES lines, reorder
# interval NISAM_REORDER; g) float32 iSAM2 over F32_LINES lines. c), e), f)
# and g) are cut for the script's time (c) from 1,000 lines, which saves
# ~40 s against a 1,200 s limit that the uncut script came within 124 s of,
# and from 400 to make room for phase 12; e) from 300 lines at lag 50 and a
# synchronize every 25, then from 60; f) from 200 lines, then from 40; g)
# from 500 lines, then from 300): the batch filter, the batch smoother and
# NonlinearISAM hold one factor batch per update, and each linearization
# walks them all: their time grows with the stream's length (PERF.md
# section 4)
FAMILY_GATE_LINES = 150
FAMILY_GATE_LAG = 50
FAMILY_GATE_CKPT = 100
FIXED_LAG_LINES = 250
FIXED_LAG = 100
CONCURRENT_LINES = 45
CONCURRENT_LAG = 15
CONCURRENT_SYNC = 15
NISAM_LINES = 20
NISAM_REORDER = 10
F32_LINES = 200
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
# one at a time; b) batch LM of at most NAV_LM_ITERS iterations, its
# iteration timed NAV_CHAIN chained, and the first NAV_CUT keyframes on the
# card against the CPU path over NAV_CUT_ITERS LM iterations; c) ISAM2 over
# the first NAV_ISAM2_KEYFRAMES keyframes, its first NAV_ISAM2_GATE updates
# against the card engine on the CPU; its final error over the final graph's
# optimum against the JAX ISAM2's on the same loop, both read from
# NAV_ISAM2_REF (tools/imu_isam2_reference.py, CPU: the optimum is LM to
# convergence polished by dense GN): to NAV_ISAM2_REF_GATE (relative; the
# margin covers the drive's PIMs made on the card, within 1e-12 of the
# CPU's) against the JAX ISAM2 with its tree ordered by the proxy COLAMD
# (the port's AMD tree gives the same error on this chain, rel ~1e-11 on
# the CPU), and to NAV_ORDERING_GATE against the JAX ISAM2 on its own
# CCOLAMD tree (where the wildfire stops elsewhere: rel 1.9e-4 on the CPU);
# batch LM (NAV_ISAM2_LM_ITERS iterations) from the drive's start reaches
# that optimum to NAV_OPT_GATE (relative)
NAV_KEYFRAMES = 1000
NAV_RATE = 200
NAV_ONE_AT_A_TIME = 5
NAV_LM_ITERS = 30
NAV_CHAIN = 4
NAV_CUT = 50
NAV_CUT_ITERS = 4
NAV_ISAM2_KEYFRAMES = 300
NAV_ISAM2_GATE = 50
NAV_ISAM2_LM_ITERS = 25
NAV_OPT_GATE = 1e-5
NAV_ISAM2_REF = "tests/data/imu_isam2_reference.json"
NAV_ISAM2_REF_GATE = 1e-6
NAV_ORDERING_GATE = 1e-3
NAV_PROGRESS = 25

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
    largest differences by kernel."""
    v2, v1, kernels = mods
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
        log(f"kernels {name} ({len(cases)} shapes checked, {n_smem} fit shared memory): "
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


def profile_step(torch, step, values, top=12):
    """One step under torch.profiler: (device busy ms, kernel launches,
    [(kernel, ms, calls)], [(host op, self ms, calls)]), or None when the
    profiler shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(values)
    torch.cuda.synchronize()
    # twice, keeping the profile that saw more launches: the profiler can
    # drop a share of a step's ~3,000 kernel events
    kern, prof = [], None
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            step(values)
            torch.cuda.synchronize()
        k = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in k) > sum(e.count for e in kern):
            kern, prof = k, p
    if not kern:
        return None
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in kern),
                  key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows[:top], host[:top]


def time_step(torch, v1, label, unit, step, graph, values, n_chain, prof_out=None):
    """Chained time of `step`, its launches per step, and its profile
    (`prof_out`, a dict, gets its device busy ms and kernel launches)."""
    v1.reset_launch_counts()
    step(values)
    per_step = v1.launch_counts()
    ms, out = chained_ms(torch, step, values, n_chain)
    err = float(graph.error(out))
    log(f"{label}: {ms:.3f} ms/{unit} (chained x{n_chain}, median of 3); launches per "
        f"{unit} {per_step}; error after {n_chain} steps {err:.6e}")
    if not err == err:
        raise AssertionError(f"{label}: steps gave a non-finite error")
    prof = profile_step(torch, step, values)
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
    # layer (synchronized timers), then one under torch.profiler
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
            window["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
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
    estimate and its checkpoint at line 600; without it (the
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

        # d) phase 6 c)'s checkpoint at line 600, onto the card, fed to
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


def lm_bad_pivot_trials(levenberg_marquardt, graph, values, params, device):
    """levenberg_marquardt with its trial lines captured: (result, the count
    of trials rejected for clamped pivots)."""
    import dataclasses

    with contextlib.redirect_stdout(io.StringIO()) as lines:
        res = levenberg_marquardt(graph, values, dataclasses.replace(params, verbose=True),
                                  device=device)
    return res, sum("bad pivots" in ln for ln in lines.getvalue().splitlines())


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
    edges = np.concatenate([np.stack([s.gids[a], s.gids[b]], axis=1) for s in structure
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
        it_ms, per_it = time_step(torch, v1, "navigation b) LM iteration", "iter", lm_step, g, v,
                                  NAV_CHAIN, prof_out=prof)
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

    log(f"total {time.perf_counter() - t_start:.1f} s")

    # 13. result lines
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
                      + nav_res["launches"][kname]),
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
                                  "navigation": nav_res}),
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
