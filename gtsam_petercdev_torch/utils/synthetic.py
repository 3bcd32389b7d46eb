"""Synthetic graphs: Pose3 rings with the topology of the sphere benchmark,
a City10000-like Pose2 stream (`city_stream`) and its Hybrid City variant
with ambiguous measurements (`hybrid_city_stream`), an IMU + GPS drive
(`imu_gps_drive`), the scenes of the unstable factors and the camera
factors, those of the robust and global front end (`ring_rotations`,
`sphere_directions`) and those of the extended geometry (`planar_slam`,
`sim3_sphere`, `plane_slam`, `two_view_pairs`, `extra_factor_scenes`,
`drive_positions`).

`sphere_rings(n_rings, n_per_ring)` places n_rings x n_per_ring poses on
latitude rings of a sphere, facing along each ring. Factors:
  - one prior on pose 0;
  - odometry i -> i+1 along the whole sequence (n - 1 factors, ring to ring);
  - one between-factor from each pose to the same pose on the previous ring
    ((n_rings - 1) * n_per_ring factors).
At 50 x 50 that is 2,500 poses and 2,499 + 2,450 = 4,949 between factors,
the size and factor count of sphere2500. Measurements are the true relative
poses perturbed by Exp(noise); initial values are the truth perturbed the
same way (pose 0 exact). Everything comes from one numpy seed and is
returned as numpy arrays in the `utils/convert.py` format, so the JAX
package and the port can be fed the same data.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsam_petercdev_torch.core.keys import symbol
from gtsam_petercdev_torch.device import DeviceLike
from gtsam_petercdev_torch.geometry import essential, pose2, pose3, so3
from gtsam_petercdev_torch.linear import noise
from gtsam_petercdev_torch.navigation import preintegration as pre
from gtsam_petercdev_torch.navigation.factors import combined_covariance
from gtsam_petercdev_torch.navigation.scenario import ScenarioRunner, constant_twist


def _exp_np(xi: np.ndarray):
    p = pose3.expmap(torch.from_numpy(xi))
    return p.R.numpy(), p.t.numpy()


def _compose_np(a, b):
    p = pose3.compose(pose3.Pose3(*map(torch.from_numpy, a)), pose3.Pose3(*map(torch.from_numpy, b)))
    return p.R.numpy(), p.t.numpy()


def _between_np(a, b):
    p = pose3.between(pose3.Pose3(*map(torch.from_numpy, a)), pose3.Pose3(*map(torch.from_numpy, b)))
    return p.R.numpy(), p.t.numpy()


def sphere_truth(n_rings: int, n_per_ring: int):
    """The true poses of `sphere_rings` as (R [n, 3, 3], t [n, 3])."""
    n = n_rings * n_per_ring
    radius = n_per_ring / (2.0 * np.pi)
    r_idx, k_idx = np.divmod(np.arange(n), n_per_ring)
    lat = -0.5 * np.pi + np.pi * (r_idx + 1) / (n_rings + 1)
    lon = 2.0 * np.pi * k_idx / n_per_ring
    pos = radius * np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)], axis=1
    )
    # frame: x along the ring, z outward, y = z x x
    x_ax = np.stack([-np.sin(lon), np.cos(lon), np.zeros(n)], axis=1)
    z_ax = pos / radius
    y_ax = np.cross(z_ax, x_ax)
    return np.stack([x_ax, y_ax, z_ax], axis=2), pos


def sphere_rings(
    n_rings: int = 50,
    n_per_ring: int = 50,
    seed: int = 0,
    rot_sigma: float = 0.01,
    trans_sigma: float = 0.05,
    init_rot_sigma: float = 0.05,
    init_trans_sigma: float = 0.1,
):
    """Returns (values_arrays, factor_arrays) in float64 numpy."""
    rng = np.random.default_rng(seed)
    n = n_rings * n_per_ring
    gt = sphere_truth(n_rings, n_per_ring)

    sigmas = np.array([rot_sigma] * 3 + [trans_sigma] * 3)
    a = np.concatenate([np.arange(n - 1), np.arange(n - n_per_ring)])
    b = np.concatenate([np.arange(1, n), np.arange(n_per_ring, n)])
    meas = _between_np((gt[0][a], gt[1][a]), (gt[0][b], gt[1][b]))
    meas = _compose_np(meas, _exp_np(rng.normal(size=(len(a), 6)) * sigmas))

    init_sig = np.array([init_rot_sigma] * 3 + [init_trans_sigma] * 3)
    xi0 = rng.normal(size=(n, 6)) * init_sig
    xi0[0] = 0.0
    init = _compose_np(gt, _exp_np(xi0))

    keys = np.arange(n, dtype=np.int64)
    info = np.broadcast_to(np.diag(1.0 / sigmas), (len(a), 6, 6)).copy()
    prior_info = np.diag([1e3] * 3 + [1e2] * 3)[None].copy()
    values = {"Pose3": (keys, init)}
    factors = [
        ("PriorPose3", keys[:1, None], (gt[0][:1], gt[1][:1]), prior_info),
        ("BetweenPose3", np.stack([a, b], axis=1), meas, info),
    ]
    return values, factors


def pose2_compose_np(a, b):
    """Pose2 a * b on numpy (x, y, theta)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    th = a[2] + b[2]
    return np.array([a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1],
                     np.arctan2(np.sin(th), np.cos(th))])


def pose2_between_np(a, b):
    """Pose2 a^-1 * b on numpy (x, y, theta)."""
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    th = b[2] - a[2]
    return np.array([c * dx + s * dy, -s * dx + c * dy, np.arctan2(np.sin(th), np.cos(th))])


CITY_SIGMAS = (1.0 / 30.0, 1.0 / 30.0, 1.0 / 100.0)  # the City10000 harness's odometry


def city_stream(n_poses: int, seed: int = 0, side: int = 48, p_turn: float = 0.3):
    """A synthetic City10000-like Pose2 stream: a Manhattan-world walk on a
    unit grid of `side` x `side` cells, from one numpy seed.

    Each step moves one cell along the heading, after turning left or right
    with probability `p_turn` (never back; forced to turn at the grid's
    edge). Pose i's odometry line is the true relative pose from pose i - 1,
    perturbed by N(0, diag(CITY_SIGMAS^2)); whenever the walker reaches a
    cell it has visited before, a loop-closure line to the most recent
    earlier pose in that cell follows, perturbed the same way. At the
    defaults with seed 0, 3,687 poses give 5,714 lines of which 2,028 are
    loop closures: City10000's density (2,000 loops in the first 5,686
    lines, 3,687 poses; CITY10000.md).

    Returns (lines, gt): the lines in the City10000 EDGE2 format that
    `models/city10000.parse_city10000` reads (`EDGE2 keyS 1 keyT 1 1 x y
    theta`; odometry has keyT = keyS + 1), and the true poses [n_poses, 3],
    pose 0 at the origin as the harness's prior puts it."""
    rng = np.random.default_rng(seed)
    heads = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]])
    cell = np.array([side // 2, side // 2])
    h = 0
    gt = [np.array([float(cell[0]), float(cell[1]), 0.0])]
    last_at = {tuple(cell): 0}
    lines = []

    def line(a, b, rel):
        meas = rel + rng.normal(size=3) * CITY_SIGMAS
        meas[2] = np.arctan2(np.sin(meas[2]), np.cos(meas[2]))
        lines.append(f"EDGE2 {a} 1 {b} 1 1 {meas[0]:.9f} {meas[1]:.9f} {meas[2]:.9f}")

    for i in range(1, n_poses):
        u = rng.random()
        turn = -1 if u < p_turn / 2 else (1 if u < p_turn else 0)
        options = [(h + turn) % 4, (h + 1) % 4, (h + 3) % 4]
        for nh in options:
            nxt = cell + heads[nh]
            if 0 <= nxt[0] < side and 0 <= nxt[1] < side:
                h, cell = nh, nxt
                break
        pose = np.array([float(cell[0]), float(cell[1]), np.arctan2(heads[h][1], heads[h][0])])
        line(i - 1, i, pose2_between_np(gt[-1], pose))
        gt.append(pose)
        j = last_at.get(tuple(cell))
        if j is not None:
            line(j, i, pose2_between_np(gt[j], pose))
        last_at[tuple(cell)] = i
    gt = np.stack(gt)
    gt[:, :2] -= gt[0, :2]  # the harness starts at the origin
    return lines, gt


# the three moves of city_stream's walker as relative poses (x, y, theta):
# one cell straight on, after a left turn, after a right turn
CITY_MOVES = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, np.pi / 2], [0.0, -1.0, -np.pi / 2]])


def hybrid_city_stream(n_poses: int, seed: int = 0, p_ambiguous: float = 0.1,
                       p_false_loop: float = 0.1):
    """A synthetic Hybrid_City10000-like stream: `city_stream(n_poses,
    seed)` with ambiguity added, in the same EDGE2 format (`EDGE2 keyS 1 keyT
    1 numMeas x y theta [x y theta ...]`) that models/hybrid_city reads. The
    reference's T1_city10000_04.txt is not in the repository; until it is,
    this stream has the shape of what Hybrid_City10000's users run.

    With probability `p_ambiguous` an odometry line carries a second
    candidate measurement: a wrong turn (another of CITY_MOVES than the one
    taken, under the same odometry noise), placed at a random position among
    the two candidates. A `p_false_loop` share of the loop closures points
    at a wrong earlier pose (drawn uniformly among those at least two poses
    back, not the true one), keeping its measurement. The decisions draw
    from their own numpy seed stream, so the walk and its measurements are
    city_stream's.

    Returns (lines, gt, truth): gt as city_stream's; truth a dict of
    `candidate` [n_lines] (the index of the true measurement among a line's
    candidates; 0 on single-candidate lines) and `loop_true` [n_lines]
    (False on a false loop closure; True on every other line)."""
    base, gt = city_stream(n_poses, seed)
    rng = np.random.default_rng([seed, 1])
    lines, candidate, loop_true = [], [], []
    for ln in base:
        parts = ln.split()
        a, b = int(parts[1]), int(parts[3])
        meas = np.array([float(p) for p in parts[6:9]])
        cand, true_loop = 0, True
        if b == a + 1:
            ms = [meas]
            if rng.random() < p_ambiguous:
                rel = pose2_between_np(gt[a], gt[b])
                taken = int(np.argmin(np.abs(CITY_MOVES - rel).sum(1)))
                wrong = CITY_MOVES[rng.choice([k for k in range(3) if k != taken])]
                alt = wrong + rng.normal(size=3) * CITY_SIGMAS
                alt[2] = np.arctan2(np.sin(alt[2]), np.cos(alt[2]))
                cand = int(rng.integers(2))
                ms = [alt, meas] if cand else [meas, alt]
        else:
            ms = [meas]
            if rng.random() < p_false_loop and b >= 3:
                a = int(rng.choice([j for j in range(b - 1) if j != a]))
                true_loop = False
        lines.append(f"EDGE2 {a} 1 {b} 1 {len(ms)} "
                     + " ".join(f"{m[0]:.9f} {m[1]:.9f} {m[2]:.9f}" for m in ms))
        candidate.append(cand)
        loop_true.append(true_loop)
    return lines, gt, {"candidate": np.asarray(candidate), "loop_true": np.asarray(loop_true)}


# the drive's car: body yaw rate and forward speed (a circle of radius
# 200 m at 10 m/s), its constant true IMU bias (accelerometer m/s^2,
# gyroscope rad/s), the GPS sigma (m), the priors' sigmas on X0 (rotation
# rad, position m), V0 (m/s) and B0, and the start's perturbation of the
# truth (rotation rad, position m, velocity m/s; the bias starts at 0)
DRIVE_TWIST = ((0.0, 0.0, 0.05), (10.0, 0.0, 0.0))
DRIVE_BIAS = (0.05, -0.03, 0.04, 2e-3, -1e-3, 1.5e-3)
DRIVE_GPS_SIGMA = 0.5
DRIVE_PRIOR_SIGMAS = ((0.01, 0.1), 0.1, (0.1, 0.01))
DRIVE_START_SIGMAS = (0.01, 0.5, 0.2)
# the bias random walk (accelerometer, gyroscope sigma a sqrt-second) of the
# KITTI sequence's IMU calibration that IMUKittiExampleGPS reads
# (AccelerometerBiasSigma, GyroscopeBiasSigma); default_params' 1e-3
# variances let the gyroscope bias wander 0.03 rad/s a second
DRIVE_BIAS_WALK = (1.67e-4, 2.91e-6)


def imu_gps_drive(n_keyframes: int, rate_hz: int = 200, seed: int = 0,
                  device: DeviceLike = "cuda", bias_walk=DRIVE_BIAS_WALK):
    """A synthetic drive in the shape of the reference's IMUKittiExampleGPS:
    a `ConstantTwistScenario` car (DRIVE_TWIST), one keyframe a second, a
    `rate_hz` IMU with `default_params` noise and a constant true bias
    (DRIVE_BIAS), one GPS fix per keyframe (sigma DRIVE_GPS_SIGMA), priors on
    X0, V0 and B0, and a start perturbed from the truth (X0 exact).

    Each interval's `rate_hz` samples come from `ScenarioRunner.
    measured_series` (one numpy Generator: IMU noise, GPS noise, then the
    start's perturbation) and integrate in one batched `preintegrate` pass
    on `device` (bias_hat 0); each CombinedImuFactor is whitened by
    `combined_covariance`, its bias random walk the sigmas `bias_walk`
    (accelerometer, gyroscope; None: `default_params`' own). Keys:
    symbol("x" | "v" | "b", k).

    Returns (values, factors, truth): the first two in the numpy format of
    `utils/convert.py` (float64), truth a dict of the keyframes' R [K, 3, 3],
    t [K, 3], v [K, 3], the true bias [6], the IMU samples ("imu": acc,
    omega [K - 1, S, 3], dts [K - 1, S]), the GPS fixes [K, 3] and the keys."""
    K, S = int(n_keyframes), int(rate_hz)
    rng = np.random.default_rng(seed)
    params = pre.default_params(device=device)
    if bias_walk is not None:
        I3 = torch.eye(3, dtype=params.n_gravity.dtype, device=params.n_gravity.device)
        params = params._replace(bias_acc_cov=I3 * bias_walk[0] ** 2,
                                 bias_omega_cov=I3 * bias_walk[1] ** 2)
    sc = constant_twist(*DRIVE_TWIST, device=device)
    runner = ScenarioRunner(sc, params, 1.0 / S, bias=np.asarray(DRIVE_BIAS))
    acc, omega, dts = runner.measured_series(float(K - 1), rng)
    acc, omega, dts = acc.reshape(K - 1, S, 3), omega.reshape(K - 1, S, 3), dts.reshape(K - 1, S)
    pim = pre.preintegrate(params, acc, omega, dts)
    cov = combined_covariance(pim, params)
    pim_np = tuple(f.cpu().numpy() for f in pim)
    imu_info = noise.gaussian_covariance(cov.cpu().numpy())

    nav = sc.nav_state(torch.arange(K, dtype=torch.float64, device=params.n_gravity.device))
    R, t, v = (a.cpu().numpy() for a in nav)
    gps = t + rng.normal(size=(K, 3)) * DRIVE_GPS_SIGMA
    s_rot, s_pos, s_vel = DRIVE_START_SIGMAS
    dth = rng.normal(size=(K, 3)) * s_rot
    dth[0] = 0.0
    R0 = R @ so3.expmap(torch.from_numpy(dth)).numpy()
    t0 = t + np.concatenate([np.zeros((1, 3)), rng.normal(size=(K - 1, 3)) * s_pos])
    v0 = v + np.concatenate([np.zeros((1, 3)), rng.normal(size=(K - 1, 3)) * s_vel])

    ks = np.arange(K)
    xk, vk, bk = (np.array([symbol(c, int(k)) for k in ks], dtype=np.uint64) for c in "xvb")
    values = {"Pose3": (xk, (R0, t0)), "Vector3": (vk, v0),
              "ConstantBias": (bk, np.zeros((K, 6)))}
    (p_rot, p_pos), p_vel, (p_ba, p_bg) = DRIVE_PRIOR_SIGMAS
    imu_keys = np.stack([xk[:-1], vk[:-1], xk[1:], vk[1:], bk[:-1], bk[1:]], axis=1)
    factors = [
        ("PriorPose3", xk[:1, None], (R[:1], t[:1]),
         noise.diagonal_sigmas(np.array([p_rot] * 3 + [p_pos] * 3))[None]),
        ("PriorVector3", vk[:1, None], v[:1], noise.isotropic(3, p_vel, np.float64)[None]),
        ("PriorConstantBias", bk[:1, None], np.zeros((1, 6)),
         noise.diagonal_sigmas(np.array([p_ba] * 3 + [p_bg] * 3))[None]),
        ("CombinedImuFactor", imu_keys,
         {"pim": pim_np, "n_gravity": np.broadcast_to(params.n_gravity.cpu().numpy(), (K - 1, 3)).copy()},
         imu_info),
        ("GPSFactor", xk[:, None], gps,
         np.broadcast_to(noise.isotropic(3, DRIVE_GPS_SIGMA, np.float64), (K, 3, 3)).copy()),
    ]
    truth = {"R": R, "t": t, "v": v, "bias": np.asarray(DRIVE_BIAS),
             "imu": {"acc": acc.cpu().numpy(), "omega": omega.cpu().numpy(), "dts": dts.cpu().numpy()},
             "gps": gps, "keys": {"x": xk, "v": vk, "b": bk}}
    return values, factors, truth


# --- scenes of the unstable factors ------------------------------------------

# the outliers of `sphere_rings_outliers`: a share of the loop closures, each
# composed with Exp(xi), xi ~ N(0, diag(OUTLIER_SIGMAS^2)) (rad, m); the EM
# factor's outlier model is EM_WIDTH x wider than the inlier model, its
# priors EM_PRIORS (inlier, outlier)
OUTLIER_SIGMAS = (0.5,) * 3 + (2.0,) * 3
EM_WIDTH = 100.0
EM_PRIORS = (0.9, 0.1)


def sphere_rings_outliers(n_rings: int = 50, n_per_ring: int = 50, seed: int = 0,
                          share: float = 0.1):
    """`sphere_rings(n_rings, n_per_ring, seed)` with `share` of its loop
    closures (the ring-to-ring edges; the odometry is left as it is) turned
    into outliers, drawn from numpy seed `seed`.

    Returns (values, plain, em, truth, outliers): the values of sphere_rings;
    `plain` its factors with the between batch split into odometry and loop
    closures (BetweenPose3 both); `em` the same with BetweenFactorEMPose3 on
    every loop closure (unit outer noise; the inlier model at the sphere's
    sigmas, the outlier model EM_WIDTH x wider, priors EM_PRIORS); truth
    (R, t); outliers the indices of the corrupted loop closures."""
    values, factors = sphere_rings(n_rings, n_per_ring, seed=seed)
    prior, (name, keys, (R, t), info) = factors
    n_odo = n_rings * n_per_ring - 1
    n_loop = len(keys) - n_odo
    rng = np.random.default_rng(seed)
    outliers = np.sort(rng.choice(n_loop, size=int(round(share * n_loop)), replace=False))
    R, t = R.copy(), t.copy()
    xi = rng.normal(size=(len(outliers), 6)) * np.asarray(OUTLIER_SIGMAS)
    Ro, to = _compose_np((R[n_odo + outliers], t[n_odo + outliers]), _exp_np(xi))
    R[n_odo + outliers], t[n_odo + outliers] = Ro, to
    odo = (name, keys[:n_odo], (R[:n_odo], t[:n_odo]), info[:n_odo])
    loop_keys, loop_meas = keys[n_odo:], (R[n_odo:], t[n_odo:])
    plain = [prior, odo, (name, loop_keys, loop_meas, info[n_odo:])]
    R_in = info[n_odo:]
    em = [prior, odo, ("BetweenFactorEMPose3", loop_keys,
                       {"measured": loop_meas, "R_in": R_in, "R_out": R_in / EM_WIDTH,
                        "prior_in": np.full(n_loop, EM_PRIORS[0]),
                        "prior_out": np.full(n_loop, EM_PRIORS[1])},
                       np.broadcast_to(np.eye(12), (n_loop, 12, 12)).copy())]
    return values, plain, em, sphere_truth(n_rings, n_per_ring), outliers


# the camera scenes: Cal3_S2 (fx, fy, s, u0, v0) of a 640 x 480 image, a
# keyframe every CAM_STEP m along the world x axis, looking along +z with a
# slow yaw; points on a wall CAM_DEPTH m ahead (+- 2 m), within +-1.5 m of
# their keyframes in x and +-3 m in y; pixel noise 1; the start perturbs the
# poses by CAM_START (rad, m) and the points by POINT_START m
CAM_K = (500.0, 500.0, 0.0, 320.0, 240.0)
CAM_ROWS = 480
CAM_STEP = 0.2
CAM_DEPTH = 10.0
CAM_START = (0.005, 0.05)
POINT_START = 0.2
CAM_PRIOR_SIGMAS = (1e-3, 1e-3)


def _camera_track(n: int):
    """True camera poses (R [n, 3, 3], t [n, 3]) of the camera scenes."""
    k = np.arange(n, dtype=np.float64)
    yaw = 0.05 * np.sin(k / 10.0)
    w = np.stack([np.zeros(n), yaw, np.zeros(n)], axis=1)
    R = so3.expmap(torch.from_numpy(w)).numpy()
    t = np.stack([CAM_STEP * k, 0.1 * np.sin(k / 7.0), np.zeros(n)], axis=1)
    return R, t


def _wall_points(rng, centres: np.ndarray):
    """One true point in front of each camera centre [P, 3]."""
    P = len(centres)
    return centres + np.stack([rng.uniform(-1.5, 1.5, P), rng.uniform(-3.0, 3.0, P),
                               CAM_DEPTH + rng.uniform(-2.0, 2.0, P)], axis=1)


def _perturbed_track(rng, R, t):
    n = len(t)
    R0 = R @ so3.expmap(torch.from_numpy(rng.normal(size=(n, 3)) * CAM_START[0])).numpy()
    return R0, t + rng.normal(size=(n, 3)) * CAM_START[1]


def _pose_priors(R, t, keys):
    sig = np.array([CAM_PRIOR_SIGMAS[0]] * 3 + [CAM_PRIOR_SIGMAS[1]] * 3)
    info = np.broadcast_to(noise.diagonal_sigmas(sig), (len(keys), 6, 6)).copy()
    return ("PriorPose3", np.asarray(keys)[:, None], (R[keys], t[keys]), info)


def rolling_shutter_scene(n_keyframes: int = 200, n_points: int = 10_000, n_obs: int = 4,
                          seed: int = 0):
    """A rolling-shutter bundle adjustment scene, from one numpy seed.

    Each point is seen `n_obs` times, observation i through the pose
    interpolated between keyframes k0 + i and k0 + i + 1 at alpha = the
    pixel row / CAM_ROWS (found by a fixed point: project at alpha, take the
    row, project again), a ProjectionFactorRollingShutter with pixel noise
    1; priors (CAM_PRIOR_SIGMAS) on the first two keyframes at the truth.
    Keys: keyframes 0..K-1, points K..K+P-1.

    Returns (values, factors, truth) in the numpy format of utils/convert.py
    (float64); truth {"R", "t", "points"}."""
    from gtsam_petercdev_torch.geometry import cameras
    from gtsam_petercdev_torch.slam.unstable_factors import interpolate_pose3

    rng = np.random.default_rng(seed)
    R, t = _camera_track(n_keyframes)
    k0 = rng.integers(0, n_keyframes - n_obs, size=n_points)
    pts = _wall_points(rng, t[k0 + n_obs // 2])
    ka = (k0[:, None] + np.arange(n_obs)[None, :]).reshape(-1)
    pj = np.repeat(np.arange(n_points), n_obs)
    K = torch.tensor(CAM_K, dtype=torch.float64)
    A = pose3.Pose3(torch.from_numpy(R[ka]), torch.from_numpy(t[ka]))
    B = pose3.Pose3(torch.from_numpy(R[ka + 1]), torch.from_numpy(t[ka + 1]))
    P = torch.from_numpy(pts[pj])
    alpha = torch.full((len(ka),), 0.5, dtype=torch.float64)
    for _ in range(3):
        uv, _ = cameras.project_s2(interpolate_pose3(A, B, alpha), P, K)
        alpha = torch.clamp(uv[:, 1] / CAM_ROWS, 0.0, 1.0)
    uv, depth = cameras.project_s2(interpolate_pose3(A, B, alpha), P, K)
    assert bool((depth > 0).all())
    uv = uv.numpy() + rng.normal(size=(len(ka), 2))
    R0, t0 = _perturbed_track(rng, R, t)
    p0 = pts + rng.normal(size=pts.shape) * POINT_START
    M = len(ka)
    values = {"Pose3": (np.arange(n_keyframes), (R0, t0)),
              "Point3": (n_keyframes + np.arange(n_points), p0)}
    factors = [
        _pose_priors(R, t, [0, 1]),
        ("ProjectionFactorRollingShutter", np.stack([ka, ka + 1, n_keyframes + pj], axis=1),
         {"uv": uv, "K": np.broadcast_to(np.asarray(CAM_K), (M, 5)).copy(),
          "alpha": alpha.numpy()}, np.broadcast_to(np.eye(2), (M, 2, 2)).copy()),
    ]
    return values, factors, {"R": R, "t": t, "points": pts}


# the inverse-depth scene's anchor prior: sigma on the ray's base (m); the
# base is the anchor keyframe's start position, theta / phi / rho free
RAY_BASE_SIGMA = 0.01


def inv_depth_scene(n_poses: int = 200, n_landmarks: int = 5_000, n_obs: int = 4,
                    seed: int = 0):
    """An inverse-depth SLAM scene, from one numpy seed: each landmark an
    InvDepthRay5 (x, y, z, theta, phi) anchored at keyframe k0 plus a
    Vector1 inverse depth, seen from keyframes k0 .. k0 + n_obs - 1 through
    InvDepthFactor3 (pixel noise 1). Anchor priors: each ray's base pinned
    (RAY_BASE_SIGMA; zero weight on theta, phi) at its anchor keyframe's
    start position, and priors (CAM_PRIOR_SIGMAS) on the first two
    keyframes at the truth. Variables of dims 6 / 5 / 1. Keys: keyframes
    0..K-1, rays K..K+L-1, inverse depths K+L..K+2L-1.

    Returns (values, factors, truth) in the numpy format of utils/convert.py
    (float64); truth {"R", "t", "points"}."""
    from gtsam_petercdev_torch.geometry import cameras

    rng = np.random.default_rng(seed)
    R, t = _camera_track(n_poses)
    k0 = rng.integers(0, n_poses - n_obs + 1, size=n_landmarks)
    pts = _wall_points(rng, t[k0 + n_obs // 2])
    ka = (k0[:, None] + np.arange(n_obs)[None, :]).reshape(-1)
    lj = np.repeat(np.arange(n_landmarks), n_obs)
    K = torch.tensor(CAM_K, dtype=torch.float64)
    uv, depth = cameras.project_s2(pose3.Pose3(torch.from_numpy(R[ka]), torch.from_numpy(t[ka])),
                                   torch.from_numpy(pts[lj]), K)
    assert bool((depth > 0).all())
    uv = uv.numpy() + rng.normal(size=(len(ka), 2))
    R0, t0 = _perturbed_track(rng, R, t)
    base = t0[k0]
    ray = pts + rng.normal(size=pts.shape) * POINT_START - base
    theta = np.arctan2(ray[:, 1], ray[:, 0])
    phi = np.arctan2(ray[:, 2], np.linalg.norm(ray[:, :2], axis=1))
    ray5 = np.concatenate([base, theta[:, None], phi[:, None]], axis=1)
    rho = 1.0 / np.linalg.norm(ray, axis=1, keepdims=True)
    L, M = n_landmarks, len(ka)
    rays, rhos = n_poses + np.arange(L), n_poses + L + np.arange(L)
    base_info = np.diag([1.0 / RAY_BASE_SIGMA] * 3 + [0.0, 0.0])
    values = {"Pose3": (np.arange(n_poses), (R0, t0)), "InvDepthRay5": (rays, ray5),
              "Vector1": (rhos, rho)}
    factors = [
        _pose_priors(R, t, [0, 1]),
        ("PriorInvDepthRay5", rays[:, None], ray5, np.broadcast_to(base_info, (L, 5, 5)).copy()),
        ("InvDepthFactor3", np.stack([ka, rays[lj], rhos[lj]], axis=1),
         {"uv": uv, "K": np.broadcast_to(np.asarray(CAM_K), (M, 5)).copy()},
         np.broadcast_to(np.eye(2), (M, 2, 2)).copy()),
    ]
    return values, factors, {"R": R, "t": t, "points": pts}


# --- scenes of the robust and global front end --------------------------------


def ring_rotations(n: int = 10, noise_sigma: float = 0.0, seed: int = 0):
    """A rotation-averaging ring, the JAX package's Shonan tests' scene: n
    true rotations Exp(N(0, 0.8^2 I)), an edge (a, b) for each b - a in
    1..3, the measurement R_a^T R_b composed with Exp(N(0, noise_sigma^2 I))
    when noise_sigma > 0 (drawn edge by edge, after the rotations, from one
    numpy seed).

    Returns (i [E], j [E], R [E, 3, 3], kappa [E] (ones), R_true [n, 3, 3]),
    float64 numpy (`convert.shonan_measurements` carries them across)."""
    rng = np.random.default_rng(seed)
    R_gt = so3.expmap(torch.from_numpy(rng.normal(size=(n, 3)) * 0.8))
    iis, jjs, Rs = [], [], []
    for a in range(n):
        for b in range(a + 1, min(a + 4, n)):
            iis.append(a)
            jjs.append(b)
            Rij = so3.between(R_gt[a], R_gt[b])
            if noise_sigma > 0:
                Rij = so3.compose(Rij, so3.expmap(torch.from_numpy(rng.normal(size=3) * noise_sigma)))
            Rs.append(Rij.numpy())
    return (np.array(iis), np.array(jjs), np.stack(Rs), np.ones(len(iis)), R_gt.numpy())


# the translation-recovery scene: each direction rotated by Exp(xi), xi ~
# N(0, DIRECTION_SIGMA^2 I) (rad), then REVERSED_SHARE of them reversed
DIRECTION_SIGMA = 0.01
REVERSED_SHARE = 0.05


def sphere_directions(n_rings: int = 50, n_per_ring: int = 50, seed: int = 0,
                      sigma: float = DIRECTION_SIGMA, share: float = REVERSED_SHARE):
    """World-frame unit directions t_j - t_i of `sphere_truth`'s positions
    over `sphere_rings`' edges (odometry, then ring to ring), each rotated by
    a small random rotation (sigma rad), then `share` of them reversed: the
    outliers of translation recovery (MFAS). From one numpy seed.

    Returns (edges [E, 2], directions [E, 3], t_true [n, 3], reversed
    indices), float64 numpy."""
    rng = np.random.default_rng(seed)
    n = n_rings * n_per_ring
    _, pos = sphere_truth(n_rings, n_per_ring)
    a = np.concatenate([np.arange(n - 1), np.arange(n - n_per_ring)])
    b = np.concatenate([np.arange(1, n), np.arange(n_per_ring, n)])
    d = pos[b] - pos[a]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Rn = so3.expmap(torch.from_numpy(rng.normal(size=(len(a), 3)) * sigma)).numpy()
    d = np.einsum("eij,ej->ei", Rn, d)
    flipped = np.sort(rng.choice(len(a), size=int(round(share * len(a))), replace=False))
    d[flipped] *= -1.0
    return np.stack([a, b], axis=1), d, pos, flipped


# --- scenes of the extended geometry ---------------------------------------------

# planar landmark SLAM: a landmark is seen within PLANAR_RANGE m, by its
# PLANAR_OBS nearest from each pose; bearing / range sigmas (rad, m); a
# share of the observations after a landmark's first is range-only, another
# bearing-only; the start perturbs poses (m, rad) and landmarks (m)
PLANAR_RANGE = 8.0
PLANAR_OBS = 4
PLANAR_SIGMAS = (0.05, 0.2)
PLANAR_SHARES = (0.1, 0.1)
PLANAR_START = (0.1, 0.05, 0.3)


def planar_slam(n_poses: int = 3687, n_landmarks: int = 1000, seed: int = 0):
    """Planar landmark SLAM in the PlanarSLAMExample / Victoria Park pattern:
    `city_stream(n_poses, seed)`'s Pose2 walk (its odometry lines only, at
    City10000's sigmas) and `n_landmarks` Point2 landmarks drawn uniformly
    over the walk's bounding box (+2 m). Each pose observes its PLANAR_OBS
    nearest landmarks within PLANAR_RANGE m: a landmark's first observation
    is a bearing-range factor (so each landmark is determined), a later one
    range-only or bearing-only with PLANAR_SHARES, else bearing-range.
    Landmarks no pose sees are dropped. The start is the truth perturbed by
    PLANAR_START; a prior pins pose 0. From one numpy seed.

    Returns (values, factors, truth): the first two in the numpy format of
    `utils/convert.py`, truth {"poses": [n, 3], "landmarks": [L, 2],
    "landmark_keys": [L]}; landmark keys follow the poses'."""
    lines, gt = city_stream(n_poses, seed=seed)
    rng = np.random.default_rng(seed + 1)
    odo = [ln.split() for ln in lines]
    odo = np.array([[int(f[1]), int(f[3])] + [float(x) for x in f[6:9]]
                    for f in odo if int(f[3]) == int(f[1]) + 1])
    lo, hi = gt[:, :2].min(axis=0) - 2.0, gt[:, :2].max(axis=0) + 2.0
    lms = rng.uniform(lo, hi, size=(n_landmarks, 2))
    d2 = np.sum((gt[:, None, :2] - lms[None]) ** 2, axis=-1)  # [n, L]
    near = np.argsort(d2, axis=1, kind="stable")[:, :PLANAR_OBS]
    obs = [(i, j) for i in range(n_poses) for j in near[i] if d2[i, j] <= PLANAR_RANGE ** 2]
    seen = np.unique([j for _, j in obs])
    lm_key = {int(j): n_poses + k for k, j in enumerate(seen)}
    kinds = {"BearingRangePose2Point2": [], "RangePose2Point2": [], "BearingPose2Point2": []}
    first = set()
    sb, sr = PLANAR_SIGMAS
    for i, j in obs:
        dx, dy = lms[j] - gt[i, :2]
        c, s = np.cos(gt[i, 2]), np.sin(gt[i, 2])
        b = np.arctan2(-s * dx + c * dy, c * dx + s * dy) + rng.normal() * sb
        r = np.hypot(dx, dy) + rng.normal() * sr
        u = rng.random()
        kind = "BearingRangePose2Point2"
        if j in first:
            kind = ("RangePose2Point2" if u < PLANAR_SHARES[0] else "BearingPose2Point2"
                    if u < sum(PLANAR_SHARES) else kind)
        first.add(j)
        kinds[kind].append((i, lm_key[int(j)], b, r))
    factors = [("PriorPose2", np.zeros((1, 1), dtype=np.int64), gt[:1],
                np.diag([1e3, 1e3, 1e4])[None].copy()),
               ("BetweenPose2", odo[:, :2].astype(np.int64), odo[:, 2:],
                np.broadcast_to(np.diag(1.0 / np.asarray(CITY_SIGMAS)), (len(odo), 3, 3)).copy())]
    for kind, rows in kinds.items():
        if not rows:
            continue
        a = np.array(rows)
        keys = a[:, :2].astype(np.int64)
        if kind == "BearingRangePose2Point2":
            params, info = a[:, 2:4], np.diag([1.0 / sb, 1.0 / sr])
        elif kind == "RangePose2Point2":
            params, info = a[:, 3], np.eye(1) / sr
        else:
            params, info = a[:, 2], np.eye(1) / sb
        factors.append((kind, keys, params, np.broadcast_to(info, (len(a),) + info.shape).copy()))
    sp, sa, sl = PLANAR_START
    start = gt + rng.normal(size=gt.shape) * np.array([sp, sp, sa])
    start[0] = gt[0]
    lm_true = lms[seen]
    values = {"Pose2": (np.arange(n_poses, dtype=np.int64), start),
              "Point2": (np.array([lm_key[int(j)] for j in seen], dtype=np.int64),
                         lm_true + rng.normal(size=lm_true.shape) * sl)}
    truth = {"poses": gt, "landmarks": lm_true, "landmark_keys": values["Point2"][0]}
    return values, factors, truth


# the Sim(3) lift of the sphere: the odometry's scale noise and the scale's
# sigma in its factors and the prior's
SIM3_SCALE_SIGMA = 0.01


def sim3_sphere(n_rings: int = 50, n_per_ring: int = 50, seed: int = 0,
                scale_sigma: float = SIM3_SCALE_SIGMA):
    """`sphere_rings(n_rings, n_per_ring, seed)` lifted to Sim(3), the pose
    graph of monocular SLAM's scale-drift-aware loop closure (Strasdat et
    al., RSS 2010): each odometry measurement's scale is exp(N(0,
    scale_sigma^2)) (drawn after the sphere's own draws, from the same
    seed's second stream), the loop closures keep scale 1, the start has
    scale 1 everywhere. Factor sigmas: the sphere's, and scale_sigma on
    log-scale; the prior pins pose 0 (sim(3) scale 1).

    Returns (values, factors) in the numpy format of `utils/convert.py`."""
    va, fa = sphere_rings(n_rings, n_per_ring, seed=seed)
    rng = np.random.default_rng(seed + 1)
    keys, (R0, t0) = va["Pose3"]
    (_, pk, (pR, pt), pinfo), (_, bk, (bR, bt), binfo) = fa
    n_odo = n_rings * n_per_ring - 1
    s = np.ones(len(bk))
    s[:n_odo] = np.exp(rng.normal(size=n_odo) * scale_sigma)

    def lift(info, scale_info):
        out = np.zeros((len(info), 7, 7))
        out[:, :6, :6] = info
        out[:, 6, 6] = scale_info
        return out

    values = {"Sim3": (keys, (R0, t0, np.ones(len(keys))))}
    factors = [("PriorSim3", pk, (pR, pt, np.ones(len(pk))), lift(pinfo, 1e3)),
               ("BetweenSim3", bk, (bR, bt, s), lift(binfo, 1.0 / scale_sigma))]
    return values, factors


# plane SLAM: rooms in a row along x, each PLANE_ROOM (x, y, z) m with six
# planes (floor, ceiling, four walls) slightly tilted room by room; keyframes
# walk each room's ellipse, then the door to the next; odometry sigmas (rad,
# m), the plane measurement's (unit3 tangent, m) and the direction prior's;
# the start perturbs poses (rad, m) and planes (tangent, m)
PLANE_ROOM = (6.0, 4.0, 3.0)
PLANE_ODO_SIGMAS = (0.01, 0.02)
PLANE_MEAS_SIGMAS = (0.01, 0.02)
PLANE_PRIOR_SIGMAS = (0.1, 1.0)
PLANE_START = ((0.02, 0.1), (0.05, 0.1))


def _planes_of_room(k: int, rng):
    """The six (n [6, 3], d [6]) planes of room k, n.x + d = 0, normals
    pointing into the room, each tilted by N(0, 0.02^2) rad."""
    X, Y, Z = PLANE_ROOM
    x0 = k * X
    n = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]], float)
    pts = np.array([[x0, 0, 0], [x0, 0, Z], [x0, 0, 0], [x0 + X, 0, 0], [x0, -Y / 2, 0],
                    [x0, Y / 2, 0]])
    R = so3.expmap(torch.from_numpy(rng.normal(size=(6, 3)) * 0.02)).numpy()
    n = np.einsum("pij,pj->pi", R, n)
    return n, -np.sum(n * pts, axis=1)


def plane_slam(n_keyframes: int = 1000, n_planes: int = 60, seed: int = 0):
    """RGB-D SLAM with infinite planes (Kaess, ICRA 2015): n_planes / 6 rooms
    in a row; n_keyframes Pose3 keyframes split evenly over the rooms, each
    room's share walking an ellipse around its centre at 1.5 m height,
    looking along the walk, with a slow pitch / roll; Pose3 odometry between
    consecutive keyframes (PLANE_ODO_SIGMAS), and every keyframe observing
    the six planes of its room through an OrientedPlane3Factor (the plane in
    its frame retracted by N(0, PLANE_MEAS_SIGMAS^2)); one
    OrientedPlane3DirectionPrior a plane at PLANE_PRIOR_SIGMAS; a prior pins
    keyframe 0. The start is the truth perturbed by PLANE_START. From one
    numpy seed.

    Returns (values, factors, truth {"R", "t", "n", "d"}) in the numpy format
    of `utils/convert.py`; plane keys follow the keyframes'."""
    rng = np.random.default_rng(seed)
    rooms = n_planes // 6
    per = -(-n_keyframes // rooms)
    X, Y, Z = PLANE_ROOM
    room = np.arange(n_keyframes) // per
    ang = 2.0 * np.pi * (np.arange(n_keyframes) % per) / per
    pos = np.stack([room * X + X / 2 + 0.3 * X * np.cos(ang), 0.3 * Y * np.sin(ang),
                    np.full(n_keyframes, 1.5)], axis=1)
    yaw = ang + np.pi / 2
    w_yaw = np.stack([np.zeros(n_keyframes), np.zeros(n_keyframes), yaw], axis=1)
    wobble = np.stack([0.05 * np.sin(3 * ang), 0.05 * np.cos(2 * ang),
                       np.zeros(n_keyframes)], axis=1)
    R = np.einsum("nij,njk->nik", so3.expmap(torch.from_numpy(w_yaw)).numpy(),
                  so3.expmap(torch.from_numpy(wobble)).numpy())
    planes = [_planes_of_room(k, rng) for k in range(rooms)]
    pn = np.concatenate([p[0] for p in planes])
    pd = np.concatenate([p[1] for p in planes])
    P = len(pd)
    keys = np.arange(n_keyframes, dtype=np.int64)
    pkeys = n_keyframes + np.arange(P, dtype=np.int64)

    so, st = PLANE_ODO_SIGMAS
    a, b = np.arange(n_keyframes - 1), np.arange(1, n_keyframes)
    odo = _between_np((R[a], pos[a]), (R[b], pos[b]))
    odo = _compose_np(odo, _exp_np(rng.normal(size=(len(a), 6)) * np.array([so] * 3 + [st] * 3)))

    obs_i = np.repeat(keys, 6)
    obs_p = (room[:, None] * 6 + np.arange(6)[None]).reshape(-1)
    Rp, tp = R[obs_i], pos[obs_i]
    n_loc = np.einsum("nji,nj->ni", Rp, pn[obs_p])
    d_loc = pd[obs_p] + np.sum(pn[obs_p] * tp, axis=1)
    sn, sd = PLANE_MEAS_SIGMAS
    m = _plane_retract_np(n_loc, d_loc, rng.normal(size=(len(obs_i), 3)) * np.array([sn, sn, sd]))
    pr_n, pr_d = PLANE_PRIOR_SIGMAS
    prior = _plane_retract_np(pn, pd, rng.normal(size=(P, 3)) * np.array([pr_n, pr_n, pr_d]))

    (sr, sp), (spn, spd) = PLANE_START
    xi0 = rng.normal(size=(n_keyframes, 6)) * np.array([sr] * 3 + [sp] * 3)
    xi0[0] = 0.0
    start = _compose_np((R, pos), _exp_np(xi0))
    p_start = _plane_retract_np(pn, pd, rng.normal(size=(P, 3)) * np.array([spn, spn, spd]))

    def info(sig, n):
        return np.broadcast_to(np.diag(1.0 / np.asarray(sig)), (n, len(sig), len(sig))).copy()

    factors = [
        ("PriorPose3", keys[:1, None], (R[:1], pos[:1]), np.diag([1e3] * 3 + [1e2] * 3)[None].copy()),
        ("BetweenPose3", np.stack([a, b], axis=1), odo, info([so] * 3 + [st] * 3, len(a))),
        ("OrientedPlane3Factor", np.stack([obs_i, pkeys[obs_p]], axis=1), m,
         info([sn, sn, sd], len(obs_i))),
        ("OrientedPlane3DirectionPrior", pkeys[:, None], prior, info([pr_n, pr_n, pr_d], P)),
    ]
    values = {"Pose3": (keys, start), "OrientedPlane3": (pkeys, p_start)}
    return values, factors, {"R": R, "t": pos, "n": pn, "d": pd}


def _plane_retract_np(n, d, xi):
    """OrientedPlane3 retract on numpy: (n [P, 3], d [P]) by xi [P, 3]."""
    p = essential.plane_retract(essential.OrientedPlane3(torch.from_numpy(n), torch.from_numpy(d)),
                                torch.from_numpy(xi))
    return p.n.numpy(), p.d.numpy()


# two-view relative poses: rotation angle sigma (rad), the points' depth
# range (m) in camera B, the baseline's length (m), the correspondences'
# noise on normalized image coordinates (~0.5 px at f = 500), the epipolar
# residual's sigma and the start's perturbation of E (rad, tangent)
TWO_VIEW_ROT = 0.2
TWO_VIEW_DEPTH = (2.0, 8.0)
TWO_VIEW_BASELINE = 1.0
TWO_VIEW_PIXEL = 1e-3
TWO_VIEW_START = (0.05, 0.1)


def two_view_pairs(n_pairs: int = 1000, n_points: int = 100, seed: int = 0):
    """An SfM front end's two-view refinement: n_pairs image pairs, each an
    EssentialMatrix value (1R2, unit t: x_a = R x_b + t) and n_points
    calibrated correspondences through EssentialMatrixFactor (pA in image A,
    pB in image B, both normalized coordinates + N(0, TWO_VIEW_PIXEL^2)),
    whitened by 1 / TWO_VIEW_PIXEL; no variable is shared between pairs.
    The start is the truth retracted by N(0, TWO_VIEW_START^2) (rotation,
    direction). From one numpy seed.

    Returns (values, factors, truth {"R": [P, 3, 3], "t": [P, 3]}) in the
    numpy format of `utils/convert.py`."""
    rng = np.random.default_rng(seed)
    R = so3.expmap(torch.from_numpy(rng.normal(size=(n_pairs, 3)) * TWO_VIEW_ROT)).numpy()
    t = rng.normal(size=(n_pairs, 3))
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    xy = rng.uniform(-0.5, 0.5, size=(n_pairs, n_points, 2))
    z = rng.uniform(*TWO_VIEW_DEPTH, size=(n_pairs, n_points, 1))
    xb = np.concatenate([xy * z, z], axis=-1)
    xa = np.einsum("pij,pnj->pni", R, xb) + TWO_VIEW_BASELINE * t[:, None]
    pa = xa[..., :2] / xa[..., 2:] + rng.normal(size=xy.shape) * TWO_VIEW_PIXEL
    pb = xb[..., :2] / xb[..., 2:] + rng.normal(size=xy.shape) * TWO_VIEW_PIXEL
    sr, st = TWO_VIEW_START
    E0 = essential.essential_retract(
        essential.EssentialMatrix(torch.from_numpy(R), torch.from_numpy(t)),
        torch.from_numpy(rng.normal(size=(n_pairs, 5)) * np.array([sr] * 3 + [st] * 2)))
    keys = np.arange(n_pairs, dtype=np.int64)
    M = n_pairs * n_points
    factors = [("EssentialMatrixFactor", np.repeat(keys, n_points)[:, None],
                {"pA": pa.reshape(M, 2), "pB": pb.reshape(M, 2)},
                np.full((M, 1, 1), 1.0 / TWO_VIEW_PIXEL))]
    values = {"EssentialMatrix": (keys, (E0.R.numpy(), E0.t.numpy()))}
    return values, factors, {"R": R, "t": t}


def drive_positions(n_keyframes: int, rate_hz: int = 200, device: DeviceLike = "cuda"):
    """The true positions of `imu_gps_drive(n_keyframes, rate_hz)`'s car at
    its IMU rate: (times [S], positions [S, 3]) on `device`, S = (n_keyframes
    - 1) * rate_hz samples over [0, n_keyframes - 1) s."""
    sc = constant_twist(*DRIVE_TWIST, device=device)
    ts = torch.arange((n_keyframes - 1) * rate_hz, dtype=torch.float64,
                      device=sc.w.device) / rate_hz
    return ts, sc.nav_state(ts).t


def _info(n, sigma, d):
    return np.broadcast_to(np.eye(d) / sigma, (n, d, d)).copy()


def extra_factor_scenes(seed: int = 0):
    """Small graphs (10-50 variables) of the extended geometry's remaining
    factor types, from one numpy seed: name -> (values, factors) in the
    numpy format of `utils/convert.py`. The measurements are the truth's
    (noise-free), the starts the truth perturbed, so LM returns to it:

      frobenius     a Rot3 chain (FrobeniusBetweenFactor) and its copies
                    tied by FrobeniusFactor, a prior on rotation 0
      karcher       10 rotations, BetweenRot3 edges, a KarcherMeanFactor10
                    gauge instead of a prior
      pose_priors   a Pose3 chain, PoseRotationPrior on pose 0 and
                    PoseTranslationPrior on every pose
      rotate        10 rotations, each with 5 RotateFactors and 5
                    RotateDirectionsFactors
      essential     a Pose3 chain with EssentialMatrixConstraints, a
                    BetweenPose3 every third edge (the scale), a prior
      reference     ReferenceFrameFactor: a Pose3 transform between 10
                    global and 10 local Point3s, with priors on the points
      planar        a Pose2 chain seeing known landmarks through
                    PlanarProjectionFactor
      range_bearing_3d  Pose3 chain and Point3 landmarks through
                    RangeFactor(Pose3, Point3) and BearingFactor3D
    """
    rng = np.random.default_rng(seed)
    out = {}

    def rots(n, s=0.5):
        return so3.expmap(torch.from_numpy(rng.normal(size=(n, 3)) * s)).numpy()

    def perturb_R(R, s=0.05):
        return np.einsum("nij,njk->nik", R, rots(len(R), s))

    def chain(n):
        xi = np.c_[rng.normal(size=(n, 3)) * 0.3, rng.normal(size=(n, 3)) * 2.0]
        return _exp_np(xi)

    n = 10
    # frobenius
    R = rots(n)
    rel = np.einsum("nji,njk->nik", R[:-1], R[1:])
    keys = np.arange(n)
    out["frobenius"] = (
        {"Rot3": (np.r_[keys, keys + n], np.concatenate([perturb_R(R), perturb_R(R)]))},
        [("PriorRot3", keys[:1, None], R[:1], _info(1, 1e-3, 3)),
         ("FrobeniusBetweenFactor", np.stack([keys[:-1], keys[1:]], 1), rel, _info(n - 1, 0.1, 9)),
         ("FrobeniusFactor", np.stack([keys, keys + n], 1), None, _info(n, 0.1, 9)),
         ("PriorRot3", (keys + n)[:, None], R, _info(n, 1.0, 3))])
    # karcher
    R = rots(n)
    a, b = np.r_[keys[:-1], keys[:-2]], np.r_[keys[1:], keys[2:]]
    out["karcher"] = (
        {"Rot3": (keys, perturb_R(R))},
        [("BetweenRot3", np.stack([a, b], 1), np.einsum("nji,njk->nik", R[a], R[b]),
          _info(len(a), 0.05, 3)),
         (f"KarcherMeanFactor{n}", keys[None], None, _info(1, 0.01, 3))])
    # pose priors
    R, t = chain(n)
    a, b = keys[:-1], keys[1:]
    out["pose_priors"] = (
        {"Pose3": (keys, _compose_np((R, t), _exp_np(rng.normal(size=(n, 6)) * 0.05)))},
        [("BetweenPose3", np.stack([a, b], 1), _between_np((R[a], t[a]), (R[b], t[b])),
          _info(len(a), 0.1, 6)),
         ("PoseRotationPrior", keys[:1, None], R[:1], _info(1, 1e-3, 3)),
         ("PoseTranslationPrior", keys[:, None], t, _info(n, 0.5, 3))])
    # rotate
    R = rots(n)
    z = rng.normal(size=(n, 5, 3))
    p = np.einsum("nij,nkj->nki", R, z)
    ks = np.repeat(keys, 5)[:, None]
    out["rotate"] = (
        {"Rot3": (keys, perturb_R(R, 0.2))},
        [("RotateFactor", ks, {"p": p.reshape(-1, 3), "z": z.reshape(-1, 3)}, _info(n * 5, 0.01, 3)),
         ("RotateDirectionsFactor", ks, {"p": p.reshape(-1, 3), "z": z.reshape(-1, 3)},
          _info(n * 5, 0.01, 2))])
    # essential constraint
    R, t = chain(n + 2)
    k2 = np.arange(n + 2)
    a, b = k2[:-1], k2[1:]
    rR, rt = _between_np((R[a], t[a]), (R[b], t[b]))
    sc = a[::3]
    out["essential"] = (
        {"Pose3": (k2, _compose_np((R, t), _exp_np(rng.normal(size=(n + 2, 6)) * 0.02)))},
        [("PriorPose3", k2[:1, None], (R[:1], t[:1]), _info(1, 1e-3, 6)),
         ("EssentialMatrixConstraint", np.stack([a, b], 1),
          (rR, rt / np.linalg.norm(rt, axis=1, keepdims=True)), _info(len(a), 0.01, 5)),
         ("BetweenPose3", np.stack([sc, sc + 1], 1), (rR[sc], rt[sc]), _info(len(sc), 0.1, 6))])
    # reference frame
    T = _exp_np(rng.normal(size=(1, 6)) * 0.5)
    loc = rng.normal(size=(n, 3)) * 2.0
    glob = np.einsum("ij,nj->ni", T[0][0], loc) + T[1][0]
    gk, lk, tk = keys, keys + n, 2 * n
    out["reference"] = (
        {"Point3": (np.r_[gk, lk], np.concatenate([glob, loc]) + rng.normal(size=(2 * n, 3)) * 0.05),
         "Pose3": (np.array([tk]), _compose_np(T, _exp_np(rng.normal(size=(1, 6)) * 0.1)))},
        [("PriorPoint3", np.r_[gk, lk][:, None], np.concatenate([glob, loc]), _info(2 * n, 0.01, 3)),
         ("ReferenceFrameFactor", np.stack([gk, np.full(n, tk), lk], 1), None, _info(n, 0.05, 3))])
    # planar projection: a robot driving along x, landmarks ahead of it
    x = np.c_[np.arange(n) * 0.5, 0.1 * np.sin(np.arange(n)), 0.05 * np.cos(np.arange(n))]
    Rbc = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    lm = np.c_[rng.uniform(8, 12, 4 * n), rng.uniform(-3, 3, 4 * n), rng.uniform(0.5, 2.5, 4 * n)]
    obs = np.repeat(keys, 4)
    cal = np.array([400.0, 400.0, 0.0, 320.0, 240.0])
    c, s = np.cos(x[obs, 2]), np.sin(x[obs, 2])
    R3 = np.zeros((len(obs), 3, 3))
    R3[:, 0, 0], R3[:, 0, 1], R3[:, 1, 0], R3[:, 1, 1], R3[:, 2, 2] = c, -s, s, c, 1.0
    t3 = np.c_[x[obs, :2], np.zeros(len(obs))]
    pc = np.einsum("nji,nj->ni", R3 @ Rbc, lm - t3)
    uv = np.c_[cal[0] * pc[:, 0] / pc[:, 2] + cal[3], cal[1] * pc[:, 1] / pc[:, 2] + cal[4]]
    a, b = keys[:-1], keys[1:]
    rel = np.stack([np.asarray(pose2.between(torch.from_numpy(x[i]), torch.from_numpy(x[j])))
                    for i, j in zip(a, b)])
    out["planar"] = (
        {"Pose2": (keys, x + rng.normal(size=x.shape) * np.array([0.05, 0.05, 0.01]))},
        [("PriorPose2", keys[:1, None], x[:1], _info(1, 1e-3, 3)),
         ("BetweenPose2", np.stack([a, b], 1), rel, _info(len(a), 0.1, 3)),
         ("PlanarProjectionFactor", obs[:, None],
          {"landmark": lm, "measured": uv, "cal": np.broadcast_to(cal, (len(obs), 5)).copy(),
           "body_P_cam_R": np.broadcast_to(Rbc, (len(obs), 3, 3)).copy(),
           "body_P_cam_t": np.zeros((len(obs), 3))}, _info(len(obs), 1.0, 2))])
    # range and bearing in 3-D
    R, t = chain(n)
    pts = t[np.repeat(keys, 2)] + rng.normal(size=(2 * n, 3)) * 3.0
    pk = n + np.arange(2 * n)
    pl = np.r_[np.stack([2 * keys, 2 * keys + 1], 1).reshape(-1),
               np.stack([2 * keys + 2, 2 * keys + 3], 1).reshape(-1) % (2 * n)]
    po = np.r_[np.repeat(keys, 2), np.repeat(keys, 2)]
    d = pts[pl] - t[po]
    rng_m = np.linalg.norm(d, axis=1)
    body = np.einsum("nji,nj->ni", R[po], d)
    a, b = keys[:-1], keys[1:]
    out["range_bearing_3d"] = (
        {"Pose3": (keys, _compose_np((R, t), _exp_np(rng.normal(size=(n, 6)) * 0.02))),
         "Point3": (pk, pts + rng.normal(size=pts.shape) * 0.1)},
        [("PriorPose3", keys[:1, None], (R[:1], t[:1]), _info(1, 1e-3, 6)),
         ("BetweenPose3", np.stack([a, b], 1), _between_np((R[a], t[a]), (R[b], t[b])),
          _info(len(a), 0.05, 6)),
         ("RangePose3Point3", np.stack([po, pk[pl]], 1), rng_m, _info(len(po), 0.05, 1)),
         ("BearingPose3Point3", np.stack([po, pk[pl]], 1),
          body / np.linalg.norm(body, axis=1, keepdims=True), _info(len(po), 0.01, 2))])
    return out
