"""Synthetic graphs: Pose3 rings with the topology of the sphere benchmark,
a City10000-like Pose2 stream (`city_stream`), an IMU + GPS drive
(`imu_gps_drive`), the scenes of the unstable factors and the camera
factors, and those of the robust and global front end (`ring_rotations`,
`sphere_directions`).

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
from gtsam_petercdev_torch.geometry import pose3, so3
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
