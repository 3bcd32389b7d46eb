"""Dataset I/O: g2o / TORO pose-graph files (reference: gtsam/slam/dataset.cpp).

Port of gtsam_petercdev_tpu/utils/dataset.py. readG2o parses VERTEX_SE2 /
EDGE_SE2 (TORO: VERTEX2 / EDGE2) and VERTEX_SE3:QUAT / EDGE_SE3:QUAT (TORO:
VERTEX3 / EDGE3) into a (NonlinearFactorGraph, Values) pair on the caller's
device. The parser is the JAX package's own pure-Python one (its fallback
after the native reader): the port loads no shared library of the JAX
package.

g2o conventions handled to match the reference:
  * SE2 edge information is the upper triangle of a 6-entry (x, y, theta)
    info matrix (dataset.cpp:269).
  * SE3 edge information is the upper triangle (21 entries) in g2o (t, R)
    order; GTSAM tangent order is (R, t), so blocks are swapped
    (dataset.cpp:850-856).
  * TORO EDGE2 stores (ixx ixy it ixy2... ) in the order
    v(0) v(1) v(5) v(2) v(4) v(3) per dataset.cpp parsing of EDGE2.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from gtsam_petercdev_torch.device import DeviceLike
from gtsam_petercdev_torch.geometry import so3
from gtsam_petercdev_torch.geometry.pose3 import Pose3
from gtsam_petercdev_torch.linear import noise
from gtsam_petercdev_torch.nonlinear.factor_graph import NonlinearFactorGraph
from gtsam_petercdev_torch.nonlinear.values import Values
from gtsam_petercdev_torch.slam.factors import between_factor


def _ypr_matrix(yaw, pitch, roll):
    """Rot3::Ypr(y,p,r) = Rz(y) Ry(p) Rx(r) as a numpy 3x3."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _mat_to_quat(R):
    """[...,3,3] -> (w,x,y,z) quaternion, host numpy (Shepperd's method, as
    so3.to_quaternion; parsing issues no device work)."""
    R = np.asarray(R, dtype=np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def ssqrt(x):
        return np.sqrt(np.maximum(x, 1e-12))

    q0 = np.stack(
        [ssqrt(1 + tr) / 2, (m21 - m12) / (2 * ssqrt(1 + tr)),
         (m02 - m20) / (2 * ssqrt(1 + tr)), (m10 - m01) / (2 * ssqrt(1 + tr))],
        axis=-1,
    )
    s1 = 2 * ssqrt(1 + m00 - m11 - m22)
    q1 = np.stack([(m21 - m12) / s1, s1 / 4, (m01 + m10) / s1, (m02 + m20) / s1], axis=-1)
    s2 = 2 * ssqrt(1 - m00 + m11 - m22)
    q2 = np.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4, (m12 + m21) / s2], axis=-1)
    s3 = 2 * ssqrt(1 - m00 - m11 + m22)
    q3 = np.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, s3 / 4], axis=-1)
    k = np.argmax(np.stack([tr, m00, m11, m22], axis=-1), axis=-1)
    qs = np.stack([q0, q1, q2, q3], axis=-2)
    q = np.take_along_axis(qs, np.repeat(k[..., None, None], 4, axis=-1), axis=-2)[..., 0, :]
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def initialize_from_odometry(edges3, first=None):
    """Compose sequential edges into an initial trajectory.

    edges3: list of (i, j, t, q_wxyz, info). Returns {id: (t, q_wxyz)}.
    Mirrors the incremental bootstrap used by the reference's
    SolverComparer/ISAM2 harnesses for vertex-less TORO files.
    """
    if first is None:
        first = min(min(i, j) for (i, j, *_r) in edges3)
    poses = {first: (np.zeros(3), np.array([1.0, 0.0, 0.0, 0.0]))}
    for (i, j, t, q, _info) in edges3:
        if i in poses and j not in poses:
            ti, qi = poses[i]
            Ri, Rij = _np_quat_to_R(qi), _np_quat_to_R(q)
            poses[j] = (ti + Ri @ t, _mat_to_quat(Ri @ Rij))
        elif j in poses and i not in poses:
            tj, qj = poses[j]
            Ri = _np_quat_to_R(qj) @ _np_quat_to_R(q).T
            poses[i] = (tj - Ri @ t, _mat_to_quat(Ri))
    return poses


def _np_quat_to_R(q):
    """Vectorized host-side quaternion (w,x,y,z) [...,4] -> R [...,3,3]
    (so3.from_quaternion on numpy)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _sym_from_upper(vals, d):
    """Fill symmetric dxd from upper-triangle row-major list."""
    M = np.zeros((d, d))
    idx = 0
    for i in range(d):
        for j in range(i, d):
            M[i, j] = M[j, i] = vals[idx]
            idx += 1
    return M


def read_g2o(path: str, is3D: bool = False, dtype=np.float64, *,
             device: DeviceLike = "cuda") -> Tuple[NonlinearFactorGraph, Values]:
    """Parse a g2o file (reference readG2o, dataset.h:190) into a graph and
    Values on `device` (default "cuda"; raises without a card unless the
    caller passes "cpu") in `dtype`."""
    vertices2, vertices3 = {}, {}
    edges2, edges3 = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag in ("VERTEX_SE2", "VERTEX2"):
                vertices2[int(parts[1])] = [float(p) for p in parts[2:5]]
            elif tag == "VERTEX_SE3:QUAT":
                x, y, z, qx, qy, qz, qw = (float(p) for p in parts[2:9])
                vertices3[int(parts[1])] = (np.array([x, y, z]), np.array([qw, qx, qy, qz]))
            elif tag in ("EDGE_SE2", "EDGE2"):
                i, j = int(parts[1]), int(parts[2])
                vals = [float(p) for p in parts[3:]]
                iv = vals[3:]
                if tag == "EDGE_SE2":
                    info = _sym_from_upper(iv, 3)
                else:  # TORO EDGE2 ordering (dataset.cpp load2D TORO branch)
                    info = np.zeros((3, 3))
                    info[0, 0], info[0, 1], info[1, 1] = iv[0], iv[1], iv[2]
                    info[2, 2], info[0, 2], info[1, 2] = iv[3], iv[4], iv[5]
                    info[1, 0], info[2, 0], info[2, 1] = info[0, 1], info[0, 2], info[1, 2]
                edges2.append((i, j, np.array(vals[:3]), info))
            elif tag == "VERTEX3":
                x, y, z, roll, pitch, yaw = (float(p) for p in parts[2:8])
                vertices3[int(parts[1])] = (np.array([x, y, z]),
                                            _mat_to_quat(_ypr_matrix(yaw, pitch, roll)))
            elif tag == "EDGE3":
                # TORO 3D: x y z roll pitch yaw + 21 upper-tri info entries.
                # The reference reads the info WITHOUT reordering — i.e. it is
                # interpreted directly in GTSAM (R, t) tangent order
                # (dataset.cpp:829-840) — replicated here for parity.
                i, j = int(parts[1]), int(parts[2])
                vals = [float(p) for p in parts[3:]]
                x, y, z, roll, pitch, yaw = vals[:6]
                edges3.append((i, j, np.array([x, y, z]),
                               _mat_to_quat(_ypr_matrix(yaw, pitch, roll)),
                               _sym_from_upper(vals[6:27], 6)))
            elif tag == "EDGE_SE3:QUAT":
                i, j = int(parts[1]), int(parts[2])
                vals = [float(p) for p in parts[3:]]
                x, y, z, qx, qy, qz, qw = vals[:7]
                info_g2o = _sym_from_upper(vals[7:28], 6)
                # swap (t, R) -> (R, t) blocks (dataset.cpp:850-856)
                info = np.zeros((6, 6))
                info[:3, :3] = info_g2o[3:, 3:]
                info[3:, 3:] = info_g2o[:3, :3]
                info[:3, 3:] = info_g2o[3:, :3]
                info[3:, :3] = info_g2o[:3, 3:]
                edges3.append((i, j, np.array([x, y, z]), np.array([qw, qx, qy, qz]), info))
    return _build_g2o_graph(vertices2, vertices3, edges2, edges3, is3D, dtype, device)


def _build_g2o_graph(vertices2, vertices3, edges2, edges3, is3D, dtype, device):
    graph = NonlinearFactorGraph(device=device, dtype=dtype)
    values = Values(device=device, dtype=dtype)
    if is3D or vertices3 or edges3:
        if not vertices3 and edges3:
            # vertex-less TORO file (e.g. sphere2500): bootstrap the initial
            # trajectory by composing odometry, as the reference harnesses do.
            vertices3 = initialize_from_odometry(edges3)
        vkeys = sorted(vertices3.keys())
        values.insert_batch(vkeys, "Pose3", Pose3(
            torch.as_tensor(_np_quat_to_R(np.stack([vertices3[i][1] for i in vkeys]))),
            torch.as_tensor(np.stack([vertices3[i][0] for i in vkeys]))))
        if edges3:
            keys = np.array([[i, j] for (i, j, *_rest) in edges3], dtype=np.uint64)
            Rs = _np_quat_to_R(np.stack([q for (_i, _j, _t, q, _info) in edges3]))
            ts = np.stack([t for (_i, _j, t, _q, _info) in edges3])
            infos = np.stack([info for (*_r, info) in edges3])
            graph.add_batch(between_factor("Pose3"), keys, Pose3(Rs, ts),
                            noise.gaussian_information(infos))
    else:
        vkeys2 = sorted(vertices2.keys())
        if vkeys2:
            values.insert_batch(vkeys2, "Pose2", np.stack([vertices2[i] for i in vkeys2]))
        if edges2:
            keys = np.array([[i, j] for (i, j, _m, _info) in edges2], dtype=np.uint64)
            ms = np.stack([m for (_i, _j, m, _info) in edges2])
            infos = np.stack([info for (*_r, info) in edges2])
            graph.add_batch(between_factor("Pose2"), keys, ms, noise.gaussian_information(infos))
    return graph, values


def write_g2o(graph, values: Values, path: str):
    """Write Pose2/Pose3 values + Between factors (dataset.cpp writeG2o).
    As in the JAX package, only the vertices are written, at 6 decimals.
    Each type's values come off the device in one read."""
    lines = []
    for t in values.types():
        keys = values.type_keys(t)
        rows = torch.as_tensor(values.rows(keys, t), dtype=torch.int64)
        if t == "Pose2":
            v = values.params(t).cpu()[rows].numpy()
            lines += [f"VERTEX_SE2 {key} {x[0]:.6f} {x[1]:.6f} {x[2]:.6f}"
                      for key, x in zip(keys, v)]
        elif t == "Pose3":
            p = values.params(t)
            tv = p.t.cpu()[rows].numpy()
            q = so3.to_quaternion(p.R).cpu()[rows].numpy()  # (w,x,y,z)
            lines += ["VERTEX_SE3:QUAT "
                      f"{key} {a[0]:.6f} {a[1]:.6f} {a[2]:.6f} "
                      f"{b[1]:.6f} {b[2]:.6f} {b[3]:.6f} {b[0]:.6f}"
                      for key, a, b in zip(keys, tv, q)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# the data files inside this checkout (the JAX package searches the
# reference's examples/Data, which no checkout of this repository holds)
_EXAMPLE_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "data")


def find_example_data(name: str, data_dir: Optional[str] = None) -> str:
    """Path to a dataset file (findExampleDataFile): `name` in `data_dir`
    when the caller gives one, else in this checkout's tests/data. The
    reference's examples/Data tree, which the JAX package searches, is not
    part of this repository; the tests and chip_smoke.py write their files
    with `write_g2o`. Raises FileNotFoundError when the file is not there."""
    p = os.path.join(data_dir or _EXAMPLE_DATA, name)
    if os.path.exists(p):
        return p
    raise FileNotFoundError(name)
