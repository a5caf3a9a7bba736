"""Rotation math: rotation matrices, roll-pitch-yaw, quaternions.

The PyTorch counterpart of ``drake_tpu/math/rotations.py``.  Rotations are
plain ``(..., 3, 3)`` tensors and every function broadcasts over leading batch
dimensions.  Conventions follow Drake: ``R_AB`` maps vectors expressed in
frame B to frame A; rpy is extrinsic X-Y-Z, ``R = Rz(yaw) @ Ry(pitch) @
Rx(roll)``; quaternions are ``(w, x, y, z)``.
"""

from __future__ import annotations

import torch

from drake_tpu_torch.utils.linalg import solve


def _mat3(rows):
    """(..., 3, 3) from three rows of three (...,) tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_x(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _mat3([(o, z, z), (z, c, -s), (z, s, c)])


def rot_y(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _mat3([(c, z, s), (z, o, z), (-s, z, c)])


def rot_z(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _mat3([(c, -s, z), (s, c, z), (z, z, o)])


def rpy_to_rotation(rpy):
    """Roll-pitch-yaw (extrinsic XYZ) -> rotation matrix R_AB."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    return rot_z(y) @ rot_y(p) @ rot_x(r)


def rotation_to_rpy(R):
    """Rotation matrix -> roll-pitch-yaw, Drake's atan2 extraction:
    pitch = atan2(-R20, sqrt(R00^2 + R10^2))."""
    pitch = torch.atan2(-R[..., 2, 0], torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def rpy_rates_to_angular_velocity_in_child(rpy, rpy_dot):
    """w_AB_B (angular velocity expressed in the child frame) from rpy rates:
    w_B = Rx(r)^T Ry(p)^T [0, 0, yd] + Rx(r)^T [0, pd, 0] + [rd, 0, 0]."""
    r, p = rpy[..., 0], rpy[..., 1]
    sr, cr = torch.sin(r), torch.cos(r)
    sp, cp = torch.sin(p), torch.cos(p)
    rd, pd, yd = rpy_dot.unbind(-1)
    return torch.stack([rd - sp * yd, cr * pd + sr * cp * yd, -sr * pd + cr * cp * yd], dim=-1)


def rpy_rates_to_angular_velocity_in_parent(rpy, rpy_dot):
    """w_AB_A (angular velocity expressed in the parent frame) from rpy rates:
    w_A = Rz(y) Ry(p) [rd, 0, 0] + Rz(y) [0, pd, 0] + [0, 0, yd]."""
    p, y = rpy[..., 1], rpy[..., 2]
    sp, cp = torch.sin(p), torch.cos(p)
    sy, cy = torch.sin(y), torch.cos(y)
    rd, pd, yd = rpy_dot.unbind(-1)
    return torch.stack([cy * cp * rd - sy * pd, sy * cp * rd + cy * pd, -sp * rd + yd], dim=-1)


def rpy_ddt_from_angular_accel_in_parent(rpy, rpy_dot, alpha_A):
    """Second time-derivative of rpy from the angular acceleration in the
    parent frame: alpha_A = M rpy_ddot + Mdot rpy_dot, so rpy_ddot =
    M^-1 (alpha_A - Mdot rpy_dot), a batched 3x3 solve."""
    p, y = rpy[..., 1], rpy[..., 2]
    sp, cp = torch.sin(p), torch.cos(p)
    sy, cy = torch.sin(y), torch.cos(y)
    rd, pd, yd = rpy_dot.unbind(-1)
    zero, one = torch.zeros_like(p), torch.ones_like(p)
    # w_A = M @ rpy_dot (rpy_rates_to_angular_velocity_in_parent).
    M = _mat3([(cy * cp, -sy, zero), (sy * cp, cy, zero), (-sp, zero, one)])
    Mdot_rpyd = torch.stack(
        [
            (-sy * yd * cp - cy * sp * pd) * rd - cy * yd * pd,
            (cy * yd * cp - sy * sp * pd) * rd - sy * yd * pd,
            -cp * pd * rd,
        ],
        dim=-1,
    )
    return solve(M, alpha_A - Mdot_rpyd)


def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_multiply(q1, q2):
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q, eps=1e-12):
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), eps)


def quat_to_rotation(q):
    """Unit quaternion (w,x,y,z) -> rotation matrix."""
    w, x, y, z = q.unbind(-1)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return _mat3(
        [
            (ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)),
            (2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)),
            (2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz),
        ]
    )


def rotation_to_quat(R):
    """Rotation matrix -> unit quaternion (w,x,y,z) with w >= 0, branch-free:
    Shepperd's four candidates and a select by the largest of (trace,
    R00, R11, R22), the first on ties."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    q = torch.take_along_dim(cand, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)
    q = quat_normalize(q.squeeze(-2))
    return torch.where(q[..., :1] < 0, -q, q)


def quat_rotate(q, v):
    """Rotate v by the unit quaternion q (quat_to_rotation(q) @ v)."""
    qv, w = q[..., 1:], q[..., :1]
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def quat_derivative(q, w_B):
    """dq/dt from the body-frame angular velocity: 0.5 q (x) [0, w_B]."""
    return 0.5 * quat_multiply(q, torch.cat([torch.zeros_like(w_B[..., :1]), w_B], dim=-1))


def quat_integrate(q, w_B, dt):
    """Exact exponential-map integration of a constant body-frame rate.

    Gradient-safe at w = 0 as the reference: the squared angle is computed
    smoothly and each branch of the select sees a safe argument (Taylor
    series below the threshold), so no NaN reaches the gradient."""
    a2 = torch.sum(w_B * w_B, dim=-1, keepdim=True) * dt * dt
    small = a2 < 1e-12
    a2_safe = torch.where(small, torch.ones_like(a2), a2)
    angle = torch.sqrt(a2_safe)
    half = 0.5 * angle
    k = torch.where(small, 0.5 * dt * (1.0 - a2 / 24.0), torch.sin(half) * dt / angle)
    c = torch.where(small, 1.0 - a2 / 8.0, torch.cos(half))
    dq = torch.cat([c, k * w_B], dim=-1)
    return quat_normalize(quat_multiply(q, dq))


def hat(v):
    """Skew-symmetric cross-product matrix: hat(v) @ u == v x u."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return _mat3([(zero, -z, y), (z, zero, -x), (-y, x, zero)])


def vee(S):
    """Inverse of hat: v from the skew-symmetric S."""
    return torch.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], dim=-1)


def axis_angle_to_rotation(axis, angle):
    """Rodrigues' formula; axis must be unit length.  `axis` (..., 3) and
    `angle` (...) broadcast against each other."""
    K = hat(axis)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def rotation_log(R):
    """Rotation vector (axis * angle) of R (..., 3, 3): the SO(3) log, vee'd.

    Smooth near the identity (Taylor in sin^2 theta; atan2 above it), not
    valid at theta = pi.  The trace is taken over each matrix's diagonal;
    the reference's ``jnp.trace`` sums the first two axes, which is the
    diagonal for one matrix (as under vmap) but not for a batch."""
    cos_t = torch.clamp((torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0, -1.0, 1.0)
    w = vee(R - R.mT) / 2.0  # axis * sin(theta)
    s2 = torch.sum(w * w, dim=-1)
    small = s2 < 1e-12
    sin_t = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(small, 1.0 + s2 / 6.0, theta / sin_t)
    return w * scale[..., None]
