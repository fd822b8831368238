"""Quaternion kit for rigid-body Monte Carlo (counterpart of
metropolismontecarlo_tpu/ops/quaternions.py).

Convention: q = (w, x, y, z), scalar first, Hamilton product; functions
act on the trailing axis and broadcast over leading axes.  Every random
draw takes an explicit torch.Generator; the leading axis of its shape is
the chains (`fold` rows per chain), so under a shard context it is
chain-global (utils/shard.py) and otherwise the plain draw.  rot_to_quat
and fit_quaternions are host-side numpy (used once, by
MonteCarlo.init_from_coords).
"""

import math

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.utils.shard import (
    rand_chains,
    randn_chains,
)


def normalize(q, dim=-1):
    return q / torch.linalg.vector_norm(q, dim=dim, keepdim=True)


def quat_to_rot(q):
    """(..., 4) unit quaternions -> (..., 3, 3) with lab = R @ body."""
    w, x, y, z = q.unbind(-1)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = (
        (ww + xx - yy - zz, 2.0 * (xy - wz), 2.0 * (xz + wy)),
        (2.0 * (xy + wz), ww - xx + yy - zz, 2.0 * (yz - wx)),
        (2.0 * (xz - wy), 2.0 * (yz + wx), ww - xx - yy + zz),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotate_vectors(q, v):
    """Rotate body-frame vectors v (..., P, 3) by q (..., 4).

    An elementwise product and sum, not a matmul, so the result is full
    f32 on the card whatever the TF32 setting."""
    rot = quat_to_rot(q)
    return torch.sum(rot[..., None, :, :] * v[..., :, None, :], dim=-1)


def quat_mul(a, b):
    """Hamilton product a * b, both (..., 4)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def random_unit_vector(generator, shape=(), dtype=torch.float32):
    """Uniform random unit 3-vectors, (*shape, 3), on the generator's
    device: normalised standard Gaussians (no rejection sampling)."""
    return normalize(randn_chains(tuple(shape) + (3,), generator, dtype,
                                  generator.device))


def random_quaternion(generator, shape=(), dtype=torch.float32, fold=1):
    """Uniform random unit quaternions on S^3 (Shoemake), (*shape, 4), on
    the generator's device."""
    return shoemake_quaternion(rand_chains(
        tuple(shape) + (3,), generator, dtype, generator.device, fold))


def shoemake_quaternion(u):
    """Shoemake's uniform unit quaternion of uniforms u (..., 3) in
    [0, 1): (..., 4)."""
    u1, u2, u3 = u.unbind(-1)
    a, b = torch.sqrt(1.0 - u1), torch.sqrt(u1)
    t2, t3 = 2.0 * math.pi * u2, 2.0 * math.pi * u3
    return torch.stack(
        [a * torch.sin(t2), a * torch.cos(t2), b * torch.sin(t3),
         b * torch.cos(t3)], dim=-1)


def random_rotate_quaternion(generator, q, dphi_max):
    """q (..., 4) turned by a uniform random angle in [-dphi_max, dphi_max]
    about a uniform random axis (a symmetric proposal), renormalised."""
    shape = tuple(q.shape[:-1])
    axis = random_unit_vector(generator, shape, q.dtype)
    u = rand_chains(shape, generator, q.dtype, generator.device)
    return rotate_quaternion(q, axis, u, dphi_max)


def rotate_quaternion(q, axis, u, dphi_max):
    """random_rotate_quaternion on given draws: q (..., 4) turned by the
    angle (2 u - 1) dphi_max about the unit axis (..., 3), renormalised."""
    half = 0.5 * (2.0 * u - 1.0) * dphi_max
    rot = torch.cat([torch.cos(half)[..., None],
                     torch.sin(half)[..., None] * axis], dim=-1)
    return normalize(quat_mul(rot, q))


def rot_to_quat(r):
    """Rotation matrix (3, 3) -> unit quaternion (w, x, y, z), numpy
    (Shepperd's method)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2.0
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s]
    elif r[0, 0] >= r[1, 1] and r[0, 0] >= r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2.0
        q = [(r[2, 1] - r[1, 2]) / s, 0.25 * s, (r[0, 1] + r[1, 0]) / s,
             (r[0, 2] + r[2, 0]) / s]
    elif r[1, 1] >= r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2.0
        q = [(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s, 0.25 * s,
             (r[1, 2] + r[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2.0
        q = [(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
             (r[1, 2] + r[2, 1]) / s, 0.25 * s]
    q = np.array(q)
    return q / np.linalg.norm(q)


def fit_quaternions(body, rel_coords):
    """Per-molecule quaternions from COM-relative coordinates (numpy).

    body (M, P, 3) templates, rel_coords (M, P, 3).  Kabsch fit: the
    returned q satisfies rel ~= R(q) @ body, exactly for rigid copies."""
    quats = np.zeros((body.shape[0], 4))
    for m in range(body.shape[0]):
        h = body[m].T @ rel_coords[m]
        u, _, vt = np.linalg.svd(h)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        quats[m] = rot_to_quat(vt.T @ np.diag([1.0, 1.0, d]) @ u.T)
    return quats


def center_of_mass(coords, masses):
    """Mass-weighted centre: coords (..., P, 3), masses broadcastable to
    (..., P); tensors or numpy arrays (numpy in, numpy out)."""
    if not isinstance(coords, torch.Tensor):
        m = np.broadcast_to(np.asarray(masses, np.float64),
                            np.shape(coords)[:-1])
        return (np.asarray(coords) * m[..., None]).sum(-2) \
            / m.sum(-1)[..., None]
    m = torch.broadcast_to(torch.as_tensor(masses, dtype=coords.dtype,
                                           device=coords.device),
                           coords.shape[:-1])
    return torch.sum(coords * m[..., None], dim=-2) \
        / torch.sum(m, dim=-1)[..., None]


def body_frame_from_template(coords, masses):
    """A molecule template (P, 3) shifted so that its centre of mass is
    the origin (the reference's BodyFixed + Shift_COM_to_Zero!)."""
    return coords - center_of_mass(coords, masses)[..., None, :]
