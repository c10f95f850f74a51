"""SE(3) utilities on the Euler-angle chart, as batched JAX ops.

Re-design of the reference math layer
(``/root/reference/include/utils.h:16-102``): poses are plain ``(4, 4)``
float32 arrays (or ``(..., 4, 4)`` batches) instead of ``Eigen::Isometry3f``,
and every function is jit/vmap-friendly (no Python control flow on traced
values).

The reference applies Gauss-Newton increments on the *Euler-angle* chart,
``X <- v2tEuler(dx) * X`` (``/root/reference/src/picp_solver.cpp:110``,
``/root/reference/include/utils.h:73-78``), NOT the SE(3) exponential map.
We preserve that chart exactly — it is load-bearing for trajectory parity
over 121 frames (SURVEY.md §6 gotcha 2).
"""

from __future__ import annotations

import jax.numpy as jnp

Array = jnp.ndarray


def rotation_x(angle: Array) -> Array:
    """Rotation about x. Mirrors ``RotationX`` (utils.h:16-27). Batched."""
    s, c = jnp.sin(angle), jnp.cos(angle)
    o, z = jnp.ones_like(s), jnp.zeros_like(s)
    return jnp.stack(
        [
            jnp.stack([o, z, z], -1),
            jnp.stack([z, c, -s], -1),
            jnp.stack([z, s, c], -1),
        ],
        -2,
    )


def rotation_y(angle: Array) -> Array:
    """Rotation about y. Mirrors ``RotationY`` (utils.h:31-42). Batched."""
    s, c = jnp.sin(angle), jnp.cos(angle)
    o, z = jnp.ones_like(s), jnp.zeros_like(s)
    return jnp.stack(
        [
            jnp.stack([c, z, s], -1),
            jnp.stack([z, o, z], -1),
            jnp.stack([-s, z, c], -1),
        ],
        -2,
    )


def rotation_z(angle: Array) -> Array:
    """Rotation about z. Mirrors ``RotationZ`` (utils.h:46-57). Batched."""
    s, c = jnp.sin(angle), jnp.cos(angle)
    o, z = jnp.ones_like(s), jnp.zeros_like(s)
    return jnp.stack(
        [
            jnp.stack([c, -s, z], -1),
            jnp.stack([s, c, z], -1),
            jnp.stack([z, z, o], -1),
        ],
        -2,
    )


def euler_to_rotation(angles: Array) -> Array:
    """xyz Euler angles ``(..., 3)`` -> rotation ``(..., 3, 3)``.

    ``R = Rx(a) @ Ry(b) @ Rz(c)`` exactly as ``Rotation`` (utils.h:61-67).
    """
    return rotation_x(angles[..., 0]) @ rotation_y(angles[..., 1]) @ rotation_z(angles[..., 2])


def pose_from_rt(rotation: Array, translation: Array) -> Array:
    """Assemble ``(..., 4, 4)`` rigid transforms from R ``(..., 3, 3)``, t ``(..., 3)``."""
    batch = jnp.broadcast_shapes(rotation.shape[:-2], translation.shape[:-1])
    rotation = jnp.broadcast_to(rotation, batch + (3, 3))
    translation = jnp.broadcast_to(translation, batch + (3,))
    top = jnp.concatenate([rotation, translation[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], rotation.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def v2t_euler(v: Array) -> Array:
    """6-vector ``(x y z th_x th_y th_z)`` -> ``(4, 4)`` transform.

    The Euler chart used for all GN updates. Mirrors ``v2tEuler``
    (utils.h:73-78). Batched over leading dims.
    """
    return pose_from_rt(euler_to_rotation(v[..., 3:]), v[..., :3])


def identity_pose(dtype=jnp.float32) -> Array:
    return jnp.eye(4, dtype=dtype)


def rot(pose: Array) -> Array:
    """Rotation block of a ``(..., 4, 4)`` pose."""
    return pose[..., :3, :3]


def trans(pose: Array) -> Array:
    """Translation of a ``(..., 4, 4)`` pose."""
    return pose[..., :3, 3]


def inverse(pose: Array) -> Array:
    """Closed-form rigid inverse: ``[Rᵀ | -Rᵀ t]`` (cheaper + stabler than LU)."""
    r_t = jnp.swapaxes(rot(pose), -1, -2)
    t = -(r_t @ trans(pose)[..., :, None])[..., 0]
    return pose_from_rt(r_t, t)


def transform_points(pose: Array, points: Array) -> Array:
    """Apply ``(4, 4)`` (or batched) pose to points ``(..., N, 3)``.

    Mirrors ``Isometry3f * point`` and the PointCloud transform
    (``/root/reference/include/PointCloud.h:77-82``); appearance channels are
    carried separately in this framework and never touched.
    """
    return points @ jnp.swapaxes(rot(pose), -1, -2) + trans(pose)[..., None, :]


def skew(v: Array) -> Array:
    """``(..., 3)`` -> skew-symmetric ``(..., 3, 3)``. Mirrors ``skew`` (utils.h:96-102)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([o, -z, y], -1),
            jnp.stack([z, o, -x], -1),
            jnp.stack([-y, x, o], -1),
        ],
        -2,
    )


def v2t_se2(v: Array) -> Array:
    """Planar (x, y, theta) -> (..., 4, 4) SE(3) pose acting in the z=0 plane.

    The SE(2) chart of the reference's ``est_SE2`` branch (README.md:13):
    translation (x, y, 0) and a pure z-rotation. Coincides with
    ``v2t_euler([x, y, 0, 0, 0, theta])`` — the Euler chart's z-rotation is
    exact when the other two angles vanish.
    """
    x, y, theta = v[..., 0], v[..., 1], v[..., 2]
    zeros = jnp.zeros_like(x)
    t = jnp.stack([x, y, zeros], -1)
    return pose_from_rt(rotation_z(theta), t)


def t2v_se2(pose: Array) -> Array:
    """(..., 4, 4) planar pose -> (x, y, theta). Inverse of :func:`v2t_se2`."""
    theta = jnp.arctan2(pose[..., 1, 0], pose[..., 0, 0])
    return jnp.stack([pose[..., 0, 3], pose[..., 1, 3], theta], -1)


def project_se2(pose: Array) -> Array:
    """Nearest planar pose on the chart: keep (x, y) and the yaw angle.

    Used to planarize the SE(3) two-view initialization when running the
    SE(2) estimation variant.
    """
    return v2t_se2(t2v_se2(pose))
