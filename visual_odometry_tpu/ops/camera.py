"""Pinhole camera as a JAX pytree with fully-vectorized masked projection.

Re-design of the reference ``Camera`` class
(``/root/reference/include/camera.h:12-63``,
``/root/reference/src/camera.cpp:16-37``): instead of a mutable object with a
per-point bool-returning ``projectPoint``, the camera is an immutable
NamedTuple of arrays and projection is a single batched op returning
``(image_points, valid_mask)``. Invalid points keep the reference's
``(-1, -1)`` sentinel so downstream file dumps match.

Validity semantics replicate camera.h:25-37 exactly:
  * depth test:   ``z_near <= z_cam <= z_far``   (strictly outside fails)
  * bounds test:  ``0 <= u <= cols-1`` and ``0 <= v <= rows-1``
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from . import se3

Array = jnp.ndarray


class Camera(NamedTuple):
    """Pinhole camera state (all leaves are arrays => valid jit pytree).

    Fields mirror the reference members (camera.h:56-62): ``world_in_camera``
    is the pose mapping world coords into the camera frame.
    """

    camera_matrix: Array        # (3, 3) intrinsics K
    world_in_camera: Array      # (4, 4) extrinsics
    rows: Array                 # () image height in pixels
    cols: Array                 # () image width in pixels
    z_near: Array               # ()
    z_far: Array                # ()

    @classmethod
    def create(
        cls,
        camera_matrix,
        world_in_camera=None,
        rows: int = 100,
        cols: int = 100,
        z_near: float = 0.0,
        z_far: float = 10.0,
    ) -> "Camera":
        """Defaults mirror the reference ctor (camera.h:17-23)."""
        if world_in_camera is None:
            world_in_camera = jnp.eye(4, dtype=jnp.float32)
        return cls(
            camera_matrix=jnp.asarray(camera_matrix, jnp.float32),
            world_in_camera=jnp.asarray(world_in_camera, jnp.float32),
            rows=jnp.asarray(rows, jnp.float32),
            cols=jnp.asarray(cols, jnp.float32),
            z_near=jnp.asarray(z_near, jnp.float32),
            z_far=jnp.asarray(z_far, jnp.float32),
        )

    def with_pose(self, world_in_camera: Array) -> "Camera":
        """Functional ``setWorldInCameraPose`` (camera.h:50)."""
        return self._replace(world_in_camera=world_in_camera)


def project_points(camera: Camera, world_points: Array) -> Tuple[Array, Array]:
    """Project ``(..., N, 3)`` world points -> ``((..., N, 2), (..., N) bool)``.

    Replaces the scalar loop of ``Camera::projectPoints``
    (camera.cpp:16-37, keep_indices=True mode): one fused matmul + compares on
    all points at once instead of N branchy calls. Invalid points are ``(-1, -1)``.
    """
    p_cam = se3.transform_points(camera.world_in_camera, world_points)
    z = p_cam[..., 2]
    depth_ok = (z <= camera.z_far) & (z >= camera.z_near)
    p_hom = p_cam @ camera.camera_matrix.T
    # Guard the divide; masked-out lanes never reach downstream consumers.
    safe_z = jnp.where(p_hom[..., 2] == 0.0, 1.0, p_hom[..., 2])
    uv = p_hom[..., :2] / safe_z[..., None]
    in_img = (
        (uv[..., 0] >= 0.0)
        & (uv[..., 0] <= camera.cols - 1.0)
        & (uv[..., 1] >= 0.0)
        & (uv[..., 1] <= camera.rows - 1.0)
    )
    valid = depth_ok & in_img
    uv = jnp.where(valid[..., None], uv, -1.0)
    return uv, valid
