"""Synthetic dataset generator in the reference on-disk format.

The reference ships one example dataset (``example_data/data``,
SURVEY.md §2) but no generator. This module writes a full synthetic dataset
— ``meas-XXXXX.dat``, ``world.dat``, ``camera.dat``, ``trajectory.dat`` —
byte-compatible with the readers in ``utils/io.py`` AND with the reference
C++ parsers (files_utils.cpp:19-134), so both frameworks can consume it.

The robot drives a planar arc (SE(2) ground truth, matching the
trajectory.dat convention of x, y, theta columns) while the camera looks
out of the robot through the standard cam-in-robot transform; landmarks
carry unique random appearance vectors observed verbatim (the exact-
equality identity invariant, SURVEY.md §6 gotcha 4).

:func:`generate_reference_shaped` reproduces the shape of the reference's
example dataset (121 frames, 1000 landmarks, at most 115 measurements per
frame, 10-dim appearances, the same camera): the workload the tests, the
chip smoke run and the benchmark use, made from a seed. Its ground truth is
the generator's own, so accuracy is checked against that.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from .io import PAD_APPEARANCE

CAM_IN_ROBOT = np.array(
    [[0, 0, 1, 0.2], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32
)
K = np.array([[180.0, 0.0, 320.0], [0.0, 180.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
Z_NEAR, Z_FAR, WIDTH, HEIGHT = 0.0, 5.0, 640, 480


class Simulation(NamedTuple):
    """A simulated drive: the map, the ground truth and every frame's view."""

    world: np.ndarray        # (L, 3) landmark positions
    appearances: np.ndarray  # (L, 10) landmark descriptors
    gt: np.ndarray           # (F, 3) robot x, y, theta
    odom: np.ndarray         # (F, 3) noisy odometry
    uv: np.ndarray           # (F, L, 2) projections
    visible: np.ndarray      # (F, L) bool measured in that frame


def simulate(
    num_frames: int = 60,
    num_landmarks: int = 500,
    seed: int = 0,
    odom_noise: float = 0.002,
    arc_rate: float = 0.02,
    step: float = 0.15,
    extent: "float | None" = None,
    max_visible: "int | None" = None,
) -> Simulation:
    """Simulate a planar drive along an arc through a landmark field.

    Landmarks fill a box around the start of the arc, or with ``extent`` a
    square of that half-width (metres) centred on the arc's circle, with
    heights in [-2, 2]. ``max_visible`` keeps only the nearest that many
    landmarks of each frame (the reference's per-frame measurement count
    is bounded the same way). Projection is numpy float32 with the
    semantics of ``ops.camera.project_points``, so a seed gives the same
    data on every machine."""
    rng = np.random.default_rng(seed)
    if extent is None:
        lo, hi = (-2.0, -6.0, 0.2), (12.0, 6.0, 2.0)
    else:
        cy = step / arc_rate
        lo, hi = (-extent, cy - extent, -2.0), (extent, cy + extent, 2.0)
    world = rng.uniform(lo, hi, (num_landmarks, 3)).astype(np.float32)
    appearances = rng.uniform(-1.0, 1.0, (num_landmarks, 10)).astype(np.float32)

    # Planar ground-truth trajectory + noisy odometry.
    gt = np.zeros((num_frames, 3), np.float32)   # x, y, theta
    odom = np.zeros((num_frames, 3), np.float32)
    x = y = th = 0.0
    for i in range(1, num_frames):
        th += arc_rate
        x += step * np.cos(th)
        y += step * np.sin(th)
        gt[i] = (x, y, th)
        odom[i] = gt[i] + rng.normal(0, odom_noise, 3)

    c, s = np.cos(gt[:, 2]), np.sin(gt[:, 2])
    robot = np.zeros((num_frames, 4, 4), np.float32)
    robot[:, 0, 0], robot[:, 0, 1], robot[:, 0, 3] = c, -s, gt[:, 0]
    robot[:, 1, 0], robot[:, 1, 1], robot[:, 1, 3] = s, c, gt[:, 1]
    robot[:, 2, 2] = robot[:, 3, 3] = 1.0
    world_in_cam = (np.linalg.inv(CAM_IN_ROBOT) @ np.linalg.inv(robot)).astype(np.float32)
    p_cam = np.einsum("fij,lj->fli", world_in_cam[:, :3, :3], world) + world_in_cam[:, None, :3, 3]
    z = p_cam[..., 2]
    p_hom = p_cam @ K.T
    safe = np.where(p_hom[..., 2] == 0.0, np.float32(1.0), p_hom[..., 2])
    uv = (p_hom[..., :2] / safe[..., None]).astype(np.float32)
    visible = (
        (z <= Z_FAR) & (z >= Z_NEAR)
        & (uv[..., 0] >= 0.0) & (uv[..., 0] <= WIDTH - 1.0)
        & (uv[..., 1] >= 0.0) & (uv[..., 1] <= HEIGHT - 1.0)
    )
    if max_visible is not None:
        for i in range(num_frames):
            if visible[i].sum() > max_visible:
                order = np.argsort(np.where(visible[i], z[i], np.inf), kind="stable")
                visible[i] = False
                visible[i, order[:max_visible]] = True
    return Simulation(world, appearances, gt, odom, uv, visible)


def padded_sequence(sim: Simulation, n_slots: int):
    """The frames as padded device-ready arrays, the layout
    ``utils.io.load_sequence`` produces from the written files:
    (points (F, S, 2), appearances (F, S, 10), mask (F, S)). Frames list
    their landmarks in id order."""
    f = sim.uv.shape[0]
    points = np.full((f, n_slots, 2), -1.0, np.float32)
    apps = np.full((f, n_slots, sim.appearances.shape[1]), PAD_APPEARANCE, np.float32)
    mask = np.zeros((f, n_slots), bool)
    for i in range(f):
        ids = np.nonzero(sim.visible[i])[0][:n_slots]
        points[i, :len(ids)] = sim.uv[i, ids]
        apps[i, :len(ids)] = sim.appearances[ids]
        mask[i, :len(ids)] = True
    return points, apps, mask


def write_dataset(out_dir: str, sim: Simulation) -> None:
    """Write ``sim`` in the reference's file format."""
    os.makedirs(out_dir, exist_ok=True)
    world, appearances, gt, odom = sim.world, sim.appearances, sim.gt, sim.odom
    with open(os.path.join(out_dir, "world.dat"), "w") as f:
        for i in range(world.shape[0]):
            vals = " ".join(f"{v:g}" for v in [*world[i], *appearances[i]])
            f.write(f"{i} {vals}\n")

    with open(os.path.join(out_dir, "camera.dat"), "w") as f:
        f.write("camera matrix:\n")
        for r in range(3):
            f.write(" ".join(f"{v:g}" for v in K[r]) + "\n")
        f.write("cam_transform:\n")
        for r in range(4):
            f.write(" ".join(f"{v:g}" for v in CAM_IN_ROBOT[r]) + "\n")
        f.write(f"z_near: {Z_NEAR:g}\nz_far:  {Z_FAR:g}\n"
                f"width:  {WIDTH}\nheight: {HEIGHT}\n")

    with open(os.path.join(out_dir, "trajectory.dat"), "w") as f:
        for i in range(gt.shape[0]):
            f.write(
                f"{i} {odom[i,0]:g} {odom[i,1]:g} {odom[i,2]:g} "
                f"{gt[i,0]:g} {gt[i,1]:g} {gt[i,2]:g}\n"
            )

    for i in range(gt.shape[0]):
        with open(os.path.join(out_dir, f"meas-{i:05d}.dat"), "w") as f:
            f.write(f"seq: {i}\n")
            f.write(f"gt_pose: {gt[i,0]:g} {gt[i,1]:g} {gt[i,2]:g}\n")
            f.write(f"odom_pose: {odom[i,0]:g} {odom[i,1]:g} {odom[i,2]:g}\n")
            for n, j in enumerate(np.nonzero(sim.visible[i])[0]):
                vals = " ".join(
                    f"{v:g}" for v in [sim.uv[i, j, 0], sim.uv[i, j, 1], *appearances[j]]
                )
                f.write(f"point {n} {j} {vals}\n")


def generate_dataset(out_dir: str, *args, **kwargs) -> None:
    """Write a complete synthetic dataset to ``out_dir`` (arguments as
    :func:`simulate`)."""
    write_dataset(out_dir, simulate(*args, **kwargs))


REFERENCE_SHAPE = dict(
    num_frames=121, num_landmarks=1000, arc_rate=2.0 * np.pi / 121,
    step=0.47, extent=10.0, max_visible=115,
)
# Production slot count: the same drive and camera, 16x the landmarks, so
# 900-1024 of them are measured per frame (padded to 1024 slots), and four
# laps (512 frames).
PRODUCTION_SLOTS = 1024
PRODUCTION_SHAPE = dict(REFERENCE_SHAPE, num_frames=512, num_landmarks=16000,
                        max_visible=PRODUCTION_SLOTS)


def generate_reference_shaped(out_dir: str, seed: int = 0) -> None:
    """The reference example dataset's shape: 121 frames, 1000 landmarks
    in a 20 x 20 x 4 m box, at most 115 measurements per frame (padded to
    128 slots), 10-dim appearances, the reference camera, and one lap of
    a circle of radius ~9 m at ~0.47 m per frame (the reference's
    published monocular scale is 0.47337)."""
    generate_dataset(out_dir, seed=seed, **REFERENCE_SHAPE)


def main(argv: Optional[list] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--landmarks", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reference-shaped", action="store_true",
                   help="121 frames x 1000 landmarks, <= 115 per frame")
    a = p.parse_args(argv)
    if a.reference_shaped:
        generate_reference_shaped(a.out_dir, a.seed)
    else:
        generate_dataset(a.out_dir, a.frames, a.landmarks, a.seed)
    print(f"wrote synthetic dataset to {a.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
