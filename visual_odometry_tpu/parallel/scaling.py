"""1->N scaling-efficiency measurement (frames/s from 1 device to N).

The reference is single-threaded; nothing there scales. This framework's
scaling axes (SURVEY.md §5) are measured here on a device mesh:

  * ``dp`` — the data-parallel multi-sequence tracker
    (parallel/multiseq): a FIXED total batch of independent sequences
    sharded over 1, 2, 4, ... devices (strong scaling; zero collectives —
    sequences are independent, so ideal hardware scaling is linear).
  * ``sp`` — the sequence-parallel chunked tracker
    (parallel/posegraph): ONE fixed sequence split into n chunks sharded
    over n devices (the VO analogue of context parallelism; one tiny
    pose-stream all-gather at the stitch).

Measurement honesty on a VIRTUAL mesh: the tests validate multi-device
behavior with ``xla_force_host_platform_device_count`` CPU devices, which
ALL SHARE the host's physical cores. Wall-clock speedup from sharding is
therefore capped by the core count no matter how well the design scales —
on real cards every mesh element owns its own silicon and the cap does not
exist. Each row therefore reports two complementary things:

  * Wall clock, fixed TOTAL work (strong scaling): ``speedup`` =
    T(1)/T(n) and ``efficiency`` = T(1)/(n*T(n)). On this host speedup
    saturates near the core count; > 1.0 at n=2 already demonstrates the
    sharded program runs with no serialization against itself.
  * ``flops_per_device`` — XLA's compiled per-device FLOP count, and
    ``partition_efficiency`` = (flops(1)/n) / flops(n): 1.0 means the
    compiled SPMD program gives every device EXACTLY total/n of the
    tracking work — no duplication, no replication. This is the
    compile-time guarantee that transfers to real cards: per-card work
    falls as 1/n and the only cross-device traffic is dp = none (the
    sequences are independent) / sp = one O(frames x 16 float) pose-
    stream gather at the stitch. Projected real-hardware scaling
    efficiency is partition_efficiency x (1 - collective_fraction),
    which for the dp tracker is partition_efficiency itself.
"""

from __future__ import annotations

import functools
import os
import time
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import pipeline
from ..utils import synthetic
from ..utils.config import VOConfig

Array = jnp.ndarray


def _host_cores() -> int:
    return os.cpu_count() or 1


def _dp_batch(seqs_total: int, frames: int, n_slots: int):
    pts, apps, masks = [], [], []
    for s in range(seqs_total):
        rng = np.random.default_rng(1000 + s)
        p, a, m = synthetic.generate_tracking_sequence(rng, frames, n_slots)
        pts.append(p)
        apps.append(a)
        masks.append(m)
    return np.stack(pts), np.stack(apps), np.stack(masks)


def _time_best(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def measure_dp_scaling(
    devices: Sequence[jax.Device],
    ns: Sequence[int],
    seqs_total: int = 8,
    frames: int = 24,
    n_slots: int = 256,
    gn_iterations: int = 100,
    reps: int = 3,
) -> List[dict]:
    """Strong-scaling rows for the dp multi-sequence tracker."""
    config = VOConfig(
        n_slots=n_slots, map_capacity=2 * n_slots, gn_iterations=gn_iterations
    )
    # Deep-frustum tracking camera: the monocular rescale puts synthetic
    # triangulations past z_far=5 and tracking degenerates to zero-inlier
    # no-ops (see synthetic.deep_camera) — the partition measurement must
    # run REAL tracking work.
    camera = synthetic.deep_camera()
    pts, apps, masks = _dp_batch(seqs_total, frames, n_slots)
    ids = np.full(masks.shape, -1, np.int32)

    @functools.partial(jax.jit, static_argnames=())
    def run(p, a, m, i):
        def one(pp, aa, mm, ii):
            return pipeline._run(camera, config, pp, aa, mm, ii, False)

        return jax.vmap(one)(p, a, m, i)[0]  # trajectories only

    rows = []
    t1 = None
    for n in ns:
        if seqs_total % n:
            continue
        mesh = Mesh(np.asarray(devices[:n]), ("dp",))
        spec = NamedSharding(mesh, P("dp"))
        args = tuple(
            jax.block_until_ready(jax.device_put(x, spec))
            for x in (pts, apps, masks, ids)
        )
        compiled = run.lower(*args).compile()
        flops = float(compiled.cost_analysis().get("flops", 0.0))
        jax.block_until_ready(compiled(*args))  # warm
        t = _time_best(lambda: compiled(*args), reps)
        if t1 is None:
            t1 = t
            flops1 = flops
        rows.append(
            _row("scaling_dp", n, t, t1, seqs_total * frames, flops, flops1)
        )
    return rows


def measure_sp_scaling(
    devices: Sequence[jax.Device],
    ns: Sequence[int],
    frames: int = 64,
    n_slots: int = 64,
    overlap: int = 6,
    gn_iterations: int = 50,
    reps: int = 3,
) -> List[dict]:
    """Strong-scaling rows for the chunked (sequence-parallel) tracker."""
    from . import posegraph

    config = VOConfig(
        n_slots=n_slots, map_capacity=2 * n_slots, gn_iterations=gn_iterations
    )
    # Deep-frustum tracking camera: the monocular rescale puts synthetic
    # triangulations past z_far=5 and tracking degenerates to zero-inlier
    # no-ops (see synthetic.deep_camera) — the partition measurement must
    # run REAL tracking work.
    camera = synthetic.deep_camera()
    rng = np.random.default_rng(7)
    pts, apps, masks = synthetic.generate_tracking_sequence(rng, frames, n_slots)
    pts, apps, masks = (jnp.asarray(x) for x in (pts, apps, masks))
    ids = jnp.full(masks.shape, -1, jnp.int32)

    rows = []
    t1 = None
    flops1 = None
    for n in ns:
        mesh = Mesh(np.asarray(devices[:n]), ("dp",)) if n > 1 else None

        # Per-device compiled FLOPs of the tracking+stitch program. For the
        # chunked runner partition_efficiency is honestly < 1: every chunk
        # re-tracks its ``overlap`` shared frames (bounded redundancy
        # (F/n + overlap) / (F/n), NOT duplication of the whole sequence).
        if n == 1:
            compiled = pipeline._run.lower(
                camera, config, pts, apps, masks, ids, False
            ).compile()
        else:
            try:
                starts, chunk_len = posegraph.plan_chunks(frames, n, overlap, None, 0)
            except ValueError:
                continue  # sequence too short for this chunk count
            spec = NamedSharding(mesh, P("dp"))
            cargs = tuple(
                jax.device_put(posegraph._chunk(x, starts, chunk_len), spec)
                for x in (pts, apps, masks, ids)
            )
            compiled = posegraph._track_and_stitch.lower(
                camera, config, *cargs, starts, chunk_len, frames, False
            ).compile()
        flops = float(compiled.cost_analysis().get("flops", 0.0))

        def call():
            return posegraph.run_sequence_chunked(
                camera, config, pts, apps, masks,
                num_chunks=n, overlap=overlap, slack=0,
                mesh=mesh, sp_axis="dp",
            )[0]

        try:
            jax.block_until_ready(call())  # compile + warm
        except posegraph.StitchError:
            # This (frames, n, overlap) point cannot stitch reliably (a
            # boundary with zero scale observations) — an honest skip, not
            # a measurement.
            continue
        t = _time_best(call, reps)
        if t1 is None:
            t1 = t
            flops1 = flops
        rows.append(_row("scaling_sp", n, t, t1, frames, flops, flops1))
    return rows


def measure_lm_scaling(
    devices: Sequence[jax.Device],
    ns: Sequence[int],
    frames: int = 48,
    num_landmarks: int = 4096,
    obs_per_lm: int = 6,
    cg_iterations: int = 16,
    reps: int = 2,
) -> List[dict]:
    """Strong-scaling rows for the landmark-sharded sparse Schur-CG BA.

    One fixed corridor problem (utils/synthetic.generate_ba_corridor);
    landmarks + their observations shard over an ``lm`` mesh axis of size
    n (parallel/sparse_ba.make_sharded_sparse_ba_step). Per-device FLOP
    partition is the transferable evidence (module docstring): landmarks
    partition exactly, the only replicated work is the O(F) pose-space CG
    vector algebra and the only collectives are O(F) psums per matvec —
    partition_efficiency stays near 1 while N >> F * cg_iterations.
    """
    from ..utils import synthetic as syn
    from . import sparse_ba as sba

    k, problem, _ = syn.generate_ba_corridor(
        f=frames, l=num_landmarks, obs_per_lm=obs_per_lm, seed=3
    )
    kj = jnp.asarray(k, jnp.float32)
    fi = np.asarray(problem.frame_idx)
    li = np.asarray(problem.lm_idx)
    uv = np.asarray(problem.uv)
    mask = np.asarray(problem.obs_mask)

    rows = []
    t1 = None
    flops1 = None
    for n in ns:
        mesh = Mesh(np.asarray(devices[:n]), ("lm",))
        fi_s, li_s, uv_s, mask_s, l_per = sba.partition_observations(
            n, num_landmarks, fi, li, uv, mask
        )
        lms = np.zeros((n * l_per, 3), np.float32)
        lms[:num_landmarks] = np.asarray(problem.landmarks)
        sp = sba.SparseBAProblem(
            poses=problem.poses,
            landmarks=jnp.asarray(lms),
            frame_idx=jnp.asarray(fi_s),
            lm_idx=jnp.asarray(li_s),
            uv=jnp.asarray(uv_s),
            obs_mask=jnp.asarray(mask_s),
        )
        step = sba.make_sharded_sparse_ba_step(
            mesh, damping=0.1, cg_iterations=cg_iterations
        )
        compiled = step.lower(kj, sp).compile()
        flops = float(compiled.cost_analysis().get("flops", 0.0))
        jax.block_until_ready(compiled(kj, sp))  # warm
        t = _time_best(lambda: compiled(kj, sp)[0].poses, reps)
        if t1 is None:
            t1 = t
            flops1 = flops
        rows.append(
            _row("scaling_lm_sparse_ba", n, t, t1, frames, flops, flops1)
        )
    return rows


def _row(metric, n, t, t1, total_frames, flops, flops1):
    row = {
        "metric": metric,
        "n_devices": n,
        "wall_ms": round(t * 1e3, 2),
        "fps": round(total_frames / t, 1),
        "speedup": round(t1 / t, 3),
        "efficiency": round(t1 / (n * t), 3),
        "host_cores": _host_cores(),
    }
    if flops is not None and flops1:
        row["flops_per_device"] = flops
        # 1.0 = per-device work is exactly total/n: no duplicated tracking.
        row["partition_efficiency"] = round((flops1 / n) / flops, 3)
    return row


def measure_scaling(
    devices: Optional[Sequence[jax.Device]] = None,
    ns: Optional[Sequence[int]] = None,
    reps: int = 3,
    **kw,
) -> List[dict]:
    """All scaling rows (dp + sp) for the given devices; see module doc."""
    if devices is None:
        devices = jax.devices()
    if ns is None:
        ns = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    dp_kw = {k: v for k, v in kw.items() if k in (
        "seqs_total", "frames", "n_slots", "gn_iterations")}
    sp_kw = {k: v for k, v in kw.items() if k in (
        "frames", "n_slots", "overlap", "gn_iterations")}
    return (
        measure_dp_scaling(devices, ns, reps=reps, **dp_kw)
        + measure_sp_scaling(devices, ns, reps=reps, **sp_kw)
    )
