"""Smoke run of the main path on one GPU, checked against plain references.

    python chip_smoke.py          one GPU: every phase below
    python chip_smoke.py --four   four GPUs of one host: only the sharded
                                  paths and their single-device solvers

Phases (one process; the CPU reference runs on ``jax.devices("cpu")``):

  kernels   the RANSAC scorer, the brute-force NN and the voxel-hash NN
            at production widths against float64 numpy / scipy oracles;
  cuboid    the cuboid pipeline on 640x480 D435 frames at batch 1 and 8
            against ground truth and against the same frames and keys
            run on the CPU;
  backend   bundle adjustment of one SLAM-sized window, with and without
            depth rows, against ground truth and the CPU run;
  slam      keyframe SLAM with BA + loop closure, and map mode at 32k, on
            a 640x480 revisit sweep: ATE against ground truth, and a
            trajectory prefix against the CPU run of the same frames;
  tracking  streaming multi-cuboid tracking: median error, latched share.

Every check prints its value beside its tolerance and the reason for it.
The last line of standard output is one JSON object naming the device,
printed only when every phase passed. Without a GPU, or when a phase
fails, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Box symmetry group (identity + 180-degree turns about each axis): a
# cuboid's pose is defined only up to these.
_BOX_SYM = [np.diag(d) for d in ([1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1])]


class Checks:
    """Collects named checks; a failed check fails its phase."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failed = []

    def __call__(self, name: str, ok: bool, detail: str) -> None:
        print(f"[{self.phase}] {'ok  ' if ok else 'FAIL'} {name}: {detail}", flush=True)
        if not ok:
            self.failed.append(name)


def rot_deg(Ra, Rb, symmetric: bool = False) -> float:
    """Angle between two rotations (deg), optionally modulo box symmetry."""
    syms = _BOX_SYM if symmetric else _BOX_SYM[:1]
    Ra, Rb = np.asarray(Ra, np.float64), np.asarray(Rb, np.float64)
    # 2 asin(|M - I|_F / sqrt(8)) stays accurate near 0, where the
    # arccos of the trace loses half the digits.
    return min(
        float(np.degrees(2.0 * np.arcsin(min(
            np.linalg.norm(Ra.T @ Rb @ S - np.eye(3)) / np.sqrt(8.0), 1.0))))
        for S in syms)


# ---------------------------------------------------------------- kernels

def room_clouds(n_frames: int = 2, width: int = 640, height: int = 480, seed: int = 0):
    """World-frame point clouds of full 640x480 frames of the SLAM room
    scene (coordinates 1-3 m, planar surfaces, 1 mm depth noise)."""
    from benchmarks.slam_scene import render_textured_room, sweep_trajectory
    from perception.geometry.camera import PinholeCamera

    fx = 307.0 * width / 320.0
    cam = PinholeCamera.from_K([fx, 0, width / 2, 0, fx, height / 2, 0, 0, 1],
                               width=width, height=height)
    vv, uu = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    rays = np.stack([(uu - width / 2) / fx, (vv - height / 2) / fx, np.ones_like(uu, float)], -1)
    clouds = []
    for i, T in enumerate(sweep_trajectory(n=40)[: n_frames * 7: 7]):
        _, depth = render_textured_room(cam, T, seed=seed + i)
        pc = (rays * depth[..., None]).reshape(-1, 3)
        T = np.asarray(T, np.float64)
        clouds.append((pc @ T[:3, :3].T + T[:3, 3]).astype(np.float32))
    return clouds


def check_ransac(ck: Checks, dev, n: int = 8192, k: int = 1024) -> None:
    import jax
    import jax.numpy as jnp

    from perception.ops import ransac as R

    tau, margin = 0.015, 1e-4
    rng = np.random.RandomState(1)
    normals = rng.randn(k, 3)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    d = rng.uniform(-2.0, 2.0, k)
    base = rng.uniform(-2.5, 2.5, (n, 3)) + np.array([0.0, 0.0, 2.5])
    base -= (base @ normals[0] + d[0])[:, None] * normals[0]
    offs = np.array([tau - margin, tau + margin, -tau + margin, -tau - margin])
    pts = base + offs[np.arange(n) % 4][:, None] * normals[0]
    mask = rng.rand(n) > 0.1
    pts, normals, d = (x.astype(np.float32) for x in (pts, normals, d))
    args = [jax.device_put(jnp.asarray(x), dev) for x in (pts, mask, normals, d)]
    got = np.asarray(jax.jit(R._score)(*args, tau))
    dist = np.abs(pts.astype(np.float64) @ normals.T.astype(np.float64) + d[None, :])
    want = ((dist <= tau) & mask[:, None]).sum(0)
    near = (mask[:, None] & (np.abs(dist - tau) < 2e-6)).sum(0)
    clear = near == 0
    exact = bool(np.array_equal(got[clear], want[clear]))
    bounded = bool(np.all(np.abs(got - want) <= near))
    ck(f"ransac scorer N={n} K={k} vs numpy f64", exact and bounded,
       f"exact on {clear.sum()}/{k} hypotheses with no point within 2e-6 m of "
       f"+-tau; elsewhere |diff| {int(np.abs(got - want).max())} <= points "
       f"within 2e-6 m of tau (tolerance: counts may flip only for points "
       f"within f32 rounding of tau; precision: elementwise f32 FMAs, no dot)")


def check_nn(ck: Checks, dev, clouds, shapes=((4096, 8192), (2048, 32768), (4096, 32768))):
    import jax
    import jax.numpy as jnp
    from scipy.spatial import cKDTree

    from perception.ops.nn import nearest_neighbor

    rng = np.random.RandomState(2)
    ref_all, q_all = clouds[0], clouds[1]
    nn = jax.jit(nearest_neighbor)
    # f32 rounding of |q|^2 - 2 q.r + |r|^2 at |p| <= 4 m is a few ulp of
    # 32 m^2 (ulp 3.8e-6), so a winner is decided only when the f64
    # runner-up is farther by more than this margin.
    margin = 3e-5
    for nq, m in shapes:
        ref = ref_all[rng.choice(len(ref_all), m, replace=False)]
        q = q_all[rng.choice(len(q_all), nq, replace=False)]
        idx, d2 = nn(jax.device_put(jnp.asarray(q), dev),
                     jax.device_put(jnp.asarray(ref), dev),
                     jax.device_put(jnp.ones(m, bool), dev))
        idx, d2 = np.asarray(idx), np.asarray(d2)
        dd, ii = cKDTree(ref.astype(np.float64)).query(q.astype(np.float64), k=2)
        gap = dd[:, 1] ** 2 - dd[:, 0] ** 2
        clear = gap > margin
        agree = float((idx[clear] == ii[clear, 0]).mean())
        d2_err = float(np.abs(d2 - dd[:, 0] ** 2).max())
        ck(f"brute NN {nq}x{m} vs cKDTree f64",
           agree == 1.0 and d2_err <= margin and clear.mean() > 0.5,
           f"index agreement {agree:.4f} on {clear.sum()}/{nq} queries whose "
           f"runner-up is > {margin} m^2 farther (required 1.0); max |d2 err| "
           f"{d2_err:.2e} <= {margin} m^2 (precision: f32 matmul at HIGHEST)")


def check_voxelhash(ck: Checks, dev, clouds, nq: int = 307200, m: int = 32768):
    import jax
    import jax.numpy as jnp
    from scipy.spatial import cKDTree

    from perception.ops import voxelhash

    rng = np.random.RandomState(3)
    radius = 0.06
    ref = clouds[0][rng.choice(len(clouds[0]), m, replace=False)]
    q = clouds[1][:nq]
    vh = voxelhash.build(jax.device_put(jnp.asarray(ref), dev),
                         jax.device_put(jnp.ones(m, bool), dev), radius)
    idx, d2 = voxelhash.query(vh, jax.device_put(jnp.asarray(q), dev))
    orig = np.asarray(vh.order)[np.asarray(idx)]
    d2 = np.asarray(d2)
    dd, ii = cKDTree(ref.astype(np.float64)).query(q.astype(np.float64), k=2)
    # Contract: exact NN wherever the true NN lies within the radius.
    # d2 is the direct (q-p)^2 in f32, exact to ~1e-7 relative.
    margin = 1e-6
    inside = dd[:, 0] <= radius * 0.999
    clear = inside & (dd[:, 1] ** 2 - dd[:, 0] ** 2 > margin)
    agree = float((orig[clear] == ii[clear, 0]).mean())
    d2_err = float(np.abs(d2[inside] - dd[inside, 0] ** 2).max())
    ck(f"voxel-hash NN {nq}x{m} vs cKDTree f64",
       agree == 1.0 and d2_err <= margin and clear.mean() > 0.5,
       f"index agreement {agree:.4f} on {clear.sum()}/{nq} queries with the "
       f"true NN inside r={radius} m and runner-up > {margin} m^2 farther "
       f"(required 1.0); max |d2 err| {d2_err:.2e} <= {margin} m^2 "
       f"(precision: elementwise f32 (q-p)^2, no dot)")


def phase_kernels(gpu, cpu) -> list:
    ck = Checks("kernels")
    clouds = room_clouds()
    check_ransac(ck, gpu)
    check_nn(ck, gpu, clouds)
    check_voxelhash(ck, gpu, clouds)
    return ck.failed


# ----------------------------------------------------------------- cuboid

def cuboid_frames(n: int = 8):
    from benchmarks.scene import render_depth_tabletop
    from perception.geometry import se3
    from perception.geometry.camera import PinholeCamera

    import jax.numpy as jnp

    camera = PinholeCamera.d435_depth()
    twists = [(0.05, 0.03, 0.80, 0.0, 0.0, 0.3 + 0.05 * s) for s in range(n)]
    depths = np.stack([render_depth_tabletop(camera, cuboid_pose_twist=tw, seed=s)
                       for s, tw in enumerate(twists)])
    gts = [np.asarray(se3.se3_exp(jnp.asarray(tw, jnp.float32)), np.float64) for tw in twists]
    return camera, depths, gts


def phase_cuboid(gpu, cpu, n: int = 8) -> list:
    import jax
    import jax.numpy as jnp

    from benchmarks.scene import benchmark_template
    from perception.models.cuboid import (
        CuboidConfig,
        cuboid_pipeline_batch,
        cuboid_pipeline_from_depth,
        template_features,
    )

    ck = Checks("cuboid")
    camera, depths, gts = cuboid_frames(n)
    config = CuboidConfig()
    t = benchmark_template()
    tmpl = template_features(t, np.ones(len(t), bool), config)
    keys = jax.random.split(jax.random.key(0), n)

    def single(d, k, tp, tn, tm):
        return cuboid_pipeline_from_depth(d, camera, tp, tm, k, config, template_normals=tn)

    def batch(ds, ks, tp, tn, tm):
        return cuboid_pipeline_batch(ds, camera, tp, tm, ks, config, template_normals=tn)

    def run(dev):
        put = lambda x: jax.device_put(x, dev)
        tp, tn, tm = (put(x) for x in tmpl)
        f1, f8 = jax.jit(single), jax.jit(batch)
        b1 = [f1(put(jnp.asarray(depths[i])), put(keys[i]), tp, tn, tm) for i in range(n)]
        b8 = f8(put(jnp.asarray(depths)), put(keys), tp, tn, tm)
        to_np = lambda r: jax.tree_util.tree_map(np.asarray, r)
        return [to_np(r) for r in b1], to_np(b8)

    g1, g8 = run(gpu)
    c1, c8 = run(cpu)

    # Ground truth. The cuboid template maps into the camera frame by
    # the result pose; the box is symmetric under 180-degree turns.
    t_err = np.array([np.linalg.norm(r.pose[:3, 3] - gt[:3, 3]) for r, gt in zip(g1, gts)]) * 1e3
    r_err = np.array([rot_deg(r.pose[:3, :3], gt[:3, :3], symmetric=True) for r, gt in zip(g1, gts)])
    acc = [bool(r.accepted) for r in g1]
    # Known defect (ROADMAP): the camera looks straight down on the 3 cm
    # thin box, so nearly every point lies on the top face, whose
    # point-to-plane residual does not change under an in-plane slide or
    # yaw; only slivers of the side faces seen at ~4 degrees pin them.
    # Frame 5 (yaw 0.55 rad) is accepted 17.3 mm off along the long
    # axis, frame 7 (yaw 0.65 rad) 5.9 deg off in yaw, on the CPU too.
    # They are reported by name; every other frame meets the bound.
    known = {5: "slides along the long axis", 7: "turns in-plane"}
    others = [i for i in range(n) if i not in known]
    ck("batch-1 pose vs ground truth",
       all(acc) and np.median(t_err) <= 5.0 and np.median(r_err) <= 2.0
       and t_err[others].max() <= 5.0 and r_err[others].max() <= 2.0,
       f"accepted {sum(acc)}/{n}; median {np.median(t_err):.2f} mm <= 5 mm, "
       f"{np.median(r_err):.2f} deg <= 2 deg; frames {others}: max "
       f"{t_err[others].max():.2f} mm <= 5 mm, {r_err[others].max():.2f} deg "
       f"<= 2 deg, modulo box symmetry (tolerance: 1.5 mm depth noise, 5 mm "
       f"voxels); known degenerate fits, not bounded: "
       + "; ".join(f"frame {i} {why}: {t_err[i]:.2f} mm, {r_err[i]:.2f} deg"
                   for i, why in known.items()))

    def compare(name, a_list, b_list, tol_mm, tol_deg, reason):
        dt = max(np.linalg.norm(a.pose[:3, 3] - b.pose[:3, 3]) for a, b in zip(a_list, b_list)) * 1e3
        dr = max(rot_deg(a.pose[:3, :3], b.pose[:3, :3], symmetric=True) for a, b in zip(a_list, b_list))
        same_acc = all(bool(a.accepted) == bool(b.accepted) for a, b in zip(a_list, b_list))
        dplane = max(float(np.abs(a.plane * np.sign(a.plane[2]) - b.plane * np.sign(b.plane[2])).max())
                     for a, b in zip(a_list, b_list))
        ck(name, same_acc and dt <= tol_mm and dr <= tol_deg and dplane <= 1e-3,
           f"max |dt| {dt:.3f} mm <= {tol_mm} mm, max dR {dr:.3f} deg <= {tol_deg} deg, "
           f"plane coeffs max diff {dplane:.2e} <= 1e-3, accept flags equal {same_acc} ({reason})")

    unbatch = lambda b: [jax.tree_util.tree_map(lambda x: x[i], b) for i in range(n)]
    flips = ("the GPU contracts to FMA and sums in another order, so a RANSAC "
             "count flips only for points within ulps of tau; ICP then lands "
             "within the same basin")
    compare("batch-1 GPU vs CPU", g1, c1, 2.0, 0.5, flips)
    compare("batch-8 GPU vs CPU", unbatch(g8), unbatch(c8), 2.0, 0.5, flips)
    compare("batch-8 vs batch-1 on the GPU", unbatch(g8), g1, 2.0, 0.5,
            "vmap changes only the reduction order")
    return ck.failed


# ------------------------------------------------------------------- slam

def phase_slam(gpu, cpu, frames: int = 300, width: int = 640, height: int = 480,
               prefix: int = 16, ate_cm_max: float = 3.0) -> list:
    import jax

    from benchmarks.slam_bench import loop_closures, rendered_sequence, slam_config, track
    from perception.utils.metrics import ate

    ck = Checks("slam")
    camera, gt, grays, depths = rendered_sequence(frames, width, height)
    gtp = np.stack([np.asarray(T, np.float64) for T in gt])
    for label, cfg in (("keyframe+BA", slam_config(enable_ba=True)),
                       ("map 32k", slam_config(enable_ba=True, map_budget=32768))):
        with jax.default_device(gpu):
            est, state, n_ba, n_corr, dt = track(camera, depths, grays, cfg)
        ate_cm = float(ate(est, gtp, align=False).rmse * 100.0)
        n_loop = loop_closures(state)
        ck(f"{label} ATE over {frames} frames at {width}x{height}",
           bool(np.isfinite(est).all()) and ate_cm <= ate_cm_max,
           f"ATE {ate_cm:.3f} cm <= {ate_cm_max} cm (tolerance: 1 mm depth "
           f"noise over a 1 m sweep; the synthetic room is drift-bounded by "
           f"loop closure); {int(state.keyframes.count)} keyframes")
        ck(f"{label} back end fired", n_ba >= 1 and n_loop >= 1,
           f"{n_ba} BA runs >= 1, {n_loop} accepted loop closures >= 1, "
           f"{n_corr} pose-graph corrections")
        with jax.default_device(cpu):
            ref, _, _, _, _ = track(camera, depths[:prefix], grays[:prefix], cfg)
        dpos = float(np.linalg.norm(est[:prefix, :3, 3] - ref[:, :3, 3], axis=1).max()) * 1e3
        drot = max(rot_deg(a[:3, :3], b[:3, :3]) for a, b in zip(est[:prefix], ref))
        ck(f"{label} GPU vs CPU trajectory, first {prefix} frames",
           dpos <= 5.0 and drot <= 0.3,
           f"max |dp| {dpos:.3f} mm <= 5 mm, max dR {drot:.4f} deg <= 0.3 deg "
           f"(tolerance: GN sums reduce in another order on the GPU; a "
           f"keyframe promotion decided within rounding can shift later poses "
           f"by the odometry noise)")
    return ck.failed


# ---------------------------------------------------------------- backend

def phase_backend(gpu, cpu, iterations: int = 4) -> list:
    import jax

    import __graft_entry__ as g
    from perception.models.slam.backend import bundle_adjust

    ck = Checks("backend")
    for depth, label in ((False, "reprojection only"), (True, "with depth rows")):
        problem, cam = g.ba_window_problem(depth=depth)
        truth = np.asarray(problem.poses_wc, np.float64)
        costs, poses = {}, {}
        for name, dev in (("gpu", gpu), ("cpu", cpu)):
            p = jax.device_put(problem, dev)
            runs = [bundle_adjust(p, *cam, iterations=k) for k in range(1, iterations + 1)]
            costs[name] = [float(runs[0].initial_cost)] + [float(r.final_cost) for r in runs]
            poses[name] = np.asarray(runs[-1].poses_wc, np.float64)
        d_dev = float(np.abs(poses["gpu"] - poses["cpu"]).max())
        d_gt = float(np.abs(poses["gpu"] - truth).max())
        ck(f"bundle_adjust {label}, window 5 poses x 1024 landmarks x 4096 obs, GPU vs CPU",
           costs["gpu"][-1] <= 1e-4 and costs["cpu"][-1] <= 1e-4
           and d_dev <= 1e-4 and d_gt <= 1e-4,
           f"cost per iteration GPU {['%.3g' % c for c in costs['gpu']]}, CPU "
           f"{['%.3g' % c for c in costs['cpu']]} px^2, final <= 1e-4 on both; "
           f"max |pose GPU - CPU| {d_dev:.2e} <= 1e-4, max |pose - truth| "
           f"{d_gt:.2e} <= 1e-4 (tolerance: the observations are exact, so a "
           f"float64 LM ends below 1e-9 px^2; float32 rounding of the reduced "
           f"gradient leaves steps of ~1e-5)")
    return ck.failed


# --------------------------------------------------------------- tracking

def phase_tracking(gpu, cpu, frames: int = 150, width: int = 640, height: int = 480) -> list:
    import jax

    from benchmarks.tracking_bench import run

    ck = Checks("tracking")
    with jax.default_device(gpu):
        out = run(frames=frames, width=width, height=height)
    ck(f"track_step_from_depth over {frames} frames, {out['objects']} objects at {width}x{height}",
       out["median_err_cm"] <= 2.5 and out["latched_pct"] >= 90.0,
       f"median error {out['median_err_cm']:.3f} cm <= 2.5 cm, p90 "
       f"{out['p90_err_cm']:.3f} cm, latched {out['latched_pct']:.1f}% >= 90% "
       f"(tolerance: 1.5 cm correspondence gate, 5 mm voxels)")
    return ck.failed


# ------------------------------------------------------------- four GPUs

def phase_four(gpus, cpu) -> list:
    import __graft_entry__ as g

    ck = Checks("four")
    mesh = g.multichip_mesh(4)
    for check in g.MULTICHIP_CHECKS:
        try:
            line = check(mesh)
        except AssertionError as e:
            ck(check.__name__, False, str(e))
            continue
        if line.startswith("skipped:"):
            print(f"[four] skip {check.__name__}: {line}", flush=True)
        else:
            ck(check.__name__, True, line)
    return ck.failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded paths and their comparisons")
    args = ap.parse_args(argv)

    # The CPU reference runs in this process, beside the GPU.
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU; JAX found {jax.devices()}", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    gpus = jax.devices()
    if len(gpus) < need:
        print(f"chip_smoke: needs {need} GPUs, found {gpus}", file=sys.stderr)
        return 2
    # The card's name and power limit, as nvidia-smi reports them.
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip(), flush=True)
    print(f"jax {jax.__version__}: {len(gpus)} x {gpus[0].device_kind}", flush=True)

    sys.path.insert(0, REPO)
    from perception.utils.compile_cache import configure_compile_cache

    print(f"compile cache: {configure_compile_cache()}", flush=True)
    cpu = jax.devices("cpu")[0]

    phases = [("four", phase_four)] if args.four else [
        ("kernels", phase_kernels), ("cuboid", phase_cuboid),
        ("backend", phase_backend), ("slam", phase_slam), ("tracking", phase_tracking)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            bad = fn(gpus[0] if not args.four else gpus, cpu)
        except Exception:
            traceback.print_exc()
            bad = ["raised"]
        print(f"[{name}] {'FAILED ' + ', '.join(bad) if bad else 'passed'} "
              f"in {time.perf_counter() - t0:.1f} s (compilation included)", flush=True)
        if bad:
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
