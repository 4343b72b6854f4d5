"""Generate the mini TUM-format fixture sequence (VERDICT r2 item 8).

Real TUM RGB-D data is egress-blocked in this environment; a rendered
sequence WRITTEN IN THE TUM FORMAT (rgb/ + depth/ 16-bit PNG at 5000
counts/m + rgb.txt/depth.txt/groundtruth.txt, plus the repo's
calibration.txt extension for the reduced resolution) still proves the
config #4 harness wiring end to end: ``python -m perception.cli
slam --tum tests/fixtures/tum_mini`` loads it through the standard
association path and reports ATE against groundtruth.txt.

Usage: python tools/make_tum_fixture.py [--frames 30] [--out DIR]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument(
        "--out",
        default=str(Path(__file__).resolve().parents[1] / "tests/fixtures/tum_mini"),
    )
    args = ap.parse_args()

    import cv2
    import jax.numpy as jnp

    from benchmarks.slam_scene import render_textured_room, sweep_trajectory
    from perception.geometry import se3
    from perception.geometry.camera import PinholeCamera
    from perception.io.tum import TUM_DEPTH_SCALE

    W, H = args.width, args.height
    fx = 307.0 * W / 320.0
    camera = PinholeCamera.from_K(
        [fx, 0, W / 2, 0, fx, H / 2, 0, 0, 1], width=W, height=H
    )
    gt = sweep_trajectory(n=args.frames)

    out = Path(args.out)
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    (out / "depth").mkdir(parents=True, exist_ok=True)

    rgb_lines, depth_lines, gt_lines = [], [], []
    for i, T in enumerate(gt):
        t = 1000.0 + i / 30.0  # 30 Hz timestamps
        gray, depth = render_textured_room(camera, T, seed=i)

        d16 = np.clip(depth / TUM_DEPTH_SCALE, 0, 65535).astype(np.uint16)
        dname = f"depth/{t:.6f}.png"
        cv2.imwrite(str(out / dname), d16)
        depth_lines.append(f"{t:.6f} {dname}")

        g8 = np.clip(gray, 0, 255).astype(np.uint8)
        rgb = np.stack([g8, g8, g8], axis=-1)
        rname = f"rgb/{t:.6f}.png"
        cv2.imwrite(str(out / rname), rgb)
        rgb_lines.append(f"{t:.6f} {rname}")

        q = np.asarray(se3.matrix_to_quat(jnp.asarray(T[:3, :3], jnp.float32)))
        tx, ty, tz = T[:3, 3]
        gt_lines.append(
            f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
            f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
        )

    hdr = "# mini rendered TUM-format fixture (tools/make_tum_fixture.py)\n"
    (out / "depth.txt").write_text(hdr + "# timestamp filename\n" + "\n".join(depth_lines) + "\n")
    (out / "rgb.txt").write_text(hdr + "# timestamp filename\n" + "\n".join(rgb_lines) + "\n")
    (out / "groundtruth.txt").write_text(
        hdr + "# timestamp tx ty tz qx qy qz qw\n" + "\n".join(gt_lines) + "\n"
    )
    (out / "calibration.txt").write_text(
        f"# fx fy cx cy width height\n{fx} {fx} {W/2} {H/2} {W} {H}\n"
    )
    total_kb = sum(p.stat().st_size for p in out.rglob("*") if p.is_file()) / 1024
    print(f"wrote {args.frames} frames to {out} ({total_kb:.0f} KB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
