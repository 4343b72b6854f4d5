"""Map-mode recency-decay sweep: measure fps/ATE vs map_decay.

Run on the GPU:  python -m benchmarks.decay_sweep
Each row is a full 300-frame 640x480 SLAM run (BA on, 32k map) through
benchmarks.slam_bench.run with only map_decay / map_voxel varied.
"""

from __future__ import annotations

import json
import sys

from benchmarks.slam_bench import run


def main() -> None:
    configs = [
        ("decay=1.0 (baseline)", dict()),
        ("decay=0.5", dict(map_decay=0.5)),
        ("decay=0.25", dict(map_decay=0.25)),
    ]
    if len(sys.argv) > 1:
        configs = [
            (f"decay={v}", dict(map_decay=float(v))) for v in sys.argv[1:]
        ]
    rows = []
    for name, kw in configs:
        r = run(frames=300, enable_ba=True, map_budget=32768, **kw)
        row = {
            "config": name,
            "fps": round(r["slam_fps"], 1),
            "ate_cm": round(r["ate_cm"], 3),
            "keyframes": r.get("keyframes"),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
