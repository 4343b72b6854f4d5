"""Example 13 — multi-face tracking facade + the multi-host runtime.

Part A drives the assembled multi-face pipeline through the Perception
facade (the reference's max_faces OpenFace topology,
openface2_ros.cpp:174-183/252-281): three faces rendered into one
frame, detected into tracker slots, then carried through detector-off
frames by the slot tracker — per-face landmarks, head pose, gaze, AU02
gate, all (max_faces, ...) arrays from ONE jitted dispatch.

Part B shows the multi-host bootstrap surface (parallel/multihost.py):
the same `initialize()` call a GPU cluster would make, demonstrated here by
spawning the 2-process localhost CPU fleet used by tests/test_multihost
(skipped automatically if the fixture trainings are absent or the
spawn is unavailable).
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples._common import setup_backend  # noqa: E402

setup_backend()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main() -> None:
    from perception.models import face_fixture as FF
    from perception.models.face_data import render_faces, sample_face_at
    from perception.wrapper import (
        Perception,
        WrapperStructFace,
        WrapperStructPose,
    )

    if not FF.fixture_available():
        print("example 13 skipped (face fixture missing)")
        return

    hw = (256, 256)
    key = jax.random.key(5)
    offs = [(-0.14, -0.14), (0.14, -0.14), (0.0, 0.14)]
    scenes = [
        sample_face_at(jax.random.fold_in(key, i), hw, FF.FIXTURE_FX,
                       FF.FIXTURE_FX, o, 0.62)
        for i, o in enumerate(offs)
    ]
    stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *scenes)

    engine = Perception(
        pose=WrapperStructPose(enabled=False),
        face=WrapperStructFace(enabled=True, max_faces=4, detect_every=3),
    )
    n_per_frame = []
    for t in range(4):  # frame 0 detects; 1-2 ride the tracker slots
        img = np.repeat(
            np.asarray(render_faces(stacked, hw, key=jax.random.fold_in(key, 50 + t)))[..., None],
            3, axis=-1,
        )
        d = engine.emplace_and_pop(img, frame_index=t)
        n = int(np.asarray(d.faces["mask"]).sum())
        n_per_frame.append(n)
        gates = np.asarray(d.faces["pose_gate"])[np.asarray(d.faces["mask"])]
        print(f"frame {t}: {n} faces tracked, "
              f"reproj {[round(float(r), 2) for r in np.asarray(d.faces['reproj_px'])[:n]]} px, "
              f"AU02 gate {gates.tolist()}")
    assert n_per_frame == [3, 3, 3, 3], n_per_frame

    # Part B: the 2-process fleet (same worker the test suite uses).
    worker = Path(__file__).resolve().parent.parent / "tests" / "multihost_worker.py"
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = str(worker.parent.parent) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port), "2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(worker.parent),
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=540)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "MULTIHOST ICP OK" in out, out
    print("multihost: 2 processes x 2 devices joined one fleet; "
          "distributed ICP+BA sharded across the process boundary == single")


if __name__ == "__main__":
    main()
