"""Example 10 — GUI layer: info overlay, display loop, orbiting 3-D viewer.

The reference's gui module (FrameDisplayer / GuiInfoAdder / Gui /
Gui3D, ``openpose/src/openpose/gui/``). Headless-safe: with no DISPLAY
the frames route to a sink (here: a video file through
``io/savers.VideoWriter``), so the same code runs interactive on a
workstation and silent in production.
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples._common import setup_backend  # noqa: E402

setup_backend()

import numpy as np  # noqa: E402

from perception.geometry.camera import PinholeCamera  # noqa: E402
from perception.io.gui import FrameDisplayer, Gui, Gui3D  # noqa: E402
from perception.io.savers import VideoWriter  # noqa: E402
from benchmarks.scene import render_depth_tabletop  # noqa: E402
from perception.models.viz import depth_to_vis  # noqa: E402


def main() -> None:
    cam = PinholeCamera.d435_depth()

    with tempfile.TemporaryDirectory() as d:
        out_path = Path(d) / "session.mp4"
        writer = VideoWriter(out_path, fps=15.0)
        gui = Gui(displayer=FrameDisplayer(sink=writer.write))

        # 2-D loop: depth visualization frames with the FPS/info overlay.
        for i in range(6):
            depth = render_depth_tabletop(
                cam, seed=i,
                cuboid_pose_twist=(0.05, 0.03, 0.80, 0.0, 0.0, 0.3 + 0.1 * i),
            )
            frame = depth_to_vis(np.asarray(depth), max_depth=1.2)
            alive = gui.update(frame, num_people=0, extra=f"seed {i}")
            assert alive
        gui.close()
        writer.close()
        size = out_path.stat().st_size
        print(f"2-D GUI: 6 frames -> {out_path.name} ({size} bytes)")
        assert size > 1000

    # 3-D loop: orbiting offscreen viewer over a backprojected cloud.
    import jax.numpy as jnp

    depth = render_depth_tabletop(cam, seed=0)
    pts, mask = cam.backproject_depth(jnp.asarray(depth))
    cloud = np.asarray(pts)[np.asarray(mask)][::50]
    frames = []
    g3 = Gui3D(hw=(120, 160), orbit_step_deg=30.0,
               displayer=FrameDisplayer(sink=frames.append))
    for _ in range(4):
        g3.update(cloud)
    assert len(frames) == 4
    assert not np.array_equal(frames[0], frames[1]), "orbit static"
    print(f"3-D viewer: {len(frames)} orbit frames rendered "
          f"({frames[0].shape[1]}x{frames[0].shape[0]})")

    # Key handling (the reference's space-pause / q-quit bindings).
    gui2 = Gui(displayer=FrameDisplayer())
    gui2.handle_key(ord(" "))
    assert gui2.paused
    gui2.handle_key(ord("q"))
    assert gui2.quit
    print("key bindings: space=pause, q=quit OK")




def main_facade() -> None:
    """GUI sinks driven through the Perception facade: the Wrapper's
    producer -> extractor -> displayer flow in a few lines."""
    import numpy as np

    from perception.wrapper import (
        Perception,
        WrapperStructGui,
        WrapperStructInput,
        WrapperStructPose,
    )

    frames = [np.random.RandomState(i).rand(96, 96, 3).astype(np.float32)
              for i in range(2)]
    engine = Perception(
        pose=WrapperStructPose(topology="COCO_18", net_hw=(64, 64)),
        input=WrapperStructInput(source=frames),
        gui=WrapperStructGui(display=True),  # headless sink off-display
    )
    for datum in engine.exec():
        print(f"facade+gui frame {datum.frame_index}: "
              f"{int(np.asarray(datum.people.mask).sum())} people")
    engine.stop()


if __name__ == "__main__":
    main()
    main_facade()
