"""Example 08 — camera models, image bridge, and display conversion.

The vision_opencv layer (cv_bridge + image_geometry): pinhole project /
backproject round trip, plumb_bob distortion rectification, stereo
disparity -> 3-D, encoding conversions, and cvtColorForDisplay-style
depth/label visualization.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples._common import setup_backend  # noqa: E402

setup_backend()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from perception.geometry.camera import PinholeCamera  # noqa: E402
from perception.geometry.stereo import StereoCamera  # noqa: E402
from perception.io.imgcodec import (  # noqa: E402
    array_to_image,
    convert_color,
    cvt_color_for_display,
    image_to_array,
)


def main() -> None:
    cam = PinholeCamera.d435_depth()

    # project . pixel_to_ray == identity (image_geometry's invariant test).
    uv = jnp.asarray([[100.0, 80.0], [320.0, 240.0], [613.0, 470.0]])
    rays = cam.pixel_to_ray(uv)
    uv2 = cam.project(rays * 2.5)  # any positive depth
    err = float(jnp.max(jnp.abs(uv2 - uv)))
    print(f"project(pixel_to_ray(uv)) max error = {err:.2e} px")
    assert err < 1e-3

    # Distorted camera: rectifyPoint . unrectifyPoint ~ identity.
    dcam = PinholeCamera.from_K(
        [380.0, 0, 320, 0, 380.0, 240, 0, 0, 1], width=640, height=480,
        dist=[0.1, -0.05, 0.001, 0.001, 0.0],
    )
    pt = jnp.asarray([250.0, 200.0])
    rt = dcam.rectify_point(dcam.unrectify_point(pt))
    print(f"rectify(unrectify(pt)) error = {float(jnp.linalg.norm(rt - pt)):.2e} px")

    # Stereo: disparity -> 3-D point (StereoCameraModel Q matrix).
    stereo = StereoCamera(left=cam, baseline=jnp.float32(0.05))
    xyz = stereo.project_disparity_to_3d(jnp.asarray([300.0, 220.0]),
                                         jnp.float32(9.5))
    print(f"disparity 9.5 px at (300, 220) -> z = {float(xyz[2]):.3f} m")

    # cv_bridge: encode / convert / display.
    rgb = (np.random.RandomState(0).rand(48, 64, 3) * 255).astype(np.uint8)
    msg = array_to_image(rgb, "rgb8")
    back = image_to_array(msg)
    assert (back == rgb).all()
    bgr = convert_color(rgb, "rgb8", "bgr8")
    assert (bgr[..., 0] == rgb[..., 2]).all()

    depth = np.random.RandomState(1).uniform(0.3, 3.0, (48, 64)).astype(np.float32)
    disp = cvt_color_for_display(depth, "32FC1", "bgr8", do_dynamic_scaling=True)
    labels = np.arange(48 * 64, dtype=np.int32).reshape(48, 64) % 7 - 1
    lab = cvt_color_for_display(labels, "32SC1", "rgb8")
    print(f"display images: depth {disp.shape} {disp.dtype}, labels {lab.shape}")


if __name__ == "__main__":
    main()
