"""In-house chessboard detection: synthetic renders with known corners."""

import numpy as np
import jax.numpy as jnp
import pytest

from perception.ops.chessboard import (
    detect_chessboard_native,
    find_corner_candidates,
    order_grid,
    saddle_response,
)


def render_board(H, rows, cols, size=(240, 320), ss=3):
    """Render a chessboard with (rows x cols) INNER corners through
    homography H (board->image, board units = squares). Returns
    (gray image float [0,1], (rows*cols, 2) GT inner corners row-major)."""
    h, w = size
    Hinv = np.linalg.inv(H)
    # Pixel i is centered at coordinate i (detector convention): the ss
    # subsamples of pixel i average to exactly i.
    ys = (np.arange(h * ss) + 0.5) / ss - 0.5
    xs = (np.arange(w * ss) + 0.5) / ss - 0.5
    uu, vv = np.meshgrid(xs, ys)
    ones = np.ones_like(uu)
    pix = np.stack([uu, vv, ones], -1) @ Hinv.T
    bx = pix[..., 0] / pix[..., 2]
    by = pix[..., 1] / pix[..., 2]
    # Board spans (cols+1) x (rows+1) squares -> inner corners at
    # lattice 1..cols, 1..rows; outside the board is white margin.
    inside = (bx >= 0) & (bx <= cols + 1) & (by >= 0) & (by <= rows + 1)
    checker = ((np.floor(bx).astype(int) + np.floor(by).astype(int)) % 2).astype(float)
    img = np.where(inside, checker, 1.0)
    img = img.reshape(h, ss, w, ss).mean((1, 3))

    gy, gx = np.meshgrid(np.arange(1, rows + 1), np.arange(1, cols + 1), indexing="ij")
    board_pts = np.stack([gx.ravel(), gy.ravel(), np.ones(rows * cols)], -1)
    proj = board_pts @ H.T
    gt = proj[:, :2] / proj[:, 2:3]
    return img.astype(np.float32), gt.astype(np.float32)


def make_H(scale=24.0, angle=0.25, tx=90, ty=60, px=1e-4, py=-6e-5):
    c, s = np.cos(angle), np.sin(angle)
    A = np.array([[c, -s], [s, c]]) * scale
    return np.array(
        [[A[0, 0], A[0, 1], tx], [A[1, 0], A[1, 1], ty], [px, py, 1.0]]
    )


class TestSaddleResponse:
    def test_peaks_at_corners(self):
        H = make_H()
        img, gt = render_board(H, 4, 5)
        resp = np.asarray(saddle_response(jnp.asarray(img)))
        # Response at GT corners should dominate random locations.
        at_corners = np.array(
            [resp[int(round(v)), int(round(u))] for u, v in gt]
        )
        assert at_corners.min() > 0.3 * resp.max()


class TestDetection:
    @pytest.mark.parametrize("angle,px", [(0.0, 0.0), (0.3, 1.2e-4), (-0.5, -8e-5)])
    def test_detects_all_corners_subpixel(self, angle, px):
        rows, cols = 4, 5
        H = make_H(angle=angle, px=px)
        img, gt = render_board(H, rows, cols)
        det = detect_chessboard_native(img, rows, cols)
        assert det is not None
        assert det.shape == (rows * cols, 2)
        # Row-major ordering must match GT ordering (same convention).
        err = np.linalg.norm(det - gt, axis=-1)
        assert err.max() < 0.7, err.max()
        assert err.mean() < 0.4

    def test_none_on_blank(self):
        img = np.ones((240, 320), np.float32) * 0.5
        assert detect_chessboard_native(img, 4, 5) is None

    def test_order_grid_rejects_partial(self):
        rng = np.random.default_rng(0)
        pts = rng.uniform(0, 100, (10, 2))
        assert order_grid(pts, 4, 5) is None


class TestCalibrationEndToEnd:
    def test_recovers_intrinsics_from_rendered_views(self):
        from perception.ops.calibration import (
            calibrate_camera,
            chessboard_object_points,
        )

        rows, cols, square = 4, 5, 0.03
        # Views = different in-plane rotations/translations/perspectives.
        Hs_img = [
            make_H(scale=26, angle=0.1, tx=80, ty=60, px=8e-5, py=-5e-5),
            make_H(scale=22, angle=-0.35, tx=130, ty=90, px=-9e-5, py=1.1e-4),
            make_H(scale=20, angle=0.55, tx=100, ty=70, px=1.3e-4, py=7e-5),
            make_H(scale=24, angle=-0.15, tx=150, ty=70, px=5e-5, py=-1.2e-4),
        ]
        det_uvs = []
        for H in Hs_img:
            img, gt = render_board(H, rows, cols)
            det = detect_chessboard_native(img, rows, cols)
            assert det is not None
            det_uvs.append(det)

        obj = chessboard_object_points(rows, cols, square)
        K, Ts = calibrate_camera(jnp.asarray(obj), jnp.asarray(np.stack(det_uvs)))
        K = np.asarray(K)
        # The synthetic homographies imply *some* consistent camera; the
        # sanity contract here is a finite, plausible K and board poses
        # in front of the camera.
        assert np.isfinite(K).all()
        assert K[0, 0] > 0 and K[1, 1] > 0
        assert np.asarray(Ts)[:, 2, 3].min() > 0
