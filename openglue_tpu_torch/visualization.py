"""Match visualization (port of ``openglue_tpu/visualization.py``; the
reference CLI draws LAF matches via kornia_moons, inference.py:255-264; here
with OpenCV primitives, no extra deps).

``draw_matches`` renders a side-by-side pair with match lines colored by
confidence; LAF ellipses (the affine frame mapped onto the unit circle) are
drawn when requested.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _to_bgr(image: np.ndarray) -> np.ndarray:
    import cv2

    if image.ndim == 2:
        return cv2.cvtColor(image, cv2.COLOR_GRAY2BGR)
    return image.copy()


def draw_laf(canvas: np.ndarray, laf: np.ndarray, color, offset_x: int = 0) -> None:
    """Draw one LAF as the affine image of the unit circle (an ellipse)."""
    import cv2

    A = laf[:2, :2]
    center = laf[:, 2]
    ts = np.linspace(0, 2 * np.pi, 32)
    circle = np.stack([np.cos(ts), np.sin(ts)], axis=1)
    pts = circle @ A.T + center
    pts[:, 0] += offset_x
    cv2.polylines(canvas, [pts.astype(np.int32)], True, color, 1, cv2.LINE_AA)


def draw_matches(
    image0: np.ndarray,
    image1: np.ndarray,
    keypoints0: np.ndarray,
    keypoints1: np.ndarray,
    confidence: Optional[np.ndarray] = None,
    lafs0: Optional[np.ndarray] = None,
    lafs1: Optional[np.ndarray] = None,
    output_path: Optional[str] = None,
    max_draw: int = 500,
) -> np.ndarray:
    """Side-by-side match rendering. Returns the BGR canvas (and writes it to
    output_path when given)."""
    import cv2

    img0 = _to_bgr(np.asarray(image0))
    img1 = _to_bgr(np.asarray(image1))
    h = max(img0.shape[0], img1.shape[0])
    w0, w1 = img0.shape[1], img1.shape[1]
    canvas = np.zeros((h, w0 + w1, 3), np.uint8)
    canvas[: img0.shape[0], :w0] = img0
    canvas[: img1.shape[0], w0:] = img1

    n = len(keypoints0)
    order = np.arange(n)
    if confidence is not None and n > max_draw:
        order = np.argsort(-np.asarray(confidence))[:max_draw]

    for i in order:
        p0 = tuple(np.round(keypoints0[i]).astype(int))
        p1 = tuple(np.round(keypoints1[i] + [w0, 0]).astype(int))
        c = float(confidence[i]) if confidence is not None else 1.0
        color = (int(64 + 191 * (1 - c)), int(64 + 191 * c), 64)  # blue->green
        cv2.line(canvas, p0, p1, color, 1, cv2.LINE_AA)
        cv2.circle(canvas, p0, 2, color, -1, cv2.LINE_AA)
        cv2.circle(canvas, p1, 2, color, -1, cv2.LINE_AA)
        if lafs0 is not None:
            draw_laf(canvas, np.asarray(lafs0[i]), color)
        if lafs1 is not None:
            draw_laf(canvas, np.asarray(lafs1[i]), color, offset_x=w0)

    if output_path:
        cv2.imwrite(str(output_path), canvas)
    return canvas
