"""Golden-image regression: a full rendered frame (lighting, ghost blend,
tone map) pinned against a committed image, PSNR-bounded.

Complements the ray probes in test_renderer.py (which pin hit structure but
would miss a shading/tone-map regression). The
golden was rendered by tools/gen_golden_image.py on the CPU backend; the
PSNR bound (35 dB) absorbs platform float wobble and Monte-Carlo jitter from
RNG-layout changes while failing on any real shading change (a wrong light
dot, a dropped vignette, a broken ghost blend all land far below 30 dB).
"""
import os

import numpy as np

from tools.gen_golden_image import GOLDEN_PATH, render_scene


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def test_golden_image_psnr():
    assert os.path.exists(GOLDEN_PATH), (
        "golden image missing — run tools/gen_golden_image.py --write")
    golden = np.load(GOLDEN_PATH)
    img = render_scene()
    assert img.shape == golden.shape
    psnr = _psnr(img, golden)
    assert psnr > 35.0, f"rendered frame drifted: PSNR {psnr:.2f} dB"
