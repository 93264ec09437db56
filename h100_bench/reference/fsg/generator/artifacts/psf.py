"""Point-spread-function construction (host-side NumPy; copy of
``fetalsyngen_tpu.generator.artifacts.psf``, held equal to it by the CPU
tests).

Reference parity with ``svort/data/utils.py:30-102`` (NeSVoR-derived):
``resolution2sigma`` maps resolution ratios to PSF sigmas via FWHM constants,
``get_psf`` builds the truncated, normalized 3D kernel. PSFs are tiny (<= 9^3)
host arrays fed to the jitted acquisition as separable sigma parameters.
"""

from __future__ import annotations

from math import log, sqrt

import numpy as np

GAUSSIAN_FWHM = 1 / (2 * sqrt(2 * log(2)))
SINC_FWHM = 1.206709128803223 * GAUSSIAN_FWHM


def resolution2sigma(rx, ry=None, rz=None, isotropic: bool = False):
    """Sigma(s) of the PSF from resolution ratio(s) (``utils.py:30-58``)."""
    if isotropic:
        fx = fy = fz = GAUSSIAN_FWHM
    else:
        fx = fy = SINC_FWHM
        fz = GAUSSIAN_FWHM
    if ry is None:
        if isinstance(rx, (tuple, list, np.ndarray)):
            rx, ry, rz = rx
        else:
            if isotropic:
                return fx * rx
            return fx * rx, fy * rx, fz * rx
    return fx * rx, fy * ry, fz * rz


def get_psf(
    r_max: int | None = None,
    res_ratio: tuple[float, float, float] = (1, 1, 3),
    threshold: float = 1e-4,
    psf_type: str = "gaussian",
) -> np.ndarray:
    """Truncated normalized 3D PSF (``utils.py:61-102``), (z, y, x) order."""
    sigma_x, sigma_y, sigma_z = resolution2sigma(res_ratio, isotropic=False)

    if r_max is None:
        r_max = max(int(2 * r + 1) for r in (sigma_x, sigma_y, sigma_z))
        r_max = max(r_max, 4)

    x = np.linspace(-r_max, r_max, 2 * r_max + 1, dtype=np.float32)
    grid_z, grid_y, grid_x = np.meshgrid(x, x, x, indexing="ij")
    if psf_type == "gaussian":
        psf = np.exp(
            -0.5 * (grid_x**2 / sigma_x**2 + grid_y**2 / sigma_y**2 + grid_z**2 / sigma_z**2)
        )
    elif psf_type == "sinc":
        psf = np.sinc(
            np.sqrt((grid_x / res_ratio[0]) ** 2 + (grid_y / res_ratio[1]) ** 2)
        ) ** 2 * np.exp(-0.5 * grid_z**2 / sigma_z**2)
    else:
        raise TypeError(f"Unknown PSF type: <{psf_type}>!")
    psf[np.abs(psf) < threshold] = 0

    # auto-crop zero borders (utils.py:93-100)
    rx = int(np.nonzero(psf.sum((0, 1)) > 0)[0][0])
    ry = int(np.nonzero(psf.sum((0, 2)) > 0)[0][0])
    rz = int(np.nonzero(psf.sum((1, 2)) > 0)[0][0])
    psf = psf[
        rz : 2 * r_max + 1 - rz,
        ry : 2 * r_max + 1 - ry,
        rx : 2 * r_max + 1 - rx,
    ]
    return np.ascontiguousarray(psf / psf.sum())
