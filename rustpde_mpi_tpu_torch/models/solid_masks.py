"""Volume-penalization masks for solid obstacles (counterpart of the JAX
package's ``models/solid_masks.py``, numpy only).

Each builder returns ``(mask, value)``: ``mask`` in [0, 1] marks solid
cells (with a tanh smoothing layer, arXiv:1903.11914 eq. 12), ``value``
is the temperature the solid enforces (the velocity targets are zero).
``Navier2D.set_solid`` applies them as an implicit pointwise Brinkman
relaxation after each step.
"""

from __future__ import annotations

import numpy as np
import torch


def _smooth_layer(dist: np.ndarray, thickness: float) -> np.ndarray:
    """Tanh smoothing ramp: 1 deep inside (dist << 0), 0 outside."""
    return 0.5 * (1.0 - np.tanh(2.0 * dist / thickness))


def solid_cylinder_inner(
    x: np.ndarray, y: np.ndarray, x0: float, y0: float, radius: float
) -> tuple[np.ndarray, np.ndarray]:
    """Solid cylinder: r < radius is solid, with a tanh layer of radius/10."""
    r = np.sqrt((x0 - x[:, None]) ** 2 + (y0 - y[None, :]) ** 2)
    thickness = radius / 10.0
    mask = np.where(
        r < radius - thickness,
        1.0,
        np.where(r < radius + thickness, _smooth_layer(r - radius, thickness), 0.0),
    )
    return mask, np.zeros_like(mask)


def solid_rectangle(
    x: np.ndarray, y: np.ndarray, x0: float, y0: float, dx: float, dy: float
) -> tuple[np.ndarray, np.ndarray]:
    """Axis-aligned solid rectangle of half-widths (dx, dy)."""
    inside = (np.abs(x[:, None] - x0) < dx) & (np.abs(y[None, :] - y0) < dy)
    mask = inside.astype(np.float64)
    return mask, np.zeros_like(mask)


def solid_roughness_sinusoid(
    x: np.ndarray, y: np.ndarray, height: float, wavenumber: float
) -> tuple[np.ndarray, np.ndarray]:
    """Sinusoidal roughness elements on both plates; the solid enforces the
    plate temperatures (+0.5 bottom, -0.5 top)."""
    bottom, top = y[0], y[-1]
    thickness = height / 10.0
    y_rough = height * (top - bottom) / 2.0 * (np.sin(wavenumber * x) + 0.5)
    yr = y_rough[:, None]
    mask = np.zeros((x.size, y.size))
    value = np.zeros_like(mask)
    # bottom plate
    d = (y[None, :] - bottom) - yr
    m_bot = np.where(d <= 0.0, 1.0, np.where(d <= thickness, _smooth_layer(d, thickness), 0.0))
    mask = np.maximum(mask, m_bot)
    value = np.where(m_bot > 0.0, 0.5, value)
    # top plate
    d = (top - y[None, :]) - yr
    m_top = np.where(d <= 0.0, 1.0, np.where(d <= thickness, _smooth_layer(d, thickness), 0.0))
    mask = np.maximum(mask, m_top)
    value = np.where(m_top > 0.0, -0.5, value)
    return mask, value


def solid_porosity(
    x: np.ndarray, y: np.ndarray, diameter: float, porosity: float
) -> tuple[np.ndarray, np.ndarray]:
    """Regular array of circles approximating the requested porosity."""
    radius = diameter / 2.0
    length = x[-1] - x[0]
    height = y[-1] - y[0]
    ncx = round(np.sqrt((1.0 - porosity) * 4.0 * length**2 / (np.pi * diameter**2)))
    ncy = round(np.sqrt((1.0 - porosity) * 4.0 * height**2 / (np.pi * diameter**2)))
    dist_x = (length - ncx * diameter) / (ncx + 1.0)
    dist_y = (height - ncy * diameter) / (ncy + 1.0)
    mask = np.zeros((x.size, y.size))
    ox = x[0] + dist_x + radius
    for _ in range(int(ncx)):
        oy = y[0] + dist_y + radius
        for _ in range(int(ncy)):
            mask += solid_cylinder_inner(x, y, ox, oy, radius)[0]
            oy += dist_y + diameter
        ox += dist_x + diameter
    return mask, np.zeros_like(mask)


def solid_porosity_interpolate(
    nx: int, ny: int, diameter: float, porosity: float
) -> tuple[np.ndarray, np.ndarray]:
    """The porosity mask built on a fixed 513x513 Chebyshev grid, then
    spectrally interpolated (coefficient truncation or zero-padding) onto
    the requested Chebyshev x Chebyshev grid, so the mask does not depend on
    the target resolution.  The transforms run in f64 on the CPU."""
    from ..bases import Space2, chebyshev

    n = 513
    kw = dict(device="cpu", dtype=torch.float64)
    src = Space2(chebyshev(n), chebyshev(n), **kw)
    dst = Space2(chebyshev(nx), chebyshev(ny), **kw)
    xs, ys = src.bases[0].points, src.bases[1].points
    out = []
    for values in solid_porosity(xs, ys, diameter, porosity):
        # the port stores spectral axes in natural order: the lowest modes
        # come first
        vhat = src.forward(torch.as_tensor(values)).numpy()
        sh = (min(n, nx), min(n, ny))
        padded = np.zeros((nx, ny))
        padded[: sh[0], : sh[1]] = vhat[: sh[0], : sh[1]]
        out.append(dst.backward(torch.as_tensor(padded)).numpy())
    return out[0], out[1]
