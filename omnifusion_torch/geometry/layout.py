"""Tangent-patch layout tables for the icosahedron-like sphere covering.

A copy of ``omnifusion_tpu/geometry/layout.py``: the port keeps its own so
that it never imports the JAX package.

Behavioral parity with the upstream layout tables
(equi_pers/equi2pers_v3.py:32-47): each row of the sphere at
latitude ``phi_centers[i]`` holds ``num_cols[i]`` patches spaced uniformly in
longitude, with the j-th patch centered at ``(j + 0.5) * 360 / num_cols[i]``
degrees.

Note: the reference's forward (equi2pers) and inverse (pers2equi) projections
disagree on the nrows=3 row latitudes (+-60 vs +-59.6,
equi2pers_v3.py:41-43 vs pers2equi_v3.py:44-47). Both packages use a single
consistent table (the forward one) so the round trip is self-consistent.

Only what the port's projection tables use is copied: the ring layout's
patch counts and centers, and the uniform grid's centers. The JAX module's
``patch_centers_normalized`` and ``patch_centers_radians`` are the spec's
``centers_normalized`` and ``centers_radians`` here (projection/spec.py),
which follow either layout.
"""

from __future__ import annotations

import numpy as np

# nrows -> (num_cols per row, phi center in degrees per row)
PATCH_LAYOUTS: dict[int, tuple[tuple[int, ...], tuple[float, ...]]] = {
    3: ((3, 4, 3), (-60.0, 0.0, 60.0)),
    4: ((3, 6, 6, 3), (-67.5, -22.5, 22.5, 67.5)),
    5: ((3, 6, 8, 6, 3), (-72.2, -36.1, 0.0, 36.1, 72.2)),
    6: ((3, 8, 12, 12, 8, 3), (-75.2, -45.93, -15.72, 15.72, 45.93, 75.2)),
}

# npatches per nrows (matches npatches_dict at train_erp_depth.py:111).
_NPATCHES = {k: sum(v[0]) for k, v in PATCH_LAYOUTS.items()}


def num_patches(nrows: int) -> int:
    """Total number of tangent patches for a given row count."""
    return _NPATCHES[nrows]


def patch_centers(nrows: int) -> np.ndarray:
    """Patch centers in degrees, shape (P, 2) as (theta, phi).

    theta in (0, 360), phi in (-90, 90); ordering is row-major from the
    bottom (most negative phi) row, matching the reference enumeration
    (equi2pers_v3.py:52-57).
    """
    num_cols, phi_centers = PATCH_LAYOUTS[nrows]
    centers = []
    for n_cols, phi_c in zip(num_cols, phi_centers):
        theta_interval = 360.0 / n_cols
        for j in range(n_cols):
            centers.append((j * theta_interval + theta_interval / 2.0, phi_c))
    return np.asarray(centers, dtype=np.float64)


def uniform_patch_centers(num_rows: int, num_cols: int) -> np.ndarray:
    """Uniform-grid patch centers (the v2 layout, equi_pers/equi2pers_v2.py:26-35):
    rows at the midpoints of linspace(-90, 90, rows+1), columns at the
    midpoints of linspace(-180, 180, cols+1).  Returns (rows*cols, 2) degrees
    as (theta in (0, 360), phi in (-90, 90)), row-major from the bottom row.
    """
    rows = np.linspace(-90.0, 90.0, num_rows + 1)
    rows = (rows[:-1] + rows[1:]) * 0.5
    cols = np.linspace(-180.0, 180.0, num_cols + 1)
    cols = (cols[:-1] + cols[1:]) * 0.5
    centers = [(c + 180.0, r) for r in rows for c in cols]
    return np.asarray(centers, dtype=np.float64)
