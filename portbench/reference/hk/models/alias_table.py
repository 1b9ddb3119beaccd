"""Alias tables for O(1) area-weighted emissive-triangle sampling.

Semantics replicate the reference's over/under bucket pouring
(src/mesh_material/mod.rs:330-376) including its stack (LIFO, highest index
first) pairing order, so sampled distributions match:
    entry = table[min(int(rand_x * n), n-1)]
    primitive = entry.index if rand_y < entry.prob else alias_index
(light.wgsl:662-664).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def triangle_areas(positions: np.ndarray, indices: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """Per-triangle world-space areas under an affine transform
    (reference `transformed_primitive_areas`, mod.rs:318-328)."""
    p = positions @ transform[:3, :3].T + transform[:3, 3]
    v0 = p[indices[:, 0]]
    v1 = p[indices[:, 1]]
    v2 = p[indices[:, 2]]
    return 0.5 * np.abs(np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1))


def build_alias_table(areas: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (prob [n] f32, index [n] u32).

    Bucket pouring with LIFO order matching the reference: `over`/`under`
    lists are built in ascending primitive id and popped from the back.
    Entries never poured into keep (prob=0, index=self).
    """
    n = len(areas)
    if n == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.uint32)
    mean = float(np.sum(areas)) / n
    if mean <= 0.0:
        return np.zeros(n, np.float32), np.arange(n, dtype=np.uint32)
    ratios = np.asarray(areas, dtype=np.float64) / mean

    over = [(i, r) for i, r in enumerate(ratios) if r > 1.0]
    under = [(i, r) for i, r in enumerate(ratios) if r < 1.0]

    prob = np.zeros(n, dtype=np.float32)
    index = np.arange(n, dtype=np.uint32)

    while under and over:
        oi, ov = over.pop()
        ui, uv = under.pop()
        delta = 1.0 - uv
        ov -= delta
        if ov > 1.0:
            over.append((oi, ov))
        elif ov < 1.0:
            under.append((oi, ov))
        prob[ui] = delta
        index[ui] = oi

    return prob, index


