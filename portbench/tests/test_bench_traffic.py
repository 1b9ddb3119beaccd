"""The traffic is a function of the frame number and the seed alone."""

import numpy as np

from portbench.harness.spec import load_cell
from portbench.harness.traffic import Traffic

BIG = 2 ** 31 + 12345


def _sequence(cell, seed, n=40):
    desc = cell.scene.build()
    t = Traffic(cell.traffic, seed, desc)
    cams = [t.eye(f) for f in range(n)]
    tfs = [t.transforms(f) for f in range(n)] if t.update_scene else []
    return cams, tfs, t.compared(16)


def test_same_seed_same_cameras_scene_and_compared_frames():
    for name in ("city-orbit", "minimal-orbit"):
        cell = load_cell(name)
        a, b = _sequence(cell, BIG), _sequence(cell, BIG)
        assert a[0] == b[0]
        for (ta, pa), (tb, pb) in zip(a[1], b[1]):
            assert all(np.array_equal(x, y) for x, y in zip(ta, tb))
            assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
        assert a[2] == b[2]
        c = _sequence(cell, BIG + 1)
        assert c[0] != a[0]


def test_orbit_and_spin_follow_the_traffic_file():
    cell = load_cell("city-orbit")
    desc = cell.scene.build()
    t = Traffic(cell.traffic, 7, desc)
    e0, target = t.eye(0)
    e240, _ = t.eye(240)        # 1.5 degrees a frame: one turn
    assert np.allclose(e0, e240)
    assert np.isclose(np.hypot(e0[0], e0[2]), 20.0) and e0[1] == 2.5
    tf, prev = t.transforms(5)
    tf4, _ = t.transforms(4)
    assert np.array_equal(prev[1], tf4[1])      # the sphere's last pose
    assert not np.array_equal(tf[1], prev[1])
    assert all(np.array_equal(tf[i], prev[i]) for i in range(len(tf))
               if i != 1)


def test_city_and_minimal_scenes_have_the_examples_sizes():
    city = load_cell("city-orbit").scene.build()
    assert len(city.instances) == 122 and city.num_triangles == 2618
    assert len(city.materials) == 7
    minimal = load_cell("minimal-orbit").scene.build()
    assert len(minimal.instances) == 2 and minimal.num_triangles == 14
