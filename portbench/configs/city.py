"""The city of bevy-hikari v0.3.15 examples/city.rs after its three
load waves (hikari_tpu_torch/examples/city.py `build_scene(3)`, BASELINE
config 5), frozen: a 100 m ground plane, the emissive UV sphere (1,224
triangles; untextured, as without the Earth image) and twelve houses of
ten instances each under a 10,000 lux sun. 122 instances, 2,618
triangles, 7 materials. The sphere is spawned at angle 0; the traffic
turns it (portbench/traffic).

The houses are procedural stand-ins. city.rs loads the 'Low Poly' house
glTF scenes, which are not in the repository; here each house is nine
boxes and a roof prism, sized and turned from default_rng(wave * 10 + i)
and placed at city.rs's load positions. Their geometry, and so the
triangle count, comes from no public source."""

from __future__ import annotations

import numpy as np

from portbench.harness.scenes import (SceneDesc, cube, make_transform,
                                      plane, rot_x, rot_y, uv_sphere)

WAVES = [  # (x positions, z offsets) per load_models tick (city.rs:152-198)
    [(4.0 * loc, 0.0) for loc in (-3, -1, 1, 3)],
    [(4.0 * loc, 8.0 if i % 2 == 0 else -8.0)
     for i, loc in enumerate((-3, -1, 1, 3))],
    [(4.0 * loc, -8.0 if i % 2 == 0 else 8.0)
     for i, loc in enumerate((-3, -1, 1, 3))],
]


def _roof_prism():
    """A triangular prism (gable roof) of unit footprint and height."""
    from portbench.harness.scenes import _mesh

    v = np.array([
        [-0.5, 0, -0.5], [0.5, 0, -0.5], [0.0, 1, -0.5],
        [-0.5, 0, 0.5], [0.5, 0, 0.5], [0.0, 1, 0.5],
    ], np.float32)
    faces = np.array([
        [0, 2, 1], [3, 4, 5], [0, 3, 5], [0, 5, 2],
        [1, 2, 5], [1, 5, 4], [0, 1, 4], [0, 4, 3],
    ], np.int32)
    pos = v[faces.reshape(-1)]
    e1 = pos[1::3] - pos[0::3]
    e2 = pos[2::3] - pos[0::3]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    uvs = np.tile(np.array([[0, 0], [1, 0], [0.5, 1]], np.float32),
                  (len(faces), 1))
    return _mesh(pos, np.repeat(fn, 3, axis=0), uvs,
                 np.arange(len(pos), dtype=np.uint32))


def _house(instances, x, z, seed):
    """One procedural house of ten instances: body, base, roof, chimney,
    door, four windows and a bin (meshes: 0 cube, 3 roof; materials: 1
    wall, 2 roof, 3 base, 4 door, 5 window)."""
    rng = np.random.default_rng(seed)
    w, d = rng.uniform(2.4, 3.2), rng.uniform(2.4, 3.2)
    h = rng.uniform(1.8, 2.6)
    r = rot_y(rng.uniform(-0.3, 0.3))

    def place(mesh, mat, off, scale):
        t = np.array([x, 0.0, z]) + r @ np.asarray(off, np.float64)
        instances.append((mesh, mat, make_transform(tuple(t), rotation=r,
                                                    scale=scale)))

    place(0, 1, (0, h / 2, 0), (w, h, d))
    place(0, 3, (0, 0.08, 0), (w + 0.4, 0.16, d + 0.4))
    place(3, 2, (0, h + 0.02, 0), (w + 0.5, rng.uniform(0.8, 1.4), d + 0.5))
    place(0, 2, (w * 0.25, h + 1.1, 0), (0.3, 0.9, 0.3))
    place(0, 4, (0, 0.55, d / 2 + 0.02), (0.7, 1.1, 0.08))
    for wx in (-w * 0.3, w * 0.3):
        place(0, 5, (wx, h * 0.6, d / 2 + 0.02), (0.5, 0.5, 0.06))
        place(0, 5, (wx, h * 0.6, -d / 2 - 0.02), (0.5, 0.5, 0.06))
    place(0, 1, (w / 2 + 0.15, 0.4, d * 0.2), (0.3, 0.8, 0.3))


def build() -> SceneDesc:
    meshes = [cube(1.0), plane(1.0), uv_sphere(0.5), _roof_prism()]
    materials = [
        dict(base_color=(0.8, 0.7, 0.6, 1.0), perceptual_roughness=0.9),
        dict(base_color=(0.85, 0.8, 0.7, 1.0), perceptual_roughness=0.85),
        dict(base_color=(0.55, 0.25, 0.2, 1.0), perceptual_roughness=0.7),
        dict(base_color=(0.5, 0.5, 0.5, 1.0), perceptual_roughness=0.9),
        dict(base_color=(0.35, 0.22, 0.12, 1.0), perceptual_roughness=0.6),
        dict(base_color=(0.6, 0.75, 0.85, 1.0), perceptual_roughness=0.1,
             metallic=0.3),
        dict(emissive=(1.0, 1.0, 1.0, 0.5)),
    ]
    instances = [
        (1, 0, make_transform((0, 0, 0), scale=(100, 1, 100))),
        (2, 6, make_transform((0.0, 1.0, 0.0), rotation=rot_x(-np.pi / 2))),
    ]
    for wv, wave in enumerate(WAVES):
        for i, (x, z) in enumerate(wave):
            _house(instances, x, z, seed=wv * 10 + i)
    return SceneDesc(meshes, materials, instances,
                     sun=dict(euler=(-np.pi / 4, np.pi / 4, 0.0),
                              illuminance=10000.0))
