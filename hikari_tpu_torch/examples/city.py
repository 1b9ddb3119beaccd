"""The city scene of examples/city.py (reference examples/city.rs) for the
port: a 100x100 ground plane, the rotating emissive Earth sphere and three
waves of four procedural multi-instance houses, with a sun.

`build_scene(waves)` builds the scene after `waves` load-timer ticks and
`rotate_sphere` is the per-frame sphere_rotate_system. Like hikari_tpu,
the sphere is textured with the Earth image when it is found under
$HIKARI_ASSETS (models/Earth/earth_daymap.jpg, read with PIL), and left
untextured otherwise. `main` is the example's entry point: HikariSettings()
with SMAA 2.0 on an HDR camera, the waves landing every frames // 5
frames (a recompile each), the sphere turning in every other frame
through the on-device refit.

    python -m hikari_tpu_torch.examples.city --frames 20
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from hikari_tpu_torch.camera import Camera
from hikari_tpu_torch.config import HikariSettings, Upscale
from hikari_tpu_torch.examples.common import (apply_overrides, default_out,
                                              parse_args, synchronize)
from hikari_tpu_torch.models import mesh as shapes
from hikari_tpu_torch.models.material import StandardMaterial, Texture
from hikari_tpu_torch.models.scene import (DirectionalLight, Scene,
                                           make_transform)
from hikari_tpu_torch.renderer import Renderer

WAVES = [  # (x positions, z offsets) per load_models tick (city.rs:152-198)
    [(4.0 * loc, 0.0) for loc in (-3, -1, 1, 3)],
    [(4.0 * loc, 8.0 if i % 2 == 0 else -8.0)
     for i, loc in enumerate((-3, -1, 1, 3))],
    [(4.0 * loc, -8.0 if i % 2 == 0 else 8.0)
     for i, loc in enumerate((-3, -1, 1, 3))],
]

# spawn order inside build_scene: ground plane = 0, Earth sphere = 1
SPHERE_INSTANCE = 1
EYE, TARGET = (0.0, 2.5, 20.0), (0.0, 0.0, 0.0)


def rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def earth_texture():
    """The Earth image under $HIKARI_ASSETS as hikari_tpu's examples load
    it (RGBA, at most 1024 texels on a side, sRGB), or None when it is not
    there."""
    assets = os.environ.get("HIKARI_ASSETS")
    path = os.path.join(assets or "", "models/Earth/earth_daymap.jpg")
    if not assets or not os.path.exists(path):
        return None
    from PIL import Image

    img = Image.open(path).convert("RGBA")
    img.thumbnail((1024, 1024))
    return Texture(np.asarray(img), is_srgb=True)


def _spawn_house(sc, meshes, mats, x, z, seed):
    """One procedural multi-instance house (~10 instances): base, walls,
    roof prism, chimney, door, 4 windows."""
    rng = np.random.default_rng(seed)
    w, d = rng.uniform(2.4, 3.2), rng.uniform(2.4, 3.2)
    h = rng.uniform(1.8, 2.6)
    yaw = rng.uniform(-0.3, 0.3)
    R = rot_y(yaw)

    def place(mesh, mat, off, scale):
        t = np.array([x, 0.0, z]) + R @ np.asarray(off, np.float64)
        sc.spawn(mesh, mat, make_transform(tuple(t), rotation=R, scale=scale))

    cube = meshes["cube"]
    place(cube, mats["wall"], (0, h / 2, 0), (w, h, d))               # body
    place(cube, mats["base"], (0, 0.08, 0), (w + 0.4, 0.16, d + 0.4))  # base
    place(meshes["roof"], mats["roof"], (0, h + 0.02, 0),
          (w + 0.5, rng.uniform(0.8, 1.4), d + 0.5))                   # roof
    place(cube, mats["roof"], (w * 0.25, h + 1.1, 0), (0.3, 0.9, 0.3))  # chimney
    place(cube, mats["door"], (0, 0.55, d / 2 + 0.02), (0.7, 1.1, 0.08))
    for wx in (-w * 0.3, w * 0.3):
        place(cube, mats["win"], (wx, h * 0.6, d / 2 + 0.02),
              (0.5, 0.5, 0.06))
        place(cube, mats["win"], (wx, h * 0.6, -d / 2 - 0.02),
              (0.5, 0.5, 0.06))
    place(cube, mats["wall"], (w / 2 + 0.15, 0.4, d * 0.2),
          (0.3, 0.8, 0.3))                                             # bin


def _roof_prism():
    """Triangular prism (gable roof), unit footprint and height."""
    v = np.array([
        [-0.5, 0, -0.5], [0.5, 0, -0.5], [0.0, 1, -0.5],   # back gable
        [-0.5, 0, 0.5], [0.5, 0, 0.5], [0.0, 1, 0.5],      # front gable
    ], np.float32)
    faces = np.array([
        [0, 2, 1], [3, 4, 5],              # gables
        [0, 3, 5], [0, 5, 2],              # left slope
        [1, 2, 5], [1, 5, 4],              # right slope
        [0, 1, 4], [0, 4, 3],              # underside
    ], np.int32)
    pos = v[faces.reshape(-1)]
    e1 = pos[1::3] - pos[0::3]
    e2 = pos[2::3] - pos[0::3]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    normals = np.repeat(fn, 3, axis=0)
    uvs = np.tile(np.array([[0, 0], [1, 0], [0.5, 1]], np.float32),
                  (len(faces), 1))
    idx = np.arange(len(pos), dtype=np.uint32)
    return shapes.Mesh(positions=pos, normals=normals, uvs=uvs, indices=idx)


def sphere_transform(angle: float) -> np.ndarray:
    """The Earth sphere's model matrix at rotation `angle` about y."""
    return make_transform((0.0, 1.0, 0.0),
                          rotation=rot_y(angle) @ rot_x(-np.pi / 2))


def rotate_sphere(scene: Scene, angle: float) -> Scene:
    """sphere_rotate_system (city.rs:104-112): sets the sphere instance's
    transform in place, the previous one becoming prev_transform."""
    inst = scene.instances[SPHERE_INSTANCE]
    inst.prev_transform = inst.transform
    inst.transform = sphere_transform(angle)
    return scene


def build_scene(waves: int = len(WAVES), sphere_angle: float = 0.0) -> Scene:
    """Scene after `waves` load-timer ticks (city.rs:144-199), with the
    emissive Earth sphere at `sphere_angle`."""
    sc = Scene()
    meshes = {
        "cube": sc.add_mesh(shapes.cube(1.0)),
        "plane": sc.add_mesh(shapes.plane(1.0)),
        "sphere": sc.add_mesh(shapes.uv_sphere(0.5)),
        "roof": sc.add_mesh(_roof_prism()),
    }
    mats = {
        "ground": sc.add_material(StandardMaterial(
            base_color=(0.8, 0.7, 0.6, 1.0), perceptual_roughness=0.9)),
        "wall": sc.add_material(StandardMaterial(
            base_color=(0.85, 0.8, 0.7, 1.0), perceptual_roughness=0.85)),
        "roof": sc.add_material(StandardMaterial(
            base_color=(0.55, 0.25, 0.2, 1.0), perceptual_roughness=0.7)),
        "base": sc.add_material(StandardMaterial(
            base_color=(0.5, 0.5, 0.5, 1.0), perceptual_roughness=0.9)),
        "door": sc.add_material(StandardMaterial(
            base_color=(0.35, 0.22, 0.12, 1.0), perceptual_roughness=0.6)),
        "win": sc.add_material(StandardMaterial(
            base_color=(0.6, 0.75, 0.85, 1.0), perceptual_roughness=0.1,
            metallic=0.3)),
    }
    # ground plane (city.rs:62-77)
    sc.spawn(meshes["plane"], mats["ground"],
             make_transform((0, 0, 0), scale=(100, 1, 100)))
    # rotating emissive Earth sphere (city.rs:81-102)
    tex = earth_texture()
    em = sc.add_material(StandardMaterial(
        base_color_texture=tex, emissive=(1.0, 1.0, 1.0, 0.5),
        emissive_texture=tex))
    sc.spawn(meshes["sphere"], em, sphere_transform(sphere_angle),
             prev_transform=sphere_transform(sphere_angle - 0.2 / 60.0))
    # staggered house waves
    for wv in range(min(waves, len(WAVES))):
        for i, (x, z) in enumerate(WAVES[wv]):
            _spawn_house(sc, meshes, mats, x, z, seed=wv * 10 + i)
    sc.directional_light = DirectionalLight.from_euler(
        -np.pi / 4, np.pi / 4, 0.0, illuminance=10000.0)
    return sc


def main(argv=None):
    """The city example's entry point (examples/city.py main): wave w lands at
    frame (w + 1) * interval (city.rs LoadTimer) through
    update_scene(fast=False); between waves the sphere turns every frame
    through the on-device refit. Returns (renderer, last image)."""
    args = parse_args("city: staggered loading + many instances + SMAA TU4X"
                      " + HDR + animated emissive sphere", argv=argv)
    settings = dataclasses.replace(HikariSettings(),
                                   upscale=Upscale.smaa_tu4x(2.0))
    settings = apply_overrides(settings, args)
    cam = Camera.from_look_at(EYE, TARGET, width=args.width,
                              height=args.height, hdr=True)
    interval = max(2, args.frames // 5)
    waves_landed = 0
    scene = build_scene(waves=0)
    r = Renderer(scene, cam, settings, device=args.device)
    img = None
    t0 = time.perf_counter()
    for f in range(args.frames):
        angle = 0.2 * f / 60.0
        want_waves = min(len(WAVES), f // interval)
        if want_waves != waves_landed:
            waves_landed = want_waves
            scene = build_scene(waves_landed, angle)
            r.update_scene(scene, fast=False)
            print(f"[city] frame {f}: wave {waves_landed} landed "
                  f"({r.gpu_scene.num_instances} instances, "
                  f"{r.gpu_scene.num_triangles} tris)")
        elif f > 0:
            r.update_scene(rotate_sphere(scene, angle), fast=True)
        img = r.render_frame()
    synchronize(r.device)
    dt = (time.perf_counter() - t0) / max(1, args.frames)
    print(f"[city] {args.frames} frames, {dt * 1e3:.1f} ms/frame avg "
          f"(incl. {len(WAVES)} recompiles + per-frame refit)")
    out = args.out or default_out("city")
    r.save_png(out, img)
    print(f"[city] saved {out}")
    return r, img


if __name__ == "__main__":
    main()
