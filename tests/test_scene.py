import json
import os

import numpy as np
import pytest

from micro_raytracer_tpu.models import schema
from micro_raytracer_tpu.models.compiler import compile_scene

from micro_raytracer_tpu.utils.paths import EXAMPLES_DIR as EXAMPLES


def load_example(name):
    path = os.path.join(EXAMPLES, name)
    if not os.path.exists(path):
        pytest.skip(f"missing example {name}")
    with open(path) as f:
        return json.load(f)


def test_defaults_match_reference():
    cfg = schema.RenderConfig.from_json({})
    assert cfg.rt.bounce == 8 and cfg.rt.sample == 16 and cfg.rt.loss == 0.15
    assert cfg.frame.res == (1280, 720) and cfg.frame.ssaa == 1.0
    cam = cfg.frame.cam
    np.testing.assert_allclose(cam.pos, [0, -1, 0])
    np.testing.assert_allclose(cam.dir, [0, 0, 1, 0])
    assert (cam.fov, cam.gamma, cam.exp, cam.aprt, cam.foc) == (70.0, 0.8, 0.2, 0.001, 100.0)
    assert cfg.scene.sky.pwr == 0.5
    np.testing.assert_allclose(cfg.scene.sky.color, [0, 0, 0])


def test_hex_colors():
    np.testing.assert_allclose(schema.parse_color("#ff0000"), [1, 0, 0])
    np.testing.assert_allclose(schema.parse_color("#00ff00"), [0, 1, 0])
    c = schema.parse_color("#ffc177")
    np.testing.assert_allclose(c, [255 / 255, 193 / 255, 119 / 255], rtol=1e-6)


def test_parse_default_json():
    cfg = schema.RenderConfig.from_json(load_example("Default.json"))
    assert cfg.rt.sample == 16
    assert len(cfg.scene.objects) == 1
    obj = cfg.scene.objects[0]
    assert obj.kind == "sphere" and obj.geometry["r"] == 0.5
    # default instance: pos=0, dir=backward
    pos, dr = obj.instances[0]
    np.testing.assert_allclose(pos, [0, 0, 0])
    np.testing.assert_allclose(dr, [0, 0, -1, 0])
    assert len(cfg.scene.lights) == 1
    np.testing.assert_allclose(cfg.scene.lights[0].pos, [-0.5, -1, 0.5])


def test_parse_instance_json_flattens():
    cfg = schema.RenderConfig.from_json(load_example("Instance.json"))
    obj = cfg.scene.objects[0]
    assert len(obj.instances) == 1000  # 10x10x10 grid
    scene = compile_scene(cfg.scene)
    assert scene.kind_counts[schema.KIND_SPHERE] >= 1000
    assert int(np.sum(np.asarray(scene.prim_valid))) == 1000


def test_compile_cornellbox():
    cfg = schema.RenderConfig.from_json(load_example("CornellBox.json"))
    scene = compile_scene(cfg.scene)
    # 6 planes + 1 box? inspect kinds present
    assert scene.kind_counts[schema.KIND_PLANE] >= 5
    assert scene.n_prims == sum(scene.kind_counts)
    assert scene.n_lights == len(cfg.scene.lights)


def test_mesh_example_compiles():
    cfg = schema.RenderConfig.from_json(load_example("Mesh.json"))
    scene = compile_scene(cfg.scene)
    assert scene.kind_counts[schema.KIND_TRIANGLE] > 0


def test_textured_scene_atlas():
    cfg = schema.RenderConfig.from_json(load_example("Minecraft.json"))
    scene = compile_scene(cfg.scene)
    assert scene.has_maps
    assert scene.tex_data.shape[0] > 1


def test_inst_prepend_when_pos_given():
    d = {"type": "sphere", "r": 1.0, "pos": [1, 2, 3],
         "inst": [[[0, 0, 0], [0, 0, -1, 0]]]}
    obj = schema.ObjectConfig.from_json(d)
    assert len(obj.instances) == 2
    np.testing.assert_allclose(obj.instances[0][0], [1, 2, 3])
