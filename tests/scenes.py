"""Shared test scenes: one per tracer path worth covering on its own.

* ``opaque`` — sphere, plane, rotated emissive box; point + dir lights;
* ``glass`` — refractive sphere, a 16-triangle mesh, a plane;
* ``textured`` — every kind with texture / rough / opacity / emission maps;
* ``glass_flat`` — refraction without a mesh (every group one row);
* ``textured_flat`` — ``textured`` without its mesh.
"""

import jax.numpy as jnp
import numpy as np

NAMES = ("opaque", "glass", "textured", "glass_flat", "textured_flat")


def scenes():
    rng = np.random.default_rng(4)
    tris = rng.uniform(-1, 1, (16, 3, 3)).astype(np.float32)
    opaque = {
        "renderer": [
            {"type": "sphere", "r": 0.4, "pos": [0.3, 0.2, 0]},
            {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.8]},
            {"type": "box", "sizes": [0.3, 0.4, 0.5], "pos": [-0.6, 0.8, 0],
             "dir": [0, 0.5, 0.5, 0.1], "mat": {"rough": 0.7, "emit": 0.3}},
        ],
        "light": [{"type": "point", "pos": [-0.5, -1, 0.5], "pwr": 0.6},
                  {"type": "dir", "dir": [0.3, 0.5, -1], "pwr": 0.3}],
        "sky": {"color": [0.15, 0.2, 0.3], "pwr": 0.5},
    }
    glass = {
        "renderer": [
            {"type": "sphere", "r": 0.4, "mat": {"glass": 0.08, "opacity": 0.0}},
            {"type": "mesh", "mesh": tris.tolist(), "pos": [0.1, 0.9, 0.2],
             "mat": {"rough": 0.9}},
            {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.8],
             "mat": {"rough": 1.0}},
        ],
        "light": [{"type": "point", "pos": [0, -1, 1], "pwr": 0.6}],
        "sky": {"color": [0.2, 0.3, 0.4], "pwr": 0.5},
    }
    tex1 = {"w": 4, "h": 4,
            "dat": rng.uniform(0, 1, (16, 3)).round(3).tolist()}
    tex2 = {"w": 8, "h": 2,
            "dat": rng.uniform(0, 1, (16, 3)).round(3).tolist()}
    emap = {"w": 4, "h": 1,
            "dat": [[0.1, 0, 0], [0.4, 0, 0], [0.7, 0, 0], [0.95, 0, 0]]}
    textured = {
        "renderer": [
            {"type": "sphere", "r": 0.5, "pos": [0.3, 0.2, 0],
             "mat": {"tex": tex1, "rough": 0.4}},
            {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.8],
             "mat": {"tex": tex2, "emap": emap}},
            {"type": "box", "sizes": [0.4, 0.5, 0.6], "pos": [-0.6, 0.8, 0],
             "dir": [0, 0.5, 0.5, 0.1],
             "mat": {"tex": tex2, "rmap": emap, "omap": tex1,
                     "glass": 0.1}},
            {"type": "mesh", "mesh": tris[:4].tolist(), "pos": [0.9, -0.4, 0],
             "mat": {"tex": tex1}},
        ],
        "light": [{"type": "point", "pos": [-0.5, -1, 0.5], "pwr": 0.6}],
        "sky": {"color": [0.15, 0.2, 0.3], "pwr": 0.5},
    }
    # refraction without a mesh: every group is one primitive, so the exit
    # winner IS the entry winner
    glass_flat = {
        "renderer": [
            {"type": "sphere", "r": 0.4,
             "mat": {"glass": 0.08, "opacity": 0.0}},
            {"type": "box", "sizes": [0.4, 0.5, 0.6], "pos": [-0.6, 0.8, 0],
             "dir": [0, 0.5, 0.5, 0.1],
             "mat": {"glass": 0.1, "opacity": 0.3}},
            {"type": "plane", "n": [0, 0, 1], "pos": [0, 0, -0.8],
             "mat": {"rough": 1.0}},
            {"type": "sphere", "r": 0.3, "pos": [0.8, 0.3, 0.1],
             "mat": {"rough": 0.6, "emit": 0.4}},
        ],
        "light": [{"type": "point", "pos": [0, -1, 1], "pwr": 0.6}],
        "sky": {"color": [0.2, 0.3, 0.4], "pwr": 0.5},
    }
    textured_flat = {
        "renderer": [r for r in textured["renderer"] if r["type"] != "mesh"],
        "light": textured["light"],
        "sky": textured["sky"],
    }
    return {"opaque": opaque, "glass": glass, "textured": textured,
            "glass_flat": glass_flat, "textured_flat": textured_flat}


def state(n=256, seed=0):
    """Random live-mostly bounce state: (o, d, pwr, live), A, B, u, u_emit."""
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.uniform(-2, 2, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    pwr = jnp.asarray(rng.uniform(0.5, 1.0, (n,)), jnp.float32)
    live = jnp.asarray(rng.random(n) < 0.9)
    A = jnp.asarray(rng.uniform(0, 1, (n, 3)), jnp.float32)
    B = jnp.asarray(rng.uniform(0, 0.5, (n, 3)), jnp.float32)
    u = jnp.asarray(rng.random((n, 7)), jnp.float32)
    u_emit = jnp.asarray(rng.random(n), jnp.float32)
    return (o, d, pwr, live), A, B, u, u_emit
