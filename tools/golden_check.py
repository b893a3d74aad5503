"""Golden-image comparison against the reference's published renders.

The reference ships no tests; its de-facto goldens are the README command
lines and their published outputs (the reference's README.md:16-27,
127-157 -> doc/out0-3.png). This tool re-renders those scenes through the
real CLI parsing path and reports downsampled mean-absolute error against
each published image, read from ``--goldens DIR`` (a copy of the
reference's ``doc/`` directory; this repo does not ship it).

RNG differs from the reference (threefry vs thread_rng), so images match in
expectation only: both sides are box-downsampled to wash out sampling noise
before comparison. Published goldens were rendered at 1024 spp; pass
--sample to trade time for noise.

An out3 MAE of ~45 once exposed a default-precision attribute-fetch matmul
that rounded fetched geometry and zeroed box normals; geometry matmuls run
at Precision.HIGHEST since (intersect.fetch_attrs).

Usage:
  python tools/golden_check.py --goldens DIR [--sample 64]
                               [--scenes out0,out2,out3] [--save DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from micro_raytracer_tpu.utils import codecs  # noqa: E402
from micro_raytracer_tpu.utils.paths import EXAMPLES_DIR  # noqa: E402

# README command lines, verbatim argv (README.md:127-157, 16-27).
GOLDENS = {
    "out0": ["--obj", "sphere", "--light", "point:", "-0.5", "-1", "0.5"],
    "out1": ["--obj", "sphere", "--light", "point:", "-0.5", "-1", "0.5",
             "--res", "1920", "1080", "--ssaa", "2"],
    "out2": ("--obj sph r: 0.2 pos: 0.5 0.5 0 albedo: #ffc177 emit: 1.0 "
             "--obj sph r: 0.2 pos: -0.5 0 0 rough: 1 "
             "--obj sph r: 0.2 pos: 0 0.5 0 albedo: #ff0000 "
             "--obj sph r: 0.2 pos: 0.5 0 0 metal: 1 "
             "--obj sph r: 0.2 pos: -0.15 -0.5 0 glass: 0.08 opacity: 0 "
             "--obj pln pos: 0 0 -0.201 rough: 1 "
             "--obj pln n: 0 0 -1 pos: 0 0 1 rough: 1 "
             "--obj pln n: -1 0 0 pos: 1 0 0 albedo: #00ff00 rough: 1 "
             "--obj pln n: 1 0 0 pos: -1 0 0 albedo: #ff0000 rough: 1 "
             "--obj pln n: 0 -1 0 pos: 0 1 0 rough: 1 "
             "--cam pos: 0 -1.2 0.1 fov: 60 gamma: 0.5 exp: 0.75 "
             "--bounce 16").split(),
    "out3": ("--obj sph r: 0.15 pos: 0 0 -0.1 "
             "--obj box size: 0.25 0.25 0.25 pos: 0 0 -0.375 dir: 0 0.5 0.5 0 "
             "--obj box size: 0.3 0.3 0.01 pos: 0 0 0.499 emit: 1 "
             "--obj box size: 1 0.01 1 pos: 0 0.5 0 "
             "--obj box size: 1 1 0.01 pos: 0 0 0.5 "
             "--obj box size: 1 1 0.01 pos: 0 0 -0.5 "
             "--obj box size: 0.01 1 1 pos: -0.5 0 0 albedo: #ff0000 "
             "--obj box size: 0.01 1 1 pos: 0.5 0 0 albedo: #00ff00 "
             "--cam pos: 0 -1.25 0 fov: 60 gamma: 0.6 exp: 0.8 "
             "--ssaa 2 --res 1080 1080").split(),
}


# Published images rendered from shipped example files rather than CLI
# commands: out4 is dof.json (README.md:11 hero image).
GOLDEN_FILES = {
    "out4": os.path.join(EXAMPLES_DIR, "dof.json"),
}


def downsample(img: np.ndarray, f: int) -> np.ndarray:
    h, w = img.shape[:2]
    h2, w2 = h // f * f, w // f * f
    return img[:h2, :w2].reshape(h2 // f, f, w2 // f, f, 3).mean((1, 3))


def run_golden(name: str, sample: int, goldens: str,
               save_dir: str | None = None) -> dict:
    from micro_raytracer_tpu.frontends import cli
    from micro_raytracer_tpu.models.render import render_image

    if name in GOLDEN_FILES:
        cfg = cli.parse_render(cli.build_parser().parse_args([GOLDEN_FILES[name]]))
    else:
        cfg = cli.parse_render(cli.build_parser().parse_args(GOLDENS[name]))
    cfg.rt.sample = sample
    ours = render_image(cfg)
    with open(os.path.join(goldens, f"{name}.png"), "rb") as f:
        ref = codecs.decode_png(f.read()).astype(np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)

    f = max(8, ours.shape[1] // 160)
    a, b = downsample(ours.astype(np.float32), f), downsample(ref, f)
    mae = float(np.abs(a - b).mean())
    p95 = float(np.percentile(np.abs(a - b), 95))
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, f"{name}_ours.png"), "wb") as f:
            f.write(codecs.encode_png(ours))
    return {"name": name, "mae_u8": round(mae, 2), "p95_u8": round(p95, 2),
            "shape": list(ours.shape), "sample": sample}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--goldens", required=True,
                   help="directory holding the reference's out0-4.png")
    p.add_argument("--sample", type=int, default=64)
    p.add_argument("--scenes", default="out0,out1,out2,out3,out4",
                   help="comma-separated golden names")
    p.add_argument("--save", default=None, help="dir to save our renders")
    args = p.parse_args(argv)

    results = []
    for name in args.scenes.split(","):
        name = name.strip()
        if name in GOLDEN_FILES and not os.path.exists(GOLDEN_FILES[name]):
            print(json.dumps({"name": name, "skipped": "scene not in "
                              "examples/ yet"}))
            continue
        r = run_golden(name, args.sample, args.goldens, args.save)
        print(json.dumps(r))
        results.append(r)
    worst = max(r["mae_u8"] for r in results) if results else 0.0
    ok = worst < 12.0
    print(json.dumps({"worst_mae_u8": worst, "pass": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
