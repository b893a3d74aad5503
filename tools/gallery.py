"""Render every shipped example scene to docs/gallery/ as a visual check.

Usage: python tools/gallery.py [--scale 0.5] [--sample-cap 256]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from micro_raytracer_tpu.utils.paths import EXAMPLES_DIR as EXAMPLES  # noqa: E402
SCENES = ["Default", "CornellBox", "CornellBox2", "dof", "Mesh", "Minecraft",
          "Instance"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scale", type=float, default=0.5)
    p.add_argument("--sample-cap", type=int, default=256)
    p.add_argument("--out", default="docs/gallery")
    args = p.parse_args(argv)

    from PIL import Image

    from micro_raytracer_tpu.models import schema
    from micro_raytracer_tpu.models.render import render_image

    os.makedirs(args.out, exist_ok=True)
    for name in SCENES:
        path = os.path.join(EXAMPLES, f"{name}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            cfg = schema.RenderConfig.from_json(json.load(f))
        cfg.frame.res = (max(64, int(cfg.frame.res[0] * args.scale)),
                         max(64, int(cfg.frame.res[1] * args.scale)))
        cfg.rt.sample = min(cfg.rt.sample, args.sample_cap)
        t0 = time.time()
        img = render_image(cfg)
        out = os.path.join(args.out, f"{name}.png")
        Image.fromarray(img).save(out)
        print(json.dumps({"scene": name, "res": list(cfg.frame.res),
                          "sample": cfg.rt.sample,
                          "seconds": round(time.time() - t0, 1),
                          "out": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
