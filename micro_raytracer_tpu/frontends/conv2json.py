"""`conv2json`: convert images / wavefront OBJs to render-JSON fragments.

Companion tool to the reference's second binary
(reference src/bin/conv2json.rs:9-72): ``--img`` emits ``{"tex": ...}``
and ``--obj`` emits ``{"mesh": ...}`` in either raw-buffer (``buf``, default)
or gzip+base64 inline (``inl``) format, optionally prettified.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils import assets


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="conv2json",
        description="Convert images to json for micro-rt.")
    p.add_argument("--img", help="Input image filename")
    p.add_argument("--obj", help="Input wavefont object filename")
    p.add_argument("--pretty", action="store_true",
                   help="Print json with prettifier")
    p.add_argument("-f", "--fmt", choices=("buf", "inl"), default="buf",
                   metavar="fmt: <buf|inl>", help="Texture format")
    args = p.parse_args(argv)

    out = {}
    try:
        if args.img:
            tex = assets.load_texture_file(args.img)
            buf = assets.texture_to_buffer_json(tex)
            out = {"tex": assets.encode_inline(buf) if args.fmt == "inl" else buf}
        elif args.obj:
            mesh = assets.load_obj_mesh(args.obj)
            buf = assets.mesh_to_buffer_json(mesh)
            out = {"mesh": assets.encode_inline(buf) if args.fmt == "inl" else buf}
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    print(json.dumps(out, indent=2) if args.pretty
          else json.dumps(out, separators=(",", ":")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
