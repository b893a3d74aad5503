"""Frontend tests: CLI mini-language, flag merge semantics, conv2json, HTTP.

Fixtures are the reference's own README command lines (README.md:17-27,
127-157) and example JSONs, so the grammar is exercised exactly as
published.
"""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from micro_raytracer_tpu.frontends import cli, conv2json, miniargs
from micro_raytracer_tpu.models import schema

from micro_raytracer_tpu.utils.paths import EXAMPLES_DIR as EXAMPLES


# ---------------------------------------------------------------- miniargs
def test_split_groups_reversed_order():
    # README.md:17-27 CornellBox command: 8 objects; reference group order is
    # reversed command-line order (parser.rs:584-595).
    toks = ("sph r: 0.15 pos: 0 0 -0.1 "
            "box size: 0.25 0.25 0.25 pos: 0 0 -0.375 dir: 0 0.5 0.5 0 "
            "box size: 0.3 0.3 0.01 pos: 0 0 0.499 emit: 1").split()
    objs = miniargs.parse_objects(toks)
    assert len(objs) == 3
    assert objs[0]["type"] == "box" and objs[0]["mat"]["emit"] == 1.0
    assert objs[2]["type"] == "sphere" and objs[2]["r"] == 0.15
    assert objs[1]["dir"] == [0.0, 0.5, 0.5, 0.0]


def test_obj_defaults_and_hex():
    objs = miniargs.parse_objects(["sphere"])
    assert objs[0] == {"type": "sphere", "r": 0.5, "pos": [0, 0, 0],
                       "dir": [0, 0, -1, 0]}
    objs = miniargs.parse_objects("pln albedo: #00ff00 rough: 1".split())
    assert objs[0]["n"] == [0.0, 0.0, 1.0]
    assert objs[0]["mat"]["albedo"] == "#00ff00"


def test_obj_texture_routing():
    objs = miniargs.parse_objects("box tex: wall.png rmap: QUJD".split())
    assert objs[0]["mat"]["tex"] == "wall.png"      # contains "." -> file
    assert objs[0]["mat"]["rmap"] == "QUJD"          # inline base64


def test_obj_bad_param_raises():
    with pytest.raises(miniargs.TokenError, match="unxpected"):
        miniargs.parse_objects("sph bogus: 1".split())
    with pytest.raises(miniargs.TokenError, match="type is unxpected"):
        miniargs.parse_objects("r: 0.5 sph".split())  # leading junk group


def test_light_grammar():
    lights = miniargs.parse_lights("point: -0.5 -1 0.5".split())
    assert lights[0] == {"type": "point", "pos": [-0.5, -1.0, 0.5]}
    lights = miniargs.parse_lights("pt: 0 0 2 pwr: 0.35 col: #ff0000".split())
    assert lights[0]["pwr"] == 0.35 and lights[0]["color"] == "#ff0000"
    # dir light normalizes at parse time (parser.rs:379)
    lights = miniargs.parse_lights("dir: 0 3 0".split())
    assert lights[0]["dir"] == [0.0, 1.0, 0.0]


def test_camera_and_sky():
    cam = miniargs.parse_camera("pos: 0 -1.25 0 fov: 60 gamma: 0.6 exp: 0.8".split())
    assert cam == {"pos": [0, -1.25, 0], "fov": 60.0, "gamma": 0.6, "exp": 0.8}
    sky = miniargs.parse_sky("0.1 0.2 0.3 0.5".split())
    assert sky == {"color": [0.1, 0.2, 0.3], "pwr": 0.5}
    with pytest.raises(miniargs.TokenError):
        miniargs.parse_sky("0.1 0.2 0.3".split())  # pwr required (cli.rs:148-150)


def test_mesh_vertex_stream():
    toks = "mesh mesh: 0 0 0 1 0 0 0 1 0 0 0 1 1 0 1 0 1 1 rough: 1".split()
    objs = miniargs.parse_objects(toks)
    assert len(objs[0]["mesh"]) == 2
    assert objs[0]["mat"] == {"rough": 1.0}


# ------------------------------------------------------------- CLI merge
def _parse(argv):
    return cli.parse_render(cli.build_parser().parse_args(argv))


def test_merge_full_json_plus_overrides(tmp_path):
    cfg = _parse([os.path.join(EXAMPLES, "CornellBox.json"),
                  "--sample", "7", "--bounce", "3", "--loss", "0.5"])
    assert cfg.rt.sample == 7 and cfg.rt.bounce == 3 and cfg.rt.loss == 0.5
    assert len(cfg.scene.objects) == 10  # from the JSON


def test_merge_cam_replaces_frame_camera(tmp_path):
    frame = {"res": [640, 360], "cam": {"pos": [5, 5, 5], "fov": 30}}
    fp = tmp_path / "frame.json"
    fp.write_text(json.dumps(frame))
    cfg = _parse(["-f", str(fp), "--cam", "fov:", "60"])
    # --cam builds a FRESH default camera (cli.rs:127): pos reset, fov=60
    assert cfg.frame.cam.fov == 60.0
    assert tuple(cfg.frame.cam.pos) == (0.0, -1.0, 0.0)
    assert cfg.frame.res == (640, 360)


def test_merge_obj_appends_to_scene():
    cfg = _parse(["-s", os.path.join(EXAMPLES, "CornellBox.json")])
    # CornellBox.json is a full render file; as --scene its top-level keys
    # don't match SceneWrapper so objects stay empty — use --obj appending
    cfg2 = _parse(["--obj", "sphere", "--obj", "box", "size:", "1", "1", "1",
                   "--light", "point:", "0", "0", "1"])
    kinds = [o.kind for o in cfg2.scene.objects]
    assert sorted(kinds) == ["box", "sphere"]
    assert cfg2.scene.lights[0].kind == "point"


def test_sky_flag():
    cfg = _parse(["--sky", "0.2", "0.2", "0.3", "0.9"])
    assert np.allclose(cfg.scene.sky.color, [0.2, 0.2, 0.3])
    assert cfg.scene.sky.pwr == pytest.approx(0.9)


def test_cli_dry_run_and_render(tmp_path, capsys):
    out = tmp_path / "o.png"
    rc = cli.main(["--obj", "sphere", "--light", "point:", "-0.5", "-1", "0.5",
                   "-d", "-v", "--pretty", "-o", str(out)])
    assert rc == 0 and not out.exists()  # dry run renders nothing

    rc = cli.main(["--obj", "sphere", "--light", "point:", "-0.5", "-1", "0.5",
                   "--res", "48", "32", "--sample", "2", "-o", str(out)])
    assert rc == 0 and out.exists()
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (32, 48, 3)
    assert img.max() > 20  # the lit sphere is visible


def test_cli_resume_roundtrip(tmp_path):
    out = tmp_path / "o.png"
    state = tmp_path / "s.npz"
    argv = ["--obj", "sphere", "--light", "point:", "-0.5", "-1", "0.5",
            "--res", "32", "24", "--sample", "2", "-o", str(out),
            "--save-state", str(state)]
    assert cli.main(argv) == 0 and state.exists()
    argv2 = argv[:-2] + ["--sample", "4", "--resume", str(state)]
    assert cli.main(argv2) == 0


# ------------------------------------------------------------ conv2json
def test_conv2json_img_roundtrip(tmp_path, capsys):
    from PIL import Image

    from micro_raytracer_tpu.utils import assets

    src = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3) * 10
    p = tmp_path / "t.png"
    Image.fromarray(src).save(p)

    assert conv2json.main(["--img", str(p)]) == 0
    buf = json.loads(capsys.readouterr().out)["tex"]
    assert buf["w"] == 3 and buf["h"] == 2
    np.testing.assert_allclose(assets.load_texture(buf), src / 255.0, atol=1e-6)

    assert conv2json.main(["--img", str(p), "--fmt", "inl"]) == 0
    inl = json.loads(capsys.readouterr().out)["tex"]
    assert isinstance(inl, str)
    np.testing.assert_allclose(assets.load_texture(inl), src / 255.0, atol=1e-6)


def test_conv2json_obj(tmp_path, capsys):
    from micro_raytracer_tpu.utils import assets

    p = tmp_path / "m.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3\nf 2 4 3\n")
    assert conv2json.main(["--obj", str(p), "--fmt", "inl"]) == 0
    spec = json.loads(capsys.readouterr().out)["mesh"]
    mesh = assets.load_mesh(spec)
    assert mesh.shape == (2, 3, 3)
    np.testing.assert_allclose(mesh[0, 1], [1, 0, 0])


# ----------------------------------------------------------------- HTTP
@pytest.fixture(scope="module")
def http_server():
    from micro_raytracer_tpu.frontends.http import HttpServer

    srv = HttpServer("127.0.0.1:0")
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    srv.port = port
    threading.Thread(target=srv.start, daemon=True).start()
    time.sleep(0.3)
    return port


def _req(port, raw: bytes) -> bytes:
    s = socket.create_connection(("127.0.0.1", port), timeout=120)
    s.sendall(raw)
    out = b""
    while True:
        chunk = s.recv(1 << 20)
        if not chunk:
            break
        out += chunk
    s.close()
    return out


def test_http_render(http_server):
    body = json.dumps({
        "rt": {"sample": 2, "bounce": 2},
        "frame": {"res": [32, 24]},
        "scene": {
            "renderer": [{"type": "sphere", "r": 0.5}],
            "light": [{"type": "point", "pos": [-0.5, -1, 0.5]}],
        },
    }).encode()
    raw = (b"POST /render HTTP/1.1\r\nContent-Type: application/json\r\n"
           + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    res = _req(http_server, raw)
    assert res.startswith(b"HTTP/1.1 200 OK")
    assert b"Content-Type: image/jpeg" in res
    jpg = res.split(b"\r\n\r\n", 1)[1]
    assert jpg[:2] == b"\xff\xd8"  # JPEG SOI marker


@pytest.mark.parametrize("raw,code", [
    (b"POST / HTTP/1.0\r\nContent-Type: application/json\r\nContent-Length: 2\r\n\r\n{}",
     b"505"),
    (b"GET / HTTP/1.1\r\nContent-Type: application/json\r\nContent-Length: 2\r\n\r\n{}",
     b"405"),
    (b"POST / HTTP/1.1\r\nContent-Length: 2\r\n\r\n{}", b"400"),
    (b"POST / HTTP/1.1\r\nContent-Type: text/plain\r\nContent-Length: 2\r\n\r\n{}",
     b"415"),
    (b"POST / HTTP/1.1\r\nContent-Type: application/json\r\n\r\n{}", b"411"),
])
def test_http_validation(http_server, raw, code):
    res = _req(http_server, raw)
    assert code in res.split(b"\r\n")[0]


def test_miniargs_fuzz_never_crashes():
    """Random token streams either parse or raise TokenError — nothing else."""
    import random

    rng = random.Random(0)
    vocab = ["sph", "box", "pln", "tri", "mesh", "r:", "size:", "n:", "vtx:",
             "pos:", "dir:", "albedo:", "rough:", "tex:", "name:", "#ff00zz",
             "#00ff00", "0.5", "-1", "abc", "pt:", "col:", "pwr:", "1e9",
             "nan", ""]
    for _ in range(300):
        toks = [rng.choice(vocab) for _ in range(rng.randrange(0, 12))]
        for parse in (miniargs.parse_objects, miniargs.parse_lights,
                      miniargs.parse_camera, miniargs.parse_sky):
            try:
                parse(toks)
            except (miniargs.TokenError, ValueError):
                pass  # the only acceptable failure modes


def test_http_concurrent_requests_serialize(http_server):
    """Two simultaneous renders both succeed (render lock serializes)."""
    import concurrent.futures

    body = json.dumps({
        "rt": {"sample": 1, "bounce": 1},
        "frame": {"res": [16, 12]},
        "scene": {"renderer": [{"type": "sphere", "r": 0.5}],
                  "light": [{"type": "point", "pos": [-0.5, -1, 0.5]}]},
    }).encode()
    raw = (b"POST / HTTP/1.1\r\nContent-Type: application/json\r\n"
           + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(_req, http_server, raw) for _ in range(2)]
        results = [f.result(timeout=180) for f in futs]
    for res in results:
        assert res.startswith(b"HTTP/1.1 200 OK"), res[:60]


def test_cli_devices_flag_renders_identical(tmp_path):
    """--devices N (virtual 8-CPU mesh, sp=1) must be byte-identical to the
    single-device render (cli.rs:157's --worker surface, reborn)."""
    from micro_raytracer_tpu.frontends import cli

    args = ["--obj", "sphere", "--light", "point:", "-0.5", "-1", "0.5",
            "--res", "64", "48", "--sample", "2", "--bounce", "2"]
    out1 = tmp_path / "single.png"
    out2 = tmp_path / "mesh.png"
    assert cli.main(args + ["-o", str(out1)]) == 0
    assert cli.main(args + ["-o", str(out2), "--devices", "8"]) == 0
    assert out1.read_bytes() == out2.read_bytes()
