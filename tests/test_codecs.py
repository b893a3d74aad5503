"""Image codecs without Pillow: numpy/zlib PNG and JPEG, the native JPEG
encoder, and the CLI/texture paths that use them. Pillow only decodes
here, to check the results."""

import io

import numpy as np
import pytest
from PIL import Image

from micro_raytracer_tpu import native
from micro_raytracer_tpu.utils import assets, codecs


def _image(h=45, w=67, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    (x * y) % 256], -1).astype(np.uint8)
    img[::9] = rng.integers(0, 256, img[::9].shape)  # some hard edges
    return img


@pytest.mark.parametrize("shape", [(45, 67), (8, 8), (1, 1), (33, 130)])
def test_numpy_jpeg_decodes_close_to_source(shape):
    img = _image(*shape)
    data = codecs.encode_jpeg(img, 90)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    assert codecs.jpeg_size(data) == (shape[1], shape[0])
    dec = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert dec.shape == img.shape
    # q90 error, measured the same way against libjpeg's own q90 encode
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90, subsampling=0)
    ref = np.asarray(Image.open(buf))
    err = np.abs(dec.astype(int) - img).mean()
    assert err <= 1.1 * np.abs(ref.astype(int) - img).mean() + 0.5


def test_numpy_jpeg_tables_match_libjpeg_q90():
    """DQT and DHT segments equal libjpeg's (Pillow) at quality 90."""
    def segments(data):
        out, pos = {}, 2
        while pos < len(data) and data[pos + 1] != 0xDA:
            n = int.from_bytes(data[pos + 2:pos + 4], "big")
            out.setdefault(data[pos + 1], b"")
            out[data[pos + 1]] += data[pos + 4:pos + 2 + n]
            pos += 2 + n
        return out

    img = _image()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90, subsampling=0)
    ours, ref = segments(codecs.encode_jpeg(img, 90)), segments(buf.getvalue())
    assert ours[0xDB] == ref[0xDB]
    assert sorted(ours[0xC4]) == sorted(ref[0xC4])


@pytest.mark.skipif(not native.available(), reason="native lib not built")
def test_native_jpeg_matches_numpy_encoder():
    img = _image(37, 53)
    a, b = native.jpeg_encode(img, 90), codecs.encode_jpeg(img, 90)
    assert codecs.jpeg_size(a) == (53, 37)
    da = np.asarray(Image.open(io.BytesIO(a))).astype(int)
    db = np.asarray(Image.open(io.BytesIO(b))).astype(int)
    assert np.abs(da - db).max() <= 1  # same algorithm, f64 rounding aside


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_decode_matches_pillow(mode):
    img = Image.fromarray(_image()).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG", optimize=True)  # adaptive row filters
    got = codecs.decode_png(buf.getvalue())
    np.testing.assert_array_equal(got, np.asarray(img.convert("RGB")))


def test_png_encode_roundtrip():
    img = _image(29, 31)
    np.testing.assert_array_equal(codecs.decode_png(codecs.encode_png(img)),
                                  img)
    with pytest.raises(ValueError):
        codecs.encode_png(np.zeros((0, 4, 3), np.uint8))


def test_png_texture_loads_without_pillow(tmp_path):
    img = _image(6, 5)
    path = tmp_path / "t.png"
    path.write_bytes(codecs.encode_png(img))
    np.testing.assert_allclose(assets.load_texture(str(path)), img / 255.0,
                               atol=1e-7)


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_cli_save_formats(tmp_path, ext):
    from micro_raytracer_tpu.frontends import cli

    img = _image(20, 30)
    path = tmp_path / f"o.{ext}"
    cli._save(img, str(path))
    dec = np.asarray(Image.open(path).convert("RGB"))
    assert dec.shape == img.shape
    if ext == "png":
        np.testing.assert_array_equal(dec, img)
