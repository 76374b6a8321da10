"""PyTorch port, media: the port's copies of ``data/jpeg.py`` and
``data/avi.py`` decode byte for byte as the JAX package's do (baseline
JPEG in 4:4:4, 4:2:0, greyscale and with restart markers; DIB AVIs of odd
widths, MJPEG AVIs), write byte-identical files, and fail the same way
(progressive JPEG, non-AVI input, an unsupported codec).  PIL encodes the
JPEG test streams; ``tests/test_jpeg.py`` holds the decoder against it."""

import io
import struct

import numpy as np
import pytest

PIL = pytest.importorskip("PIL.Image")

from multimodal_av_model_tpu.data import avi as j_avi  # noqa: E402
from multimodal_av_model_tpu.data import jpeg as j_jpeg  # noqa: E402
from multimodal_av_model_tpu_torch.data import avi, jpeg  # noqa: E402


def _encode(img: np.ndarray, mode="RGB", **kw) -> bytes:
    buf = io.BytesIO()
    PIL.fromarray(img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _smooth(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / 17 + i) * np.cos(yy / 23 - i) for i in range(3)],
                   -1)
    img += rng.standard_normal((h, w, 3)) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("size,kw", [
    ((8, 8), dict(quality=75, subsampling=0)),
    ((33, 47), dict(quality=95, subsampling=0)),
    ((64, 48), dict(quality=90, subsampling=2)),                       # 4:2:0
    ((40, 56), dict(quality=85, subsampling=0, restart_marker_blocks=3)),
])
def test_jpeg_decode_equals_jax(size, kw):
    img = _smooth(*size, seed=size[0])
    blob = _encode(img, **kw)
    got = jpeg.decode_jpeg(blob)
    assert got.shape == img.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, j_jpeg.decode_jpeg(blob))


def test_jpeg_greyscale_and_errors_equal_jax():
    blob = _encode(_smooth(31, 29, seed=5)[:, :, 0], mode="L", quality=92)
    got = jpeg.decode_jpeg(blob)
    assert got.ndim == 2
    np.testing.assert_array_equal(got, j_jpeg.decode_jpeg(blob))
    with pytest.raises(jpeg.JpegError, match="progressive"):
        jpeg.decode_jpeg(_encode(_smooth(16, 16), quality=80, progressive=True))
    with pytest.raises(jpeg.JpegError, match="SOI"):
        jpeg.decode_jpeg(b"\x00" * 32)


@pytest.mark.parametrize("W", [32, 31, 33, 34])     # odd widths pad rows to 4 bytes
def test_dib_avi_files_and_decodes_equal_jax(tmp_path, W):
    frames = np.random.default_rng(W).integers(0, 256, size=(5, 7, W, 3), dtype=np.uint8)
    path, j_path = str(tmp_path / "a.avi"), str(tmp_path / "j.avi")
    avi.write_avi(path, frames, fps=25)
    j_avi.write_avi(j_path, frames, fps=25)
    assert open(path, "rb").read() == open(j_path, "rb").read()
    got, fps = avi.read_avi(path)
    np.testing.assert_array_equal(got, frames)
    assert fps == 25.0
    with avi.AviReader(path) as r:
        assert (r.num_frames, r.width, r.height) == (5, W, 7)
        np.testing.assert_array_equal(r.read_frame(4), frames[4])
        with pytest.raises(IndexError):
            r.read_frame(5)
    read = avi.avi_frame_reader(path)
    np.testing.assert_array_equal(read(1, 4), frames[1:4])
    assert read(3, 9) is None and read(-1, 2) is None and read(2, 2) is None


def test_mjpeg_avi_decode_equals_jax(tmp_path):
    T, H, W = 3, 32, 24
    blobs = [_encode(_smooth(H, W, seed=t), quality=92, subsampling=0) for t in range(T)]
    path = str(tmp_path / "m.avi")
    avi.write_avi_mjpeg(path, blobs, W, H, fps=30)
    j_path = str(tmp_path / "j.avi")
    j_avi.write_avi_mjpeg(j_path, blobs, W, H, fps=30)
    assert open(path, "rb").read() == open(j_path, "rb").read()
    with avi.AviReader(path) as r, j_avi.AviReader(path) as jr:
        assert r.num_frames == T and r.fps == 30.0
        for t in range(T):
            np.testing.assert_array_equal(r.read_frame(t), jr.read_frame(t))


def test_avi_errors_name_the_problem(tmp_path):
    bad = tmp_path / "not.avi"
    bad.write_bytes(b"\x00" * 64)
    with pytest.raises(avi.AviFormatError):
        avi.AviReader(str(bad))
    path = str(tmp_path / "h264.avi")
    avi.write_avi(path, np.zeros((2, 4, 4, 3), np.uint8), fps=30)
    blob = bytearray(open(path, "rb").read())
    off = blob.find(b"strf") + 8 + 16                # biCompression
    assert struct.unpack_from("<I", blob, off)[0] == 0
    blob[off:off + 4] = b"H264"
    open(path, "wb").write(bytes(blob))
    with pytest.raises(avi.AviFormatError, match="H264"):
        avi.AviReader(path)
    with pytest.raises(ValueError, match="expected"):
        avi.write_avi(path, np.zeros((2, 4, 4), np.uint8))
