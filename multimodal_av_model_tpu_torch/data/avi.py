"""AVI container reader and writer in numpy (no cv2, no ffmpeg).

Own copy of ``multimodal_av_model_tpu/data/avi.py:42-315``:

* ``AviReader`` / ``read_avi``: parse the RIFF tree, index the video
  stream's chunks once, decode frames lazily to ``[H, W, 3]`` uint8 RGB:
  uncompressed 24-bit DIB (bottom-up or top-down, rows padded to 4 bytes) or
  MJPEG through ``data/jpeg.py``; other codecs raise, naming the codec;
* ``write_avi`` (DIB) and ``write_avi_mjpeg`` (pre-encoded JPEG frames):
  ``hdrl`` + ``movi`` + ``idx1``, playable by stock decoders;
* ``avi_frame_reader``: ``(start, end) -> [T, H, W, 3] | None``;
* ``open_video`` (``avi.py:306-315``): that reader for ``.avi``, and
  ``lip_extract.video_frame_reader`` (cv2) for any other container.
"""

from __future__ import annotations

import os
import struct

import numpy as np


def _fourcc(tag: bytes) -> bytes:
    assert len(tag) == 4
    return tag


class AviFormatError(ValueError):
    pass


# -- writer --------------------------------------------------------------------

def _dib_frame_bytes(frame_rgb: np.ndarray) -> bytes:
    """RGB [H, W, 3] uint8 -> DIB payload: BGR, bottom-up, rows padded to 4."""
    H, W, _ = frame_rgb.shape
    bgr = frame_rgb[:, :, ::-1]                  # RGB -> BGR
    row_bytes = W * 3
    stride = (row_bytes + 3) & ~3
    rows = np.zeros((H, stride), np.uint8)
    rows[:, :row_bytes] = bgr.reshape(H, row_bytes)
    return rows[::-1].tobytes()                  # bottom-up scan order


def _chunk(tag: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return tag + struct.pack("<I", len(payload)) + payload + pad


def _lst(kind: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", kind + payload)


def _write_avi_container(path: str, payloads: list, W: int, H: int, fps: int,
                         handler: bytes, compression: int, chunk_tag: bytes):
    """Assemble RIFF/AVI from per-frame codec payloads (shared writer core)."""
    T = len(payloads)
    buf_size = max((len(p) for p in payloads), default=0)
    avih = struct.pack(
        "<14I",
        1_000_000 // max(fps, 1),   # dwMicroSecPerFrame
        buf_size * fps,             # dwMaxBytesPerSec
        0,                          # dwPaddingGranularity
        0x10,                       # dwFlags: AVIF_HASINDEX
        T, 0, 1,                    # dwTotalFrames, dwInitialFrames, dwStreams
        buf_size,                   # dwSuggestedBufferSize
        W, H, 0, 0, 0, 0,           # dwWidth, dwHeight, dwReserved[4]
    )
    strh = (
        b"vids" + handler + struct.pack(
            "<IHHIIIIIIII4H",
            0, 0, 0,                # dwFlags, wPriority, wLanguage
            0,                      # dwInitialFrames
            1, fps,                 # dwScale, dwRate  (rate/scale = fps)
            0, T,                   # dwStart, dwLength (frames)
            buf_size,               # dwSuggestedBufferSize
            0xFFFFFFFF, 0,          # dwQuality, dwSampleSize
            0, 0, W, H,             # rcFrame
        )
    )
    strf = struct.pack(
        "<IiiHHIIiiII",
        40, W, H, 1, 24,            # biSize, biWidth, biHeight(+:bottom-up), planes, bpp
        compression,                # biCompression (0 = BI_RGB)
        buf_size, 0, 0, 0, 0,
    )
    hdrl = _lst(b"hdrl", _chunk(b"avih", avih)
                + _lst(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))

    # The chunks are joined once: appending each to one bytes object would
    # copy everything so far per frame, quadratic in the frames.
    chunks = [b"movi"]
    index_entries = []
    offset = 4          # idx1 offsets are measured from the 'movi' fourcc
    for p in payloads:
        index_entries.append((offset, len(p)))
        chunks.append(_chunk(chunk_tag, p))
        offset += len(chunks[-1])
    movi = _chunk(b"LIST", b"".join(chunks))

    idx1 = b"".join(
        chunk_tag + struct.pack("<III", 0x10, off, size)   # AVIIF_KEYFRAME
        for off, size in index_entries
    )
    body = b"AVI " + hdrl + _lst(b"INFO", _chunk(b"ISFT", b"mmav_tpu\x00")) \
        + movi + _chunk(b"idx1", idx1)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def write_avi(path: str, frames: np.ndarray, fps: int = 30) -> None:
    """Write ``[T, H, W, 3]`` uint8 RGB frames as an uncompressed AVI."""
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
        raise ValueError(f"expected [T,H,W,3] uint8, got {frames.shape} "
                         f"{frames.dtype}")
    T, H, W, _ = frames.shape
    payloads = [_dib_frame_bytes(frames[t]) for t in range(T)]
    _write_avi_container(path, payloads, W, H, fps,
                         handler=b"DIB ", compression=0, chunk_tag=b"00db")


def write_avi_mjpeg(path: str, jpeg_blobs: list, width: int, height: int,
                    fps: int = 30) -> None:
    """Write pre-encoded JPEG frames as an MJPEG AVI (pure stdlib container
    assembly; encoding is the caller's business — tests use PIL, cameras
    emit the blobs directly)."""
    _write_avi_container(path, [bytes(b) for b in jpeg_blobs], width, height,
                         fps, handler=b"MJPG",
                         compression=int.from_bytes(b"MJPG", "little"),
                         chunk_tag=b"00dc")


# -- reader --------------------------------------------------------------------

class AviReader:
    """Lazy frame access over an uncompressed AVI.

    Opening parses the RIFF tree and builds a ``[T]`` table of video-chunk
    file offsets (headers only — no frame is decoded until requested), so a
    5-minute source costs O(T) pointers, not O(T·H·W) bytes, matching the
    seek-then-read access pattern of the reference's sentence loop
    (reference preprocessing.py:44-50).
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self.width = self.height = 0
        self.fps = 0.0
        self.compression = 0
        self.bits = 24
        self._offsets: list[tuple[int, int]] = []   # (file_offset, size)
        self._parse()

    # context-manager convenience
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    @property
    def num_frames(self) -> int:
        return len(self._offsets)

    def _read_exact(self, n: int) -> bytes:
        data = self._f.read(n)
        if len(data) != n:
            raise AviFormatError(f"truncated file {self.path}")
        return data

    def _parse(self):
        f = self._f
        riff, _size, kind = struct.unpack("<4sI4s", self._read_exact(12))
        if riff != b"RIFF" or kind != b"AVI ":
            raise AviFormatError(f"{self.path} is not a RIFF/AVI file")
        file_end = os.fstat(f.fileno()).st_size
        stream_index = 0
        vid_tags = None

        def walk(end: int):
            nonlocal stream_index, vid_tags
            while f.tell() + 8 <= end:
                tag, size = struct.unpack("<4sI", self._read_exact(8))
                payload_end = f.tell() + size
                if tag == b"LIST":
                    kind = self._read_exact(4)
                    if kind in (b"hdrl", b"strl", b"movi", b"rec "):
                        if kind == b"movi":
                            self._index_movi(payload_end)
                        else:
                            walk(payload_end)
                    # other LISTs (INFO, ...) skipped
                elif tag == b"strh":
                    data = self._read_exact(min(size, 56))
                    fcc_type = data[:4]
                    if fcc_type == b"vids":
                        vid_tags = (f"{stream_index:02d}db".encode(),
                                    f"{stream_index:02d}dc".encode())
                        scale, rate = struct.unpack("<II", data[20:28])
                        self.fps = rate / scale if scale else 0.0
                        self._vid_tags = vid_tags
                    stream_index += 1
                elif tag == b"strf" and self.width == 0 and vid_tags is not None:
                    data = self._read_exact(min(size, 40))
                    (_bisz, w, h, _pl, bits, comp) = struct.unpack(
                        "<IiiHHI", data[:20])
                    self.width, self.height = w, h
                    self.bits, self.compression = bits, comp
                f.seek(payload_end + (size & 1))

        self._vid_tags = (b"00db", b"00dc")
        walk(file_end)
        if self.width == 0 or not self._offsets:
            raise AviFormatError(f"{self.path}: no decodable video stream")
        codec = struct.pack("<I", self.compression)
        self._mjpeg = codec in (b"MJPG", b"mjpg", b"dmb1", b"jpeg")
        if self.compression != 0 and not self._mjpeg:
            raise AviFormatError(
                f"{self.path}: unsupported compression {codec!r}; this "
                f"first-party decoder handles uncompressed BI_RGB DIB and "
                f"MJPG frames")
        if not self._mjpeg and self.bits != 24:
            raise AviFormatError(f"{self.path}: only 24-bit DIB supported, "
                                 f"got {self.bits}")

    def _index_movi(self, end: int):
        f = self._f
        while f.tell() + 8 <= end:
            tag, size = struct.unpack("<4sI", self._read_exact(8))
            if tag == b"LIST":                    # 'rec ' grouping
                self._read_exact(4)
                continue
            if tag in self._vid_tags:
                self._offsets.append((f.tell(), size))
            f.seek(size + (size & 1), os.SEEK_CUR)

    def read_frame(self, t: int) -> np.ndarray:
        """Decode frame ``t`` -> ``[H, W, 3]`` uint8 RGB."""
        if not 0 <= t < len(self._offsets):
            raise IndexError(f"frame {t} out of range [0, {len(self._offsets)})")
        off, size = self._offsets[t]
        self._f.seek(off)
        payload = self._read_exact(size)
        if self._mjpeg:
            from .jpeg import decode_jpeg

            rgb = decode_jpeg(payload)
            if rgb.ndim == 2:                     # grayscale MJPEG stream
                rgb = np.repeat(rgb[:, :, None], 3, axis=2)
            return rgb
        W, H = self.width, abs(self.height)
        stride = (W * 3 + 3) & ~3
        if size < stride * H:
            raise AviFormatError(f"frame {t}: {size} bytes < {stride * H}")
        rows = np.frombuffer(payload, np.uint8, stride * H).reshape(H, stride)
        bgr = rows[:, : W * 3].reshape(H, W, 3)
        if self.height > 0:                       # bottom-up DIB
            bgr = bgr[::-1]
        return np.ascontiguousarray(bgr[:, :, ::-1])   # BGR -> RGB

    def read_range(self, start: int, end: int) -> np.ndarray | None:
        """Frames ``[start, end)`` -> ``[T, H, W, 3]`` uint8 RGB, or None when
        the range escapes the stream (the caller's skip semantics, matching
        ``lip_extract.video_frame_reader``)."""
        if start < 0 or end > len(self._offsets) or end <= start:
            return None
        return np.stack([self.read_frame(t) for t in range(start, end)])


def read_avi(path: str) -> tuple[np.ndarray, float]:
    """Decode a whole uncompressed AVI -> (``[T, H, W, 3]`` uint8 RGB, fps)."""
    with AviReader(path) as r:
        return r.read_range(0, r.num_frames), r.fps


def avi_frame_reader(path: str):
    """First-party drop-in for ``lip_extract.video_frame_reader`` (which
    needs cv2): returns ``(start, end) -> [T, H, W, 3] | None``."""
    reader = AviReader(path)
    return reader.read_range


def open_video(path: str):
    """A frame-range reader for ``path``: the numpy AVI decoder for ``.avi``,
    cv2 (imported at the call) for anything else."""
    if path.lower().endswith(".avi"):
        return avi_frame_reader(path)
    from .lip_extract import video_frame_reader

    return video_frame_reader(path)
