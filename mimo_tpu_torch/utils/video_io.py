"""Video and image I/O (RGB numpy frames).

Where OpenCV imports, every function is a copy of
``mimo_tpu/utils/video_io.py``'s (OpenCV's VideoCapture / VideoWriter /
imread / imwrite), so the port reads and writes what ``mimo_tpu`` does.

Where it does not (the card's machine has no OpenCV and no video codec),
the same functions read and write two formats with numpy, ``struct`` and
``zlib`` only:

- video: an uncompressed RIFF AVI under whatever name it is given (the
  template's ``.mp4`` names too): BI_RGB, 32-bit BGRA rows bottom-up, one
  ``00db`` chunk a frame and an ``idx1`` index, the frame rate held as
  ``dwRate / dwScale`` = ``round(fps * 1000) / 1000``; 4 bytes a pixel
  (1.38 MB a 720x480 frame). OpenCV and ``mimo_tpu`` read it back equal in
  every bit. The reader takes BI_RGB at 24 or 32 bits, rows bottom-up or
  top-down;
- images: PNG, read at 8 bits in gray, RGB or RGBA (non-interlaced, every
  row filter; alpha dropped, as ``IMREAD_COLOR`` drops it), written as 8-bit
  RGB with filter 0.

Anything else (an H.264 or MPEG-4 video, a JPEG) raises ``ValueError``
naming its codec or format: decoding it needs OpenCV.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - depends on the machine
    cv2 = None


def get_fps(path: str) -> float:
    if cv2 is None:
        with _AviReader(path) as avi:
            return avi.fps
    cap = cv2.VideoCapture(path)
    try:
        return float(cap.get(cv2.CAP_PROP_FPS))
    finally:
        cap.release()


def read_frames(path: str) -> List[np.ndarray]:
    if cv2 is None:
        with _AviReader(path) as avi:
            return [avi.frame(i) for i in range(len(avi.chunks))]
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    return frames


def _kept(fps: float, n: int, target_fps: float, target_speed: float):
    """The frame indices of n frames at ``fps`` kept at ``target_fps``."""
    keep_ratio = target_speed * (round(fps) or target_fps) / target_fps
    return set(np.arange(0, n, keep_ratio).astype(int).tolist())


def load_video_fixed_fps(path: str, target_fps: float = 30.0,
                         target_speed: float = 1.0) -> List[np.ndarray]:
    """Read a video resampled to target_fps by index striding (over the
    header's frame count)."""
    if cv2 is None:
        with _AviReader(path) as avi:
            keep = _kept(avi.fps, avi.count, target_fps, target_speed)
            return [avi.frame(i) for i in range(len(avi.chunks))
                    if i in keep]
    cap = cv2.VideoCapture(path)
    try:
        keep = _kept(cap.get(cv2.CAP_PROP_FPS),
                     int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), target_fps,
                     target_speed)
        frames = []
        idx = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx in keep:
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            idx += 1
        return frames
    finally:
        cap.release()


def _as_uint8(f) -> np.ndarray:
    f = np.asarray(f)
    if f.dtype != np.uint8:
        f = (np.clip(f, 0, 1) * 255).astype(np.uint8)
    return f


def save_video(frames, path: str, fps: float = 30.0) -> None:
    """frames: iterable of (H, W, 3) uint8 or [0,1] float RGB."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames = list(frames)
    if not frames:
        raise ValueError("no frames to save")
    if cv2 is None:
        _write_avi(frames, path, fps)
        return
    h, w = np.asarray(frames[0]).shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"could not open video writer for {path}")
    try:
        for f in frames:
            writer.write(cv2.cvtColor(_as_uint8(f), cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


class VideoReader:
    """Random-access clip sampler: seek-based frame access and uniform clip
    sampling without decoding the whole file."""

    def __init__(self, path: str):
        self.path = path
        if cv2 is None:
            self._avi = _AviReader(path)
            self.num_frames = self._avi.count
            self.fps = self._avi.fps
            self.width, self.height = self._avi.width, self._avi.height
            return
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise FileNotFoundError(path)
        self.num_frames = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS))
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def __len__(self) -> int:
        return self.num_frames

    def get_frame(self, idx: int) -> np.ndarray:
        if cv2 is None:
            if not 0 <= idx < len(self._avi.chunks):
                raise IndexError(f"frame {idx} of {self.num_frames}")
            return self._avi.frame(idx)
        self._cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
        ok, frame = self._cap.read()
        if not ok:
            raise IndexError(f"frame {idx} of {self.num_frames}")
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def sample_clip(self, n: int, start: int = 0,
                    end: Optional[int] = None) -> List[np.ndarray]:
        """n frames uniformly spread over [start, end)."""
        end = self.num_frames if end is None else min(end, self.num_frames)
        idx = np.linspace(start, max(start, end - 1), n).astype(int)
        return [self.get_frame(int(i)) for i in idx]

    def close(self) -> None:
        if cv2 is None:
            self._avi.close()
        else:
            self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_image(path: str) -> np.ndarray:
    if cv2 is None:
        return _read_png(path)
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def save_image(img: np.ndarray, path: str) -> None:
    img = _as_uint8(img)
    if cv2 is None:
        _write_png(img, path)
        return
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


# -- uncompressed RIFF AVI ----------------------------------------------------

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10
_RIFF_LIMIT = 2 ** 32 - 1


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(body)) + body


def _write_avi(frames, path: str, fps: float) -> None:
    """``frames`` as an uncompressed AVI (BI_RGB, 32-bit BGRA, alpha 255,
    bottom-up rows)."""
    frames = [_as_uint8(f) for f in frames]
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.shape != (h, w, 3):
            raise ValueError(f"frames of shape {f.shape} and {(h, w, 3)}: "
                             f"every frame must be (H, W, 3) and alike")
    n, size = len(frames), w * h * 4
    movi = 4 + n * (8 + size)
    total = 8 + 4 + (8 + 192) + (8 + movi) + (8 + 16 * n)
    if total > _RIFF_LIMIT:
        raise ValueError(f"{path}: {n} frames of {w}x{h} take {total} bytes, "
                         f"past the RIFF limit of {_RIFF_LIMIT}")
    rate, scale = round(fps * 1000), 1000
    if rate <= 0:
        raise ValueError(f"fps {fps} is not positive")
    avih = struct.pack("<14I", round(1e6 / fps),
                       min(size * (rate // scale + 1), _RIFF_LIMIT), 0,
                       _AVIF_HASINDEX, n, 0, 1, size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sI2H8I4h", b"vids", b"\0\0\0\0", 0, 0, 0, 0,
                       scale, rate, 0, n, size, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 32, 0, size, 0, 0, 0, 0)
    strl = _chunk(b"LIST", b"strl" + _chunk(b"strh", strh)
                  + _chunk(b"strf", strf))
    hdrl = _chunk(b"LIST", b"hdrl" + _chunk(b"avih", avih) + strl)
    index = b"".join(struct.pack("<4s3I", b"00db", _AVIIF_KEYFRAME,
                                 4 + i * (8 + size), size) for i in range(n))
    bgra = np.empty((h, w, 4), np.uint8)
    bgra[..., 3] = 255
    with open(path, "wb") as out:
        out.write(b"RIFF" + struct.pack("<I", total - 8) + b"AVI " + hdrl
                  + b"LIST" + struct.pack("<I", movi) + b"movi")
        for f in frames:
            bgra[..., :3] = f[::-1, :, ::-1]
            out.write(b"00db" + struct.pack("<I", size))
            out.write(bgra.data)
        out.write(_chunk(b"idx1", index))


def _fourcc(code: int) -> str:
    text = struct.pack("<I", code).decode("latin-1")
    return text if text.isprintable() else str(code)


def _mp4_codecs(f) -> List[str]:
    """The sample-entry types (codec fourccs) of every track of an ISO
    media file (mp4, mov), from its ``stsd`` boxes."""
    codecs = []

    def walk(start: int, end: int) -> None:
        pos = start
        while pos + 8 <= end:
            f.seek(pos)
            size, kind = struct.unpack(">I4s", f.read(8))
            head = 8
            if size == 1:
                size, head = struct.unpack(">Q", f.read(8))[0], 16
            elif size == 0:
                size = end - pos
            if size < head:
                return
            if kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
                walk(pos + head, pos + size)
            elif kind == b"stsd":
                f.seek(pos + head + 8)      # version, flags, entry count
                codecs.append(f.read(8)[4:].decode("latin-1"))
            pos += size

    f.seek(0, os.SEEK_END)
    walk(0, f.tell())
    return codecs


class _AviReader:
    """An uncompressed AVI's first video stream: its header fields and the
    file offset and size of each frame chunk; ``frame(i)`` decodes one."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        try:
            self._parse()
        except BaseException:
            self._file.close()
            raise

    def _refuse(self, what: str):
        raise ValueError(f"{self.path}: decoding {what} needs OpenCV")

    def _parse(self) -> None:
        f = self._file
        head = f.read(12)
        if head[4:8] == b"ftyp":
            codecs = _mp4_codecs(f)
            self._refuse(", ".join(f"'{c}'" for c in codecs)
                         or "an ISO media file with no track")
        if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            self._refuse(f"a file that is not an AVI (it starts with "
                         f"{head[:12]!r})")
        self.chunks = []
        stream = strf = self._id = None     # the first video stream's
        streams, want_strf = 0, False
        end = 8 + struct.unpack("<I", head[4:8])[0]
        pos, stack = 12, []
        while True:
            while stack and pos + 8 > stack[-1]:
                pos = stack.pop()
            if pos + 8 > end:
                break
            f.seek(pos)
            fourcc, size = struct.unpack("<4sI", f.read(8))
            if fourcc == b"LIST":
                kind = f.read(4)
                if kind in (b"hdrl", b"strl", b"movi", b"rec "):
                    stack.append(pos + 8 + size + (size & 1))
                    pos += 12
                    continue
            elif fourcc == b"strh":
                strh = f.read(56)
                streams += 1
                want_strf = strh[:4] == b"vids" and stream is None
                if want_strf:
                    self._id, stream = b"%02d" % (streams - 1), strh
            elif fourcc == b"strf" and want_strf:
                strf, want_strf = f.read(40), False
            elif fourcc[:2] == self._id and fourcc[2:] in (b"db", b"dc"):
                self.chunks.append((pos + 8, size))
            pos += 8 + size + (size & 1)
        if stream is None or strf is None:
            self._refuse("an AVI with no video stream")
        (scale, rate, _, length) = struct.unpack("<4I", stream[20:36])
        (_, self.width, height, _, bits, compression) = struct.unpack(
            "<IiiHHI", strf[:20])
        if compression != 0:
            self._refuse(f"'{_fourcc(compression)}'")
        if bits not in (24, 32):
            self._refuse(f"BI_RGB at {bits} bits")
        self.fps = rate / scale if scale else 0.0
        self.count = length or len(self.chunks)
        self.height, self._bottom_up = abs(height), height > 0
        self._pixel = bits // 8
        self._stride = (self.width * self._pixel + 3) & ~3

    def frame(self, i: int) -> np.ndarray:
        """Frame i as (H, W, 3) uint8 RGB."""
        offset, size = self.chunks[i]
        need = self._stride * self.height
        if size < need:
            raise ValueError(f"{self.path}: frame {i} has {size} bytes of "
                             f"{need}")
        self._file.seek(offset)
        rows = np.frombuffer(self._file.read(need), np.uint8).reshape(
            self.height, self._stride)
        img = rows[:, :self.width * self._pixel].reshape(
            self.height, self.width, self._pixel)
        if self._bottom_up:
            img = img[::-1]
        return np.ascontiguousarray(img[..., 2::-1])

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- PNG ----------------------------------------------------------------------

_PNG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}       # gray, RGB, RGBA


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _write_png(img: np.ndarray, path: str) -> None:
    """8-bit RGB, every row filter 0."""
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"an image of shape {img.shape}: (H, W, 3) needed")
    if os.path.splitext(path)[1].lower() != ".png":
        raise ValueError(f"{path}: writing anything but PNG needs OpenCV")
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)
    with open(path, "wb") as out:
        out.write(_PNG + _png_chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int,
              path: str) -> np.ndarray:
    """(h, 1 + w·bpp) filtered rows -> (h, w·bpp) pixels, all five filters.

    Average (3) and Paeth (4) make each pixel depend on its left, upper and
    upper-left neighbours, so no row can be undone at once. The pixels of
    one anti-diagonal (y + x = k) depend only on the two before it, so the
    image is skewed to make each anti-diagonal one slice, and undone in
    h + w - 1 vector steps; pixels left of x = 0 and the row above y = 0
    stay 0, as the filters define them."""
    kinds = raw[:, 0]
    if (kinds > 4).any():
        y = int(np.argmax(kinds > 4))
        raise ValueError(f"{path}: row {y} has filter {kinds[y]}")
    sub, up, avg, paeth = ((kinds == i)[:, None] for i in range(1, 5))
    x = raw[:, 1:].reshape(h, w, bpp)
    diag = h + w - 1
    xs = np.zeros((diag, h, bpp), np.int16)       # xs[k, y] = pixel x = k - y
    for y in range(h):
        xs[y:y + w, y] = x[y]
    out = np.zeros((diag + 2, h + 1, bpp), np.int16)   # 2 steps, 1 row of 0
    for k in range(diag):
        a = out[k + 1, 1:]    # (y, x - 1)
        b = out[k + 1, :-1]   # (y - 1, x)
        c = out[k, :-1]       # (y - 1, x - 1)
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where(sub, a, 0)
        pred = np.where(up, b, pred)
        pred = np.where(avg, (a + b) >> 1, pred)
        pred = np.where(paeth, np.where((pa <= pb) & (pa <= pc), a,
                                        np.where(pb <= pc, b, c)), pred)
        out[k + 2, 1:] = (xs[k] + pred) & 255
    img = np.empty((h, w, bpp), np.uint8)
    for y in range(h):
        img[y] = out[y + 2:y + 2 + w, y + 1]
    return img.reshape(h, w * bpp)


def _read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG:
        what = "JPEG" if data[:3] == b"\xff\xd8\xff" else \
            f"a file that is not a PNG (it starts with {data[:8]!r})"
        raise ValueError(f"{path}: decoding {what} needs OpenCV")
    pos, ihdr, idat = 8, None, []
    while pos + 12 <= len(data):
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        (crc,) = struct.unpack(">I", data[pos + 8 + size:pos + 12 + size])
        if len(body) != size or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: chunk {kind!r} is damaged")
        pos += 12 + size
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: a PNG with no IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    channels = _PNG_CHANNELS.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: decoding a PNG of bit depth {depth}, "
                         f"colour type {color}, interlace {interlace} needs "
                         f"OpenCV")
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixels for {w}x{h}")
    out = _unfilter(raw.reshape(h, stride + 1), h, w, channels, path)
    img = out.reshape(h, w, channels)
    if channels == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])
