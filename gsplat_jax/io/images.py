"""Image files and the async ground-truth image pipeline.

Equivalent of the reference's loader thread + pinned double buffer +
transfer stream (cuda/trainer.cu:85-199,1406-1444): a
background thread decodes images (RGB float32/255 — matching OpenCV's
convertTo(1/255), trainer.cu:171-191) and stages them; `jax.device_put`
dispatches the H2D copy asynchronously so it overlaps with the compute
stream, replacing cudaMemcpyAsync + events. Random image order with
replacement (trainer.cu:1233-1235, uniform_int_distribution over mt19937).

Binary PPM (P6, 8-bit) is read and written with numpy alone; it is the
format of the synthetic datasets and the trainer's image dumps. Other
formats (real JPEG/PNG captures) are decoded by Pillow, an optional
dependency imported only for them.
"""

from __future__ import annotations

import queue
import random
import threading

import jax
import numpy as np


def _ppm_tokens(data: bytes, count: int):
    """First ``count`` whitespace-separated header tokens (skipping
    comments) and the offset just past the single whitespace after them."""
    tokens, i = [], 0
    while len(tokens) < count:
        while data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            i = data.index(b"\n", i) + 1
            continue
        j = i
        while not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    return tokens, i + 1


def read_ppm(path) -> np.ndarray:
    """Binary 8-bit PPM (P6) -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    (magic, w, h, maxval), off = _ppm_tokens(data, 4)
    if magic != b"P6" or int(maxval) != 255:
        raise ValueError(f"{path}: not an 8-bit binary PPM (P6)")
    w, h = int(w), int(h)
    arr = np.frombuffer(data, np.uint8, count=w * h * 3, offset=off)
    return arr.reshape(h, w, 3)


def write_ppm(path, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> binary 8-bit PPM (P6)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb.tobytes())


def load_image(path: str) -> np.ndarray:
    """Image file -> (H, W, 3) float32 RGB in [0, 1]."""
    if str(path).lower().endswith(".ppm"):
        return read_ppm(path).astype(np.float32) / 255.0
    try:
        from PIL import Image as PILImage
    except ImportError as e:
        raise ImportError(
            f"decoding {path} needs Pillow (pip install pillow); PPM images "
            "need nothing beyond numpy"
        ) from e
    with PILImage.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return arr


class AsyncImageLoader:
    """Prefetches (image_index, device_array) pairs on a background thread."""

    def __init__(
        self,
        paths: list[str],
        seed: int = 0,
        prefetch: int = 2,
        order: str = "random",
        start: int = 0,
    ):
        """``start`` is the draw counter to resume from (== the training
        iteration): draws are COUNTER-BASED — draw k depends only on
        (seed, k), never on history — so a resumed run samples the exact
        image sequence an uninterrupted run would (checkpoint
        reproducibility; the reference's mt19937 stream is not resumable)."""
        self._paths = paths
        self._seed = seed
        self._order = order
        self._seq = start
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _next_index(self) -> int:
        k = self._seq
        self._seq += 1
        if self._order == "random":
            # int-only seed (Python 3.11+ restricts seed types)
            return random.Random(self._seed * 1_000_003 + k).randint(
                0, len(self._paths) - 1
            )
        return k % len(self._paths)

    def _loop(self):
        while not self._stop.is_set():
            idx = -1
            try:
                idx = self._next_index()
                arr = load_image(self._paths[idx])
            except Exception as e:  # pragma: no cover — surfaced by next():
                # a dead producer thread would deadlock the training loop.
                self._q.put((idx, e))
                continue
            # device_put dispatches the H2D transfer; it completes
            # asynchronously while compute proceeds (double buffering via
            # the queue depth).
            dev = jax.device_put(arr)
            while not self._stop.is_set():
                try:
                    self._q.put((idx, dev), timeout=0.5)
                    break
                except queue.Full:
                    continue

    def next(self):
        idx, item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return idx, item

    def close(self):
        self._stop.set()
        # Drain so the producer can exit a blocking put.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
