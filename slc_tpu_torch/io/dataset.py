"""Replay datasets in the reference's on-disk layout.

The reference's simulated sensor replays pre-captured BMP sequences
(DynaFrame/CSensorV.cpp:31-133):

    <root>/iFrame/vGrayCam{i}.bmp    i = 0..2*bits-1   (group 0)
    <root>/iFrame/vPhaseCam{i}.bmp   i = 0..steps-1    (group 1)
    <root>/cFrame/dynaCam{i}.bmp     i = 0..frames-1   (group 2)

``ReplayDataset`` reads that layout (with read-ahead of the dynamic
frames by the native library's thread pool or a Python thread — the role
CSensorV's synchronous imread per frame plays in the reference, minus the
stall);
``write_replay_dataset`` renders a synthetic scene into it, giving the
framework a self-contained generator of reference-format data.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from slc_tpu_torch.io import native as native_io
from slc_tpu_torch.io.bmp import read_bmp, write_bmp

MANIFEST_NAME = "manifest.json"


def load_manifest(root: str) -> Optional[dict]:
    """Read ``<root>/manifest.json`` if present (framework extension —
    the reference encodes dataset shape in compile-time constants,
    StaticParameters.cpp:16-18, and dies on mismatch)."""
    path = os.path.join(root, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_manifest(root: str, manifest: dict) -> None:
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)



def _bounded_put(q: "queue.Queue", stop_evt: "threading.Event",
                 item) -> bool:
    """Bounded-blocking queue put that rechecks the stop event: if the
    consumer abandons its generator while the queue is full, a bare
    q.put would strand the producer thread forever (ADVICE r4). Shared
    by both prefetch generators so the drain semantics cannot drift.
    Returns False when stopped before the item could be enqueued."""
    while not stop_evt.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class ReplayDataset:
    """Reader for a reference-layout BMP dataset (CSensorV.cpp:35-41).

    ``gray_count``/``phase_count`` left as None are taken from the
    dataset's ``manifest.json`` when it exists (falling back to the
    reference's 12/4, CSensorV.cpp:72,80); explicit values that
    contradict the manifest raise immediately with a clear message
    instead of a missing-file error deep in the decode."""

    def __init__(self, root: str, gray_count: Optional[int] = None,
                 phase_count: Optional[int] = None,
                 frame_count: Optional[int] = None):
        self.root = root
        self.manifest = load_manifest(root)
        self.gray_count = self._resolve("gray_count", gray_count, 12)
        self.phase_count = self._resolve("phase_count", phase_count, 4)
        if frame_count is None:
            frame_count = self._from_manifest("frame_count")
        if frame_count is None:
            frame_count = 0
            while os.path.exists(self._cframe_path(frame_count)):
                frame_count += 1
        self.frame_count = frame_count

    def _from_manifest(self, key: str):
        return (self.manifest or {}).get(key)

    def _resolve(self, key: str, explicit, default):
        recorded = self._from_manifest(key)
        if explicit is None:
            return recorded if recorded is not None else default
        if recorded is not None and explicit != recorded:
            raise ValueError(
                f"{key}={explicit} conflicts with the dataset manifest "
                f"({self.root}/{MANIFEST_NAME} records {key}={recorded}); "
                f"drop the explicit value or regenerate the dataset")
        return explicit

    def _iframe_path(self, kind: str, i: int) -> str:
        return os.path.join(self.root, "iFrame", f"{kind}{i}.bmp")

    def _cframe_path(self, i: int) -> str:
        return os.path.join(self.root, "cFrame", f"dynaCam{i}.bmp")

    def gray_images(self) -> np.ndarray:
        """(2*bits, H, W) uint8 — group 0 (CSensorV.cpp:66-76)."""
        return np.stack([read_bmp(self._iframe_path("vGrayCam", i))
                         for i in range(self.gray_count)])

    def fringe_images(self, count: int) -> np.ndarray:
        """(count, H, W) uint8 multi-frequency fringe stack — a
        framework extension of the layout (no reference group) used by
        the heterodyne and spatial decode modes."""
        return np.stack([read_bmp(self._iframe_path("vFringeCam", i))
                         for i in range(count)])

    def phase_images(self) -> np.ndarray:
        """(N, H, W) uint8 — group 1 (CSensorV.cpp:77-84)."""
        return np.stack([read_bmp(self._iframe_path("vPhaseCam", i))
                         for i in range(self.phase_count)])

    def frame(self, i: int) -> np.ndarray:
        """One dynamic frame — group 2 (CSensorV.cpp:85-92)."""
        return read_bmp(self._cframe_path(i))

    # --- anchor groups (framework extension; SURVEY.md §5 re-anchoring) --
    # ``aFrame{f}/`` holds a full absolute pattern group captured at
    # dynamic frame f, enabling periodic correction of deltaP-integration
    # drift (which the reference cannot do: it projects the Gray+phase
    # set exactly once, CSensorV.cpp:60-92).

    def _aframe_path(self, f: int, kind: str, i: int) -> str:
        return os.path.join(self.root, f"aFrame{f}", f"{kind}{i}.bmp")

    def anchor_frames(self) -> list:
        """Sorted dynamic-frame indices that have an anchor group."""
        out = []
        if os.path.isdir(self.root):
            for name in os.listdir(self.root):
                if name.startswith("aFrame"):
                    try:
                        out.append(int(name[len("aFrame"):]))
                    except ValueError:
                        pass
        return sorted(out)

    def anchor_gray_images(self, f: int) -> np.ndarray:
        return np.stack([read_bmp(self._aframe_path(f, "vGrayCam", i))
                         for i in range(self.gray_count)])

    def anchor_phase_images(self, f: int) -> np.ndarray:
        return np.stack([read_bmp(self._aframe_path(f, "vPhaseCam", i))
                         for i in range(self.phase_count)])

    def anchor_fringe_images(self, f: int, count: int) -> np.ndarray:
        return np.stack([read_bmp(self._aframe_path(f, "vFringeCam", i))
                         for i in range(count)])

    def frames(self, start: int = 0, prefetch: int = 4,
               native: bool = True) -> Iterator[np.ndarray]:
        """Iterate dynamic frames with read-ahead so the step on the
        device overlaps disk I/O (the streaming analog of the reference's
        per-frame synchronous imread, CSensorV.cpp:111).

        With ``native`` (the default) the frames are decoded by the
        native library's thread pool (``NativeFrameLoader``: parallel BMP
        decode into a ring, delivered in order); where the codec does not
        take the first frame (its probe rejects it, or its shape is not
        the manifest's), and with ``native=False``, one Python read-ahead
        thread reads them. A failed build of the library raises.

        Fault semantics (the same on both paths): an unreadable or
        undecodable frame is skipped and the stream continues with the
        next one. Consumers that need per-frame fault records use
        :meth:`indexed_frames` or read indices explicitly via
        :meth:`frame`, as the runner does."""
        it = self._native_frames(start, prefetch) \
            if native and start < self.frame_count else None
        if it is None:
            yield from self._python_frames(start, prefetch)
            return
        # Iterate explicitly: the loader raises IOError for a frame that
        # fails to decode but stays usable, so the skip happens here
        # rather than ending the generator as ``yield from`` would.
        try:
            while True:
                try:
                    yield next(it)
                except StopIteration:
                    return
                except IOError:
                    continue
        finally:
            it.close()

    def _native_frames(self, start: int, prefetch: int):
        """The native thread-pool loader over the dynamic frames from
        ``start``, or None where the codec does not take the first frame:
        its probe rejects the header, the depth is not 8, 24 or 32 bits,
        or its shape is not the manifest's (slc_tpu/io/dataset.py:196-231).
        The pool gets ``max(prefetch, 2)`` slots and ``min(4,
        max(prefetch, 1))`` threads."""
        shape = native_io.probe(self._cframe_path(start))
        if shape is None:
            return None
        ph, pw, bpp = shape
        m = self.manifest or {}
        h, w = m.get("cam_h", ph), m.get("cam_w", pw)
        if (ph, pw) != (h, w) or bpp not in (8, 24, 32):
            return None
        paths = [self._cframe_path(i)
                 for i in range(start, self.frame_count)]
        return native_io.NativeFrameLoader(
            paths, int(h), int(w), slots=max(prefetch, 2),
            threads=min(4, max(prefetch, 1)))

    def indexed_frames(self, start: int = 0, stop: Optional[int] = None,
                       prefetch: int = 4, native: bool = True
                       ) -> Iterator[tuple]:
        """Prefetched iteration with explicit index bookkeeping: yields
        ``(i, frame, None)`` per decoded frame and ``(i, None, errmsg)``
        for a frame that failed to read/decode — so consumers that
        align frames to per-index state (the runner's fault records,
        external ground truth) cannot silently desync the way the
        plain :meth:`frames` skip could. Backed by the same native
        thread pool or Python read-ahead thread as :meth:`frames`."""
        stop = self.frame_count if stop is None else \
            min(stop, self.frame_count)
        if start >= stop:
            return
        it = self._native_frames(start, prefetch) if native else None
        if it is not None:
            # try/finally: an abandoned generator (consumer exception or
            # early break) must still release the pool's threads and ring.
            try:
                for i in range(start, stop):
                    try:
                        yield i, next(it), None
                    except StopIteration:
                        return
                    except IOError as e:
                        yield i, None, str(e)
            finally:
                it.close()
            return
        q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        stop_evt = threading.Event()

        def worker():
            try:
                for i in range(start, stop):
                    if stop_evt.is_set():
                        return
                    try:
                        item = (i, self.frame(i), None)
                    except (IOError, OSError, ValueError) as e:
                        item = (i, None, str(e))
                    if not _bounded_put(q, stop_evt, item):
                        return
            finally:
                _bounded_put(q, stop_evt, None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop_evt.set()

    def _python_frames(self, start: int, prefetch: int
                       ) -> Iterator[np.ndarray]:
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            try:
                for i in range(start, self.frame_count):
                    if stop.is_set():
                        return
                    try:
                        item = self.frame(i)
                    except (IOError, OSError, ValueError):
                        # IOError/OSError: unreadable file; ValueError:
                        # read_bmp decode failure. Skip.
                        continue
                    if not _bounded_put(q, stop, item):
                        return
            finally:
                _bounded_put(q, stop, None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()


class FaultInjector:
    """Wraps a ReplayDataset with seeded fault injection — the testing
    hook the reference lacks (its error path prints and continues with
    empty images, CSensorV.cpp:122-129; GlobalFunction.cpp:3-8).

    ``drop_prob``: frame read raises IOError. ``corrupt_prob``: frame is
    replaced by uniform noise (a decodable-but-garbage capture).
    """

    def __init__(self, dataset: ReplayDataset, drop_prob: float = 0.0,
                 corrupt_prob: float = 0.0, seed: int = 0):
        self.ds = dataset
        self.drop_prob = drop_prob
        self.corrupt_prob = corrupt_prob
        self._rng = np.random.default_rng(seed)
        self.faults: list = []

    def __getattr__(self, name):
        return getattr(self.ds, name)

    def frame(self, i: int) -> np.ndarray:
        u = self._rng.uniform()
        if u < self.drop_prob:
            self.faults.append(("drop", i))
            raise IOError(f"injected fault: dropped frame {i}")
        img = self.ds.frame(i)
        if u < self.drop_prob + self.corrupt_prob:
            self.faults.append(("corrupt", i))
            img = self._rng.integers(0, 256, img.shape,
                                     dtype=np.uint8)
        return img

    def frames(self, start: int = 0, prefetch: int = 4,
               native: bool = False):
        # Sequential (no read-ahead thread or pool) so faults surface in
        # order; ``native`` is accepted for the interface and ignored.
        for i in range(start, self.ds.frame_count):
            yield self.frame(i)

    def indexed_frames(self, start: int = 0, stop: Optional[int] = None,
                       prefetch: int = 4, native: bool = False):
        """Indexed iteration with injected faults surfaced in-band:
        ``(i, None, errmsg)`` for a dropped frame. Sequential, so the
        injected-fault RNG sequence matches per-index :meth:`frame`
        calls exactly. ``native`` is accepted for the interface and
        ignored."""
        stop = self.ds.frame_count if stop is None else \
            min(stop, self.ds.frame_count)
        for i in range(start, stop):
            try:
                yield i, self.frame(i), None
            except (IOError, OSError, ValueError) as e:
                yield i, None, str(e)


def write_replay_dataset(root: str, gray_images: np.ndarray,
                         phase_images: np.ndarray,
                         frames: Optional[np.ndarray] = None,
                         fringe_images: Optional[np.ndarray] = None,
                         config_fields: Optional[dict] = None) -> None:
    """Write image stacks into the reference layout (CSensorV.cpp:35-41),
    creating directories as needed (the role of CStorage's mkdir
    fallback, CStorage.cpp:41-55). ``fringe_images`` adds the
    multi-frequency stack (framework extension).

    Also writes ``manifest.json`` recording the stack shapes (plus any
    ``config_fields``, e.g. gray_bits/phase_steps/resolutions), so
    readers can self-configure instead of relying on matching
    compile-time constants like the reference (StaticParameters.cpp)."""
    os.makedirs(os.path.join(root, "iFrame"), exist_ok=True)
    for i, img in enumerate(gray_images):
        write_bmp(os.path.join(root, "iFrame", f"vGrayCam{i}.bmp"), img)
    for i, img in enumerate(phase_images):
        write_bmp(os.path.join(root, "iFrame", f"vPhaseCam{i}.bmp"), img)
    if fringe_images is not None:
        for i, img in enumerate(fringe_images):
            write_bmp(os.path.join(root, "iFrame", f"vFringeCam{i}.bmp"),
                      img)
    if frames is not None:
        os.makedirs(os.path.join(root, "cFrame"), exist_ok=True)
        for i, img in enumerate(frames):
            write_bmp(os.path.join(root, "cFrame", f"dynaCam{i}.bmp"), img)
    manifest = {
        "gray_count": int(len(gray_images)),
        "phase_count": int(len(phase_images)),
        "fringe_count": (0 if fringe_images is None
                         else int(len(fringe_images))),
        "frame_count": 0 if frames is None else int(len(frames)),
        "cam_h": int(gray_images.shape[1]),
        "cam_w": int(gray_images.shape[2]),
        **(config_fields or {}),
    }
    write_manifest(root, manifest)


def write_anchor_group(root: str, frame_idx: int,
                       gray_images: Optional[np.ndarray] = None,
                       phase_images: Optional[np.ndarray] = None,
                       fringe_images: Optional[np.ndarray] = None
                       ) -> None:
    """Write an absolute pattern group captured at dynamic frame
    ``frame_idx`` into ``aFrame{frame_idx}/`` (framework extension for
    periodic re-anchoring, SURVEY.md §5)."""
    d = os.path.join(root, f"aFrame{frame_idx}")
    os.makedirs(d, exist_ok=True)
    for kind, stack in (("vGrayCam", gray_images),
                        ("vPhaseCam", phase_images),
                        ("vFringeCam", fringe_images)):
        if stack is not None:
            for i, img in enumerate(stack):
                write_bmp(os.path.join(d, f"{kind}{i}.bmp"), img)
