"""Stream mode: pipelined decode feeding the one-jit engine.

Rebuild of the reference's stream detector (SURVEY.md §3.5:
three host threads — decode, TensorRT, PAF+draw — chained by bounded
channels). Here the DNN and the grouping are a single device program, so
only decode/letterbox remains on the host: the native C++ loader
(native.py) produces uint8 batches behind a bounded channel, and JAX's
async dispatch double-buffers H2D against device compute. Sustained
throughput = max(host decode rate, device rate) — the same law as the
reference's pipeline but with one stage fewer.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from openpose_plus.engine import Engine
from openpose_plus.postproc import HumanBatch


@dataclasses.dataclass
class StreamResult:
    indices: np.ndarray        # (n,) source frame indices
    humans: HumanBatch         # device results for the batch (n rows valid)
    scales: np.ndarray         # (n,) letterbox scale per frame
    pads: np.ndarray           # (n, 2) letterbox pads per frame
    n: int


class StreamEstimator:
    """Sustained-throughput pose estimation over an image/frame stream."""

    def __init__(self, engine: Engine, batch: int = 8, workers: int = 8,
                 queue_capacity: int = 4):
        self.engine = engine
        self.batch = batch
        self.workers = workers
        self.queue_capacity = queue_capacity
        # Feed the engine its space-to-depth input layout when the model
        # supports it (MobileNet-thin s2d stem): the host permutes bytes
        # during letterbox, the device skips the stem relayout. Level 2
        # (dims % 4 == 0) additionally runs the whole stride-2 region as
        # dense block-grid convs (deep-s2d lowering, models/common.py).
        self.s2d = engine.config.model.preferred_input_layout()

    def run_files(self, paths: Sequence[str], loop: bool = False
                  ) -> Iterator[StreamResult]:
        """Stream image files through the native loader + engine."""
        from openpose_plus import native

        m = self.engine.config.model
        loader = native.NativeStreamLoader(
            paths, m.hin, m.win, batch=self.batch, workers=self.workers,
            queue_capacity=self.queue_capacity, loop=loop, s2d=self.s2d)
        try:
            yield from self._run(iter(loader))
        finally:
            loader.close()

    def run_frames(self, frames: Iterable[np.ndarray]) -> Iterator[StreamResult]:
        """Stream in-memory RGB frames (camera/video source)."""
        from openpose_plus import native

        m = self.engine.config.model

        def batcher():
            images, scales, pads, idx = [], [], [], []
            for i, frame in enumerate(frames):
                if native.is_available():
                    img, s, p = native.letterbox(frame, m.hin, m.win)
                else:
                    from openpose_plus.data.augment import letterbox
                    img, s, p = letterbox(frame, m.hin, m.win)
                if self.s2d == 2:
                    img = native.s2d2_u8(img)
                elif self.s2d == 1:
                    img = native.s2d_u8(img)
                images.append(img)
                scales.append(s)
                pads.append(p)
                idx.append(i)
                if len(images) == self.batch:
                    yield {"images": np.stack(images),
                           "scales": np.asarray(scales, np.float32),
                           "pads": np.asarray(pads, np.float32),
                           "indices": np.asarray(idx, np.int32)}
                    images, scales, pads, idx = [], [], [], []
            if images:
                yield {"images": np.stack(images),
                       "scales": np.asarray(scales, np.float32),
                       "pads": np.asarray(pads, np.float32),
                       "indices": np.asarray(idx, np.int32)}

        yield from self._run(batcher())

    def run_video(self, path: str) -> Iterator[StreamResult]:
        """Stream a video file (cv2.VideoCapture decode on host)."""
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(path)

        def frames():
            while True:
                ok, frame = cap.read()
                if not ok:
                    return
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

        try:
            yield from self.run_frames(frames())
        finally:
            # release even when the consumer stops early or the engine
            # raises mid-stream (generator close runs this finally)
            cap.release()

    # ------------------------------------------------------------------ --

    def _run(self, batches: Iterator[dict]) -> Iterator[StreamResult]:
        """Keep one batch in flight: device computes batch N while the host
        decodes N+1 (double buffering via async dispatch)."""
        pending: Optional[tuple[dict, HumanBatch]] = None
        for batch in batches:
            images = batch["images"]
            n = images.shape[0]
            if n < self.batch:  # pad the tail batch to the compiled shape
                padded = np.zeros((self.batch,) + images.shape[1:], np.uint8)
                padded[:n] = images
                images = padded
            humans = self.engine.infer(images)  # async dispatch
            if pending is not None:
                yield self._materialize(*pending)
            pending = (batch, humans)
        if pending is not None:
            yield self._materialize(*pending)

    @staticmethod
    def _materialize(batch: dict, humans: HumanBatch) -> StreamResult:
        import jax

        jax.block_until_ready(humans)
        return StreamResult(indices=batch["indices"], humans=humans,
                            scales=batch["scales"], pads=batch["pads"],
                            n=batch["indices"].shape[0])


def benchmark_stream(engine: Engine, paths: Sequence[str], n_batches: int = 20,
                     batch: int = 8) -> dict:
    """Sustained FPS over a looped file stream (BASELINE config #4)."""
    est = StreamEstimator(engine, batch=batch)
    it = est.run_files(paths, loop=True)
    next(it)  # warmup: compile + fill queues
    t0 = time.perf_counter()
    frames = 0
    for _ in range(n_batches):
        r = next(it)
        frames += r.n
    dt = time.perf_counter() - t0
    return {"fps": frames / dt, "frames": frames, "seconds": dt}
