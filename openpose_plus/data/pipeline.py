"""Host input pipeline: decode + augment workers feeding the device.

Replaces the reference's tf.data.Dataset.from_generator + py_func map
(train.py [HIGH; empty mount — SURVEY.md §2 "tf.data pipeline"]). Heavy GT
synthesis happens ON DEVICE (data/targets.py, inside the jit'd step), so
host workers only decode JPEGs and apply one affine warp per sample; a
bounded queue of ready batches gives back-pressure, and jax.device_put
overlaps H2D with compute (double-buffering via the queue depth).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from openpose_plus.config import Config
from openpose_plus.data import augment as A
from openpose_plus.data.coco import CocoPoseDataset, pad_keypoints

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _load_image(path: str) -> np.ndarray:
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class TrainPipeline:
    """Infinite shuffled batch stream: {'images', 'keypoints', 'mask'}.

    images:    (B, hin, win, 3) uint8 — or the model's space-to-depth
               input layout ((B, hin/2, win/2, 12) / (B, hin/4, win/4, 48))
               when its stem consumes one: the workers permute the bytes
               on the host, saving the train step ~1.2 ms/step of
               on-device relayout copies (measured in a device trace;
               docs/ARCHITECTURE.md). Keypoint coords are unaffected
               (they live in network-input pixel space, not the layout).
    keypoints: (B, max_people, 18, 3) float32, network-input pixel coords
    mask:      (B, hout, wout, 1) float32 loss mask
    """

    def __init__(self, dataset: CocoPoseDataset, config: Config,
                 seed: int = 0, num_workers: Optional[int] = None,
                 max_people: int = 32, with_replacement: bool = False,
                 shard_index: int = 0, shard_count: int = 1,
                 cache_decoded: bool = False):
        self.ds = dataset
        self.cfg = config
        self.max_people = max_people
        # cache_decoded: keep decoded RGB frames in RAM keyed by sample
        # index (small benchmark banks revisit every image hundreds of
        # times; JPEG decode would otherwise dominate the 2-core host).
        # Augmentation still runs per draw — only the decode is cached.
        self._img_cache: Optional[dict[int, np.ndarray]] = (
            {} if cache_decoded else None)
        self._img_cache_lock = threading.Lock()
        self.seed = seed
        self.num_workers = num_workers or config.data.num_workers
        self.with_replacement = with_replacement
        self._q: queue.Queue = queue.Queue(maxsize=config.data.prefetch)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # Layout of the TRAIN model's stem (train_lowering: e.g. vgg19
        # trains with the plain stem even though it serves s2d).
        self.s2d = config.model.train_lowering().preferred_input_layout()
        if self.s2d:
            from openpose_plus import native

            self._pack = (native.s2d2_u8 if self.s2d == 2
                          else native.s2d_u8)
        else:
            self._pack = lambda a: a
        self._started = False
        self._error: Optional[BaseException] = None
        self._bad_paths: set[str] = set()
        # Multi-host: rank-strided shard of the sample indices (the
        # reference's dataset.shard(cluster_size, rank)). Shards are
        # disjoint by construction, so a global epoch sees every sample
        # exactly once across hosts; each host shuffles only its shard.
        self._shard = (shard_index, shard_count)
        self._indices = np.arange(shard_index, len(dataset), shard_count)
        if len(self._indices) == 0:
            raise ValueError(
                f"shard {shard_index}/{shard_count} of a {len(dataset)}-"
                f"sample dataset is empty")
        # shared shuffled-epoch cursor (reference shuffle+repeat semantics:
        # every sample seen once per epoch, new permutation each epoch)
        self._epoch_lock = threading.Lock()
        self._epoch_rng = np.random.default_rng(seed)
        self._perm = self._indices[
            self._epoch_rng.permutation(len(self._indices))]
        self._cursor = 0

    def _draw_indices(self, n: int, rng: np.random.Generator) -> np.ndarray:
        if self.with_replacement:
            return self._indices[rng.integers(0, len(self._indices), size=n)]
        out = np.empty(n, np.int64)
        with self._epoch_lock:
            for i in range(n):
                if self._cursor >= len(self._perm):
                    self._perm = self._indices[
                        self._epoch_rng.permutation(len(self._indices))]
                    self._cursor = 0
                out[i] = self._perm[self._cursor]
                self._cursor += 1
        return out

    # --------------------------------------------------------- workers ---

    def _worker(self, wid: int) -> None:
        rng = np.random.default_rng(self.seed * 1000 + wid)
        m = self.cfg.model
        b = self.cfg.train.batch_size
        consecutive_skips = 0
        while not self._stop.is_set():
            images, kps, masks = [], [], []
            while len(images) < b and not self._stop.is_set():
                i = int(self._draw_indices(1, rng)[0])
                s = self.ds[i]
                try:
                    if self._img_cache is not None:
                        with self._img_cache_lock:
                            img = self._img_cache.get(i)
                        if img is None:
                            img = _load_image(s.image_path)
                            with self._img_cache_lock:
                                self._img_cache[i] = img
                    else:
                        img = _load_image(s.image_path)
                    consecutive_skips = 0
                except Exception as e:
                    # one bad file must not kill the worker (and, once all
                    # workers are dead, hang training on q.get() forever):
                    # warn once per path and draw a different sample — but
                    # if NOTHING is readable, fail loudly instead of
                    # spinning forever
                    if s.image_path not in self._bad_paths:
                        self._bad_paths.add(s.image_path)
                        import logging

                        logging.getLogger(__name__).warning(
                            "skipping unreadable sample %s: %s",
                            s.image_path, e)
                    consecutive_skips += 1
                    if consecutive_skips > max(4 * len(self._indices), 64):
                        self._error = RuntimeError(
                            f"{consecutive_skips} consecutive unreadable "
                            f"samples — is the image dir correct?")
                        self._stop.set()
                        return
                    continue
                try:
                    aug = A.augment_sample(img, s.keypoints, s.ignore_mask(),
                                           self.cfg.data, m.hin, m.win, rng)
                    images.append(self._pack(aug.image))
                    kps.append(pad_keypoints(aug.keypoints, self.max_people))
                    small = cv2.resize(aug.mask, (m.wout, m.hout),
                                       interpolation=cv2.INTER_AREA)
                    masks.append((small > 0.5).astype(np.float32)[..., None])
                except Exception:
                    # augmentation bugs are NOT data problems — surface
                    # them to the consumer instead of dying silently
                    import sys

                    self._error = sys.exc_info()[1]
                    self._stop.set()
                    return
            if self._stop.is_set():
                return
            batch = {
                "images": np.stack(images),
                "keypoints": np.stack(kps),
                "mask": np.stack(masks),
            }
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for w in range(self.num_workers):
            t = threading.Thread(target=self._worker, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()

    def __iter__(self) -> Iterator[dict]:
        self.start()
        while True:
            try:
                yield self._q.get(timeout=5.0)
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError(
                        "pipeline worker failed") from self._error
                if not any(t.is_alive() for t in self._threads):
                    raise RuntimeError(
                        "all pipeline workers exited; no batches coming")
