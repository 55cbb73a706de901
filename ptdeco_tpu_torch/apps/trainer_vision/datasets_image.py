"""Vision data pipelines (ImageNet-style), NHWC numpy batches.

Counterpart of ``apps/trainer_vision/datasets_image.py``, with the same
bytes for the same seed and files:

  * train: random-resized crop + horizontal flip + normalize, and an
    optional rotation (a coin flip, uniform(-30, 30) degrees, after the
    normalization so that the fill is normalized zero);
  * val: the shorter side resized to crop / 0.875, a centre crop,
    normalize;
  * one-hot targets; dict batches ``{"inputs", "targets"}`` whose
    ``__len__`` is the batches of an epoch.

Decode and augmentation run on host threads (the native DCT-scaled JPEG
decoder, else PIL) behind a prefetch queue; the epoch shuffle is the
native splitmix64 shuffle (``data/native_packer.shuffle_indices``).
``SyntheticImagePipeline`` yields seeded random images of the same
interface; tests and card runs use it, as there is no ImageNet.  The
trainers turn a batch into NCHW with ``permute(0, 3, 1, 2)``, a view that
is ``channels_last``.  PIL is imported only where an image is decoded or
resized.
"""

from __future__ import annotations

import concurrent.futures
import logging
import pathlib
import queue
import threading
from typing import Any, Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)

# reference datasets_dali.py:66-78
NORMALIZATIONS: dict[str, tuple[list[float], list[float]]] = {
    "imagenet": (
        [0.485 * 255, 0.456 * 255, 0.406 * 255],
        [0.229 * 255, 0.224 * 255, 0.225 * 255],
    ),
    "zero_to_one": ([0.0, 0.0, 0.0], [255.0, 255.0, 255.0]),
    "negative_one_to_one": ([127.5, 127.5, 127.5], [127.5, 127.5, 127.5]),
    "identity": ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),
}


def read_classes_file(fname: str) -> list[tuple[str, int]]:
    """'relative/path.jpg label' per line (DALI file-list format)."""
    out = []
    for line in pathlib.Path(fname).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        path, label = line.rsplit(" ", 1)
        out.append((path, int(label)))
    return out


def _load_image(
    path: pathlib.Path, target_min_side: int = 0
) -> np.ndarray:
    """Decode an image, preferring the native libjpeg path with DCT-domain
    scaling (never materializes full resolution when the augmentation
    target is much smaller — the host-side answer to DALI's GPU decoder,
    reference datasets_dali.py:226-259).  Falls back to PIL with JPEG draft
    mode (same DCT trick), then to a plain PIL decode for non-JPEGs."""
    if target_min_side > 0 and path.suffix.lower() in (".jpg", ".jpeg"):
        from ...data import native_jpeg

        img = native_jpeg.decode(path, target_min_side)
        if img is not None:
            return img
    from PIL import Image

    with Image.open(path) as im:
        if target_min_side > 0 and im.format == "JPEG":
            im.draft("RGB", (target_min_side, target_min_side))
        return np.asarray(im.convert("RGB"))


def _random_resized_crop(
    img: np.ndarray, rng: np.random.RandomState, out_hw: tuple[int, int]
) -> np.ndarray:
    from PIL import Image

    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        cw = int(round(np.sqrt(target_area * ar)))
        ch = int(round(np.sqrt(target_area / ar)))
        if cw <= w and ch <= h:
            x = rng.randint(0, w - cw + 1)
            y = rng.randint(0, h - ch + 1)
            crop = img[y : y + ch, x : x + cw]
            return np.asarray(
                Image.fromarray(crop).resize(
                    (out_hw[1], out_hw[0]), Image.BILINEAR
                )
            )
    # fallback: center crop
    return _center_crop_resize(img, out_hw)


def _rotate_keep_size(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """Bilinear rotation about the image center, keeping the frame size and
    filling exposed corners with 0 — the semantics of the reference's
    optional train-time rotation (datasets_dali.py:260-272: coin-flip 50%,
    uniform(-30, 30) degrees, INTERP_LINEAR, keep_size, fill_value=0,
    applied AFTER normalization so the fill is normalized-zero).  Pure
    numpy inverse-mapping so float32 HWC images rotate without PIL's
    uint8-only multi-channel limitation."""
    h, w = img.shape[:2]
    theta = np.deg2rad(angle_deg)
    c, s = np.cos(theta), np.sin(theta)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.meshgrid(
        np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
        indexing="ij",
    )
    # inverse rotation: output pixel -> source coordinate
    sx = c * (xx - cx) + s * (yy - cy) + cx
    sy = -s * (xx - cx) + c * (yy - cy) + cy
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    im = img.astype(np.float32)

    def tap(yc: np.ndarray, xc: np.ndarray) -> np.ndarray:
        # out-of-bounds taps contribute 0 (per-tap feathering — the
        # zero-padding convention of both DALI's warp and torch
        # grid_sample, so edges blend into the fill instead of cutting)
        inb = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
        val = im[np.clip(yc, 0, h - 1), np.clip(xc, 0, w - 1)]
        return np.where(inb[..., None], val, 0.0)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def _center_crop_resize(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    from PIL import Image

    h, w = img.shape[:2]
    # resize the shorter side to crop/0.875 (the standard 256-for-224 rule,
    # reference datasets_dali.py:209-223) — scaled to the requested crop so
    # >256 outputs (e.g. 384) don't produce negative crop offsets
    target = int(round(min(out_hw) / 0.875))
    scale = target / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    img = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
    y = (nh - out_hw[0]) // 2
    x = (nw - out_hw[1]) // 2
    return img[y : y + out_hw[0], x : x + out_hw[1]]


class ImageNetPipeline:
    """Threaded decode/augment pipeline yielding NHWC float32 batches."""

    def __init__(
        self,
        root_dir: str,
        classes_fname: str,
        batch_size: int,
        normalization: str,
        input_h_w: tuple[int, int],
        training: bool,
        num_classes: int = 1000,
        seed: int = 42,
        num_workers: int = 4,
        prefetch: int = 4,
        use_rotation: bool = False,
    ) -> None:
        self.root = pathlib.Path(root_dir)
        self.entries = read_classes_file(classes_fname)
        self.batch_size = batch_size
        self.mean, self.std = (
            np.asarray(v, np.float32) for v in NORMALIZATIONS[normalization]
        )
        self.input_h_w = tuple(input_h_w)
        self.training = training
        self.num_classes = num_classes
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers
        self.prefetch = prefetch
        # optional train-time rotation (reference datasets_dali.py:145,
        # :260-272 — an attribute there, a constructor knob here)
        self.use_rotation = use_rotation

    def __len__(self) -> int:
        return len(self.entries) // self.batch_size

    def _decode_one(self, entry: tuple[str, int], rng_seed: int) -> np.ndarray:
        path, _ = entry
        # train: DCT-scaled decode to >=2x the crop target keeps full
        # fidelity for crops down to 25% area (random_resized_crop draws
        # RELATIVE areas, so cropping the scaled image is distribution-
        # equivalent); val: match _center_crop_resize's crop/0.875 rule
        # (256 for 224 crops; scales up for larger inputs so the decode
        # never forces an upscale before the crop)
        target = (
            2 * min(self.input_h_w)
            if self.training
            else int(round(min(self.input_h_w) / 0.875))
        )
        img = _load_image(self.root / path, target_min_side=target)
        rng = np.random.RandomState(rng_seed)
        if self.training:
            img = _random_resized_crop(img, rng, self.input_h_w)
            if rng.rand() < 0.5:
                img = img[:, ::-1]
        else:
            img = _center_crop_resize(img, self.input_h_w)
        out = (img.astype(np.float32) - self.mean) / self.std
        if self.training and self.use_rotation and rng.rand() < 0.5:
            out = _rotate_keep_size(out, rng.uniform(-30.0, 30.0))
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        epoch = self.epoch
        # per-epoch shuffle (DALI random_shuffle, reference :202-208)
        if self.training:
            try:
                from ...data import native_packer

                order = native_packer.shuffle_indices(
                    len(self.entries), self.seed + self.epoch
                )
            except Exception:
                order = np.random.RandomState(self.seed + self.epoch).permutation(
                    len(self.entries)
                )
        else:
            order = np.arange(len(self.entries))
        self.epoch += 1

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure: list[BaseException] = []

        def producer() -> None:
            try:
                _produce()
            except BaseException as e:  # surfaced to the consumer
                failure.append(e)
            while not stop.is_set():
                try:
                    q.put(None, timeout=0.25)
                    break
                except queue.Full:
                    continue

        def _produce() -> None:
            with concurrent.futures.ThreadPoolExecutor(self.num_workers) as ex:
                for b in range(len(self)):
                    if stop.is_set():
                        break
                    idx = order[b * self.batch_size : (b + 1) * self.batch_size]
                    entries = [self.entries[int(i)] for i in idx]
                    # fold the epoch in so augmentations differ per epoch
                    # (RandomState seeds must fit uint32)
                    seeds = [
                        ((self.seed + epoch * 7_919) * 1_000_003 + int(i))
                        % (2**32)
                        for i in idx
                    ]
                    imgs = list(ex.map(self._decode_one, entries, seeds))
                    labels = np.asarray([e[1] for e in entries], np.int32)
                    onehot = np.zeros(
                        (len(labels), self.num_classes), np.float32
                    )
                    onehot[np.arange(len(labels)), labels] = 1.0
                    item = {"inputs": np.stack(imgs), "targets": onehot}
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.25)
                            break
                        except queue.Full:
                            continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=1.0)
                except queue.Empty:
                    if not t.is_alive():
                        break
                    continue
                if item is None:
                    break
                yield item
            if failure:
                raise RuntimeError(
                    "image pipeline producer failed"
                ) from failure[0]
        finally:
            stop.set()


class SyntheticImagePipeline:
    """In-memory random-image pipeline with the same interface (tests)."""

    def __init__(
        self,
        batch_size: int,
        input_h_w: tuple[int, int] = (224, 224),
        num_classes: int = 1000,
        n_batches: int = 8,
        seed: int = 0,
        rank: Optional[int] = None,
    ) -> None:
        self.batch_size = batch_size
        self.input_h_w = tuple(input_h_w)
        self.num_classes = num_classes
        self.n_batches = n_batches
        self.seed = seed
        self.rank = rank  # if set, inputs confined to a low-rank channel space

    def __len__(self) -> int:
        return self.n_batches

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        h, w = self.input_h_w
        for _ in range(self.n_batches):
            x = rng.randn(self.batch_size, h, w, 3).astype(np.float32)
            labels = rng.randint(0, self.num_classes, self.batch_size)
            onehot = np.zeros((self.batch_size, self.num_classes), np.float32)
            onehot[np.arange(self.batch_size), labels] = 1.0
            yield {"inputs": x, "targets": onehot}


def infinite(pipeline: Any) -> Iterator[dict[str, np.ndarray]]:
    while True:
        yield from pipeline


def make_imagenet_pipelines(
    *,
    imagenet_root_dir: str,
    trn_imagenet_classes_fname: str,
    val_imagenet_classes_fname: str,
    batch_size: int,
    normalization: str,
    input_h_w: tuple[int, int],
    num_classes: int = 1000,
    seed: int = 42,
    use_rotation: bool = False,
) -> tuple[ImageNetPipeline, ImageNetPipeline]:
    """Train/val pipeline pair (reference make_imagenet_pipelines).

    ``num_classes`` sets the one-hot width (reference hardcodes 1000,
    datasets_dali.py:298,323 — here the drivers pass the class count of
    the actual model so HF-snapshot models with arbitrary ``num_labels``
    train/eval correctly)."""
    train = ImageNetPipeline(
        imagenet_root_dir,
        trn_imagenet_classes_fname,
        batch_size,
        normalization,
        input_h_w,
        training=True,
        num_classes=num_classes,
        seed=seed,
        use_rotation=use_rotation,
    )
    val = ImageNetPipeline(
        imagenet_root_dir,
        val_imagenet_classes_fname,
        batch_size,
        normalization,
        input_h_w,
        training=False,
        num_classes=num_classes,
        seed=seed,
    )
    return train, val
