"""YOLO-format dataset with a label cache, rect batches and host augmentation
(mosaic, mixup, the affine/perspective warp, HSV, flips), and a threaded batch
loader.

Port of ``skyeye_tpu/data/dataset.py``:

  * image discovery from a dir, a glob or a list file (``find_images``) and the
    images/ -> labels/ mapping (``img2label_paths``);
  * label verification that drops corrupt files (``verify_image_label``, on
    ``imageio.image_size`` where JAX opens the file with PIL);
  * the label cache at ``<labels dir>.cache``, keyed by a hash of sizes and
    paths; the port writes JSON under its own version string, so neither
    package reads the other's cache: each rebuilds it;
  * rect batches by aspect ratio, bucketed to ``shape_buckets`` shapes (not
    with ``augment``, as in JAX);
  * decode (``imageio.imread``) and the pre-resize of the longest side to
    ``img_size`` (``resize_linear`` when augmenting or enlarging, else
    ``resize_area``), then the host ``letterbox``;
  * with ``augment``, JAX's item: a 4-image mosaic with probability
    ``hyp["mosaic"]`` (then mixup of a second mosaic with probability
    ``hyp["mixup"]``), else the letterbox and the warp; then HSV and the flips
    (``data/augment.py``, OpenCV's pixels without OpenCV);
  * ``BatchLoader``: fixed-shape batch dicts {images (B, H, W, 3) uint8 RGB,
    targets (B, M, 6), mask (B, M), n_valid, indices}, assembled by a thread
    pool ahead of the consumer; a short last batch is padded by repeating its
    images, as JAX pads it (only ``n_valid`` rows count); with ``shuffle`` the
    order is JAX's (``np.random.default_rng(seed)`` shuffles once an epoch);
    ``InfiniteBatchLoader`` runs epoch after epoch. In a data-parallel run
    (``rank``, ``world``) every rank shuffles the global order and takes every
    item's draws, and assembles only its share of each global batch (rows
    ``rank * B / world`` on, wrap-around copies included); the ranks' shares,
    concatenated, are the single-process batch, and ``n_valid`` counts the
    global batch's valid rows.

An item is drawn, then rendered: ``AerialDataset.draw`` takes every random
number the item needs (they never depend on pixels) from the dataset's
generators in JAX's order, and ``render`` does the pixel work from them.
``dataset[i]`` is ``render(draw(i))``. The loader draws the items in order
on one thread and renders them on its workers, so its batches are the same
for any number of workers, and equal JAX's with one worker (JAX's workers
share one generator, so with more than one its draws follow thread timing).

JAX's native C++ decode path for square batches is not ported (ROADMAP.md);
this is JAX's Python path.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config import DEFAULT_HYP
from ..ops.letterbox import letterbox
from ..utils.general import LOGGER
from .augment import (
    apply_hsv, blend, build_affine_matrix, flip_lr, flip_ud, hsv_gains, warp_with_matrix,
    xywhn_to_xyxy, xyxy_to_xywhn,
)
from .imageio import image_size, imread, resize_area, resize_linear

IMG_FORMATS = ("bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp")
VID_FORMATS = ("asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv")
CACHE_VERSION = "skyeye_tpu_torch-0.1"


def img2label_paths(img_paths: Sequence[str]) -> List[str]:
    """images/ -> labels/, .ext -> .txt."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(p.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for p in img_paths]


def get_hash(paths: Sequence[str]) -> str:
    """md5 of the total size and the joined paths."""
    size = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
    h = hashlib.md5(str(size).encode())
    h.update("".join(paths).encode())
    return h.hexdigest()


def find_images(path) -> List[str]:
    """Images in a dir (recursively), a glob, a list file, or a list of these."""
    files: List[str] = []
    for p in path if isinstance(path, (list, tuple)) else [path]:
        p = Path(p)
        if p.is_dir():
            files += [str(f) for f in sorted(p.rglob("*.*"))]
        elif p.is_file():
            if p.suffix == ".txt":
                root = p.parent
                for line in p.read_text().splitlines():
                    line = line.strip()
                    if not line:
                        continue
                    files.append(str((root / line).resolve()) if line.startswith("./") else line)
            else:
                files.append(str(p))
        else:
            import glob as _glob

            files += sorted(_glob.glob(str(p), recursive=True))
    return sorted(f for f in files if f.rsplit(".", 1)[-1].lower() in IMG_FORMATS)


def verify_image_label(args) -> Tuple[Optional[str], Optional[np.ndarray],
                                      Optional[Tuple[int, int]], int, int, int, str]:
    """Verify one (image, label) pair. Returns
    (img_file, labels (n, 5), (w, h), n_found, n_missing, n_corrupt, msg)."""
    img_file, label_file = args
    try:
        shape = image_size(img_file)  # (w, h)
        if shape[0] < 10 or shape[1] < 10:
            raise ValueError(f"image too small {shape}")

        if os.path.isfile(label_file):
            with open(label_file) as f:
                rows = [x.split() for x in f.read().strip().splitlines() if len(x)]
            labels = np.array(rows, dtype=np.float32) if rows else np.zeros((0, 5), np.float32)
            if len(labels):
                # segment polygons: class + >= 8 coordinates -> the polygon's box
                if labels.shape[1] > 5:
                    boxes = []
                    for r in labels:
                        xs, ys = r[1::2], r[2::2]
                        boxes.append([r[0], (xs.min() + xs.max()) / 2, (ys.min() + ys.max()) / 2,
                                      xs.max() - xs.min(), ys.max() - ys.min()])
                    labels = np.array(boxes, np.float32)
                if labels.shape[1] != 5:
                    raise ValueError(f"labels require 5 columns, got {labels.shape[1]}")
                if (labels < 0).any() or (labels[:, 1:] > 1).any():
                    raise ValueError("non-normalized or negative label coordinates")
                labels = np.unique(labels, axis=0)
            return img_file, labels, shape, 1 if len(labels) else 0, 0 if len(labels) else 1, 0, ""
        return img_file, np.zeros((0, 5), np.float32), shape, 0, 1, 0, ""
    except Exception as e:  # a corrupt image or label file is counted and dropped
        return None, None, None, 0, 0, 1, f"ignoring corrupt image/label {img_file}: {e}"


class AerialDataset:
    """Map-style YOLO dataset with caching and mosaic/mixup/affine/HSV augmentation.

    ``__getitem__`` returns (img (H, W, 3) uint8 BGR letterboxed, labels (n, 5)
    [cls, x, y, w, h] normalized to the output canvas).
    """

    def __init__(
        self,
        path,
        img_size: int = 640,
        batch_size: int = 16,
        augment: bool = False,
        hyp: Optional[Dict[str, float]] = None,
        rect: bool = False,
        stride: int = 32,
        pad: float = 0.0,
        cache_images: bool = False,
        max_labels: int = 300,
        seed: int = 0,
        shape_buckets: Optional[int] = None,
    ):
        self.img_size = img_size
        self.augment = augment
        self.hyp = dict(DEFAULT_HYP)
        if hyp:
            self.hyp.update(hyp)
        self.rect = rect and not augment
        self.stride = stride
        self.pad = pad
        self.shape_buckets = shape_buckets
        self.max_labels = max_labels
        self.mosaic = augment and self.hyp.get("mosaic", 0) > 0
        self.mosaic_border = (-img_size // 2, -img_size // 2)
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)

        self.img_files = find_images(path)
        if not self.img_files:
            raise FileNotFoundError(f"no images found in {path}")
        self.label_files = img2label_paths(self.img_files)

        cache = self._load_or_build_cache()
        # corrupt files are not in the cache: drop them (on a cache hit too, where
        # JAX's dataset looks them up and raises a KeyError)
        keep = [i for i, f in enumerate(self.img_files) if f in cache]
        if len(keep) < len(self.img_files):
            LOGGER.warning("dropped %d corrupt images", len(self.img_files) - len(keep))
            self.img_files = [self.img_files[i] for i in keep]
            self.label_files = [self.label_files[i] for i in keep]
        self.labels = [cache[f][0] for f in self.img_files]
        self.shapes = np.array([cache[f][1] for f in self.img_files], np.float64)  # (w, h)
        n = len(self.img_files)
        self.n = n
        self.indices = np.arange(n)
        self.batch_index = np.floor(np.arange(n) / batch_size).astype(int)

        if self.rect:
            self._setup_rect_batches(batch_size)

        self.ims: List[Optional[np.ndarray]] = [None] * n
        self.im_hw0: List[Optional[Tuple[int, int]]] = [None] * n
        self.im_hw: List[Optional[Tuple[int, int]]] = [None] * n
        if cache_images:
            with ThreadPoolExecutor(8) as ex:
                for i, (im, hw0, hw) in enumerate(ex.map(self._load_image_raw, range(n))):
                    self.ims[i], self.im_hw0[i], self.im_hw[i] = im, hw0, hw

    # -- caching ---------------------------------------------------------------

    def _cache_path(self) -> Path:
        lbl = Path(self.label_files[0])
        return (lbl.parent if lbl.parent.exists() else Path(self.img_files[0]).parent
                ).with_suffix(".cache")

    def _load_or_build_cache(self) -> Dict:
        cache_path = self._cache_path()
        want_hash = get_hash(self.label_files + self.img_files)
        if cache_path.is_file():
            try:
                data = json.loads(cache_path.read_text())
            except (ValueError, UnicodeDecodeError):  # another writer's cache
                data = None
            if isinstance(data, dict) and data.get("version") == CACHE_VERSION \
                    and data.get("hash") == want_hash:
                return {f: (np.array(lb, np.float32).reshape(-1, 5), tuple(shape))
                        for f, (lb, shape) in data["items"].items()}

        items: Dict = {}
        nf = nm = nc = 0
        with ThreadPoolExecutor(8) as ex:
            for img, labels, shape, f, m, c, msg in ex.map(
                verify_image_label, zip(self.img_files, self.label_files)
            ):
                nf += f
                nm += m
                nc += c
                if msg:
                    LOGGER.warning(msg)
                if img is not None:
                    items[img] = (labels, shape)
        LOGGER.info("dataset scan: %d labeled, %d background, %d corrupt", nf, nm, nc)
        payload = {"version": CACHE_VERSION, "hash": want_hash,
                   "items": {f: (lb.tolist(), list(shape)) for f, (lb, shape) in items.items()}}
        tmp = cache_path.with_name(cache_path.name + f".{os.getpid()}.tmp")
        try:
            tmp.write_text(json.dumps(payload))
            os.replace(tmp, cache_path)
        except OSError as e:
            LOGGER.warning("cache not saved: %s", e)
        return items

    # -- rect batching ------------------------------------------------------------

    def _setup_rect_batches(self, batch_size: int):
        ar = self.shapes[:, 1] / self.shapes[:, 0]  # h / w
        order = ar.argsort()
        self.img_files = [self.img_files[i] for i in order]
        self.label_files = [self.label_files[i] for i in order]
        self.labels = [self.labels[i] for i in order]
        self.shapes = self.shapes[order]
        ar = ar[order]

        nb = self.batch_index[-1] + 1
        shapes = []
        for i in range(nb):
            ari = ar[self.batch_index == i]
            mini, maxi = ari.min(), ari.max()
            if maxi < 1:
                shapes.append([maxi, 1])
            elif mini > 1:
                shapes.append([1, 1 / mini])
            else:
                shapes.append([1, 1])
        self.batch_shapes = (
            np.ceil(np.array(shapes) * self.img_size / self.stride + self.pad).astype(int)
            * self.stride
        )
        if self.shape_buckets:
            # at most shape_buckets distinct shapes: round them UP (padding only,
            # never a crop) on a coarser and coarser stride grid. JAX bounds its
            # compiles this way; the port keeps it so that batches have JAX's
            # shapes, and so its detections
            q = self.stride
            quant = self.batch_shapes
            while len({tuple(s) for s in quant.tolist()}) > self.shape_buckets:
                q *= 2
                quant = (np.ceil(self.batch_shapes / q) * q).astype(int)
            self.batch_shapes = quant

    # -- image IO -------------------------------------------------------------------

    def _load_image_raw(self, i: int):
        """Decode, then bring the longest side to img_size (aspect kept)."""
        im = self.ims[i]
        if im is not None:
            return im, self.im_hw0[i], self.im_hw[i]
        im = imread(self.img_files[i])
        h0, w0 = im.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            resize = resize_linear if (self.augment or r > 1) else resize_area
            im = resize(im, (int(w0 * r), int(h0 * r)))
        return im, (h0, w0), im.shape[:2]

    # -- draws ----------------------------------------------------------------------------

    def _affine_draws(self, width: int, height: int, border=(0, 0)):
        hyp = self.hyp
        return build_affine_matrix(width, height, hyp["degrees"], hyp["translate"],
                                   hyp["scale"], hyp["shear"], hyp["perspective"], border,
                                   self.rng)

    def _mosaic_draws(self, index: int) -> Dict:
        s = self.img_size
        yc = int(self.rng.uniform(-self.mosaic_border[0], 2 * s + self.mosaic_border[0]))
        xc = int(self.rng.uniform(-self.mosaic_border[1], 2 * s + self.mosaic_border[1]))
        indices = [index] + [self.rng.randrange(self.n) for _ in range(3)]
        return {"xc": xc, "yc": yc, "indices": indices,
                "affine": self._affine_draws(2 * s, 2 * s, self.mosaic_border)}

    def draw(self, index: int) -> Dict:
        """Every random number item ``index`` takes, in JAX's order: the mosaic
        coin; the mosaic's centre, indices and warp (or the warp of the
        letterboxed frame); the mixup coin, index, mosaic and Beta(8, 8) ratio;
        HSV's gains; the two flip coins. Without ``augment``, none."""
        d: Dict = {"index": int(self.indices[index])}
        if not self.augment:
            return d
        hyp = self.hyp
        if self.mosaic and self.rng.random() < hyp["mosaic"]:
            d["mosaic"] = self._mosaic_draws(d["index"])
            if self.rng.random() < hyp["mixup"]:
                d["mixup"] = self._mosaic_draws(self.rng.randrange(self.n))
                d["mixup_ratio"] = self.np_rng.beta(8.0, 8.0)
        else:
            d["affine"] = self._affine_draws(self.img_size, self.img_size)
        d["hsv"] = hsv_gains(hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"], rng=self.rng)
        d["flipud"] = self.rng.random() < hyp["flipud"]
        d["fliplr"] = self.rng.random() < hyp["fliplr"]
        return d

    # -- mosaic -----------------------------------------------------------------------------

    def _render_mosaic(self, d: Dict) -> Tuple[np.ndarray, np.ndarray]:
        """The 2s x 2s canvas at 114 with four frames about (xc, yc), then its warp;
        labels xyxy pixels."""
        s, xc, yc = self.img_size, d["xc"], d["yc"]
        canvas = np.full((s * 2, s * 2, 3), 114, np.uint8)
        all_labels = []
        for i, idx in enumerate(d["indices"]):
            img, _, (h, w) = self._load_image_raw(idx)
            if i == 0:  # top-left
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
            elif i == 1:  # top-right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
            elif i == 2:  # bottom-left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
            else:  # bottom-right
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b

            labels = self.labels[idx]
            if len(labels):
                all_labels.append(xywhn_to_xyxy(labels, w, h, padw, padh))
        labels4 = (np.concatenate(all_labels, 0) if all_labels
                   else np.zeros((0, 5), np.float32))
        np.clip(labels4[:, 1:], 0, 2 * s, out=labels4[:, 1:])
        M, scale = d["affine"]
        return warp_with_matrix(canvas, labels4, M, scale, self.hyp["perspective"],
                                self.mosaic_border)

    # -- item -------------------------------------------------------------------------

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.render(self.draw(index))

    def render(self, d: Dict) -> Tuple[np.ndarray, np.ndarray]:
        """The item for the draws ``d`` (``draw``): its pixels and labels."""
        if "mosaic" in d:
            img, labels_xyxy = self._render_mosaic(d["mosaic"])
            if "mixup" in d:
                img2, labels2 = self._render_mosaic(d["mixup"])
                img = blend(img, img2, d["mixup_ratio"])
                labels_xyxy = np.concatenate([labels_xyxy, labels2], 0)
        else:
            index = d["index"]
            img, (h0, w0), (h, w) = self._load_image_raw(index)
            shape = (self.batch_shapes[self.batch_index[index]] if self.rect
                     else (self.img_size, self.img_size))
            img, ratio, pad = letterbox(img, tuple(shape), auto=False, scaleup=self.augment)
            labels = self.labels[index]
            labels_xyxy = (xywhn_to_xyxy(labels, ratio[0] * w, ratio[1] * h, pad[0], pad[1])
                           if len(labels) else np.zeros((0, 5), np.float32))
            if "affine" in d:
                M, scale = d["affine"]
                img, labels_xyxy = warp_with_matrix(img, labels_xyxy, M, scale,
                                                    self.hyp["perspective"])
        h, w = img.shape[:2]
        labels = xyxy_to_xywhn(labels_xyxy, w, h)  # xyxy pixels -> xywh normalized

        if self.augment:
            img = apply_hsv(img, d["hsv"])
            if d["flipud"]:
                img, labels = flip_ud(img, labels)
            if d["fliplr"]:
                img, labels = flip_lr(img, labels)
        return np.ascontiguousarray(img), labels

    def padded_labels(self, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(n, 5) -> fixed (max_labels, 6) [img=0, cls, xywh] + mask."""
        out = np.zeros((self.max_labels, 6), np.float32)
        mask = np.zeros((self.max_labels,), bool)
        n = min(len(labels), self.max_labels)
        if n:
            out[:n, 1:] = labels[:n]
            mask[:n] = True
        return out, mask


class BatchLoader:
    """Threaded loader of fixed-shape batch dicts, ``prefetch`` batches ahead."""

    def __init__(
        self,
        dataset: AerialDataset,
        batch_size: int = 16,
        shuffle: bool = False,
        workers: int = 4,
        prefetch: int = 2,
        drop_last: bool = False,
        seed: int = 0,
        bgr_to_rgb: bool = True,
        rank: int = 0,
        world: int = 1,
    ):
        if batch_size % world:
            raise ValueError(f"global batch {batch_size} not divisible by data axis {world}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.local_batch = batch_size // world
        self.shuffle = shuffle
        self.workers = workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.bgr_to_rgb = bgr_to_rgb
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def _item(self, draws: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        img, labels = self.dataset.render(draws)
        if self.bgr_to_rgb:
            img = img[:, :, ::-1]
        t, m = self.dataset.padded_labels(labels)
        return np.ascontiguousarray(img), t, m

    def _rows(self, n_valid: int) -> List[int]:
        """The items (positions in a global batch of ``n_valid`` items) of this
        rank's rows. A short last batch is filled with its own items again (JAX
        keeps one compiled shape this way); consumers read only the n_valid
        first rows of the global batch."""
        lo = self.rank * self.local_batch
        return [j if j < n_valid else (j - n_valid) % n_valid
                for j in range(lo, lo + self.local_batch)]

    def _assemble(self, idxs: Sequence[int], rows: List[int], futures) -> Dict[str, np.ndarray]:
        items = {k: f.result() for k, f in futures.items()}
        imgs, tgts, masks = zip(*(items[k] for k in rows))
        n_valid = len(idxs)
        lo = self.rank * self.local_batch
        return {
            "images": np.stack(imgs),
            "targets": np.stack(tgts),
            "mask": np.stack(masks),
            "n_valid": np.asarray(n_valid, np.int32),
            "indices": np.asarray([idxs[k] if lo + j < n_valid else -1
                                   for j, k in enumerate(rows)]),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        self.epoch += 1
        batches = [order[i: i + self.batch_size] for i in range(0, n, self.batch_size)]
        if self.drop_last and len(batches[-1]) < self.batch_size:
            batches = batches[:-1]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        err: list = []
        closed = threading.Event()  # the consumer let go: the producer stops early

        def put(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            # items are drawn here, in order, and rendered on the workers; a batch's
            # frames are spread over the workers and submitted at most
            # prefetch + 1 batches ahead of the queue, so the host holds a bounded
            # number of decoded frames. Every item of the global batch is drawn (the
            # draws are one stream); only this rank's rows are rendered
            ex = ThreadPoolExecutor(self.workers)
            try:
                pending: Deque = deque()
                for idxs in batches:
                    draws = [self.dataset.draw(i) for i in idxs]
                    rows = self._rows(len(idxs))
                    pending.append((idxs, rows, {k: ex.submit(self._item, draws[k])
                                                 for k in dict.fromkeys(rows)}))
                    if len(pending) > self.prefetch and (
                            closed.is_set() or not put(self._assemble(*pending.popleft()))):
                        return
                while pending:
                    if closed.is_set() or not put(self._assemble(*pending.popleft())):
                        return
            except Exception as e:  # raised again on the consumer's side
                err.append(e)
            finally:
                ex.shutdown(cancel_futures=closed.is_set())
                put(stop)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            closed.set()


def create_dataloader(
    path,
    img_size: int = 640,
    batch_size: int = 16,
    stride: int = 32,
    augment: bool = False,
    hyp: Optional[Dict[str, float]] = None,
    rect: bool = False,
    pad: float = 0.0,
    workers: int = 4,
    shuffle: Optional[bool] = None,
    cache_images: bool = False,
    max_labels: int = 300,
    seed: int = 0,
    shape_buckets: Optional[int] = None,
    rank: int = 0,
    world: int = 1,
) -> Tuple[BatchLoader, AerialDataset]:
    """(loader, dataset), JAX's ``create_dataloader`` signature; ``rank`` and
    ``world``: the loader yields this rank's share of each global batch of
    ``batch_size``."""
    dataset = AerialDataset(
        path, img_size=img_size, batch_size=batch_size, augment=augment, hyp=hyp,
        rect=rect, stride=stride, pad=pad, cache_images=cache_images,
        max_labels=max_labels, seed=seed, shape_buckets=shape_buckets,
    )
    loader = BatchLoader(
        dataset, batch_size=batch_size,
        shuffle=(augment if shuffle is None else shuffle) and not rect,
        workers=workers, seed=seed, rank=rank, world=world,
    )
    return loader, dataset


def load_dataset(path, **kw) -> AerialDataset:
    """Dataset constructor (the reference's ``load_dataset``)."""
    return AerialDataset(path, **kw)


class InfiniteBatchLoader(BatchLoader):
    """A loader without epoch boundaries: batches without end, shuffled anew each
    pass; ``take(n)`` bounds it."""

    def __iter__(self):
        while True:
            yield from super().__iter__()

    def take(self, n: int):
        it = iter(self)
        for _ in range(n):
            yield next(it)
