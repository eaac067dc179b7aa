"""Serving API: ``SkyEyeDetector`` facade and ``Results`` container.

Port of the serving part of ``skyeye_tpu/api.py``: uint8 frames (or PNG, BMP
or JPEG paths, read by ``data.imageio.imread``) -> device letterbox and /255 ->
detector (in its ``dtype``) -> candidate cut -> greedy NMS (one launch of the
hand-written kernel per batch) -> boxes rescaled to each frame. The single-label default cuts on the raw logits per level and decodes
only the survivors (``ops/late_decode.py``); ``approx_topk=False`` or
``multi_label`` decodes everything and takes one global cut. Frames are grouped
by shape and run in power-of-two batch buckets. Everything runs on the device
the detector was built for; CUDA is the default. ``Results`` draws
(``render``/``save``/``crop``) with ``utils.visualization`` and writes with
``data.imageio.imwrite``, as JAX's does with cv2. ``quantize_int8`` turns the
detector into JAX's int8-neck serving mode (``ops/int8_neck.py``);
``model_info`` and ``apply`` are JAX's summary and functional access.

``mesh`` (``parallel.create_mesh`` over local devices, e.g. every card, or
two replicas on one card) splits serving by batch, as JAX's ``shard_map``
over the data axis: one replica of the model per device of the mesh (its
packed int8 or fused-CSP weights prepared on that device), a batch padded
with copies of its first frame to a multiple of the data axis, and each
replica running the whole pipeline (letterbox, model, cut, NMS: one K1
launch per share) on its share, on a host thread and a CUDA stream of its
own; the shares' detections are concatenated and the pad rows dropped.
"""
from __future__ import annotations

import copy
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import ModelConfig
from .data.imageio import imread, imwrite
from .models.detector import SkyEyeDetectorModule, create_detector
from .models.head import decode_predictions
from .ops.calibrate import calibration_paths, observe_ranges
from .ops.int8_neck import NECK_BLOCKS, _range_key_map, quantize_neck_variables
from .ops.late_decode import topk_candidates
from .ops.letterbox import letterbox, letterbox_batch, letterbox_params
from .ops.nms import nms_batched, serving_max_nms, suppress_candidates_batched
from .utils.checkpoint import fuse_conv_bn, load_model
from .utils.general import LOGGER, check_img_size, resolve_device
from .utils.profiling import model_info
from .utils.visualization import Annotator, colors, save_one_box


class Results:
    """Detections for a batch of images: per image (n, 6) [x1, y1, x2, y2, conf, cls]."""

    def __init__(self, detections: List[np.ndarray], images: List[np.ndarray],
                 paths: List[str], names: Sequence[str], times: Dict[str, float]):
        self.detections = detections
        self.images = images  # original BGR frames
        self.paths = paths
        self.names = list(names)
        self.times = times    # ms per image

    def __len__(self) -> int:
        return len(self.detections)

    @property
    def xyxy(self) -> List[np.ndarray]:
        return self.detections

    @property
    def xywh(self) -> List[np.ndarray]:
        out = []
        for det in self.detections:
            d = det.copy()
            if len(d):
                d[:, 0] = (det[:, 0] + det[:, 2]) / 2
                d[:, 1] = (det[:, 1] + det[:, 3]) / 2
                d[:, 2] = det[:, 2] - det[:, 0]
                d[:, 3] = det[:, 3] - det[:, 1]
            out.append(d)
        return out

    def pandas(self):
        """Per-image pandas DataFrames with named columns (pandas imported here,
        as JAX does: the port needs it nowhere else)."""
        import pandas as pd

        cols = ["xmin", "ymin", "xmax", "ymax", "confidence", "class"]
        frames = []
        for det in self.detections:
            df = pd.DataFrame(det, columns=cols)
            df["name"] = [self.names[int(c)] if int(c) < len(self.names) else str(int(c))
                          for c in df["class"]]
            frames.append(df)
        return frames

    def _image(self, i: int) -> np.ndarray:
        """Original image i, read from its path when it was not kept."""
        if self.images[i] is None:
            self.images[i] = imread(self.paths[i])
        return self.images[i]

    def render(self) -> List[np.ndarray]:
        """Annotated copies of the original images (BGR)."""
        out = []
        for i, det in enumerate(self.detections):
            ann = Annotator(self._image(i).copy())
            for *xyxy, conf, cls in det:
                c = int(cls)
                name = self.names[c] if c < len(self.names) else str(c)
                ann.box_label(xyxy, f"{name} {conf:.2f}", colors(c, True))
            out.append(ann.result())
        return out

    def show(self) -> None:
        """JAX shows the images with cv2's window; the port has no display library."""
        LOGGER.warning("show() unavailable (%s); use save() instead",
                       "the port has no display library")

    def save(self, save_dir: Union[str, Path] = "runs/detect") -> List[Path]:
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        files = []
        for i, im in enumerate(self.render()):
            name = Path(self.paths[i]).name if i < len(self.paths) else f"image{i}.jpg"
            f = save_dir / name
            imwrite(f, im)
            files.append(f)
        LOGGER.info("saved %d annotated images to %s", len(files), save_dir)
        return files

    def crop(self, save_dir: Union[str, Path] = "runs/detect/crops") -> List[np.ndarray]:
        crops = []
        for i, det in enumerate(self.detections):
            for j, (*xyxy, conf, cls) in enumerate(det):
                name = self.names[int(cls)] if int(cls) < len(self.names) else str(int(cls))
                crops.append(save_one_box(
                    xyxy, self._image(i),
                    file=Path(save_dir) / name / f"{Path(self.paths[i]).stem}_{j}.jpg"))
        return crops

    def print(self) -> None:
        for i, det in enumerate(self.detections):
            counts: Dict[int, int] = {}
            for c in det[:, 5].astype(int) if len(det) else []:
                counts[c] = counts.get(c, 0) + 1
            s = ", ".join(
                f"{n} {self.names[c] if c < len(self.names) else c}{'s' if n > 1 else ''}"
                for c, n in counts.items()
            )
            LOGGER.info("image %d/%d: %s", i + 1, len(self.detections), s or "no detections")


class SkyEyeDetector:
    """User-facing detector, with the JAX facade's signature: build from
    ``weights`` (a reference-layout ``.pt``/``.pth``, or a configuration name) or
    from ``cfg`` with seeded weights, and call it on HWC BGR uint8 frames.

    ``weights`` that is not a ``.pt``/``.pth`` file resolves as a configuration
    name, so ``SkyEyeDetector("skyeye_s")`` builds skyeye_s; with ``weights``
    given and ``fuse`` (the default), every BatchNorm is folded into its conv,
    as JAX's ``load_model(fuse=True)`` does. ``dtype`` is the compute dtype
    (float32 or bfloat16); parameters stay float32. ``approx_topk=True`` (the
    default) takes, for single-label requests, JAX's late-decode cut: per level
    on the raw logits, decoding only the survivors. The card has no approximate
    top-k, so that cut is exact (JAX's ``approx_topk=False`` late decode);
    ``approx_topk=False`` decodes every anchor and takes one global exact cut.

    ``mesh``: a ``parallel.Mesh`` of local devices (``create_mesh(n_data,
    devices=...)`` in this process) to split every batch over, one model
    replica per device; ``device`` is then where frames come in and
    detections go out.

    The port's own: ``state_dict`` (e.g. from
    ``utils.checkpoint.from_jax_variables``) is loaded, strictly, after the
    model is built and before it is folded; ``device`` (CUDA unless the caller
    asks for the CPU) and ``seed`` (of the weights a file does not give).
    """

    def __init__(self, weights: Optional[Union[str, Path]] = None,
                 cfg: Union[str, dict, ModelConfig] = "skyeye_s",
                 num_classes: Optional[int] = None, img_size: int = 640,
                 conf_thres: float = 0.25, iou_thres: float = 0.45, max_det: int = 300,
                 dtype: torch.dtype = torch.float32, names: Optional[Sequence[str]] = None,
                 fuse: bool = True, approx_topk: bool = True, mesh=None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        self.device = resolve_device(device)
        if weights is not None:
            self.model = load_model(weights, num_classes=num_classes, dtype=dtype,
                                    device=self.device, seed=seed)
        else:
            self.model = create_detector(cfg, num_classes=num_classes, dtype=dtype,
                                         device=self.device, seed=seed)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        if weights is not None and fuse:
            self.model.load_state_dict(fuse_conv_bn(self.model.state_dict()), strict=True)
        self.config = self.model.config
        self.stride = int(max(self.config.strides))
        self.img_size = check_img_size(img_size, self.stride)
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.approx_topk = approx_topk
        self.names = list(names) if names else [str(i) for i in range(self.config.nc)]
        self._int8_neck = False
        self._bn_fused = weights is not None and fuse
        # Called with each stage's name as the stage is issued (host_prep,
        # host_to_device, letterbox, model, decode, nms, device_to_host, rescale);
        # a caller that synchronizes in it can time the stages of a real request.
        self.on_stage: Optional[Callable[[str], None]] = None
        if mesh is not None and mesh.group is not None:
            raise ValueError("serving takes a mesh of this process's devices "
                             "(parallel.create_mesh outside a process group)")
        if mesh is not None and mesh.n_spatial > 1:
            raise ValueError("serving splits batches over the data axis: a mesh with a "
                             "spatial axis is for training")
        self.mesh = mesh
        self._replica_of = None  # the model the replicas were copied from
        self._replicas: List[torch.nn.Module] = []
        self._streams: List = []
        self._pool: Optional[ThreadPoolExecutor] = None

    def quantize_int8(self, calib_images, mode: str = "neck") -> "SkyEyeDetector":
        """Post-training int8 quantization of the serving model, as JAX's facade
        does it. mode="neck" (the only mode): every FPN/PAN conv an int8 product
        with calibrated per-tensor activation scales, int8 between neck convs;
        the backbone and head stay in the model's dtype.

        ``calib_images``: a handful (8-32) of representative HWC uint8 RGB
        frames, letterboxed on the host to the detector's ``img_size`` (no
        minimum rectangle) and run in batches of 8 through
        ``ops/calibrate.observe_ranges``. BatchNorm is folded first where it was
        not. Calibrate at the serving resolution. A second call changes nothing.
        """
        if mode != "neck":
            raise ValueError(f"unsupported int8 mode: {mode!r} (only 'neck')")
        if self._int8_neck:
            return self
        if not self._bn_fused:
            self.model.load_state_dict(fuse_conv_bn(self.model.state_dict()), strict=True)
            self._bn_fused = True
        s = self.img_size
        frames = np.stack([letterbox(np.asarray(im), (s, s), auto=False)[0]
                           for im in calib_images]).astype(np.float32) / 255.0
        batches = [frames[i:i + 8] for i in range(0, len(frames), 8)]
        ranges = observe_ranges(self.model, batches,
                                paths=calibration_paths(_range_key_map(NECK_BLOCKS)))
        state = quantize_neck_variables(self.model.state_dict(), ranges, self.config)
        model = SkyEyeDetectorModule(self.config, dtype=self.model.dtype, int8_neck=True)
        model.load_state_dict(state, strict=True)
        self.model = model.eval().to(self.device)
        self._int8_neck = True
        return self

    def model_info(self, img_size: Optional[int] = None) -> Dict:
        """Parameter tensors, parameters and GFLOPs at ``img_size`` (default: the
        serving size), ``utils/profiling.py``."""
        return model_info(self.model, img_size or self.img_size)

    @torch.inference_mode()
    def apply(self, x, train: bool = False) -> List[torch.Tensor]:
        """The model on (B, H, W, C) images (JAX's layout), on the detector's
        device: the raw (B, H, W, na, nc + 5) logits per level. ``train=True``
        would update the BatchNorm statistics, which JAX's ``apply`` refuses
        without ``mutable``: it raises here too."""
        if train:
            raise ValueError("apply(train=True) would update BatchNorm statistics; "
                             "train through skyeye_tpu_torch.train")
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        return self.model(x.to(self.device).permute(0, 3, 1, 2))

    def _stage(self, name: str) -> None:
        if self.on_stage is not None:
            self.on_stage(name)

    @torch.inference_mode()
    def infer(self, frames: torch.Tensor, out_shape: Tuple[int, int], multi_label: bool = False,
              agnostic: bool = False, class_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) uint8 RGB frames on the detector's device ->
        ((B, max_det, 6) detections in letterboxed pixels, (B,) counts).
        ``class_mask`` (nc,) bool on that device keeps only the classes it marks
        (``cli.detect --classes``). With a mesh, split over its replicas (the
        ``on_stage`` hook then sees only "nms", once every share is done)."""
        if self.mesh is not None:
            return self._infer_sharded(frames, out_shape, multi_label, agnostic, class_mask)
        return self._infer_on(self.model, frames, out_shape, multi_label, agnostic, class_mask,
                              self._stage)

    def _replica_models(self) -> List[torch.nn.Module]:
        """One model per device of the mesh, copied from ``self.model`` (again
        whenever the model was replaced, as by ``quantize_int8``); the first
        device's is the model itself where it already lies there."""
        from .ops.fused_csp import FusedCSPBlock

        if self._replica_of is not self.model:
            reps = []
            for i, dev in enumerate(self.mesh.devices):
                here = next(self.model.parameters()).device == dev
                m = self.model if i == 0 and here else copy.deepcopy(self.model).to(dev).eval()
                for blk in m.modules():
                    if isinstance(blk, FusedCSPBlock) and m is not self.model:
                        blk.prepare()  # K3's packed weights, on this replica's device
                reps.append(m)
            self._replicas, self._replica_of = reps, self.model
        return self._replicas

    def _infer_sharded(self, frames, out_shape, multi_label, agnostic, class_mask):
        n = self.mesh.size
        B = frames.shape[0]
        pad = (-B) % n
        if pad:  # copies of the first frame; their rows are dropped below
            frames = torch.cat([frames, frames[:1].expand(pad, *frames.shape[1:])])
        shares = frames.chunk(n)
        models = self._replica_models()
        devices = self.mesh.devices
        cuda = frames.is_cuda
        main_stream = torch.cuda.current_stream(frames.device) if cuda else None
        if self._pool is None:
            self._pool = ThreadPoolExecutor(n, thread_name_prefix="skyeye-replica")
            self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                             for d in devices]

        def run(i):
            with torch.inference_mode():
                dev, stream = devices[i], self._streams[i]
                mask = class_mask.to(dev) if class_mask is not None else None
                if stream is None:
                    return self._infer_on(models[i], shares[i].to(dev), out_shape, multi_label,
                                          agnostic, mask, None)
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    if main_stream is not None:
                        stream.wait_stream(main_stream)  # the frames are written
                    out = self._infer_on(models[i], shares[i].to(dev, non_blocking=True),
                                         out_shape, multi_label, agnostic, mask, None)
                stream.synchronize()
                return out

        outs = list(self._pool.map(run, range(n)))
        dets, counts = [], []
        for det, cnt in outs:
            if det.is_cuda and cuda and det.device == frames.device:
                det.record_stream(main_stream)  # made on the replica's stream, read here
                cnt.record_stream(main_stream)
            dets.append(det.to(frames.device))
            counts.append(cnt.to(frames.device))
        self._stage("nms")
        return torch.cat(dets)[:B], torch.cat(counts)[:B]

    def _infer_on(self, model, frames, out_shape, multi_label, agnostic, class_mask, stage):
        """The pipeline on one model and the frames on its device."""
        stage = stage or (lambda name: None)
        x = (letterbox_batch(frames, out_shape) / 255.0).to(model.dtype)
        stage("letterbox")
        outs = model(x.permute(0, 3, 1, 2))  # NCHW view of NHWC memory
        stage("model")
        max_nms = serving_max_nms(self.conf_thres)
        if self.approx_topk and not multi_label:
            cut = topk_candidates(outs, self.config.anchors, out_shape,
                                  conf_thres=self.conf_thres, max_nms=max_nms,
                                  class_mask=class_mask)
            stage("decode")  # the cut on the logits and the survivors' decode
            out = suppress_candidates_batched(*cut, iou_thres=self.iou_thres,
                                              max_det=self.max_det, agnostic=agnostic)
        else:
            dec = decode_predictions(outs, self.config.anchors, out_shape, anchor_major=False)
            stage("decode")
            out = nms_batched(dec, conf_thres=self.conf_thres, iou_thres=self.iou_thres,
                              multi_label=multi_label, agnostic=agnostic,
                              max_det=self.max_det, max_nms=max_nms, class_mask=class_mask)
        stage("nms")
        return out

    def warmup(self, imgsz: Tuple[int, int, int, int] = (1, 3, 640, 640)) -> None:
        """Build the kernels this detector's path launches and run one batch of
        zero frames (B, 3, H, W) through it (the reference's ``model.warmup``)."""
        b, _, h, w = imgsz
        frames = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=self.device)
        self.infer(frames, (self.img_size, self.img_size))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _batch_buckets(n: int, cap: int = 16) -> List[int]:
        """Split n items into power-of-two batch sizes up to cap."""
        sizes = []
        while n >= cap:
            sizes.append(cap)
            n -= cap
        b = 1
        while n > 0:
            if n & b:
                sizes.append(b)
                n -= b
            b <<= 1
        return sorted(sizes, reverse=True)

    def __call__(self, source, size: Optional[int] = None, multi_label: bool = False,
                 agnostic: bool = False) -> Results:
        """Detect on image path(s) or HWC BGR uint8 frame(s), as cv2 reads them.
        Paths are read by ``data.imageio.imread`` (PNG, BMP and JPEG)."""
        imgs, paths = self._load_sources(source)
        out_size = check_img_size(size or self.img_size, self.stride)

        t0 = time.perf_counter()
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, im in enumerate(imgs):
            groups.setdefault(im.shape[:2], []).append(i)

        detections: List[Optional[np.ndarray]] = [None] * len(imgs)
        t_infer = 0.0
        for shape, idxs in groups.items():
            gain, dw, dh = letterbox_params(shape, (out_size, out_size))
            pos = 0
            for bs in self._batch_buckets(len(idxs)):
                chunk = idxs[pos : pos + bs]
                pos += bs
                batch = np.ascontiguousarray(np.stack([imgs[i][:, :, ::-1] for i in chunk]))
                self._stage("host_prep")
                t1 = time.perf_counter()
                x = torch.from_numpy(batch).to(self.device)
                self._stage("host_to_device")
                det, n = self.infer(x, (out_size, out_size), multi_label, agnostic)
                det, n = det.cpu().numpy(), n.cpu().numpy()
                self._stage("device_to_host")
                t_infer += time.perf_counter() - t1
                for k, i in enumerate(chunk):
                    detections[i] = _rescale(det[k, : n[k]].copy(), gain, dw, dh, shape)
                self._stage("rescale")
        total = time.perf_counter() - t0
        times = {
            "inference_ms": t_infer / max(len(imgs), 1) * 1000,
            "total_ms": total / max(len(imgs), 1) * 1000,
        }
        return Results(detections, imgs, paths, self.names, times)

    def predict_files(self, paths: Sequence[Union[str, Path]], size: Optional[int] = None,
                      multi_label: bool = False, agnostic: bool = False) -> Results:
        """Detect on image files. JAX's batch path decodes, letterboxes and packs
        in its native C++ library (``native/skyeye_prep.cc``) and takes
        ``__call__`` where that library is missing; the port has no native
        library, so this is ``__call__`` on the paths, which decodes in Python
        and letterboxes on the device (JAX's native letterbox skips the
        INTER_AREA pre-resize, so its pixels differ from both)."""
        return self([str(p) for p in paths], size=size, multi_label=multi_label,
                    agnostic=agnostic)

    @staticmethod
    def _load_sources(source) -> Tuple[List[np.ndarray], List[str]]:
        """Frames and their names: arrays as given, paths read from disk."""
        items = source if isinstance(source, (list, tuple)) else [source]
        imgs, paths = [], []
        for it in items:
            if isinstance(it, np.ndarray):
                imgs.append(it)
                paths.append(f"array{len(paths)}.jpg")
            elif isinstance(it, (str, Path)):
                imgs.append(imread(it))
                paths.append(str(it))
            else:
                raise TypeError("SkyEyeDetector takes image paths or HWC BGR uint8 numpy "
                                f"frames; got {type(it).__name__}")
        return imgs, paths


def _rescale(d: np.ndarray, gain: float, dw: float, dh: float, shape) -> np.ndarray:
    """Letterboxed xyxy -> the frame's pixels, clipped to the frame."""
    if len(d):
        d[:, [0, 2]] = np.clip((d[:, [0, 2]] - dw) / gain, 0, shape[1])
        d[:, [1, 3]] = np.clip((d[:, [1, 3]] - dh) / gain, 0, shape[0])
    return d
