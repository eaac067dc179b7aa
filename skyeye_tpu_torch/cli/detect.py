"""Detection on image files, folders and globs: the port's first user pipeline.

Port of ``skyeye_tpu/cli/detect.py::run``: source -> ``LoadImages`` (decode
with ``data.imageio.imread``, host letterbox, BGR -> RGB) -> the detector's
``infer`` on the card (forward, candidate cut, greedy NMS: K1 once a batch of
one frame) -> boxes rescaled to the frame -> per-class counts, ``labels/*.txt``
(``%.6g``), crops under ``crops/<name>/``, annotated images under the input's
own name, written by ``data.imageio.imwrite`` (JPEG as cv2 writes it), the
per-image log line and the ``Speed:`` summary. Up to 3 frames are in flight:
their work is queued on the card, and the host annotates and writes the
oldest after one sync for it.

JAX's default cut is its late decode with ``approx_max_k``, exact on the CPU;
the card has no approximate top-k, so the port's default is the exact late cut
(``SkyEyeDetector(approx_topk=True)``) and ``--exact-nms`` takes the
decode-everything path, as in JAX. ``--device`` defaults to the card; ``--half``
computes in bf16. ``--augment``, ``--visualize`` and ``--update`` are accepted
and ignored, as in JAX. Left out, raising NotImplementedError: videos, webcams,
streams and ``--view-img`` (no video decoder or display library; ROADMAP.md,
Queue 1 item 14).

Usage: python -m skyeye_tpu_torch.cli.detect --weights best.pt --source imgs/ --img-size 1280
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from ..api import SkyEyeDetector
from ..data.dataset import IMG_FORMATS, VID_FORMATS
from ..data.imageio import imwrite
from ..data.loaders import VIDEO_NOT_PORTED, LoadImages
from ..ops.boxes import scale_boxes
from ..utils.general import LOGGER, check_dataset, check_img_size, increment_path
from ..utils.visualization import Annotator, colors, save_one_box


def run(
    weights="skyeye_s",
    source="data/images",
    data=None,
    imgsz=(640, 640),
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    device: str = "cuda",
    view_img: bool = False,
    save_txt: bool = False,
    save_conf: bool = False,
    save_crop: bool = False,
    nosave: bool = False,
    classes=None,
    agnostic_nms: bool = False,
    augment: bool = False,
    visualize: bool = False,
    update: bool = False,
    project="runs/detect",
    name="exp",
    exist_ok: bool = False,
    line_thickness: int = 3,
    hide_labels: bool = False,
    hide_conf: bool = False,
    half: bool = False,
    vid_stride: int = 1,
    exact_nms: bool = False,
):
    source = str(source)
    save_img = not nosave and not source.endswith(".txt")
    is_file = Path(source).suffix[1:].lower() in (IMG_FORMATS + VID_FORMATS)
    is_url = source.lower().startswith(("rtsp://", "rtmp://", "http://", "https://"))
    webcam = source.isnumeric() or source.endswith(".streams") or (is_url and not is_file)
    if webcam or view_img:
        raise NotImplementedError(("--view-img: the port has no display library; "
                                   if view_img else f"{source}: ") + VIDEO_NOT_PORTED)

    save_dir = increment_path(Path(project) / name, exist_ok=exist_ok, mkdir=True)
    if save_txt:
        (save_dir / "labels").mkdir(parents=True, exist_ok=True)

    detector = SkyEyeDetector(
        weights=weights, img_size=max(imgsz), conf_thres=conf_thres, iou_thres=iou_thres,
        max_det=max_det, dtype=torch.bfloat16 if half else torch.float32,
        approx_topk=not exact_nms, device=device or "cuda")
    stride = detector.stride
    names = detector.names
    if data:
        names = check_dataset(data).names
        detector.names = names
    imgsz = check_img_size(list(imgsz), stride)
    dataset = LoadImages(source, img_size=imgsz[0], stride=stride)

    class_mask = None
    if classes is not None:
        mask = np.zeros(detector.config.nc, bool)
        mask[np.asarray(classes)] = True
        class_mask = torch.from_numpy(mask).to(detector.device)

    pipeline_depth = 3
    inflight: deque = deque()
    seen, dt = 0, [0.0, 0.0]

    def process(path, im0s, s, in_shape, det, infer_ms):
        nonlocal seen
        seen += 1
        p, im0 = Path(path), im0s.copy()
        save_path = str(save_dir / p.name)
        txt_path = str(save_dir / "labels" / p.stem)
        if len(det):
            det[:, :4] = scale_boxes(in_shape, torch.from_numpy(det[:, :4]),
                                     im0.shape[:2]).numpy()

        label_str = ""
        for c in np.unique(det[:, 5].astype(int)) if len(det) else []:
            ncount = int((det[:, 5] == c).sum())
            cname = names[c] if c < len(names) else str(c)
            label_str += f"{ncount} {cname}{'s' * (ncount > 1)}, "

        annotator = Annotator(im0, line_width=line_thickness)
        for *xyxy, conf, cls in reversed(det):
            c = int(cls)
            if save_txt:
                h0, w0 = im0.shape[:2]
                xywh = [(xyxy[0] + xyxy[2]) / 2 / w0, (xyxy[1] + xyxy[3]) / 2 / h0,
                        (xyxy[2] - xyxy[0]) / w0, (xyxy[3] - xyxy[1]) / h0]
                line = [c, *xywh] + ([conf] if save_conf else [])
                with open(f"{txt_path}.txt", "a") as f:
                    f.write(" ".join(f"{v:.6g}" for v in line) + "\n")
            if save_img or save_crop:
                cname = names[c] if c < len(names) else str(c)
                label = None if hide_labels else (cname if hide_conf else f"{cname} {conf:.2f}")
                annotator.box_label(xyxy, label, color=colors(c, True))
            if save_crop:
                save_one_box(xyxy, im0s, file=save_dir / "crops" / names[c] / f"{p.stem}.jpg")
        if save_img:
            imwrite(save_path, annotator.result())
        LOGGER.info("%s%s%.1fms", s, label_str or "(no detections), ", infer_ms)

    def drain_one():
        path, im0s, s, in_shape, (det, n), t_disp = inflight.popleft()
        det_n = torch.cat([det.float().flatten(), n.float()]).cpu().numpy()  # the one sync
        t2 = time.perf_counter()
        dt[1] += t2 - t_disp
        count = int(det_n[-1])
        process(path, im0s, s, in_shape, det_n[:-1].reshape(det.shape)[0, :count].copy(),
                (t2 - t_disp) * 1000)

    for path, im, im0s, _, s in dataset:
        t0 = time.perf_counter()
        x = torch.from_numpy(im[None]).to(detector.device)
        t1 = time.perf_counter()
        dt[0] += t1 - t0
        handles = detector.infer(x, (x.shape[1], x.shape[2]), agnostic=agnostic_nms,
                                 class_mask=class_mask)  # queued on the card
        inflight.append((path, im0s.copy(), s, x.shape[1:3], handles, t1))
        if len(inflight) >= pipeline_depth:
            drain_one()
    while inflight:
        drain_one()

    t = tuple(x / max(seen, 1) * 1000 for x in dt)
    LOGGER.info("Speed: %.1fms pre-process, %.1fms inference+NMS per image at shape "
                "(1, 3, %d, %d)", t[0], t[1], imgsz[0], imgsz[1])
    if save_txt or save_img:
        LOGGER.info("Results saved to %s", save_dir)
    return save_dir


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description="SkyEye detection on PyTorch/CUDA")
    p.add_argument("--weights", type=str, default="skyeye_s")
    p.add_argument("--source", type=str, default="data/images")
    p.add_argument("--data", type=str, default=None, help="dataset yaml (class names)")
    p.add_argument("--imgsz", "--img-size", nargs="+", type=int, default=[640])
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--view-img", action="store_true")
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--save-conf", action="store_true")
    p.add_argument("--save-crop", action="store_true")
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--classes", nargs="+", type=int)
    p.add_argument("--agnostic-nms", action="store_true")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--update", action="store_true")
    p.add_argument("--project", default="runs/detect")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--line-thickness", type=int, default=3)
    p.add_argument("--hide-labels", action="store_true")
    p.add_argument("--hide-conf", action="store_true")
    p.add_argument("--half", action="store_true", help="compute in bf16")
    p.add_argument("--vid-stride", type=int, default=1)
    p.add_argument("--exact-nms", action="store_true",
                   help="decode every anchor and take one global exact cut, instead of "
                        "the exact late cut on the raw logits")
    opt = p.parse_args(argv)
    opt.imgsz = opt.imgsz * 2 if len(opt.imgsz) == 1 else opt.imgsz
    return opt


def main(argv=None):
    import logging

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    return run(**vars(parse_opt(argv)))


if __name__ == "__main__":
    main()
