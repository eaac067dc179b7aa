"""Augmentation on the device, inside the train step: mosaic + affine, mixup,
HSV and flips, batched and of fixed shapes.

Port of ``skyeye_tpu/data/device_aug.py``. Each stage is split in two: a
``draw_*`` function takes its random numbers from a ``torch.Generator`` (on
the batch's device, so drawing waits for nothing), and an ``apply_*``
function computes the stage from them, with JAX's arithmetic. JAX's draws come
from ``jax.random`` keys, which torch cannot reproduce; given the same draws,
the apply functions compute what JAX computes.

  * mosaic + affine, fused: for every output pixel the inverse affine maps
    into the virtual 2s x 2s mosaic canvas, the canvas coordinate picks one
    of four batch images (i, i+1, i+2, i+3 mod B) and a local coordinate, and
    one bilinear sample is taken; the canvas is never built. Per image, with
    probability hyp["mosaic"], else the same affine on the single image.
    Labels ride along as (B, 4M, 6), moved by the same matrices and filtered
    as candidates (w, h > 2 px, aspect < 20, area kept > 10%);
  * mixup: Beta(8, 8) blend with the batch rolled by B // 2, labels
    concatenated (M -> 2M);
  * HSV gains, and horizontal and vertical flips.

In a data-parallel step each rank holds the whole batch's frames (gathered)
and the whole batch's draws (every rank draws from the same generator), and
renders only its own ``rows``: their mosaics read whichever frames they need,
and mixup's partners (rows i - B // 2) are rendered beside them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..config import DEFAULT_HYP

PAD = 114.0


def _uniform(shape, lo, hi, generator, device) -> torch.Tensor:
    """U[lo, hi) as jax.random.uniform maps its bits: lo + (hi - lo) * u."""
    u = torch.rand(shape, generator=generator, device=device)
    return lo + (hi - lo) * u


# -- HSV ------------------------------------------------------------------------


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float [0, 1] RGB -> HSV with h in [0, 1)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros((), dtype=rgb.dtype, device=rgb.device)
    s = torch.where(maxc > 0, delta / maxc.clamp(min=1e-12), zero)
    safe = delta.clamp(min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(choices):
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select([v, q, p, p, t, v]), select([t, v, v, q, p, p]),
                        select([p, p, t, v, v, q])], dim=-1)


def draw_hsv(batch: int, generator, device) -> torch.Tensor:
    """(B, 3) U[-1, 1) per image: JAX's ``r`` in ``hsv_jitter_batch``."""
    return _uniform((batch, 3), -1.0, 1.0, generator, device)


def apply_hsv(images: torch.Tensor, r: torch.Tensor, hgain=0.015, sgain=0.7,
              vgain=0.4) -> torch.Tensor:
    """images (B, H, W, 3) float [0, 1]; gains r * [h, s, v] + 1 per image."""
    gains = r * torch.tensor([hgain, sgain, vgain], dtype=torch.float32, device=r.device) + 1.0
    hsv = rgb_to_hsv(images)
    h = torch.remainder(hsv[..., 0] * gains[:, None, None, 0], 1.0)
    s = (hsv[..., 1] * gains[:, None, None, 1]).clamp(0.0, 1.0)
    v = (hsv[..., 2] * gains[:, None, None, 2]).clamp(0.0, 1.0)
    return hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def hsv_jitter_batch(images, generator, hgain=0.015, sgain=0.7, vgain=0.4):
    return apply_hsv(images, draw_hsv(images.shape[0], generator, images.device),
                     hgain, sgain, vgain)


# -- mosaic + affine (fused) -----------------------------------------------------


def draw_mosaic_affine(batch: int, s: int, hyp: Dict, mosaic_p: float, generator,
                       device) -> Dict[str, torch.Tensor]:
    """Per image: gate (mosaic or not), the mosaic centre (y, x) ~ U[s/2, 3s/2),
    and the affine's draws: angle and shears in degrees, scale, and the
    translation as a fraction of s."""
    deg, tr, sc, sh = hyp["degrees"], hyp["translate"], hyp["scale"], hyp["shear"]
    u = lambda shape, lo, hi: _uniform(shape, lo, hi, generator, device)  # noqa: E731
    return {
        "gate": u((batch,), 0.0, 1.0) < mosaic_p,
        "center": u((batch, 2), 0.5 * s, 1.5 * s),
        "angle": u((batch,), -deg, deg),
        "scale": u((batch,), 1.0 - sc, 1.0 + sc),
        "shear_x": u((batch,), -sh, sh),
        "shear_y": u((batch,), -sh, sh),
        "translate_x": u((batch,), 0.5 - tr, 0.5 + tr),
        "translate_y": u((batch,), 0.5 - tr, 0.5 + tr),
    }


def inverse_affine(d: Dict[str, torch.Tensor], s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, 3) matrices mapping output pixels back into the canvas, and the
    scale: JAX's ``_inverse_affine``, M = T S R C inverted, C centred at s (the
    mosaic canvas) or s / 2 (a single image)."""
    B = d["angle"].shape[0]
    dev = d["angle"].device
    a = d["angle"] * math.pi / 180.0
    sc = d["scale"]
    shx = torch.tan(d["shear_x"] * math.pi / 180.0)
    shy = torch.tan(d["shear_y"] * math.pi / 180.0)
    tx = d["translate_x"] * s
    ty = d["translate_y"] * s
    center = torch.where(d["gate"], torch.tensor(float(s), device=dev),
                         torch.tensor(s / 2.0, device=dev))
    cos_a, sin_a = torch.cos(a) * sc, torch.sin(a) * sc
    eye = torch.eye(3, device=dev).expand(B, 3, 3)
    C, R, S, T = (eye.clone() for _ in range(4))
    C[:, 0, 2], C[:, 1, 2] = -center, -center
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = cos_a, -sin_a, sin_a, cos_a
    S[:, 0, 1], S[:, 1, 0] = shx, shy
    T[:, 0, 2], T[:, 1, 2] = tx, ty
    M = T @ S @ R @ C
    return torch.linalg.inv_ex(M)[0], sc


def apply_mosaic_affine(images: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                        d: Dict[str, torch.Tensor], rows: Optional[torch.Tensor] = None):
    """images (B, s, s, 3) float [0, 1]; targets (B, M, 6); mask (B, M) ->
    (images (R, s, s, 3), targets (R, 4M, 6), mask (R, 4M)) for the batch's rows
    ``rows`` (R indices; default all B, in order)."""
    B, s = images.shape[0], images.shape[1]
    M_t = targets.shape[1]
    dev = images.device
    if rows is None:
        rows = torch.arange(B, device=dev)
    else:
        d = {k: v[rows] for k, v in d.items()}
    R = rows.shape[0]
    gate = d["gate"]
    cyx = torch.where(gate[:, None], d["center"], torch.tensor(float(s), device=dev))
    yc, xc = cyx[:, 0, None, None], cyx[:, 1, None, None]                  # (B, 1, 1)
    Minv, sc = inverse_affine(d, s)

    oy, ox = torch.meshgrid(torch.arange(s, dtype=torch.float32, device=dev),
                            torch.arange(s, dtype=torch.float32, device=dev), indexing="ij")
    m = Minv[:, :, :, None, None]
    cx = m[:, 0, 0] * ox + m[:, 0, 1] * oy + m[:, 0, 2]                   # (B, s, s)
    cy = m[:, 1, 0] * ox + m[:, 1, 1] * oy + m[:, 1, 2]

    right, bottom = cx >= xc, cy >= yc
    quad = bottom.long() * 2 + right.long()                                # 0 TL 1 TR 2 BL 3 BR
    lx = torch.where(right, cx - xc, cx - (xc - s))
    ly = torch.where(bottom, cy - yc, cy - (yc - s))
    in_canvas = (cx >= xc - s) & (cx < xc + s) & (cy >= yc - s) & (cy < yc + s)
    in_img = (lx >= -0.5) & (lx <= s - 0.5) & (ly >= -0.5) & (ly <= s - 0.5)
    valid = in_canvas & in_img & (gate[:, None, None] | (quad == 0))

    # one bilinear sample from the quadrant's image (JAX samples all four and
    # selects: the same value)
    src = (rows[:, None, None] + quad) % B
    y0 = torch.floor(ly).clamp(0, s - 1)
    x0 = torch.floor(lx).clamp(0, s - 1)
    y1 = (y0 + 1).clamp(0, s - 1)
    x1 = (x0 + 1).clamp(0, s - 1)
    wy = (ly - y0).clamp(0.0, 1.0)[..., None]
    wx = (lx - x0).clamp(0.0, 1.0)[..., None]
    flat = images.reshape(B * s * s, 3)
    base = src * (s * s)

    def at(y, x):
        return flat[base + y.long() * s + x.long()]

    v00, v01, v10, v11 = at(y0, x0), at(y0, x1), at(y1, x0), at(y1, x1)
    top = v00 + wx * (v01 - v00)
    bot = v10 + wx * (v11 - v10)
    out = torch.where(valid[..., None], top + wy * (bot - top),
                      torch.tensor(PAD / 255.0, device=dev))

    # labels: normalised xywh -> canvas xyxy -> forward affine -> candidate filter
    idx = (rows[:, None] + torch.arange(4, device=dev)[None]) % B
    t = targets[idx]                                                        # (R, 4, M, 6)
    offs = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], device=dev)
    origin_x = (cyx[:, 1, None] - s) + offs[None, :, 0] * s                 # (B, 4)
    origin_y = (cyx[:, 0, None] - s) + offs[None, :, 1] * s
    bx = t[..., 2] * s + origin_x[..., None]
    by = t[..., 3] * s + origin_y[..., None]
    bw, bh = t[..., 4] * s, t[..., 5] * s
    x1b, y1b, x2b, y2b = bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2
    Mf = torch.linalg.inv_ex(Minv)[0][:, None, None]                        # (B, 1, 1, 3, 3)
    cxs, cys = [], []
    for px, py in ((x1b, y1b), (x2b, y1b), (x1b, y2b), (x2b, y2b)):
        cxs.append(px * Mf[..., 0, 0] + py * Mf[..., 0, 1] + Mf[..., 0, 2])
        cys.append(px * Mf[..., 1, 0] + py * Mf[..., 1, 1] + Mf[..., 1, 2])
    cxs, cys = torch.stack(cxs, -1), torch.stack(cys, -1)
    nx1, ny1 = cxs.amin(-1).clamp(0, s), cys.amin(-1).clamp(0, s)
    nx2, ny2 = cxs.amax(-1).clamp(0, s), cys.amax(-1).clamp(0, s)
    nw, nh = nx2 - nx1, ny2 - ny1
    w_orig, h_orig = bw * sc[:, None, None], bh * sc[:, None, None]
    ar = torch.maximum(nw / (nh + 1e-16), nh / (nw + 1e-16))
    keep = (mask[idx] & (nw > 2.0) & (nh > 2.0)
            & (nw * nh / (w_orig * h_orig + 1e-16) > 0.10) & (ar < 20.0))
    keep = keep & (gate[:, None, None] | (torch.arange(4, device=dev) == 0)[None, :, None])
    out_t = torch.stack([torch.zeros_like(nx1), t[..., 1], (nx1 + nx2) / 2 / s,
                         (ny1 + ny2) / 2 / s, nw / s, nh / s], dim=-1)
    return out, out_t.reshape(R, 4 * M_t, 6), keep.reshape(R, 4 * M_t)


def mosaic_affine_batch(images, targets, mask, generator, hyp: Optional[Dict] = None,
                        mosaic_p: Optional[float] = None):
    hyp = {**DEFAULT_HYP, **(hyp or {})}
    if mosaic_p is None:
        mosaic_p = float(hyp.get("mosaic", 1.0))
    d = draw_mosaic_affine(images.shape[0], images.shape[1], hyp, mosaic_p, generator,
                           images.device)
    return apply_mosaic_affine(images, targets, mask, d)


# -- mixup ------------------------------------------------------------------------


def draw_mixup(batch: int, p: float, generator, device) -> Dict[str, torch.Tensor]:
    """lam ~ Beta(8, 8) (the 8th smallest of 15 uniforms) and the per-image gate."""
    lam = torch.rand((batch, 15), generator=generator, device=device).sort(dim=1).values[:, 7]
    return {"lam": lam, "do": _uniform((batch,), 0.0, 1.0, generator, device) < p}


def mixup_shift(batch: int) -> int:
    """Mixup's partner of row i is row i - shift (the batch rolled by B // 2)."""
    return batch // 2 or 1


def _blend(images, targets, mask, partner, t2, m2, d):
    lam = torch.where(d["do"], d["lam"], torch.ones_like(d["lam"]))
    lam4 = lam[:, None, None, None]
    blended = images * lam4 + partner * (1.0 - lam4)
    m2 = m2 & d["do"][:, None]
    return blended, torch.cat([targets, t2], dim=1), torch.cat([mask, m2], dim=1)


def apply_mixup(images, targets, mask, d):
    shift = mixup_shift(images.shape[0])
    return _blend(images, targets, mask, torch.roll(images, shift, dims=0),
                  torch.roll(targets, shift, dims=0), torch.roll(mask, shift, dims=0), d)


def mixup_batch(images, targets, mask, generator, p: float = 1.0):
    return apply_mixup(images, targets, mask,
                       draw_mixup(images.shape[0], p, generator, images.device))


# -- flips ----------------------------------------------------------------------------


def draw_flip(batch: int, p_lr: float, p_ud: float, generator, device):
    return {"lr": _uniform((batch,), 0.0, 1.0, generator, device) < p_lr,
            "ud": _uniform((batch,), 0.0, 1.0, generator, device) < p_ud}


def apply_flip(images, targets, d):
    """Flip each image left-right and/or up-down as drawn; targets [_, cls, xywh]."""
    do_lr, do_ud = d["lr"], d["ud"]
    imgs = torch.where(do_lr[:, None, None, None], images.flip(2), images)
    imgs = torch.where(do_ud[:, None, None, None], imgs.flip(1), imgs)
    tx = torch.where(do_lr[:, None], 1.0 - targets[..., 2], targets[..., 2])
    ty = torch.where(do_ud[:, None], 1.0 - targets[..., 3], targets[..., 3])
    targets = torch.cat([targets[..., :2], tx[..., None], ty[..., None], targets[..., 4:]], -1)
    return imgs, targets


def flip_batch(images, targets, generator, p_lr: float = 0.5, p_ud: float = 0.0):
    return apply_flip(images, targets,
                      draw_flip(images.shape[0], p_lr, p_ud, generator, images.device))


# -- the whole pipeline ------------------------------------------------------------------


def draw_augmentation(batch: int, s: int, hyp: Dict, generator, device,
                      use_mosaic: bool = True) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every draw of one batch's augmentation, stage by stage."""
    hyp = {**DEFAULT_HYP, **(hyp or {})}
    mosaic_p = float(hyp.get("mosaic", 1.0)) if use_mosaic else 0.0
    draws = {"mosaic_affine": draw_mosaic_affine(batch, s, hyp, mosaic_p, generator, device)}
    if hyp.get("mixup", 0.0) > 0:
        draws["mixup"] = draw_mixup(batch, hyp["mixup"], generator, device)
    draws["hsv"] = draw_hsv(batch, generator, device)
    draws["flip"] = draw_flip(batch, hyp["fliplr"], hyp["flipud"], generator, device)
    return draws


def apply_augmentation(images, targets, mask, draws, hyp: Optional[Dict] = None,
                       rows: Optional[torch.Tensor] = None):
    """JAX's ``augment_batch_device`` on given draws: the fused mosaic/affine
    (always: per image mosaic or the single-image affine), mixup when drawn,
    HSV, flips. Returns (images, targets (B, M', 6), mask (B, M')); with
    ``rows`` (R indices of the batch), only those rows, (R, ...), each equal to
    its row of the whole batch's result."""
    hyp = {**DEFAULT_HYP, **(hyp or {})}
    if rows is None:
        images, targets, mask = apply_mosaic_affine(images, targets, mask,
                                                    draws["mosaic_affine"])
        if "mixup" in draws:
            images, targets, mask = apply_mixup(images, targets, mask, draws["mixup"])
        hsv, flip = draws["hsv"], draws["flip"]
    else:
        B, R = images.shape[0], rows.shape[0]
        need = rows
        if "mixup" in draws:  # the partners' mosaics too
            need = torch.cat([rows, (rows - mixup_shift(B)) % B])
        images, targets, mask = apply_mosaic_affine(images, targets, mask,
                                                    draws["mosaic_affine"], rows=need)
        if "mixup" in draws:
            images, targets, mask = _blend(
                images[:R], targets[:R], mask[:R], images[R:], targets[R:], mask[R:],
                {k: v[rows] for k, v in draws["mixup"].items()})
        hsv, flip = draws["hsv"][rows], {k: v[rows] for k, v in draws["flip"].items()}
    images = apply_hsv(images, hsv, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"])
    images, targets = apply_flip(images, targets, flip)
    return images, targets, mask


def augment_batch_device(images, targets, mask, generator, hyp: Optional[Dict] = None,
                         use_mosaic: bool = True, rows: Optional[torch.Tensor] = None):
    """The train step's augmentation: images (B, s, s, 3) float [0, 1], targets
    (B, M, 6), mask (B, M), drawn from ``generator``; with ``rows``, only those
    rows of the result (the whole batch's draws are taken all the same)."""
    draws = draw_augmentation(images.shape[0], images.shape[1], hyp, generator,
                              images.device, use_mosaic)
    return apply_augmentation(images, targets, mask, draws, hyp, rows=rows)
