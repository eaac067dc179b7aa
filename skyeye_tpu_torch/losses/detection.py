"""Detection losses: YOLOv5-convention ComputeLoss, focal/BCE variants, aerial loss.

Port of ``skyeye_tpu/losses/detection.py``. Target assignment is JAX's
fixed-shape form: every (offset, anchor, target) triple has a slot, K = 5 * na
* M per level, and a slot that does not apply carries a False mask, so nothing
on the card waits for the host to learn how many targets matched. The loss
reads the head's (B, H, W, na, nc + 5) logits in their own dtype and upcasts at
the use sites (the gathered rows, the objectness plane): the arithmetic is
float32 (float64 for float64 logits, a reference on the card).

Where JAX gathers out of range it clamps, and where it scatters out of range it
drops: the port clamps the gather indices and sends a dropped row to a trash
row past the batch, sliced off after the scatter.

Every term divides by a sum over the whole batch (the assignments' weights,
the images' weights or the row count). In a data-parallel step
(``parallel.collectives.data_parallel``) each rank holds some of the batch's
rows: it sums its numerators over its own rows and divides by the global
sums, all-reduced in one collective before any term is formed. The ranks'
partial losses then sum to the loss of the global batch, JAX's loss under
GSPMD, and so do their gradients; a rank that holds no targets contributes
its objectness term and nothing else.

Under spatial sharding (``parallel.spatial``) the logits hold this rank's
rows of every level's grid. Targets are assigned on the whole grid, as in one
process; each rank keeps the assignments whose cell lies in its rows (at
local row indices) and drops the rest, and its objectness term covers its
rows' cells. The normalisers are summed over the world (the step's
``data_parallel`` group): the assignments' weights count once, and the row
count, which every spatial rank of a data share adds, times a share's cells
per image is the global batch's cell count. So the partial losses again sum
to the global batch's loss.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULT_HYP
from ..ops.boxes import bbox_iou
from ..parallel.collectives import all_reduce_sum, current_group
from ..parallel.spatial import current_spatial


def smooth_bce(eps: float = 0.1) -> Tuple[float, float]:
    """Label-smoothed BCE target pair (positive, negative)."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, in JAX's stable form."""
    return pred.clamp(min=0) - pred * target + torch.log1p(torch.exp(-pred.abs()))


def focal_loss(pred, target, gamma: float = 1.5, alpha: float = 0.25):
    """Elementwise focal-modulated BCE."""
    bce = bce_with_logits(pred, target)
    p = torch.sigmoid(pred)
    p_t = target * p + (1 - target) * (1 - p)
    alpha_factor = target * alpha + (1 - target) * (1 - alpha)
    return alpha_factor * (1.0 - p_t) ** gamma * bce


def modulated_bce(pred, target, alpha: float = 0.05):
    """BCE scaled by 1 - exp(-|y - p| / alpha)."""
    bce = bce_with_logits(pred, target)
    p = torch.sigmoid(pred)
    return bce * (1.0 - torch.exp(-(target - p).abs() / alpha))


def masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-9,
                mask_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of x over the mask's entries, the mask broadcast over x's trailing
    axes: sum(x * mask) / max(sum(mask) * x.size / mask.size, eps).
    ``mask_sum``, where given, stands for sum(mask) (the global batch's, in a
    data-parallel step)."""
    mask = mask.to(x.dtype)
    size = mask.numel()
    while mask.dim() < x.dim():
        mask = mask[..., None]
    total = mask.sum() if mask_sum is None else mask_sum.to(x.dtype)
    denom = total * (x.numel() / size if size else 1.0)
    return (x * mask).sum() / denom.clamp(min=eps)


def _global_sums(local) -> Optional[torch.Tensor]:
    """The sums ``local`` (a list of 0-d tensors) over the data-parallel group,
    in one collective; None outside a data-parallel step."""
    if current_group() is None:
        return None
    return all_reduce_sum(torch.stack([t.float() for t in local]))


def _mean_over_batch(x: torch.Tensor, rows: Optional[torch.Tensor]) -> torch.Tensor:
    """x.mean(), or, given the global batch's row count, sum(x) over this rank's
    rows divided by the global batch's element count."""
    if rows is None:
        return x.mean()
    return x.sum() / (rows.to(x.dtype) * (x.numel() // x.shape[0]))


def _grid_rows(h_local: int) -> Tuple[int, int]:
    """(this rank's first row of a level's grid, the grid's rows): (0, h) in one
    process, (rank h, n h) under spatial sharding."""
    share = current_spatial()
    return (0, h_local) if share is None else (share.rank * h_local, share.n * h_local)


def _own_rows(asg: Dict[str, torch.Tensor], row0: int, h: int) -> Dict[str, torch.Tensor]:
    """The assignments of whole-grid rows [row0, row0 + h) at local rows; the others
    masked off (their rows clamped into range, never read)."""
    gj = asg["gj"]
    inside = (gj >= row0) & (gj < row0 + h)
    return dict(asg, gj=(gj - row0).clamp(0, h - 1), mask=asg["mask"] & inside)


# The neighbour offsets: centre, left, up, right, down (scaled by _G).
_OFFSETS = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]],
                    np.float32)
_G = 0.5


def build_targets_level(targets: torch.Tensor, valid: torch.Tensor,
                        anchors_level: torch.Tensor, grid_hw: Tuple[int, int],
                        anchor_t: float = 4.0) -> Dict[str, torch.Tensor]:
    """Fixed-shape target assignment for one pyramid level.

    targets (M, 6) [img, cls, x, y, w, h] with xywh normalised; valid (M,) bool;
    anchors_level (na, 2) in grid units. Returns flat (K = 5 * na * M) arrays:
    b, a, gj, gi (int64), tbox (K, 4) [dx, dy, gw, gh], cls, anchor_wh (K, 2)
    and mask (K,) bool, in JAX's (offset, anchor, target) order.
    """
    gh, gw = grid_hw
    M = targets.shape[0]
    na = anchors_level.shape[0]
    dev = targets.device
    gain = torch.tensor([1.0, 1.0, gw, gh, gw, gh], dtype=torch.float32, device=dev)
    t = targets * gain

    r = t[None, :, 4:6] / anchors_level[:, None, :]                      # (na, M, 2)
    anchor_ok = torch.maximum(r, 1.0 / r).amax(dim=-1) < anchor_t        # (na, M)

    gxy = t[:, 2:4]
    gxi = torch.tensor([gw, gh], dtype=torch.float32, device=dev) - gxy
    jk = (torch.remainder(gxy, 1.0) < _G) & (gxy > 1.0)
    lm = (torch.remainder(gxi, 1.0) < _G) & (gxi > 1.0)
    off_ok = torch.stack([torch.ones(M, dtype=torch.bool, device=dev),
                          jk[:, 0], jk[:, 1], lm[:, 0], lm[:, 1]], dim=0)  # (5, M)
    mask = valid[None, None, :] & anchor_ok[None] & off_ok[:, None, :]     # (5, na, M)

    offsets = torch.from_numpy(_OFFSETS).to(dev)
    gij = torch.floor(gxy[None] - offsets[:, None, :] * _G)               # (5, M, 2)
    gi = gij[..., 0].clamp(0, gw - 1).long()
    gj = gij[..., 1].clamp(0, gh - 1).long()
    # dxy from the clamped cell, as the reference's in-place clamp leaves it
    dxy = gxy[None] - torch.stack([gi, gj], dim=-1).float()                # (5, M, 2)
    gwh = t[:, 4:6]

    K = 5 * na * M
    shape = (5, na, M)
    b = targets[:, 0].long()[None, None, :].expand(shape)
    cls = targets[:, 1].long()[None, None, :].expand(shape)
    a = torch.arange(na, device=dev)[None, :, None].expand(shape)
    tbox = torch.cat([dxy, gwh[None].expand(5, M, 2)], dim=-1)[:, None].expand(5, na, M, 4)
    anchor_wh = anchors_level[None, :, None, :].expand(5, na, M, 2)
    return {
        "b": b.reshape(K),
        "a": a.reshape(K),
        "gj": gj[:, None, :].expand(shape).reshape(K),
        "gi": gi[:, None, :].expand(shape).reshape(K),
        "tbox": tbox.reshape(K, 4),
        "cls": cls.reshape(K),
        "anchor_wh": anchor_wh.reshape(K, 2),
        "mask": mask.reshape(K),
    }


def _dropped(b: torch.Tensor, m: torch.Tensor, B: int) -> torch.Tensor:
    """Image indices for a scatter: a masked or out-of-range row goes to the trash
    row B (JAX's ``mode="drop"``)."""
    return torch.where(m & (b >= 0) & (b < B), b, torch.full_like(b, B))


def _one_hot_where(idx: torch.Tensor, nc: int, on: float, off: float) -> torch.Tensor:
    """(…,) class ids -> (…, nc) float32 with ``on`` at the id and ``off`` elsewhere;
    an id outside [0, nc) gives a row of ``off`` (JAX's one_hot and dropped scatter)."""
    hit = idx[..., None] == torch.arange(nc, device=idx.device)
    return torch.where(hit, torch.tensor(on, device=idx.device),
                       torch.tensor(off, device=idx.device))


class ComputeLoss:
    """YOLOv5-convention training loss over the head's (B, H, W, na, nc + 5) logits.

    Targets (M, 6) [img, cls, x, y, w, h] normalised, with an (M,) validity mask.
    ``dense`` is JAX's ``SKYEYE_DENSE_LOSS`` form (``_level_dense``): the targets
    are scattered into per-cell maps and every term is a dense masked reduction;
    equal to the gather form where no (image, anchor, cell) holds two
    assignments.
    """

    def __init__(self, anchors, num_classes: int, hyp: Optional[Dict[str, float]] = None,
                 dense: bool = False):
        self.hyp = dict(DEFAULT_HYP)
        if hyp:
            self.hyp.update(hyp)
        self.dense = dense
        self.anchors = torch.as_tensor(np.asarray(anchors, np.float32))  # (nl, na, 2)
        self.nl, self.na = self.anchors.shape[0], self.anchors.shape[1]
        self.nc = num_classes
        self.balance = [4.0, 1.0, 0.4] if self.nl == 3 else [4.0, 1.0, 0.25, 0.06, 0.02]
        self.cp, self.cn = smooth_bce(self.hyp.get("label_smoothing", 0.0))
        self.gamma = self.hyp.get("fl_gamma", 0.0)

    def _cls_obj_bce(self, pred, target):
        if self.gamma > 0:
            return focal_loss(pred, target, gamma=self.gamma, alpha=0.25)
        return bce_with_logits(pred, target)

    def _level_dense(self, pi, asg, w, i, img_weight, anchors, w_sum=None, img_sum=None):
        B, H, W, na, _ = pi.shape
        dev = pi.device
        wide = torch.promote_types(pi.dtype, torch.float32)
        m = asg["mask"]
        b_safe = torch.where(m, asg["b"].clamp(0, B - 1), torch.full_like(asg["b"], B))
        vals = torch.cat([w[:, None], w[:, None] * asg["tbox"],
                          (w * asg["cls"].float())[:, None]], dim=1)
        flat = ((b_safe * H + asg["gj"]) * W + asg["gi"]) * na + asg["a"]
        smap = torch.zeros(((B + 1) * H * W * na, 6), dtype=vals.dtype, device=dev)
        smap = smap.index_add(0, flat, vals).reshape(B + 1, H, W, na, 6)[:B].detach()
        w_map = smap[..., 0]
        pos = w_map > 0
        wsafe = w_map.clamp(min=1e-9)
        tbox = torch.where(pos[..., None], smap[..., 1:5] / wsafe[..., None],
                           torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev))
        tcls_idx = torch.round(smap[..., 5] / wsafe).long()

        awh = anchors[i][None, None, None, :, :]
        pxy = torch.sigmoid(pi[..., 0:2].to(wide)) * 2.0 - 0.5
        pwh = (torch.sigmoid(pi[..., 2:4].to(wide)) * 2.0) ** 2 * awh
        iou = bbox_iou(torch.cat([pxy, pwh], dim=-1), tbox, format="xywh", iou_type="ciou")
        wsum = (w_map.sum() if w_sum is None else w_sum.to(w_map.dtype)).clamp(min=1e-9)
        lbox = ((1.0 - iou) * w_map).sum() / wsum

        score_iou = torch.where(pos, iou.detach().clamp(min=0.0), torch.zeros_like(iou))
        obj_bce = self._cls_obj_bce(pi[..., 4].to(wide), score_iou)
        if img_weight is not None:
            lobj = masked_mean(obj_bce, img_weight, mask_sum=img_sum) * self.balance[i]
        else:
            lobj = _mean_over_batch(obj_bce, img_sum) * self.balance[i]

        lcls = torch.zeros((), dtype=wide, device=dev)
        if self.nc > 1:
            t_cls = self.cn + (self.cp - self.cn) * _one_hot_where(tcls_idx, self.nc, 1.0, 0.0)
            cls_bce = self._cls_obj_bce(pi[..., 5:].to(wide), t_cls)
            lcls = (cls_bce * w_map[..., None]).sum() / (wsum * self.nc)
        return lbox, lobj, lcls

    def __call__(self, predictions: Sequence[torch.Tensor], targets: torch.Tensor,
                 mask: torch.Tensor, img_weight: Optional[torch.Tensor] = None):
        """Returns (total, aux): aux = [lbox, lobj, lcls], detached.

        img_weight: optional (B,) per-image weights; the loader's wrap-around
        rows get 0, so their pixels feed BatchNorm but not the gradient."""
        dev = predictions[0].device
        targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
        mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
        anchors = self.anchors.to(dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        lbox, lobj, lcls = zero, zero, zero

        levels = []  # the assignments first: the normalisers are sums over them
        for i, pi in enumerate(predictions):
            B, H, W, na, _ = pi.shape
            row0, rows_all = _grid_rows(H)
            asg = build_targets_level(targets, mask, anchors[i], (rows_all, W),
                                      self.hyp["anchor_t"])
            if rows_all != H:
                asg = _own_rows(asg, row0, H)
            b_in = asg["b"].clamp(0, B - 1)
            w = asg["mask"].float()
            if img_weight is not None:
                w = w * img_weight[b_in]
            levels.append((asg, b_in, w))
        rows = (img_weight.sum() if img_weight is not None
                else torch.tensor(float(predictions[0].shape[0]), device=dev))
        sums = _global_sums([w.sum() for _, _, w in levels] + [rows])
        img_sum = sums[-1] if sums is not None else None

        for i, pi in enumerate(predictions):
            B, H, W, na, _ = pi.shape
            asg, b_in, w = levels[i]
            b, a, gj, gi, m = asg["b"], asg["a"], asg["gj"], asg["gi"], asg["mask"]
            w_sum = sums[i] if sums is not None else None

            if self.dense:
                lb, lo, lc = self._level_dense(pi, asg, w, i, img_weight, anchors, w_sum, img_sum)
                lbox, lobj, lcls = lbox + lb, lobj + lo, lcls + lc
                continue

            wide = torch.promote_types(pi.dtype, torch.float32)
            ps = pi[b_in, gj, gi, a].to(wide)                                  # (K, no)
            pxy = torch.sigmoid(ps[:, 0:2]) * 2.0 - 0.5
            pwh = (torch.sigmoid(ps[:, 2:4]) * 2.0) ** 2 * asg["anchor_wh"]
            iou = bbox_iou(torch.cat([pxy, pwh], dim=1), asg["tbox"], format="xywh",
                           iou_type="ciou")
            lbox = lbox + masked_mean(1.0 - iou, w, mask_sum=w_sum)

            # objectness target: the detached IoU, the largest where assignments collide
            score_iou = iou.detach().clamp(min=0.0)
            flat = ((_dropped(b, m, B) * H + gj) * W + gi) * na + a
            tobj = torch.zeros((B + 1) * H * W * na, dtype=wide, device=dev)
            tobj = tobj.scatter_reduce(0, flat, score_iou, reduce="amax", include_self=True)
            tobj = tobj[: B * H * W * na].reshape(B, H, W, na)
            obj_bce = self._cls_obj_bce(pi[..., 4].to(wide), tobj)
            if img_weight is not None:
                lobj = lobj + masked_mean(obj_bce, img_weight, mask_sum=img_sum) * self.balance[i]
            else:
                lobj = lobj + _mean_over_batch(obj_bce, img_sum) * self.balance[i]

            if self.nc > 1:
                t_cls = _one_hot_where(asg["cls"], self.nc, self.cp, self.cn)
                lcls = lcls + masked_mean(self._cls_obj_bce(ps[:, 5:], t_cls), w, mask_sum=w_sum)

        lbox = lbox * self.hyp["box"]
        lobj = lobj * self.hyp["obj"]
        lcls = lcls * self.hyp["cls"]
        total = lbox + lobj + lcls
        return total, torch.stack([lbox, lobj, lcls]).detach()


class AerialDetectionLoss:
    """Size-aware aerial loss, fixed-shape: each target goes to its best wh-IoU
    anchor when that IoU is above ``iou_thres``; CIoU box loss and
    modulated-BCE objectness and class terms; targets smaller than 64^2 / (W H)
    of the grid have their box loss added again with ``scales[3]``."""

    def __init__(self, anchors, num_classes: int,
                 scales: Tuple[float, float, float, float] = (0.5, 0.5, 1.0, 2.0),
                 iou_thres: float = 0.2):
        self.anchors = torch.as_tensor(np.asarray(anchors, np.float32))
        self.nc = num_classes
        self.scales = scales
        self.iou_thres = iou_thres

    def _assign(self, t: torch.Tensor, mask: torch.Tensor, awh: torch.Tensor, H: int, W: int):
        twh = t[:, 4:6]
        inter = torch.minimum(twh[:, None, :], awh[None, :, :]).prod(-1)
        union = twh.prod(-1)[:, None] + awh.prod(-1)[None, :] - inter
        anchor_iou = inter / (union + 1e-9)
        best_a = anchor_iou.argmax(dim=1)
        m = mask & (anchor_iou.amax(dim=1) > self.iou_thres)
        small = (t[:, 4] * t[:, 5]) < (64.0 * 64.0 / (W * H))
        return best_a, m, small

    def __call__(self, predictions, targets, mask):
        dev = predictions[0].device
        targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
        mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
        anchors = self.anchors.to(dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        lbox, lobj, lcls = zero, zero, zero

        levels = []  # the assignments first: the normalisers are sums over them
        for i, pi in enumerate(predictions):
            _, H, W, _, _ = pi.shape
            row0, rows_all = _grid_rows(H)
            gain = torch.tensor([1.0, 1.0, W, rows_all, W, rows_all], dtype=torch.float32,
                                device=dev)
            t = targets * gain
            best_a, m, small = self._assign(t, mask, anchors[i], rows_all, W)
            gj = t[:, 3].to(torch.int32).long().clamp(0, rows_all - 1)
            m = m & (gj >= row0) & (gj < row0 + H)  # this rank's rows
            levels.append((t, best_a, m, small, (gj - row0).clamp(0, H - 1)))
        local = [x for _, _, m, small, _ in levels for x in (m.sum(), (m & small).sum())]
        sums = _global_sums(local + [torch.tensor(float(predictions[0].shape[0]), device=dev)])
        rows = sums[-1] if sums is not None else None

        for i, pi in enumerate(predictions):
            pi = pi.float()
            B, H, W, na, _ = pi.shape
            t, best_a, m, small, gj = levels[i]
            m_sum, small_sum = (sums[2 * i], sums[2 * i + 1]) if sums is not None else (None, None)
            awh = anchors[i]
            gi = t[:, 2].to(torch.int32).long().clamp(0, W - 1)
            gj_grid = gj + _grid_rows(H)[0]  # the cell's row in the whole grid
            b = t[:, 0].to(torch.int32).long()

            ps = pi[b.clamp(0, B - 1), gj, gi, best_a]
            pxy = torch.sigmoid(ps[:, 0:2]) * 2.0 - 0.5 + torch.stack([gi.float(),
                                                                       gj_grid.float()], 1)
            pwh = (torch.sigmoid(ps[:, 2:4]) * 2.0) ** 2 * awh[best_a]
            iou = bbox_iou(torch.cat([pxy, pwh], 1), t[:, 2:6], format="xywh", iou_type="ciou")
            lbox = lbox + masked_mean(1.0 - iou, m, mask_sum=m_sum) * self.scales[0]
            lbox = lbox + masked_mean(1.0 - iou, m & small, mask_sum=small_sum) * self.scales[3]

            flat = ((_dropped(b, m, B) * H + gj) * W + gi) * na + best_a
            tobj = torch.zeros((B + 1) * H * W * na, dtype=torch.float32, device=dev)
            tobj = tobj.scatter_reduce(0, flat, torch.ones_like(iou), reduce="amax",
                                       include_self=True)
            tobj = tobj[: B * H * W * na].reshape(B, H, W, na)
            lobj = lobj + _mean_over_batch(modulated_bce(pi[..., 4], tobj), rows) * self.scales[1]

            if self.nc > 1:
                cls_idx = targets[:, 1].to(torch.int32).long().clamp(0, self.nc - 1)
                t_cls = F.one_hot(cls_idx, self.nc).float()
                lcls = lcls + masked_mean(modulated_bce(ps[:, 5:], t_cls), m,
                                          mask_sum=m_sum) * self.scales[2]

        total = lbox + lobj + lcls
        return total, torch.stack([lbox, lobj, lcls]).detach()
