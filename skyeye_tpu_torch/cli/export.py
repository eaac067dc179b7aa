"""Export CLI: deployment artifacts of a detector.

Port of ``skyeye_tpu/cli/export.py``. The detector is loaded as JAX's export
loads it (``load_model``, BatchNorm folded) and written in any of three
formats, JAX's under the port's names:

  * ``torch``        the reference-layout ``.pt`` (``utils/checkpoint.py``
                     ``export_torch``): the same file JAX's ``torch`` format
                     writes, which both packages read;
  * ``torch_export`` (JAX: ``stablehlo``) a ``torch.export`` program of forward
                     plus ``decode_predictions`` on (batch, img, img, 3) frames,
                     saved with ``torch.export.save``, as JAX exports forward
                     plus decode to StableHLO. K4 stays one node
                     (``skyeye::flash_attention``);
  * ``checkpoint``   (JAX: ``orbax``) ``save_model``'s file, which the port's
                     ``load_model`` reads back as it is.

The default is JAX's pair under the port's names; JAX's names raise, naming
the port's format. ``--half`` gives the program bf16 frames (the model computes
in its dtype, as JAX's does). The model runs on ``--device`` (the card unless
the caller asks for the CPU).

Usage: python -m skyeye_tpu_torch.cli.export --weights best.pt \\
           --formats torch_export checkpoint --img-size 640
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Sequence

import torch
from torch import nn

from ..models.head import decode_predictions
from ..utils.checkpoint import export_torch, fuse_conv_bn, load_model, save_model
from ..utils.general import LOGGER

FORMATS = ("torch_export", "checkpoint", "torch")
JAX_FORMATS = {"stablehlo": "torch_export", "orbax": "checkpoint"}


class DecodedForward(nn.Module):
    """(B, img, img, 3) frames -> (B, N, nc + 5) decoded predictions."""

    def __init__(self, model: nn.Module, img_size: int):
        super().__init__()
        self.model, self.img_size = model, img_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = self.model(x.permute(0, 3, 1, 2))
        return decode_predictions(outs, self.model.config.anchors, (self.img_size, self.img_size))


def export_program(module: nn.Module, img_size: int, batch: int, out: Path,
                   dtype: torch.dtype = torch.float32) -> Path:
    """``torch.export`` of forward + decode at (batch, img_size, img_size, 3)."""
    device = next(module.parameters()).device
    x = torch.zeros((batch, img_size, img_size, 3), dtype=dtype, device=device)
    with torch.no_grad():
        program = torch.export.export(DecodedForward(module, img_size).eval(), (x,))
    torch.export.save(program, out)
    LOGGER.info("torch.export program: %s (%.1f KB)", out, out.stat().st_size / 1024)
    return out


def run(weights: str, formats: Sequence[str] = ("torch_export", "checkpoint"),
        img_size: int = 640, batch: int = 1, output: str = "exports", half: bool = False,
        device: str = "cuda") -> List[Path]:
    for fmt in formats:
        if fmt in JAX_FORMATS:
            raise ValueError(f"{fmt!r} is the JAX package's format; the port writes "
                             f"{JAX_FORMATS[fmt]!r} in its place")
        if fmt not in FORMATS:
            raise ValueError(f"unknown export format {fmt!r}; one of {FORMATS}")
    module = load_model(weights, device=device)
    module.load_state_dict(fuse_conv_bn(module.state_dict()), strict=True)
    out_dir = Path(output)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for fmt in formats:
        if fmt == "torch_export":
            results.append(export_program(module, img_size, batch, out_dir / "model.pt2",
                                          torch.bfloat16 if half else torch.float32))
        elif fmt == "checkpoint":
            results.append(save_model(module, out_dir / "checkpoint.pt"))
            LOGGER.info("checkpoint export: %s", results[-1])
        else:
            results.append(export_torch(module, out_dir / "model.pt"))
    return results


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description="SkyEye export (PyTorch port)")
    p.add_argument("--weights", type=str, required=True)
    p.add_argument("--formats", nargs="+", default=["torch_export", "checkpoint"],
                   choices=[*FORMATS, *JAX_FORMATS])
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--output", type=str, default="exports")
    p.add_argument("--half", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_opt(argv)
    run(**vars(opt))


if __name__ == "__main__":
    main()
