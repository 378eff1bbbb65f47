"""What the examples share: the `--device` option."""

from __future__ import annotations

import argparse

import torch


def parse_device(doc: str, argv=None, **extra) -> argparse.Namespace:
    """Parse `--device` (default cuda; cpu runs the plain versions) and
    any `extra` store_true flags ({flag: help})."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    for flag, text in extra.items():
        ap.add_argument(flag, action="store_true", help=text)
    args = ap.parse_args(argv)
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    return args
