"""What the measurement tools share: the ``--cpu`` flag and the device it
picks, a log on standard error, and the card's name and power limit."""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from nvae_torch.device import resolve_device


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def add_cpu_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU (default: the card, which "
                             "must exist)")


def tool_device(args) -> torch.device:
    """The card unless ``args.cpu``; raises if the card is asked for and
    there is none."""
    return resolve_device("cpu" if args.cpu else "cuda")


def device_info(device: torch.device) -> dict:
    """``{"platform", "kind", "count", "power_limit"}`` of ``device``: the
    card's name, the cards on the host and the card's power limit as
    ``nvidia-smi`` reads it (None where it cannot be read), or the CPU."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "power_limit": None}
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30, check=True)
        limit = out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
            "power_limit": limit}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
