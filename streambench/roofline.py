"""The yardstick's device numbers: peaks by card, and the bytes a
kernel call needs."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def peak(kind, name: str):
    """``name`` of the card ``kind`` (its ``torch.cuda.get_device_name``),
    or None for a card the table lacks."""
    return PEAKS.get(kind or "", {}).get(name)


def seq_rolling_bytes(rows: int, keys: np.ndarray, key_size: int = 4,
                      value_size: int = 8) -> int:
    """Bytes one ``seq_rolling`` call needs: each row's key and value
    read and its emission written once, each touched plane entry read
    and written once (``chip_smoke.py:path_kernel_case``)."""
    touched = int(np.unique(keys).size)
    return rows * (key_size + 2 * value_size) + 2 * touched * value_size
