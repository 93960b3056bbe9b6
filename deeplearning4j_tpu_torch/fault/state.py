"""The integrity rule shared by model zips and fault checkpoints
(counterpart of `deeplearning4j_tpu/fault/state.py:117-122`): crc32
over an array's C-order bytes, as `np.savez` stores them."""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np


def checksum_array(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def checksum_flat(flat: Dict[str, np.ndarray]) -> Dict[str, int]:
    return {k: checksum_array(v) for k, v in flat.items()}
