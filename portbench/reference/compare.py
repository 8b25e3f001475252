"""The comparisons that decide ``correct``: of HR frames, and of training
steps' losses, gradients and parameter changes."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def compare_frames(got: Dict[int, np.ndarray], want: Dict[int, np.ndarray]
                   ) -> Dict[str, float]:
    """The worst sampled frame's mean absolute difference in levels. A frame
    missing on the program's side reads infinity."""
    mad = 0.0
    for k, ref in want.items():
        if k not in got:
            return {"mad_levels": float("inf")}
        d = np.abs(np.asarray(got[k]).astype(np.int16) - np.asarray(ref).astype(np.int16))
        mad = max(mad, float(d.mean()))
    return {"mad_levels": mad}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   leaves: List[str]) -> float:
    """Over ``leaves``, the largest gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    if not leaves:
        return float("inf")
    median = float(np.median([want[k] for k in leaves]))
    return max(abs(got[k] - want[k]) / max(want[k], median) for k in leaves)
