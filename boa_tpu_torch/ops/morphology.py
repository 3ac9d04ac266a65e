"""Binary morphology with scipy's semantics.

Counterpart of `binary_dilation_cross` in `boa_tpu/ops/morphology.py`:
`scipy.ndimage.binary_dilation` with the default cross structuring element
(the 6-neighbourhood) and `iterations=N`, as TotalSegmentator's
`remove_outside_of_mask` calls it. One iteration is the max of the mask and
its six one-voxel shifts, with zeros shifted in at the borders. The rest of
the reference's morphology is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def binary_dilation_cross(mask, iterations: int = 1) -> np.ndarray:
    """uint8 mask dilated `iterations` times by the 6-neighbourhood cross."""
    m = torch.from_numpy(np.asarray(mask) > 0)
    for _ in range(iterations):
        out = m.clone()
        for ax in range(3):
            n = m.shape[ax]
            out.narrow(ax, 1, n - 1).logical_or_(m.narrow(ax, 0, n - 1))
            out.narrow(ax, 0, n - 1).logical_or_(m.narrow(ax, 1, n - 1))
        m = out
    return m.to(torch.uint8).numpy()
