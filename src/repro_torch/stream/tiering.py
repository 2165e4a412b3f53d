"""Per-row flush trim (the part of `repro/stream/tiering.py` the untiered
flush uses).  Hot/cold tiering itself is a later slice of the port."""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.sketch import CHUNK


def fill_classes(fill: np.ndarray, rows: np.ndarray, cap_cols: int
                 ) -> list[tuple[int, np.ndarray]]:
    """Group active rows by their CHUNK-rounded fill: each group's upload
    is padded to ITS OWN rounded fill, so one hot tenant does not inflate
    every other tenant's flush width to the batch max.

    Returns [(cols, rows_of_class)] with cols ascending; `cap_cols` caps
    each class at the ring width.  Rows within a class keep their input
    (ascending) order."""
    if rows.size == 0:
        return []
    rounded = np.minimum(
        int(cap_cols),
        CHUNK * -(-fill[rows].astype(np.int64) // CHUNK))
    return [(int(cols), rows[rounded == cols])
            for cols in np.unique(rounded)]
