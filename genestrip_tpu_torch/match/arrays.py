"""Carries the matcher's device state across from the host arrays.

genestrip_tpu keeps three arrays on the device for matching: the hash
`rows` and the value table `vaux` (genestrip_tpu/match/pipeline.py
build_match_arrays) and the ancestor table `tree.ancestor_at_depth`. The
port builds the same arrays on the host (store/hash.py build_hash or a
database's persisted hash, match/pipeline.py vaux_from_nov) and turns them
into tensors here. The database zip format is shared, so a db written by
either package loads in the other unchanged.
"""

from __future__ import annotations

import numpy as np
import torch


def match_arrays_from_numpy(rows: np.ndarray, vaux: np.ndarray,
                            anc: np.ndarray, device: torch.device) -> dict:
    """Device tensors for match_step: rows [NB, 8] int32 (the dense-pass
    kernel's contiguous input), vaux [n_values + 1, 4] and anc [T, D] as
    int64 (they are gathered by index and their values feed int64 math)."""
    return {
        "rows": torch.tensor(np.asarray(rows, np.int32), device=device),
        "vaux": torch.tensor(np.asarray(vaux, np.int64), device=device),
        "anc": torch.tensor(np.asarray(anc, np.int64), device=device),
    }
