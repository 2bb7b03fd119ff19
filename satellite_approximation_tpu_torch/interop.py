"""State carried across from the JAX package.

The fill has no weights; its state is the multigrid hierarchy of a mask: the
(umask, deg) pair of every level plus the dense inverse of the coarsest
operator. :func:`hierarchy_from_numpy` turns that state, fetched from the JAX
package as numpy arrays, into the port's :class:`Hierarchy`, so both packages
can run a V-cycle or a PCG solve on the same state.
"""

from __future__ import annotations

import numpy as np

from .device import as_tensor, resolve_device
from .models.multigrid import Hierarchy


def hierarchy_from_numpy(levels, coarse_inv, device=None) -> Hierarchy:
    """``levels``: sequence of (umask, deg) array pairs, finest first;
    ``coarse_inv``: the coarsest operator's dense inverse or None. Masks
    become bool, degrees and the inverse f32, all on ``device``."""
    dev = resolve_device(device)
    lv = tuple(
        (as_tensor(np.asarray(m, bool), dev), as_tensor(np.asarray(d, np.float32), dev))
        for m, d in levels
    )
    ci = None if coarse_inv is None else as_tensor(np.asarray(coarse_inv, np.float32), dev)
    return Hierarchy(lv, ci)


__all__ = ["Hierarchy", "hierarchy_from_numpy"]
