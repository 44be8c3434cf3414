"""Host graph kernels (NumPy).

The port's copy of the NumPy half of ``stargcn_tpu/graph/kernels.py``, cut
to what the serving path reads.  The JAX package's optional C++ extension
is not built here; a later slice adds the port's own if host speed needs
it.
"""

from __future__ import annotations

import numpy as np


def row_indices_from_indptr(ind_ptr: np.ndarray, nnz: int) -> np.ndarray:
    """CSR -> COO row expansion."""
    ind_ptr = np.ascontiguousarray(ind_ptr, dtype=np.int32)
    assert int(ind_ptr[-1]) == int(nnz)
    return np.repeat(
        np.arange(ind_ptr.size - 1, dtype=np.int32),
        np.diff(ind_ptr)).astype(np.int32)
