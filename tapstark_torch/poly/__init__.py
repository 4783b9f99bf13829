"""Polynomial layer of the port (twin of `tapstark.poly`): the reference's
exports, each bound to the port's function. The reference's jitted twins
(`*_jit`) have no counterpart: the port's functions are eager torch, and
the kernels sit in `cuda_ntt`, `cols_ntt` and `matmul_ntt`. As in the
reference, the package's `ntt` is the function; the module is
`sys.modules["tapstark_torch.poly.ntt"]`."""

from .domain import LagrangeSelectors, TwoAdicMultiplicativeCoset
from .fold import fold_matrix, fold_row_scalar
from .interpolate import interpolate_coset, interpolate_coset_host
from .ntt import bit_reverse_rows, coset_lde_batch, intt, ntt
from .powers import np_geom_powers
from .reduce import fp_sum_axis0

__all__ = [
    "LagrangeSelectors",
    "TwoAdicMultiplicativeCoset",
    "fold_matrix",
    "fold_row_scalar",
    "interpolate_coset",
    "interpolate_coset_host",
    "bit_reverse_rows",
    "coset_lde_batch",
    "intt",
    "ntt",
    "np_geom_powers",
    "fp_sum_axis0",
]
