from .cell import (
    canonicalize_cell,
    cell_block_shape,
    cell_dtypes,
    cell_full_grid,
    cell_type,
    cell_zeros,
)
from .grid import BlockGrid, Grid
from .params import Params
from .stencil import Stencil
from .transition import (
    BaseTransitionFunction,
    static_field,
    transition_function,
    validate_transition_function,
)

__all__ = [
    "BaseTransitionFunction",
    "BlockGrid",
    "Grid",
    "Params",
    "Stencil",
    "canonicalize_cell",
    "cell_block_shape",
    "cell_dtypes",
    "cell_full_grid",
    "cell_type",
    "cell_zeros",
    "static_field",
    "transition_function",
    "validate_transition_function",
]
