from . import operator, reference, semiring, spgemm, spmv_dia  # noqa: F401
from . import spmv_exec, sptrsv, strategy  # noqa: F401
from .spmv_dia import spmv_dia as spmv_dia_plan  # noqa: F401
from .operator import SparseOperator  # noqa: F401
from .reference import golden, spmm, spmv, spmv_numpy  # noqa: F401
from .semiring import (MAX_PLUS, MAX_TIMES, MIN_PLUS, OR_AND,  # noqa: F401
                       PLUS_TIMES, Semiring)
from .spmv_exec import spmv_plan  # noqa: F401
