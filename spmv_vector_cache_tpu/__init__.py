"""spmv_vector_cache_tpu — a sparse linear-algebra library in JAX.

Built from scratch with the capabilities of the FPGA SpMV accelerator
``maltanar/spmv-vector-cache`` (see SURVEY.md); its executors target
NVIDIA GPUs:

* :mod:`.formats` — CSR/CSC/COO/BSR/ELL pytree containers, conversions, the
  reference's binary wire format, the structure analyses (maxAlive,
  maxColSpan, row-start marking) and the plan families they select;
* :mod:`.ops` — semiring-parameterized SpMV/SpMM/SpGEMM/triangular
  executors: jnp reference executors plus one fused executor per plan
  family (the BufferAll/BufferNone/BufferSel/vector-cache design space
  becomes a choice of layout);
* :mod:`.parallel` — multi-device scaling via shard_map row partitioning
  with halo/all-gather exchange of the dense vector;
* :mod:`.models` — solvers built on the executors (CG, Jacobi, power
  iteration/PageRank, GCN);
* :mod:`.utils` — stat registry, roofline observatory, platform route,
  compile cache;
* :mod:`.native` + :mod:`.native_lib` — C++ host-side reference runtime
  (golden kernel, analyses, format IO) mirroring the reference's software/
  layer, exposed via ctypes.
"""

from . import formats, models, ops, parallel, utils  # noqa: F401
from .formats.containers import BSR, COO, CSC, CSR, ELL  # noqa: F401
from .formats.plan import auto_plan  # noqa: F401
from .ops import semiring  # noqa: F401
from .ops.operator import SparseOperator  # noqa: F401
from .ops.reference import golden, spmm, spmv, spmv_numpy  # noqa: F401
from .ops.spmv_exec import spmv_plan  # noqa: F401

__version__ = "0.1.0"
