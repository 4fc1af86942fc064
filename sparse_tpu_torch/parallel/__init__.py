"""The distributed layer: partitioned sparse matrices over a 1-D mesh.

Port of ``sparse_tpu/parallel``.  A :class:`~.mesh.Mesh` holds the shards in
one process (``make_1d_mesh(n)``, on the card unless ``device="cpu"``) or
across the ranks of a ``torch.distributed`` group (``make_1d_mesh(n,
group=...)``, NCCL on cards, gloo on CPUs).  Every op runs its per-shard
body once for each shard this process holds, between the mesh's
``all_gather``, ``all_to_all`` and ``all_reduce``.  Two hand-written
kernels run per shard: K1 in ``halo_spmv_segtile`` and K7 in
``pbsr_smsmm_slab``.  The reference's ``_pallas`` names are ``_slab``
here (``PBsrSlabPlan``, ``build_pbsr_smsmm_plan_slab``,
``pbsr_smsmm_slab``).
"""

from .mesh import Mesh  # noqa: F401
from .pcsr import (  # noqa: F401
    PCSR,
    make_1d_mesh,
    pcsr_from_csr,
    pcsr_spmm,
    pcsr_spmv,
    pcsr_todense,
    put_sharded,
    shard_vector,
)
from .cg import (  # noqa: F401
    bicgstab_solve,
    cg_solve,
    cg_step,
    chebyshev_preconditioner,
    estimate_lmax,
    gmres_solve,
    pcg_solve,
    power_iteration_step,
)
from .halo import (  # noqa: F401
    HaloPCSR,
    HaloPCSROverlap,
    HaloSegtile,
    dist_spmv,
    halo_partition,
    halo_partition_overlapped,
    halo_partition_segtile,
    halo_spmm,
    halo_spmm_overlapped,
    halo_spmv,
    halo_spmv_overlapped,
    halo_spmv_segtile,
)
from .pbell import (  # noqa: F401
    PBELL,
    pbell_from_bell,
    pbell_shard_vector,
    pbell_smvm,
    pbell_spmm,
)
from .phub import (  # noqa: F401
    PHubSplit,
    phub_partition,
    phub_spmv,
)
from .pbsr import (  # noqa: F401
    PBSR,
    PBsrSlabPlan,
    PBsrSmsmmPlan,
    build_pbsr_smsmm_plan,
    build_pbsr_smsmm_plan_slab,
    pbsr_from_bsr,
    pbsr_smsmm,
    pbsr_smsmm_slab,
    pbsr_to_bsr,
)
from .pspgemm import (  # noqa: F401
    PSpGEMMPlan,
    PTransposePlan,
    build_pspgemm_plan,
    build_transpose_plan,
    pcsr_spgemm,
    pcsr_spgemm_aa,
    pcsr_transpose,
    pcsr_transpose_device,
)
