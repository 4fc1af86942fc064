from .dense import (  # noqa: F401
    backsolve_dense,
    forsolve_dense,
    lu_dense,
    lup_dense,
    perm_compose,
    perm_id,
    perm_inverse,
    perm_to_matrix,
    permute,
    rowsolve_upper,
)
