from .bsr_lu import (  # noqa: F401
    BSRFactorization,
    LuNumericPlan,
    TriSolvePlan,
    bsr_backsolve,
    bsr_factorize,
    bsr_forsolve,
    bsr_lower,
    bsr_lu,
    bsr_lu_find_fills,
    bsr_lu_nofill,
    bsr_lu_numeric_apply,
    bsr_lu_numeric_prepare,
    bsr_lup,
    bsr_lup_nofill,
    bsr_ols,
    bsr_tri_plan,
    bsr_upper,
)
from .precond import (  # noqa: F401
    block_jacobi_apply,
    block_jacobi_prepare,
    bsr_ilu0_preconditioner,
)
