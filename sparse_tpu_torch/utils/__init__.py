from .profiling import timed_op, trace  # noqa: F401
from .stats import matrix_stats, roofline_report, spmv_bytes  # noqa: F401
