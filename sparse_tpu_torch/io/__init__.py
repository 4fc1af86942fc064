from .matrix_market import mm_read, mm_read_coo, mm_write  # noqa: F401
