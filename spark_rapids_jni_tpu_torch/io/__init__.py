"""I/O & metadata components (reference SURVEY.md §2.3): the Parquet
footer engine, the port's own page decoder and the split/stats-pruned
scan.  Nothing here imports pyarrow: pages decode on the host with
``native/parquet_pages.cpp`` and numpy."""

from .parquet import read_parquet, select_row_groups  # noqa: F401
from .parquet_footer import ParquetFooter, read_footer_bytes  # noqa: F401
