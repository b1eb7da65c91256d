"""Observability + misc utilities (logger/timer roles of the reference's
'artwork' library and st16 logger subsystem)."""

from slam_tricks_tpu.utils import datasets  # noqa: F401
from slam_tricks_tpu.utils.logging import get_logger, log_var  # noqa: F401
from slam_tricks_tpu.utils.timer import Timer, time_median, timed  # noqa: F401
