"""Console logger of the execution layer.

Copy of ``phd_qmclib_tpu.qmc_exec.logging`` under a logger name of its
own.  The upstream library uses colorlog (``qmc_exec/logging.py:14-37``); here a plain
ANSI-colored ``logging`` formatter avoids the extra dependency.
"""
import logging
import sys

__all__ = ["exec_logger"]

_COLORS = {
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[41m",
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        color = _COLORS.get(record.levelno, "")
        prefix = (f"{color}[{self.formatTime(record, '%H:%M:%S')}] "
                  f"{record.levelname:8s}{_RESET}")
        return f"{prefix} {record.getMessage()}"


exec_logger = logging.getLogger("phd-qmclib-torch")
exec_logger.setLevel(logging.DEBUG)
if not exec_logger.handlers:
    _handler = logging.StreamHandler(stream=sys.stdout)
    _handler.setFormatter(_ColorFormatter())
    exec_logger.addHandler(_handler)
    exec_logger.propagate = False
