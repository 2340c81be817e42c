"""Multi-process logging: the port's counterpart of ``accelerate_tpu/logging.py``.

``get_logger(name)`` returns a ``MultiProcessAdapter``: a record is logged on the main
process only unless the call passes ``main_process_only=False``.
``ACCELERATE_LOG_LEVEL`` sets the level.
"""

from __future__ import annotations

import logging
import os

__all__ = ["get_logger", "MultiProcessAdapter"]


class MultiProcessAdapter(logging.LoggerAdapter):
    """A logger adapter that drops records on processes other than the main one unless
    asked otherwise."""

    @staticmethod
    def _should_log(main_process_only: bool) -> bool:
        from .state import PartialState

        state = PartialState._shared_state
        return not main_process_only or state.get("process_index", 0) == 0

    def log(self, level, msg, *args, **kwargs):
        if not self.isEnabledFor(level):
            return
        main_process_only = kwargs.pop("main_process_only", True)
        kwargs.setdefault("stacklevel", 2)
        if self._should_log(main_process_only):
            msg, kwargs = self.process(msg, kwargs)
            self.logger.log(level, msg, *args, **kwargs)


def get_logger(name: str, log_level: str | None = None) -> MultiProcessAdapter:
    """A multi-process logger named ``name``."""
    logger = logging.getLogger(name)
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_LOG_LEVEL", None)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
