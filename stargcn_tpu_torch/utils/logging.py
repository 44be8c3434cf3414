"""Logging + CSV metric logging.

The port's copy of ``stargcn_tpu/utils/logging.py``: ``logging_config``
(root logger to a file and, unless silenced, the console) and
``MetricLogger`` (CSV appender with per-column printf formats, flushed per
row).
"""

from __future__ import annotations

import logging
import os


def logging_config(folder: str, name: str = "log", level=logging.INFO,
                   no_console: bool = False) -> str:
    """Attach a file handler (and console unless silenced) to the root
    logger; returns the log path."""
    os.makedirs(folder, exist_ok=True)
    logpath = os.path.join(folder, name + ".log")
    root = logging.getLogger()
    for handler in list(root.handlers):
        root.removeHandler(handler)
    root.setLevel(level)
    fh = logging.FileHandler(logpath)
    fh.setLevel(level)
    root.addHandler(fh)
    if not no_console:
        ch = logging.StreamHandler()
        ch.setLevel(level)
        root.addHandler(ch)
    return logpath


class MetricLogger:
    """CSV appender with printf formats, flushed every row."""

    def __init__(self, attr_names, parse_formats, path):
        self._attr_names = list(attr_names)
        self._parse_formats = list(parse_formats)
        if len(self._attr_names) != len(self._parse_formats):
            raise ValueError("one format per column")
        self._file = open(path, "w")
        self._file.write(",".join(self._attr_names) + "\n")
        self._file.flush()

    def log(self, **kwargs):
        self._file.write(
            ",".join(fmt % kwargs[name] for fmt, name in
                     zip(self._parse_formats, self._attr_names)) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()
