"""Logging: colored console + per-stage file logs with a custom NOTICE level.

The port's copy of ``geotrax_tpu/utils/logging_utils.py``: the NOTICE level
(25) between INFO and WARNING, an ANSI-colored console formatter, a plain
file formatter, platform-specific default log directories, and a
``setup_logger`` that skips the file handler on dry runs.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

NOTICE_LEVEL = 25
logging.addLevelName(NOTICE_LEVEL, "NOTICE")


def _notice(self, message, *args, **kwargs):
    if self.isEnabledFor(NOTICE_LEVEL):
        self._log(NOTICE_LEVEL, message, args, **kwargs)


logging.Logger.notice = _notice  # type: ignore[attr-defined]


class AnsiColors:
    RESET = "\033[0m"
    BOLD = "\033[1m"
    GREY = "\033[90m"
    GREEN = "\033[92m"
    YELLOW = "\033[93m"
    RED = "\033[91m"
    CYAN = "\033[96m"


_LEVEL_COLOR = {
    logging.DEBUG: AnsiColors.GREY,
    logging.INFO: "",
    NOTICE_LEVEL: AnsiColors.GREEN,
    logging.WARNING: AnsiColors.YELLOW,
    logging.ERROR: AnsiColors.RED,
    logging.CRITICAL: AnsiColors.BOLD + AnsiColors.RED,
}


class ConsoleFormatter(logging.Formatter):
    """Colorizes the level name; messages stay plain for readability."""

    def format(self, record: logging.LogRecord) -> str:
        color = _LEVEL_COLOR.get(record.levelno, "")
        base = super().format(record)
        if color and sys.stderr.isatty():
            return f"{color}{base}{AnsiColors.RESET}"
        return base


class FileFormatter(logging.Formatter):
    pass


def default_log_dir(app: str = "geotrax-tpu") -> Path:
    """Platform log dir: XDG state (linux), ~/Library/Logs (mac), LOCALAPPDATA (win)."""
    if sys.platform == "darwin":
        return Path.home() / "Library" / "Logs" / app
    if sys.platform in ("win32", "cygwin"):
        root = os.environ.get("LOCALAPPDATA", str(Path.home()))
        return Path(root) / app / "logs"
    root = os.environ.get("XDG_STATE_HOME", str(Path.home() / ".local" / "state"))
    return Path(root) / app / "logs"


def setup_logger(
    name: str,
    verbose: bool = False,
    log_path: str | os.PathLike | None = None,
    dry_run: bool = False,
) -> logging.Logger:
    """Create (or refresh) a stage logger.

    Console handler at INFO (DEBUG when verbose); file handler at INFO in the
    platform log dir unless ``dry_run`` (no file side effects then).
    """
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)

    console = logging.StreamHandler()
    console.setLevel(logging.DEBUG if verbose else logging.INFO)
    console.setFormatter(ConsoleFormatter("%(levelname)s: %(message)s"))
    logger.addHandler(console)

    if not dry_run:
        log_dir = Path(log_path) if log_path else default_log_dir()
        try:
            log_dir.mkdir(parents=True, exist_ok=True)
            fh = logging.FileHandler(log_dir / f"{name}.log")
            fh.setLevel(logging.INFO)
            fh.setFormatter(
                FileFormatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
            )
            logger.addHandler(fh)
        except OSError:
            logger.debug("could not open log file in %s", log_dir)
    return logger
