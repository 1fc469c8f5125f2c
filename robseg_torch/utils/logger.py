"""Print + append-to-file logger; parity ``semseg/utils/utils.py:311-320``."""

from __future__ import annotations

import os
from typing import Optional


class Logger:
    """``quiet``: neither print nor write (a data-parallel rank other
    than 0)."""

    def __init__(self, log_path: Optional[str] = None, quiet: bool = False):
        self.log_path = log_path
        self.quiet = quiet
        if log_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)),
                        exist_ok=True)

    def log(self, msg: str) -> None:
        if self.quiet:
            return
        print(msg, flush=True)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(f"{msg}\n")
