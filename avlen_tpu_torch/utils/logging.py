"""Logger mirroring habitat.logger behavior (console + optional file handler,
habitat-lab-dialog/habitat/core/logging.py); a copy of
avlen_tpu/utils/logging.py under the port's own name."""

import logging
import sys


class _Logger(logging.Logger):
    def __init__(self):
        super().__init__("avlen_tpu_torch", logging.INFO)
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(asctime)-15s %(message)s"))
        self.addHandler(handler)

    def add_filehandler(self, path: str) -> None:
        fh = logging.FileHandler(path)
        fh.setFormatter(logging.Formatter("%(asctime)-15s %(message)s"))
        self.addHandler(fh)


logger = _Logger()
