"""Source backup into the experiment directory (counterpart of
``nlspn_eccv20_tpu/utils/backup.py``): at the start of training the main
process copies the port's package into ``<save_dir>/code``, so that every
experiment records the code that produced it. Built libraries and caches
are left out.
"""

from __future__ import annotations

import os
import shutil

_IGNORE = shutil.ignore_patterns(
    "__pycache__", "*.pyc", ".git", "*.so", "build", "experiments",
    ".pytest_cache")


def backup_source_code(backup_dir: str) -> None:
    """Copy the nlspn_eccv20_tpu_torch package source into ``backup_dir``."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if os.path.exists(backup_dir):
        shutil.rmtree(backup_dir)
    shutil.copytree(pkg_root, os.path.join(backup_dir, os.path.basename(pkg_root)),
                    ignore=_IGNORE)
