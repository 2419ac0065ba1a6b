"""Experiment bookkeeping: code and config snapshots.

The port's copy of ``instant_nsr_pl_tpu/utils/callbacks.py`` (the
reference's CodeSnapshotCallback / ConfigSnapshotCallback,
utils/callbacks.py:16-91): when training starts, the tracked source tree and
the parsed and raw configs are copied into the experiment directory, so
every run can be reproduced from its own folder.
"""

from __future__ import annotations

import os
import shutil
import subprocess

from instant_nsr_pl_tpu_torch.config import dump_config


def snapshot_code(dest_dir, repo_root=None):
    """Copy every git-tracked file of ``repo_root`` (default: the working
    directory) into ``dest_dir`` (reference utils/callbacks.py:58-76).
    Returns ``dest_dir``, or None where git or a repository is missing."""
    repo_root = repo_root or os.getcwd()
    try:
        out = subprocess.run(["git", "ls-files"], cwd=repo_root, check=True,
                             capture_output=True, text=True).stdout
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    os.makedirs(dest_dir, exist_ok=True)
    for rel in out.splitlines():
        src = os.path.join(repo_root, rel)
        if not os.path.isfile(src):
            continue
        dst = os.path.join(dest_dir, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy2(src, dst)
    return dest_dir


def snapshot_config(dest_dir, config, raw_config_path=None):
    """Dump the resolved config as ``parsed.yaml`` and copy the raw yaml as
    ``raw.yaml`` into ``dest_dir`` (reference utils/callbacks.py:79-91)."""
    os.makedirs(dest_dir, exist_ok=True)
    dump_config(os.path.join(dest_dir, "parsed.yaml"), config)
    if raw_config_path and os.path.isfile(raw_config_path):
        shutil.copy2(raw_config_path, os.path.join(dest_dir, "raw.yaml"))
    return dest_dir
