"""fleet.utils: rank-tagged logging, the local filesystem client and
checkpoint auto-resume (counterpart of paddle_tpu/distributed/
fleet_utils.py).

``save_auto_resume`` writes a shard-aware checkpoint
(``distributed/checkpoint``) into ``{ckpt_dir}/{prefix}{step}``, then
the ``.complete`` marker, then drops all but the newest ``keep_last``;
``load_auto_resume`` loads the newest complete one into the layout of
the ``state_dict`` it is given, which may differ from the one that saved
it.  Not ported (ROADMAP queue 1 item 5): ``HDFSClient``, which shells
out to the hadoop CLI.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Optional

from .recompute import recompute, recompute_sequential

__all__ = ["logger", "get_logger", "set_log_level", "LocalFS",
           "ExecuteError", "latest_checkpoint", "save_auto_resume",
           "load_auto_resume", "recompute", "recompute_sequential"]


# ---------------------------------------------------------------- logging
def _rank() -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID", 0))


def get_logger(name: str = "paddle_tpu", level=logging.INFO,
               fmt: Optional[str] = None) -> logging.Logger:
    """A logger whose records carry the trainer rank (``PADDLE_TRAINER_ID``)
    (fleet_utils.py:33)."""
    log = logging.getLogger(name)
    if not log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            fmt or f"%(asctime)s [rank {_rank()}] %(levelname)s "
                   f"%(name)s: %(message)s"))
        log.addHandler(h)
        log.propagate = False
    log.setLevel(level)
    return log


logger = get_logger()


def set_log_level(level) -> None:
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    logger.setLevel(level)


# ------------------------------------------------------------- filesystem
class ExecuteError(RuntimeError):
    pass


class LocalFS:
    """``fleet.utils.fs.LocalFS`` (fleet_utils.py:63)."""

    def ls_dir(self, path: str):
        if not os.path.exists(path):
            return [], []
        dirs, files = [], []
        for n in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, n)) else files).append(n)
        return dirs, files

    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(path)

    def is_file(self, path: str) -> bool:
        return os.path.isfile(path)

    def is_exist(self, path: str) -> bool:
        return os.path.exists(path)

    def delete(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    mv = rename

    def touch(self, path: str, exist_ok: bool = True) -> None:
        if os.path.exists(path) and not exist_ok:
            raise ExecuteError(f"{path} exists")
        open(path, "a").close()

    def upload(self, local: str, remote: str) -> None:
        self.mkdirs(os.path.dirname(remote) or ".")
        if os.path.isdir(local):
            shutil.copytree(local, remote, dirs_exist_ok=True)
        else:
            shutil.copy2(local, remote)

    def download(self, remote: str, local: str) -> None:
        self.upload(remote, local)

    def list_dirs(self, path: str):
        return self.ls_dir(path)[0]


# ------------------------------------------------------------ auto-resume
def latest_checkpoint(ckpt_dir: str, prefix: str = "step_") -> Optional[str]:
    """The newest complete checkpoint under ``ckpt_dir``: a directory
    ``{prefix}{N}`` holding the ``.complete`` marker (fleet_utils.py:177)."""
    best, best_step = None, -1
    for d in LocalFS().list_dirs(ckpt_dir):
        if not d.startswith(prefix) or not d[len(prefix):].isdigit():
            continue
        step = int(d[len(prefix):])
        full = os.path.join(ckpt_dir, d)
        if step > best_step and os.path.exists(
                os.path.join(full, ".complete")):
            best, best_step = full, step
    return best


def save_auto_resume(state_dict, ckpt_dir: str, step: int,
                     prefix: str = "step_", keep_last: int = 2) -> str:
    """Save ``state_dict`` shard-aware into ``{ckpt_dir}/{prefix}{step}``,
    mark it complete, keep the newest ``keep_last`` step directories
    (fleet_utils.py:196).  Returns the directory."""
    from .checkpoint import save_state_dict
    fs = LocalFS()
    path = os.path.join(ckpt_dir, f"{prefix}{step}")
    fs.mkdirs(path)
    save_state_dict(state_dict, path)
    fs.touch(os.path.join(path, ".complete"))
    steps = sorted((int(d[len(prefix):]) for d in fs.list_dirs(ckpt_dir)
                    if d.startswith(prefix) and d[len(prefix):].isdigit()),
                   reverse=True)
    for s in steps[keep_last:]:
        fs.delete(os.path.join(ckpt_dir, f"{prefix}{s}"))
    return path


def load_auto_resume(state_dict, ckpt_dir: str, prefix: str = "step_"):
    """``(loaded, step)`` from the newest complete checkpoint, laid out as
    ``state_dict``; ``(state_dict, None)`` when there is none
    (fleet_utils.py:217)."""
    from .checkpoint import load_state_dict
    path = latest_checkpoint(ckpt_dir, prefix)
    if path is None:
        return state_dict, None
    step = int(os.path.basename(path)[len(prefix):])
    return load_state_dict(state_dict, path), step
