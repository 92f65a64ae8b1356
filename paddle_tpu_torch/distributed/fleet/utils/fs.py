"""Filesystem clients for fleet checkpoint transport.

Counterpart of ``paddle_tpu/distributed/fleet/utils/fs.py`` (the
reference's ``python/paddle/distributed/fleet/utils/fs.py``: FS base,
LocalFS, and HDFSClient, which shells out to the hadoop CLI). The port
keeps its own copy: the module is host code, and the port imports
nothing of the JAX package. The checkpoint and elastic code move state
through this interface, so a remote store slots in without touching
training code. :func:`retry_with_backoff` retries a transient failure
with exponential backoff and jitter; an error that carries ``retryable =
False`` (a missing CLI) raises at once, so ``HDFSClient`` fails fast on
a machine without ``hadoop``.
"""

from __future__ import annotations

import logging
import os
import random
import shutil
import subprocess
import time
from typing import Callable, List, Optional, Tuple, TypeVar

__all__ = ["ExecuteError", "FSFileExistsError", "FSFileNotExistsError",
           "FSTimeOut", "FSShellCmdAborted", "FS", "LocalFS", "HDFSClient",
           "retry_with_backoff"]

logger = logging.getLogger("paddle_tpu_torch.fs")

_T = TypeVar("_T")


def retry_with_backoff(fn: Callable[[], _T], retries: int = 3,
                       base_delay: float = 0.5, max_delay: float = 30.0,
                       jitter: float = 0.5,
                       retry_on: Tuple[type, ...] = (Exception,),
                       what: str = "", sleep=time.sleep) -> _T:
    """Run ``fn`` with exponential backoff + jitter on transient failure.

    Replaces the reference's fixed-interval ``sleep_inter`` retry loop
    (fs.py HDFSClient): fixed-interval retries against a struggling
    store synchronize every worker's retries into the very thundering
    herd that is keeping the store struggling. Delay for attempt k is
    ``min(max_delay, base_delay * 2**k) * (1 + jitter*U[0,1))``; each
    failed attempt logs one line (store operations are sparse — silence
    here costs hours of debugging later). Exceptions carrying
    ``retryable = False`` (permanent failures: missing CLI, bad
    arguments) re-raise immediately; so do exception types outside
    ``retry_on``. Used by the HDFS transport and the ElasticManager
    heartbeat/marker writes."""
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            if not getattr(e, "retryable", True) or attempt >= retries:
                raise
            delay = min(max_delay, base_delay * (2.0 ** attempt))
            delay *= 1.0 + jitter * random.random()
            attempt += 1
            logger.warning(
                "%s failed (attempt %d/%d): %r — retrying in %.2fs",
                what or getattr(fn, "__name__", "operation"), attempt,
                retries + 1, e, delay)
            sleep(delay)


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FSTimeOut(Exception):
    pass


class FSShellCmdAborted(ExecuteError):
    pass


class _ProbeFalse(Exception):
    """Internal: a hadoop -test probe returned 'condition false'."""


class FS:
    """Abstract transport (the reference's fs.py ``FS``)."""

    def ls_dir(self, fs_path) -> Tuple[List[str], List[str]]:
        raise NotImplementedError

    def is_file(self, fs_path) -> bool:
        raise NotImplementedError

    def is_dir(self, fs_path) -> bool:
        raise NotImplementedError

    def is_exist(self, fs_path) -> bool:
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self) -> bool:
        raise NotImplementedError

    def rename(self, fs_src_path, fs_dst_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        raise NotImplementedError

    def list_dirs(self, fs_path) -> List[str]:
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError

    def cat(self, fs_path=None) -> str:
        raise NotImplementedError


class LocalFS(FS):
    """Local filesystem (the reference's fs.py ``LocalFS``)."""

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for e in os.listdir(fs_path):
            (dirs if os.path.isdir(os.path.join(fs_path, e))
             else files).append(e)
        return dirs, files

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def delete(self, fs_path):
        if self.is_dir(fs_path):
            shutil.rmtree(fs_path)
        elif self.is_file(fs_path):
            os.remove(fs_path)

    def need_upload_download(self):
        return False

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        if test_exists and not self.is_exist(src_path):
            raise FSFileNotExistsError(f"{src_path} does not exist")
        if self.is_exist(dst_path):
            if not overwrite:
                raise FSFileExistsError(f"{dst_path} exists")
            # REPLACE the destination: shutil.move into an existing dir
            # would nest the source inside it
            self.delete(dst_path)
        shutil.move(src_path, dst_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if exist_ok:
                return
            raise FSFileExistsError(f"{fs_path} exists")
        with open(fs_path, "a"):
            pass

    def upload(self, local_path, fs_path):
        # COPY (like the remote transports): the caller keeps its local
        # source — upload must never destroy the only local checkpoint
        if os.path.isdir(local_path):
            shutil.copytree(local_path, fs_path, dirs_exist_ok=True)
        else:
            shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        shutil.copy(fs_path, local_path)

    def cat(self, fs_path=None):
        with open(fs_path) as f:
            return f.read()


class HDFSClient(FS):
    """HDFS transport shelling out to the hadoop CLI (the reference's
    fs.py ``HDFSClient``, the same ``hadoop fs -ls/-put/-get`` command
    surface). Raises ExecuteError with the command output when the CLI
    is absent or a command fails."""

    def __init__(self, hadoop_home: str, configs: Optional[dict] = None,
                 time_out: int = 5 * 60 * 1000, sleep_inter: int = 1000,
                 retries: int = 3):
        self._hadoop = os.path.join(hadoop_home, "bin", "hadoop") \
            if hadoop_home else "hadoop"
        self._configs = configs or {}
        self._timeout = time_out / 1000.0
        # sleep_inter (ms, reference parity) seeds the BASE delay of the
        # backoff schedule; the fixed-interval loop it named is gone
        self._base_delay = max(sleep_inter, 1) / 1000.0
        self._retries = max(0, int(retries))

    def _run(self, *args, probe: bool = False,
             idempotent: bool = True) -> str:
        """Run a hadoop fs command with retry/backoff. `probe=True` is
        the `-test` mode: return code 1 with empty stderr means
        "condition false" (not an error) and raises _ProbeFalse; every
        other failure — missing CLI, permissions, network — still
        raises, so a broken transport can NEVER masquerade as "file does
        not exist". Transient failures (nonzero exit, CLI timeout) are
        retried with exponential backoff; a missing CLI is permanent and
        raises immediately. ``idempotent=False`` (mv/put/touchz)
        disables retry entirely: a timed-out rename may have SUCCEEDED
        server-side, and re-running it would convert that success into a
        spurious "source does not exist" failure — those callers must
        see the first error and decide with a probe."""
        cmd = [self._hadoop, "fs"]
        for k, v in self._configs.items():
            cmd += [f"-D{k}={v}"]
        cmd += list(args)

        def attempt() -> str:
            try:
                out = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=self._timeout)
            except FileNotFoundError as e:
                err = ExecuteError(
                    f"hadoop CLI not found at {self._hadoop!r}: {e}")
                err.retryable = False      # retrying won't grow a CLI
                raise err from e
            except subprocess.TimeoutExpired as e:
                raise FSTimeOut(f"{' '.join(cmd)} timed out") from e
            if out.returncode != 0:
                if probe and out.returncode == 1 and not out.stderr.strip():
                    raise _ProbeFalse()
                raise ExecuteError(
                    f"{' '.join(cmd)} failed: {out.stderr.strip()[:500]}")
            return out.stdout

        return retry_with_backoff(
            attempt,
            retries=self._retries if idempotent else 0,
            base_delay=self._base_delay,
            retry_on=(ExecuteError, FSTimeOut),
            what=" ".join(cmd[:4]) + (" ..." if len(cmd) > 4 else ""))

    def ls_dir(self, fs_path):
        out = self._run("-ls", fs_path)
        dirs, files = [], []
        for line in out.splitlines():
            # -ls format: perms repl owner group size date time path — the
            # path (which may contain spaces) is everything after field 7
            parts = line.split(None, 7)
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[7])
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]

    def is_exist(self, fs_path):
        try:
            self._run("-test", "-e", fs_path, probe=True)
            return True
        except _ProbeFalse:
            return False

    def is_file(self, fs_path):
        try:
            self._run("-test", "-f", fs_path, probe=True)
            return True
        except _ProbeFalse:
            return False

    def is_dir(self, fs_path):
        try:
            self._run("-test", "-d", fs_path, probe=True)
            return True
        except _ProbeFalse:
            return False

    def upload(self, local_path, fs_path):
        self._run("-put", local_path, fs_path, idempotent=False)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)

    def mkdirs(self, fs_path):
        self._run("-mkdir", "-p", fs_path)

    def delete(self, fs_path):
        self._run("-rm", "-r", "-f", fs_path)

    def need_upload_download(self):
        return True

    def rename(self, fs_src_path, fs_dst_path):
        self._run("-mv", fs_src_path, fs_dst_path, idempotent=False)

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        if test_exists and not self.is_exist(fs_src_path):
            raise FSFileNotExistsError(f"{fs_src_path} does not exist")
        if self.is_exist(fs_dst_path):
            if not overwrite:
                raise FSFileExistsError(f"{fs_dst_path} exists")
            self.delete(fs_dst_path)
        self._run("-mv", fs_src_path, fs_dst_path, idempotent=False)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if exist_ok:
                return
            raise FSFileExistsError(f"{fs_path} exists")
        self._run("-touchz", fs_path, idempotent=False)

    def cat(self, fs_path=None):
        return self._run("-cat", fs_path)
