"""Build a shared library from sources in this package, at first use.

Libraries go to ``genome_assembly_tpu_torch/build/`` (listed in
``.gitignore``). Each build is one compiler subprocess under a timeout,
writing to a process-unique temporary name that is renamed into place, so
concurrent test workers never load a half-written library. A failed build
raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import os
import subprocess
import time

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

# seconds of the last build of each library in this process (None: loaded
# a library that was already built)
BUILD_SECONDS: dict[str, float | None] = {}


def build_shared_library(name: str, source: str, command: list[str],
                         timeout: float) -> str:
    """Return the path of ``lib<name>.so``, compiling it from ``source`` when
    it is missing or older than the source.

    ``command`` is the compiler invocation without the output file; ``-o
    <tmp>`` and the source path are appended. Raises RuntimeError with the
    compiler's output when it fails, cannot be started or times out.
    """
    path = os.path.join(BUILD_DIR, f"lib{name}.so")
    if (os.path.exists(path)
            and os.path.getmtime(path) >= os.path.getmtime(source)):
        BUILD_SECONDS.setdefault(name, None)
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    argv = [*command, "-o", tmp, source]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building lib{name}.so failed (exit {proc.returncode}): "
                f"{' '.join(argv)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(
            f"building lib{name}.so failed: {' '.join(argv)}: {exc}") from exc
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return path
