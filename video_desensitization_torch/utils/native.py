"""Build a shared library from one of the package's C++/CUDA sources at
first use, into ``video_desensitization_torch/_build/`` (git-ignored).

The library's name carries the source's hash, so an edited source builds
anew. It is compiled to a temporary file and moved into place with
``os.replace``, so processes building at once never load a half-written
library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE_DIR / "_build"


def build_library(source: Path, compiler: Sequence[str], libs: Sequence[str] = ()) -> Path:
    """Compile ``source`` with ``compiler`` (the command and its flags, up
    to the output name) and link ``libs``, unless a library built from the
    same bytes exists. Returns the library's path; the compiler's output
    goes to ``<lib>.log``."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [*compiler, "-o", tmp, str(source), *libs], capture_output=True, text=True
    )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{compiler[0]} failed on {source}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib
