"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes plain C functions and is compiled on its own
into ``_build/lib<name>-<hash>.so`` (the hash is of the source, every
``csrc/*.cuh`` it includes, and the flags, so an edited source or header is
rebuilt and an unchanged one is reused), with
nvcc's output (the ``-Xptxas -v`` register and spill summary) beside it in
``lib<name>-<hash>.log``.
Sources are compiled in parallel, one ``nvcc`` each.  Nothing here runs at
import time: the library is built at first use, on a host with the CUDA
toolkit.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
KERNELS = ("decode_attention", "flash_attention", "contraction", "probe", "grouped_matmul",
           "ssm_scan", "matmul_pom", "stencil", "flash_attention_bwd", "ssm_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, object] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def headers(path: Path) -> list:
    """The ``csrc`` headers that ``path`` includes (``#include "x.cuh"``),
    directly or through another header, in the order first seen."""
    seen: list = []
    todo = [path]
    while todo:
        text = todo.pop(0).read_text()
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, flags=re.M):
            h = CSRC / inc
            if h not in seen:
                seen.append(h)
                todo.append(h)
    return seen


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for h in headers(src):
        digest.update(h.name.encode() + h.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def log_path(name: str) -> Path:
    """nvcc's output for the library ``lib_path(name)``."""
    return lib_path(name).with_suffix(".log")


def sass_counts(name: str, mnemonics=("HGMMA", "UTMALDG")) -> Dict[str, int]:
    """How many instructions of each mnemonic the built library of ``name``
    holds (``cuobjdump -sass``): HGMMA is wgmma, UTMALDG a TMA load."""
    tool = Path(nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(build([name])[name])], capture_output=True,
                          text=True, check=True).stdout
    return {m: len(re.findall(rf"\b{m}\b", sass)) for m in mnemonics}


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all at once.

    Returns name -> library path.  Raises ``RuntimeError`` with nvcc's
    output if any compile fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: lib_path(n) for n in names}
    procs = {}
    for n in names:
        if paths[n].exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}{err}")
            os.unlink(tmp)
        else:
            paths[n].with_suffix(".log").write_text(out + err)
            os.replace(tmp, paths[n])   # atomic: a concurrent build sees old or new
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str):
    """The ``ctypes.CDLL`` of kernel ``name``, built at first use."""
    import ctypes

    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        return lib
