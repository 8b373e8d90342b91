"""Build and load the CUDA kernels (``csrc/*.cu``) as one shared library.

Each source is compiled by ``nvcc`` for ``sm_90a`` in parallel, the objects
are linked into ``_build/libtcm_kernels_<hash>.so`` (the hash covers the
sources and flags, so an edited source rebuilds), and the library is loaded
with ``ctypes`` on first use.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
ptxas_log = ""  # register / shared-memory report of the last build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` (one ``nvcc`` per source, all at once) and link
    them into one shared library; returns its path.  Raises on any compiler
    error, with the compiler's output."""
    global ptxas_log
    out = BUILD_DIR / f"libtcm_kernels_{_digest()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    ptxas_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{ptxas_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            i64p = ctypes.POINTER(ctypes.c_longlong)
            so.tcm_matmul_f32_launch.argtypes = [p, p, p] + [i] * 6 + [p]
            so.tcm_matmul_f32_launch.restype = i
            so.tcm_matmul_bf16_launch.argtypes = [p, p, p] + [i] * 6 + [p]
            so.tcm_matmul_bf16_launch.restype = i
            so.tcm_matmul_bf16_instance.argtypes = [i, i]
            so.tcm_matmul_bf16_instance.restype = i
            so.tcm_matmul_bf16_instances.argtypes = []
            so.tcm_matmul_bf16_instances.restype = i
            so.tcm_flash_attention_launch.argtypes = [
                p, p, p, p, i, i, i, i, i, i, i64p, i64p, i64p, i, i, i, f,
                i, p]
            so.tcm_flash_attention_launch.restype = i
            ll = ctypes.c_longlong
            so.tcm_criteria_launch.argtypes = [p, i, i, i, i, p, ll, i, i, i,
                                               p, p]
            so.tcm_criteria_launch.restype = i
            so.tcm_criteria_eval.argtypes = [i, p, p, ll, i, i, i, i, ll, i,
                                             i, i, p, p, p]
            so.tcm_criteria_eval.restype = i
            so.tcm_error_string.argtypes = [i]
            so.tcm_error_string.restype = ctypes.c_char_p
            _lib = so
        return _lib


def _kernel_name(mangled: str) -> str:
    """``wgmma_matmul<2,128>`` from an Itanium-mangled kernel name (nested
    names, int template arguments)."""
    pos, ids = (3 if mangled.startswith("_ZN") else 2), []
    while m := re.match(r"\d+", mangled[pos:]):
        pos += len(m.group())
        ids.append(mangled[pos:pos + int(m.group())])
        pos += int(m.group())
    if not ids:
        return mangled
    args = re.match(r"I((?:Li-?\d+E)+)E", mangled[pos:])
    vals = re.findall(r"Li(-?\d+)E", args.group(1)) if args else []
    return ids[-1] + (f"<{','.join(vals)}>" if vals else "")


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel from a ``-Xptxas -v`` log: its
    registers, static shared memory where it has any, and spill bytes, and
    any performance loss ptxas reports."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = _kernel_name(m.group(1))
        elif "spill stores" in line:
            spill = line.strip()
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            smem = re.search(r"(\d+) bytes smem", line)
            smem = f"{smem.group(1)} bytes static smem, " if smem else ""
            out.append(f"{name}: {m.group(1)} registers, {smem}{spill}")
            name = None
        elif m := re.search(r"Performance Loss: (.*) in the function "
                            r"'(\w+)'", line):
            out.append(f"{_kernel_name(m.group(2))}: {m.group(1)}")
    return out


def check(code: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if code != 0:
        msg = lib().tcm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
