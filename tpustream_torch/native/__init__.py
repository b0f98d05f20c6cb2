"""ctypes bindings for the native fast parser (host C++, not a device
kernel).

A copy of the reference package's native parser: ``fastparse.cpp`` is
compiled at first use by the ``Makefile`` beside it (g++; the binding is
plain ctypes) into a shared library under ``build/torch_native/`` at the
root of the checkout. The library's file name carries a hash of the
source, the Makefile and the fallback flags, so an edited source is
rebuilt and a stale build is never loaded; nothing is built beside the
source. When the build fails, ``available()`` is False, ``build_error()``
says why, and callers keep the numpy path.

Two build flavors, as in the reference: ``default``, the tuned library,
and ``asan`` (``TPUSTREAM_NATIVE_FLAVOR=asan``, with libasan preloaded
into the interpreter), the Makefile's ``asan`` target with
``-fsanitize=address,undefined`` for memory-safety runs of the same
parser. :func:`build_flavor` names the one this process selected; the
executor's ``native_parse_ready`` flight event carries it.

Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

KIND_STR = 0
KIND_F64 = 1
KIND_I64 = 2
KIND_ISO = 3

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parents[1] / "build" / "torch_native"
# the portable line of each flavor, tried when the Makefile's (tuned:
# -march=native) fails on this host's toolchain; with the Makefile's
# target and the library's name stem
_FLAVORS = {
    "default": ("all", "libfastparse",
                ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")),
    "asan": ("asan", "libfastparse_asan",
             ("-O1", "-g", "-fno-omit-frame-pointer",
              "-fsanitize=address,undefined", "-shared", "-fPIC",
              "-std=c++17", "-pthread")),
}
_flavor = os.environ.get("TPUSTREAM_NATIVE_FLAVOR", "default")
if _flavor not in _FLAVORS:
    _flavor = "default"
_MAKE_TARGET, _STEM, FALLBACK_FLAGS = _FLAVORS[_flavor]

_lock = threading.Lock()
_lib = None
_tried = False
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of the current source is built."""
    h = hashlib.sha256()
    for name in ("fastparse.cpp", "Makefile"):
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(FALLBACK_FLAGS).encode())
    return BUILD_DIR / f"{_STEM}-{h.hexdigest()[:16]}.so"


def build_flavor() -> str:
    """The build flavor this process selected (``"default"`` or
    ``"asan"``, from ``TPUSTREAM_NATIVE_FLAVOR``)."""
    return _flavor


def _tail(text: bytes, limit: int = 400) -> str:
    s = text.decode("utf-8", "replace").strip()
    return s[-limit:] if len(s) > limit else s


def _build(out: Path) -> bool:
    """Build the library at ``out``: the Makefile first, then a portable
    g++ line. Each attempt writes a file of its own and renames it into
    place, so concurrent first uses never load a half-written library.
    Never raises: on failure the compilers' last words are kept for
    :func:`build_error` and the numpy path takes over."""
    global _build_error
    src = str(NATIVE_DIR / "fastparse.cpp")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    attempts = [
        ["make", "-s", "-C", str(NATIVE_DIR), _MAKE_TARGET, f"OUT={tmp}"],
        ["g++", *FALLBACK_FLAGS, src, "-o", str(tmp)],
    ]
    errors = []
    for cmd in attempts:
        try:
            out.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, out)
            _build_error = None
            return True
        except subprocess.CalledProcessError as e:
            errors.append(f"{cmd[0]}: {_tail(e.stderr or e.stdout or b'')}")
        except Exception as e:
            errors.append(f"{cmd[0]}: {e}")
    _build_error = "; ".join(errors) or "unknown build failure"
    return False


def build_error() -> Optional[str]:
    """Why the native parser is unavailable (None when it is, or when
    no build has been attempted yet)."""
    return _build_error


def _load():
    global _lib, _tried, _build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            # a library left by another toolchain (missing GLIBCXX
            # symbols, wrong arch) fails to load: rebuild once here
            if not _build(so):
                _build_error = f"dlopen: {e}; rebuild: {_build_error}"
                return None
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e2:
                _build_error = f"dlopen after rebuild: {e2}"
                return None
        lib.tsp_table_new.restype = ctypes.c_void_p
        lib.tsp_table_free.argtypes = [ctypes.c_void_p]
        lib.tsp_table_size.argtypes = [ctypes.c_void_p]
        lib.tsp_table_size.restype = ctypes.c_int64
        lib.tsp_table_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.tsp_table_get.restype = ctypes.c_int64
        lib.tsp_parse_mt.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
        ]
        lib.tsp_parse_mt.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeTable:
    """A C-side intern table mirrored into a Python StringTable.

    Native ids are remapped to the Python table's ids after every parse,
    so literals interned Python-side (e.g. by device-chain string
    comparisons) and natively-parsed keys share one id namespace.
    """

    def __init__(self, py_table):
        lib = _load()
        self._lib = lib
        self.ptr = lib.tsp_table_new()
        self.py_table = py_table
        self._remap: List[int] = []

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            self._lib.tsp_table_free(self.ptr)
        except Exception:
            pass

    def sync(self) -> np.ndarray:
        """Extend the remap for newly-interned native ids; returns the
        int32 remap array (native id -> python id)."""
        lib = self._lib
        n = lib.tsp_table_size(self.ptr)
        if n > len(self._remap):
            buf = ctypes.create_string_buffer(4096)
            for i in range(len(self._remap), n):
                ln = lib.tsp_table_get(self.ptr, i, buf, 4096)
                s = buf.raw[: min(ln, 4096)].decode("utf-8", "replace")
                self._remap.append(self.py_table.intern(s))
        return np.asarray(self._remap, dtype=np.int32)


class NativeParser:
    """Parses a byte buffer of lines into columns per a base-field spec."""

    def __init__(self, sep: str, specs, py_tables):
        """specs: list of (field_idx, kind, tz_hours); py_tables aligned
        (StringTable for KIND_STR outputs, else None)."""
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native parser unavailable")
        self.sep = sep.encode()[0:1]
        self.specs = list(specs)
        n = len(self.specs)
        self._field = (ctypes.c_int32 * n)(*[s[0] for s in self.specs])
        self._kind = (ctypes.c_int32 * n)(*[s[1] for s in self.specs])
        self._tz = (ctypes.c_int32 * n)(*[s[2] for s in self.specs])
        self.tables: List[Optional[NativeTable]] = [
            NativeTable(t) if s[1] == KIND_STR else None
            for s, t in zip(self.specs, py_tables)
        ]
        self._tbl_ptrs = (ctypes.c_void_p * n)(
            *[t.ptr if t is not None else None for t in self.tables]
        )

    def parse(self, data: bytes, max_rows: int, threads: Optional[int] = None):
        """Parse into fresh numpy columns. ``threads`` > 1 uses the
        chunked multi-threaded kernel (identical output, including
        intern-id assignment order); default: TPUSTREAM_PARSE_THREADS or
        the core count, engaged only for buffers >= 1 MiB."""
        if threads is None:
            try:
                threads = int(
                    os.environ.get(
                        "TPUSTREAM_PARSE_THREADS", os.cpu_count() or 1
                    )
                )
            except ValueError:
                threads = os.cpu_count() or 1
        threads = max(1, min(int(threads), 64))
        n = len(self.specs)
        cols = []
        ptrs = (ctypes.c_void_p * n)()
        for i, (fi, kind, tz) in enumerate(self.specs):
            if kind == KIND_STR:
                c = np.empty(max_rows, dtype=np.int32)
            elif kind == KIND_F64:
                c = np.empty(max_rows, dtype=np.float64)
            else:
                c = np.empty(max_rows, dtype=np.int64)
            cols.append(c)
            ptrs[i] = c.ctypes.data_as(ctypes.c_void_p)
        bad = ctypes.c_int64(0)
        rows = self._lib.tsp_parse_mt(
            data,
            len(data),
            self.sep,
            n,
            self._field,
            self._kind,
            self._tz,
            self._tbl_ptrs,
            ptrs,
            max_rows,
            ctypes.byref(bad),
            max(1, threads),
        )
        out = []
        for c, t in zip(cols, self.tables):
            c = c[:rows]
            if t is not None:
                remap = t.sync()
                c = remap[c] if len(remap) else c
            out.append(c)
        return out, int(bad.value)
