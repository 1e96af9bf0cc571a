"""ctypes bindings for the native C++ FASTQ parser/packer.

Builds the library from tsxcount_tpu/_native/fastxpack.cpp at first use, with
g++ and zlib, into _native/build/ under a name keyed by a hash of the
source, the compiler command and the host CPU — an edited source, other
flags or another machine get their own build, and no file dates are
consulted.  The C ABI + ctypes keeps the binding dependency-free.  Callers
use `native_available()` and fall back to the pure-Python packer (the CLI
warns when it does).

Byte-range chunking: `fxp_open_range` parses only the records owned by a
byte range of the file (FASTQ 4-line / FASTA resync in C++), so
NativeFileReader can fan the parse out over N host threads (ctypes calls
release the GIL) and multi-host jobs can split one file by offsets instead
of every host re-parsing everything.  Ranges need uncompressed input; .gz
falls back to one sequential stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

from tsxcount_tpu.config import BatchSpec
from tsxcount_tpu.io.packer import PackedBatch, PackStats

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "_native"
_SRC = _NATIVE_DIR / "fastxpack.cpp"
_BUILD_DIR = _NATIVE_DIR / "build"
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_build_error: str | None = None

N_POLICY_CODES = {"drop": 0, "random": 1}


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def lib_path() -> Path:
    """Where the build for this source, compiler command and CPU lives
    (-march=native code must not run on another CPU model)."""
    key = hashlib.sha256()
    key.update(_SRC.read_bytes())
    key.update(" ".join(
        [os.environ.get("CXX", "g++")] + _FLAGS + [platform.machine(),
                                                   _cpu_model()]
    ).encode())
    return _BUILD_DIR / f"libfastxpack-{key.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    global _build_error
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++")] + _FLAGS + [
        str(_SRC), "-o", str(tmp), "-lz",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        _build_error = str(e)
        return False
    if proc.returncode != 0:
        _build_error = proc.stderr[-2000:]
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return True


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _build_error = str(e)
            return None
        lib.fxp_open.restype = ctypes.c_void_p
        lib.fxp_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ]
        lib.fxp_open_range.restype = ctypes.c_void_p
        lib.fxp_open_range.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ]
        lib.fxp_next_batch.restype = ctypes.c_int
        lib.fxp_next_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fxp_stats.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_int64)
        ] * 5
        lib.fxp_hp_bonus.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
        ]
        lib.fxp_packed_words.restype = ctypes.c_int64
        lib.fxp_packed_words.argtypes = [ctypes.c_void_p]
        lib.fxp_error.restype = ctypes.c_char_p
        lib.fxp_error.argtypes = [ctypes.c_void_p]
        lib.fxp_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def native_build_error() -> str | None:
    _load()
    return _build_error


def is_gzip(path: str | Path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def split_ranges(path: str | Path, n: int,
                 byte_start: int = 0, byte_end: int | None = None
                 ) -> list[tuple[int, int]]:
    """Split [byte_start, byte_end) of a file into n contiguous ranges.

    Record-boundary alignment is the native parser's job (resync), so
    plain equal byte splits are correct.
    """
    size = os.path.getsize(path)
    end = size if byte_end is None or byte_end < 0 else min(byte_end, size)
    start = min(byte_start, end)
    span = end - start
    cuts = [start + span * i // n for i in range(n + 1)]
    return [(cuts[i], cuts[i + 1]) for i in range(n)
            if cuts[i + 1] > cuts[i]] or [(start, end)]


class _Handle:
    """One native parse stream over one byte range."""

    def __init__(self, lib, path: str | Path, batch: BatchSpec,
                 n_policy: str, seed: int, byte_start: int, byte_end: int,
                 collapse: bool = False):
        self._lib = lib
        self.batch = batch
        self._h = lib.fxp_open_range(
            str(path).encode(), batch.spec.k, N_POLICY_CODES[n_policy],
            seed, byte_start, byte_end, int(collapse),
        )
        if not self._h:
            if byte_start > 0 or byte_end >= 0:
                raise ValueError(
                    f"cannot open byte range of {path} (gzip input cannot "
                    f"be range-split; use a single stream)"
                )
            raise FileNotFoundError(path)

    def batches(self):
        lib = self._lib
        b = self.batch
        n_valid = ctypes.c_int64()
        n_bases = ctypes.c_int64()
        while True:
            buf = np.empty(b.buf_words, dtype=np.uint32)
            rc = lib.fxp_next_batch(
                self._h,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                b.total_words,
                b.capacity_words,
                b.max_intervals,
                ctypes.byref(n_valid),
                ctypes.byref(n_bases),
            )
            if rc < 0:
                raise ValueError(
                    f"parse error: {lib.fxp_error(self._h).decode()}"
                )
            if n_valid.value or n_bases.value:
                yield PackedBatch(
                    buf=buf,
                    n_valid=int(n_valid.value),
                    n_bases=int(n_bases.value),
                    batch=b,
                )
            if rc == 0:
                return

    def stats(self) -> PackStats:
        vals = [ctypes.c_int64() for _ in range(5)]
        self._lib.fxp_stats(self._h, *[ctypes.byref(v) for v in vals])
        bonus = (ctypes.c_int64 * 4)()
        self._lib.fxp_hp_bonus(self._h, bonus)
        return PackStats(
            reads=int(vals[0].value),
            reads_skipped=int(vals[1].value),
            bases=int(vals[2].value),
            n_bases=int(vals[3].value),
            windows=int(vals[4].value),
            hp_bonus=tuple(int(b) for b in bonus),
            hp_collapsed_bases=int(sum(bonus)),
            packed_words=int(self._lib.fxp_packed_words(self._h)),
        )

    def close(self):
        if self._h:
            self._lib.fxp_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeFileReader:
    """Streams PackedBatch objects straight from a FASTQ/FASTA(.gz) file.

    threads > 1 splits an uncompressed file into byte ranges parsed
    concurrently (each ctypes call releases the GIL); batch order across
    ranges is arrival order — counting is order-invariant.  gzip input
    silently degrades to one stream.
    """

    def __init__(self, path: str | Path, batch: BatchSpec,
                 n_policy: str = "drop", seed: int = 0, threads: int = 1,
                 byte_start: int = 0, byte_end: int = -1,
                 collapse: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native packer unavailable: {_build_error}")
        if not Path(path).exists():
            raise FileNotFoundError(path)
        self.batch = batch
        self.stats = PackStats()
        ranged = byte_start > 0 or byte_end >= 0
        if (threads > 1 or ranged) and is_gzip(path):
            if ranged:
                raise ValueError(
                    f"byte-range input splitting needs uncompressed input "
                    f"({path} is gzip)"
                )
            threads = 1
        if threads > 1:
            ranges = split_ranges(path, threads, byte_start, byte_end)
        else:
            ranges = [(byte_start, byte_end if ranged else -1)]
        self._handles = [
            _Handle(lib, path, batch, n_policy, seed + i, s, e,
                    collapse=collapse)
            for i, (s, e) in enumerate(ranges)
        ]

    def __iter__(self):
        try:
            if len(self._handles) == 1:
                source = self._handles[0].batches()
            else:
                from tsxcount_tpu.io.pipeline import merged_iter

                source = merged_iter(
                    [h.batches() for h in self._handles],
                    depth=2 * len(self._handles),
                )
            for pb in source:
                self.stats.batches += 1
                yield pb
        finally:
            self._finalize_stats()

    def live_stats(self) -> PackStats:
        """Point-in-time ingest stats while streaming (progress reporting);
        handles stay open.  After iteration completes, .stats is final."""
        from tsxcount_tpu.io.packer import add_stats

        if not self._handles:
            return self.stats
        total = PackStats()
        for h in self._handles:
            total = add_stats(total, h.stats())
        total.batches = self.stats.batches
        return total

    def _finalize_stats(self):
        if not self._handles:
            return
        from tsxcount_tpu.io.packer import add_stats

        total = PackStats()
        for h in self._handles:
            total = add_stats(total, h.stats())
            h.close()
        total.batches = self.stats.batches
        self.stats = total
        self._handles = []
