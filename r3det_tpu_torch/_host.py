"""Build and load the port's C++ host helpers with ``g++``.

Two libraries are built on first use into ``r3det_tpu_torch/build/``
(git-ignored), each under a file name that carries a hash of its source,
its flags, the platform (kernel and C library) and, for ``-march=native``
builds, this CPU's feature flags, so a copy of the tree on another machine
builds its own:

- ``host_ops`` from ``r3det_tpu_torch/csrc/host_ops.cpp``: the PNG row
  unfilter of :mod:`..datasets.image_io`, the minimum-area rectangle
  of :mod:`..core.rtransforms_np` and the affine point transform of
  :mod:`..datasets.transforms`. Built without ``-march=native`` and
  with ``-ffp-contract=off``, so its float32 arithmetic rounds as
  OpenCV's SSE build does.
- ``polygeo`` from the repository's ``csrc/polygon_iou.cpp``, the polygon
  engine the JAX package also loads, with that package's Makefile flags,
  so both packages compute the same IoUs. It is not built into ``csrc/``,
  where the JAX package's ``make`` may run at the same time.

Test workers build concurrently: a build holds an ``fcntl`` lock on a file
beside the library, compiles to a temporary name and renames it into
place, so no process loads a half-written library. There is no fallback:
a missing compiler or a failed build raises with the compiler's output.
"""
import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / 'build'
HOST_OPS_SOURCE = _PKG / 'csrc' / 'host_ops.cpp'
POLYGEO_SOURCE = _PKG.parent / 'csrc' / 'polygon_iou.cpp'
HOST_OPS_FLAGS = ('-O2', '-fPIC', '-shared', '-std=c++17',
                  '-ffp-contract=off')
# csrc/Makefile's flags (-march=native where the compiler takes it)
POLYGEO_FLAGS = ('-O3', '-fPIC', '-shared', '-std=c++17', '-march=native')


def _cxx():
    cxx = os.environ.get('CXX') or shutil.which('g++')
    if not cxx:
        raise RuntimeError('g++ not found (set CXX): the r3det_tpu_torch '
                           'host helpers cannot be built')
    return cxx


def _cpu_flags():
    """This CPU's feature flags (a ``-march=native`` build is only valid
    on a CPU that has them)."""
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('flags'):
                    return line
    except OSError:
        pass
    return ''


def _native_ok(cxx):
    proc = subprocess.run([cxx, '-march=native', '-E', '-x', 'c++',
                           os.devnull], capture_output=True)
    return proc.returncode == 0


def build(name, source, flags):
    """Compile ``source`` into ``build/lib<name>_<hash>.so`` unless it is
    there; returns its path."""
    source = Path(source)
    if not source.is_file():
        raise FileNotFoundError(f'{source}: the source of the {name} host '
                                'helper is missing (it builds from a '
                                'source checkout)')
    cxx = _cxx()
    flags = tuple(flags)
    if '-march=native' in flags and not _native_ok(cxx):
        flags = tuple(f for f in flags if f != '-march=native')
    digest = hashlib.sha256(' '.join((cxx, platform.platform()) + flags)
                            .encode())
    digest.update(source.read_bytes())
    if '-march=native' in flags:
        digest.update(_cpu_flags().encode())
    out = BUILD_DIR / f'lib{name}_{digest.hexdigest()[:16]}.so'
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix('.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():             # another process built it
                return out
            tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
            cmd = [cxx, *flags, str(source), '-o', str(tmp)]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f'{name} host helper build failed with '
                                   f'code {proc.returncode}:\n'
                                   f'{" ".join(cmd)}\n{proc.stdout}')
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_D = ctypes.c_double


@functools.lru_cache(maxsize=None)
def host_ops():
    """The loaded ``host_ops`` library (built on first call)."""
    lib = ctypes.CDLL(str(build('r3det_host_ops', HOST_OPS_SOURCE,
                                HOST_OPS_FLAGS)))
    # in (H * (stride + 1)), out (H * stride), H, stride, bytes per pixel
    lib.png_unfilter.argtypes = [_P, _P, _I64, _I64, _I64]
    lib.png_unfilter.restype = _I64
    # points (N, 4, 2) f32, out (N, 5) f32, N
    lib.min_area_rect.argtypes = [_P, _P, _I64]
    lib.min_area_rect.restype = None
    # points (N, 2) f64, m (2, 3) f64, out (N, 2) f64, N
    lib.transform_points.argtypes = [_P, _P, _P, _I64]
    lib.transform_points.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def polygeo():
    """The loaded polygon engine (built on first call)."""
    lib = ctypes.CDLL(str(build('polygeo', POLYGEO_SOURCE, POLYGEO_FLAGS)))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.polygon_iou_matrix.argtypes = [dp, _I64, dp, _I64, dp]
    lib.polygon_iou_matrix.restype = None
    lib.polygon_greedy_nms.argtypes = [dp, dp, _I64, _D,
                                       ctypes.POINTER(ctypes.c_int64)]
    lib.polygon_greedy_nms.restype = _I64
    return lib
