"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Every ``.cu`` source under ``r3det_tpu_torch/csrc`` is compiled by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes`` (pointers
and the stream pass as ``c_void_p``). PyTorch's own extension loader
(``torch.utils.cpp_extension``) is not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C one seconds.

The build runs on first use, into ``r3det_tpu_torch/build/`` (git-ignored),
and the library's file name carries a hash of the sources and flags, so an
edited source rebuilds. There is no fallback: a missing ``nvcc`` or a failed
build raises with the compiler's output.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper) and
``--fmad=false``, so that ``a*b + c`` written in the sources rounds twice,
as the plain PyTorch versions do (the stem's conv sums run on the tensor
cores, which the flag does not touch).

Every launch goes through :func:`launch`, which raises on the CUDA error
code the C entry point returns and counts the launch in :data:`LAUNCHES`.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '--fmad=false', '-Xcompiler', '-fPIC')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# C entry points (csrc/*.cu): each returns the cudaError_t of its launch
_SIGNATURES = {
    # boxes1, boxes2, valid_count|NULL, out, B, N, M, mode, upper_only,
    # tile_r, tile_c, stream
    'rotated_iou': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # L, then host arrays of the L levels' x, feat, rois, out pointers, H,
    # W (int) and spatial_scale (float), trig (2, cells) f32 | NULL, B, C,
    # points, transpose_quirk, stream
    'frm_sample_levels': (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _P),
    # K2's backward: L, host arrays of the L levels' g, rois, dfeat
    # pointers, H, W (int) and spatial_scale (float), trig | NULL, the
    # zeroed int32 workspace and its size, the other workspace and its
    # size, B, C, points, transpose_quirk, stream
    'frm_sample_bwd': (_I, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _P, _LL, _I,
                       _I, _I, _I, _P),
    # x12, packed weights (4, 64, 56), scale, bias, out, B, H, W, SMs,
    # stream
    'stem_conv_pool': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x12, int8 weights (4, 64, 80), amax (1,), kscale, scale, bias,
    # out, B, H, W, SMs, stream
    'stem_conv_pool_q8': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # conv output (B, H, W, 64), out, B, H, W, stream
    'stem_pool': (_P, _P, _I, _I, _I, _P),
    # x, packed weights, b1, b2, b3, out, B, H, W, F, SMs, stream
    'bottleneck': (_P,) * 6 + (_I,) * 5 + (_P,),
    # x, inv (3,), packed weights, s1, b1, s2, b2, s3, b3, out, B, H, W, F,
    # SMs, stream
    'bottleneck_q8': (_P,) * 10 + (_I,) * 5 + (_P,),
    # x, q_in, ascale (1,), packed w, bn, ck, kscale, bias|NULL, inv|NULL,
    # b|NULL, residual|NULL, res_kind, rscale|NULL, relu, out, out_q,
    # oscale|NULL, B, H, W, Ci, Ho, Wo, Co, kh, kw, sh, sw, ph, pw, stream
    'int8_conv': (_P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P,
                  _I, _P) + (_I,) * 13 + (_P,),
    # a, inv, b, residual|NULL, inv_d|NULL, b_d|NULL, out, pixels, C,
    # res_kind, relu, SMs, stream
    'conv_epilogue': (_P,) * 7 + (_LL, _I, _I, _I, _I, _P),
    # x, gamma, beta (C,) f32, out, B, H, W, Hp, Wp, C, eps, SMs, stream
    'swin_norm_pad': (_P,) * 4 + (_I,) * 6 + (_F, _I, _P),
    # qkv, table (nb, heads) f32, out, B, H, W, Hp, Wp, C, heads, window,
    # shift, scale, stream
    'swin_window_attn': (_P,) * 3 + (_I,) * 9 + (_F, _P),
    # iou (B, K, K) f32, labels (B, K) int64, valid (B, K) bool, vcount
    # (B,) int32, thr, mask scratch (B, K, ceil(K / 64)) u64, keep, B, K,
    # stream
    'nms_sweep': (_P,) * 4 + (_F, _P, _P, _I, _I, _P),
    # LSKNet's attention sub-block (csrc/lsk_attn.cu). v, taps (74, C) f32,
    # b0, bs (C,) f32, out (B, H, W, 2C), B, H, W, C, stream
    'lsk_taps': (_P,) * 5 + (_I,) * 4 + (_P,),
    # b, cb (C,) f32, wq (2, 2, 7, 7) f32, bq (2,) f32, out, B, H, W, C,
    # tile, stream
    'lsk_select': (_P,) * 5 + (_I,) * 5 + (_P,),
    # a (written in place), bias (C,) bf16, [v | x, inv, shift, ls],
    # pixels, C, SMs, stream
    'lsk_bias_gelu': (_P, _P, _LL, _I, _I, _P),
    'lsk_bias_gate': (_P,) * 3 + (_LL, _I, _I, _P),
    'lsk_bias_residual': (_P,) * 6 + (_LL, _I, _I, _P),
    # LSKNet's MLP sub-block (csrc/lsk_attn.cu). h, b1 (C,) bf16, taps
    # (9, C), bd (C,) f32, out, B, H, W, C, tile rows, SMs, stream
    'lsk_dw_gelu': (_P,) * 5 + (_I,) * 6 + (_P,),
    # a (written in place), bias, x, ls, pixels, C, SMs, stream
    'lsk_bias_scale': (_P,) * 4 + (_LL, _I, _I, _P),
}

# entry points that launch another entry's kernel, counted under its name
_KERNEL_OF = {'frm_sample_levels': 'frm_sample'}

#: kernel name -> number of launches since the last :func:`reset_launches`
LAUNCHES = {_KERNEL_OF.get(name, name): 0 for name in _SIGNATURES}

_lib = None
_lock = threading.Lock()


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin`` (default /usr/local/cuda), then
    PATH. Raises when there is none."""
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    cand = Path(home) / 'bin' / 'nvcc'
    if cand.is_file():
        return str(cand)
    found = shutil.which('nvcc')
    if found:
        return found
    raise RuntimeError(
        'nvcc not found in $CUDA_HOME/bin or on PATH: the r3det_tpu_torch '
        'CUDA kernels cannot be built')


def _library_path():
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob('*.cu')) + sorted(CSRC.glob('*.cuh')):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return BUILD_DIR / f'libr3det_kernels_{digest.hexdigest()[:16]}.so'


def _run(cmds):
    """Run the commands in parallel; raise with the output of the first
    that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, log)
    if failed:
        cmd, code, log = failed
        raise RuntimeError(f'nvcc failed with code {code}:\n'
                           f'{" ".join(cmd)}\n{log}')


def build():
    """Compile the kernels unless an up-to-date library exists; returns
    the library's path. One nvcc process per source, all at once, then
    one link."""
    out = _library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f'{out.stem}.{os.getpid()}'
    sources = sorted(CSRC.glob('*.cu'))
    objs = [BUILD_DIR / f'{tag}.{src.stem}.o' for src in sources]
    _run([[nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
          for src, obj in zip(sources, objs)])
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    _run([[nvcc, '-shared', '-o', str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, f'r3det_{name}')
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            handle.r3det_error_string.argtypes = [ctypes.c_int]
            handle.r3det_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def launch(name, *args):
    """Call the C entry point ``r3det_<name>``; raise on a launch error,
    otherwise count the launch (under its kernel's name)."""
    handle = lib()
    err = getattr(handle, f'r3det_{name}')(*args)
    if err != 0:
        msg = handle.r3det_error_string(err).decode()
        raise RuntimeError(f'CUDA kernel {name} failed to launch: '
                           f'error {err} ({msg})')
    LAUNCHES[_KERNEL_OF.get(name, name)] += 1


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def current_stream(device):
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device):
    """The number of streaming multiprocessors of ``device`` (persistent
    kernels launch a fixed number of blocks per SM)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count
