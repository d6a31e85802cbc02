"""Launch wrapper for the CUDA pairwise-ℓ1 kernel (``csrc/l1_distance.cu``).

CUDA tensors only; ``ops`` routes CPU tensors to the plain version. The
wrapper counts its launches in ``pairwise_l1.launches``: one per call, which
runs the partial-sum kernel and the fixed-order reduction over its D
chunks."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
# D-chunks are sized so that about this many blocks per SM are in flight
_BLOCKS_PER_SM = 4


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("l1_distance")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.p4_pairwise_l1.argtypes = [p, p, p, i64, i64, i64, i64, i32, p]
        lib.p4_pairwise_l1.restype = i32
        lib.p4_l1_tile_m.restype = i32
        lib.p4_l1_tile_d.restype = i32
        _lib = lib
    return _lib


def split_d(M: int, D: int, tm: int, kd: int, sms: int):
    """(S, chunk): D cut into S chunks of ``chunk`` (a multiple of ``kd``)
    so that the upper-triangle tiles times S fill ``sms`` SMs."""
    T = -(-M // tm)
    tiles = T * (T + 1) // 2
    want = max(1, -(-_BLOCKS_PER_SM * sms // tiles))
    chunk = -(-D // want)
    chunk = -(-chunk // kd) * kd
    return -(-D // chunk), chunk


def pairwise_l1(x: torch.Tensor) -> torch.Tensor:
    """x: (M, D) f32/bf16 on CUDA -> (M, M) f32, both triangles written."""
    if not x.is_cuda:
        raise ValueError(f"pairwise_l1: the CUDA kernel needs a CUDA tensor, "
                         f"got device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"pairwise_l1: dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"pairwise_l1: expected a contiguous (M, D) tensor, "
                         f"got shape {tuple(x.shape)}")
    M, D = x.shape
    if D == 0:
        return torch.zeros((M, M), dtype=torch.float32, device=x.device)
    lib = _library()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    S, chunk = split_d(M, D, lib.p4_l1_tile_m(), lib.p4_l1_tile_d(), sms)
    partial = torch.empty((S, M, M), dtype=torch.float32, device=x.device)
    out = torch.empty((M, M), dtype=torch.float32, device=x.device)
    pairwise_l1.launches += 1
    err = lib.p4_pairwise_l1(x.data_ptr(), partial.data_ptr(), out.data_ptr(),
                             M, D, S, chunk, _DTYPES[x.dtype],
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pairwise_l1")
    return out


pairwise_l1.launches = 0
