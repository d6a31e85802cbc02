"""Launch wrappers for the CUDA dp_clip kernels (``csrc/dp_clip.cu``).

These take CUDA tensors only and raise on anything else: the device routing
(plain version on a CPU tensor) lives in ``ops``. Each wrapper counts its
launches in a plain integer attribute, ``<wrapper>.launches``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("dp_clip")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.p4_sq_norms.argtypes = [p, p, i64, i64, i32, p]
        lib.p4_sq_norms.restype = i32
        lib.p4_scale_accumulate.argtypes = [p, p, p, i64, i64, i64,
                                            ctypes.c_float, ctypes.c_float, i32, p]
        lib.p4_scale_accumulate.restype = i32
        _lib = lib
    return _lib


def _check_input(x: torch.Tensor, ndim: int, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got "
                         f"device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        f"(float32 or bfloat16)")
    if x.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """x: (N, D) f32/bf16 on CUDA -> per-row Σ x² (N,) f32."""
    _check_input(x, 2, "sq_norms")
    N, D = x.shape
    out = torch.empty((N,), dtype=torch.float32, device=x.device)
    lib = _library()
    sq_norms.launches += 1
    err = lib.p4_sq_norms(x.data_ptr(), out.data_ptr(), N, D, _DTYPES[x.dtype],
                          _stream(x))
    _build.check(err, "sq_norms")
    return out


sq_norms.launches = 0


def scale_accumulate(x: torch.Tensor, sq: torch.Tensor, clip: float,
                     denom: float = 1.0) -> torch.Tensor:
    """x: (M, B, D) f32/bf16, sq: (M, B) f32 squared norms, on CUDA ->
    Σ_b s_b · x_b (M, D) f32 with s_b = min(1, clip/max(√sq_b, 1e-12))/denom
    computed inside the kernel."""
    _check_input(x, 3, "scale_accumulate")
    M, B, D = x.shape
    if sq.shape != (M, B) or sq.dtype != torch.float32 or sq.device != x.device \
            or not sq.is_contiguous():
        raise ValueError(f"scale_accumulate: squared norms must be a contiguous "
                         f"f32 ({M}, {B}) tensor on {x.device}, got "
                         f"{sq.dtype} {tuple(sq.shape)} on {sq.device}")
    out = torch.empty((M, D), dtype=torch.float32, device=x.device)
    lib = _library()
    scale_accumulate.launches += 1
    err = lib.p4_scale_accumulate(x.data_ptr(), sq.data_ptr(), out.data_ptr(),
                                  M, B, D, float(clip), float(denom),
                                  _DTYPES[x.dtype], _stream(x))
    _build.check(err, "scale_accumulate")
    return out


scale_accumulate.launches = 0
