"""Public wrappers over the port's hand-written CUDA kernels.

Dispatch follows the tensor: a tensor on the CPU goes to the kernel's
plain PyTorch version (``kernels/ref.py``), a CUDA tensor to the kernel,
launched on the current stream -- or to an exception. There is no
fallback from a CUDA tensor to the plain version.

Each wrapper checks device, dtype, shape and strides, launches, checks
the ``cudaError_t`` the C entry point returns (a refused launch never
runs, and a later synchronise would not report it), and adds one to its
entry in ``LAUNCHES`` -- only there, so a run can show that its main path
went through the kernels.

| wrapper            | CUDA source                 | replaces (TPU kernel)                      |
|--------------------|-----------------------------|--------------------------------------------|
| decode_attention   | csrc/decode_attention.cu    | kernels/decode_attention.py decode_attention |
| topk_cdf           | csrc/topk_cdf.cu            | kernels/ac_cdf.py topk_cdf_points          |
| cdf_points         | csrc/cdf_points.cu          | kernels/ac_cdf.py cdf_points               |
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, ref

#: launches per kernel since the last ``reset_launches()``
LAUNCHES = {name: 0 for name in build.KERNELS}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev} (CPU tensors take the "
                         f"plain version, anything else is unsupported)")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        lib = build.library(name)
        lib.repro_error_string.restype = ctypes.c_char_p
        lib.repro_error_string.argtypes = [ctypes.c_int]
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({rc}: {msg})")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd); k/v cache of one layer (B, S, K, hd), read through
    its strides; lengths (B,) int32 valid prefix per lane -> (B, H, hd)
    in q's dtype."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths)
    _check_cuda("decode_attention", q, k_cache, v_cache, lengths)
    B, H, hd = q.shape
    Bc, S, K, hdc = k_cache.shape
    if (Bc, hdc) != (B, hd) or v_cache.shape != k_cache.shape \
            or lengths.shape != (B,) or K < 1 or H % K:
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, k "
            f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, lengths "
            f"{tuple(lengths.shape)} do not fit (B,H,hd)/(B,S,K,hd)/(B,)")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype} (float32 or "
                         f"bfloat16, all equal)")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError("decode_attention: lengths must be contiguous "
                         "int32")
    if q.stride(2) != 1 or k_cache.stride(3) != 1 \
            or k_cache.stride() != v_cache.stride():
        raise ValueError("decode_attention: unit stride over hd and equal "
                         "k/v strides required")
    if H // K > 8 or hd > 256:
        raise ValueError(f"decode_attention: G={H // K} > 8 or hd={hd} > "
                         f"256 not supported by the kernel")
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    rc = build.entry("decode_attention")(
        q.data_ptr(), q.stride(0), q.stride(1),
        k_cache.data_ptr(), v_cache.data_ptr(),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        lengths.data_ptr(), out.data_ptr(), B, H, K, S, hd,
        _DTYPES[q.dtype], 1.0 / math.sqrt(hd), _stream(q))
    _raise_on("decode_attention", rc)
    LAUNCHES["decode_attention"] += 1
    return out


def _check_logits(name: str, logits: torch.Tensor) -> None:
    _check_cuda(name, logits)
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError(f"{name}: logits must be (rows, V) with unit "
                         f"column stride, got {tuple(logits.shape)} "
                         f"strides {logits.stride()}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"{name}: logits dtype {logits.dtype} (float32 "
                         f"or bfloat16)")


def topk_cdf(logits: torch.Tensor, k: int, precision: int):
    """logits (R, V), rows read through their stride -> (ids (R, k)
    int32, cdf (R, k+2) int32) with cdf[:, 0] == 0 and cdf[:, -1] ==
    2**precision."""
    if logits.device.type == "cpu":
        return ref.topk_cdf(logits, k, precision)
    _check_logits("topk_cdf", logits)
    R, V = logits.shape
    if not 1 <= k <= min(V, 256) or not 1 <= precision <= 24 \
            or (1 << precision) <= k + 1:
        raise ValueError(f"topk_cdf: k={k}, precision={precision} outside "
                         f"the kernel's range for V={V} (k <= 256, "
                         f"precision <= 24)")
    ids = torch.empty((R, k), dtype=torch.int32, device=logits.device)
    cdf = torch.empty((R, k + 2), dtype=torch.int32, device=logits.device)
    if R:
        rc = build.entry("topk_cdf")(
            logits.data_ptr(), logits.stride(0), _DTYPES[logits.dtype], R,
            V, k, precision, ids.data_ptr(), cdf.data_ptr(),
            _stream(logits))
        _raise_on("topk_cdf", rc)
        LAUNCHES["topk_cdf"] += 1
    return ids, cdf


def cdf_points(logits: torch.Tensor, precision: int) -> torch.Tensor:
    """logits (R, V), rows read through their stride -> int32 CDF
    interior points (R, V): strictly increasing, last == 2**precision."""
    if logits.device.type == "cpu":
        return ref.cdf_points(logits, precision)
    _check_logits("cdf_points", logits)
    R, V = logits.shape
    if not 1 <= precision <= 24 or (1 << precision) <= V:
        raise ValueError(f"cdf_points: precision {precision} cannot hold "
                         f"V={V} (and the kernel takes <= 24)")
    out = torch.empty((R, V), dtype=torch.int32, device=logits.device)
    if R:
        rc = build.entry("cdf_points")(
            logits.data_ptr(), logits.stride(0), _DTYPES[logits.dtype], R,
            V, precision, out.data_ptr(), _stream(logits))
        _raise_on("cdf_points", rc)
        LAUNCHES["cdf_points"] += 1
    return out
