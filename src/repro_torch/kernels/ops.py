"""Public wrappers over the port's hand-written CUDA kernels.

Dispatch follows the tensor: a tensor on the CPU goes to the kernel's
plain PyTorch version (``kernels/ref.py``), a CUDA tensor to the kernel,
launched on the current stream -- or to an exception. There is no
fallback from a CUDA tensor to the plain version.

No kernel has a backward. A wrapper therefore refuses, on the CPU as on
the card, an input that requires a gradient while grad mode is on: on
the card its result, written through ``data_ptr()``, would carry no
``grad_fn``, and training would lose that gradient without an error.
The training forward runs ``models/layers.py attention_masked`` instead.

Each wrapper checks device, dtype, shape and strides, launches, checks
the ``cudaError_t`` the C entry point returns (a refused launch never
runs, and a later synchronise would not report it), and adds one to its
entry in ``LAUNCHES`` -- only there, so a run can show that its main path
went through the kernels.

| wrapper            | CUDA source                 | replaces (TPU kernel)                      |
|--------------------|-----------------------------|--------------------------------------------|
| decode_attention   | csrc/decode_attention.cu    | kernels/decode_attention.py decode_attention |
| decode_attention_int8 | the same, -DREPRO_KV_INT8 | the same, over an int8 cache |
| topk_cdf           | csrc/topk_cdf.cu            | kernels/ac_cdf.py topk_cdf_points          |
| cdf_points         | csrc/cdf_points.cu          | kernels/ac_cdf.py cdf_points               |
| flash_attention    | csrc/flash_attention.cu     | kernels/flash_attention.py flash_attention |
| ssd_intra          | csrc/ssd_intra.cu           | kernels/ssd_scan.py ssd_intra              |
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


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires a gradient, and the kernel has no "
            f"backward (call it under torch.no_grad(); the training forward "
            f"uses attention_masked)")


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        lib = build.library(name)
        lib.repro_error_string.restype = ctypes.c_char_p
        lib.repro_error_string.argtypes = [ctypes.c_int]
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({rc}: {msg})")


#: positions per tile of the decode kernel (one per lane of a warp)
DECODE_TILE = 32
#: CTAs per (kv-head, lane) at most (the portable thread-block cluster size)
DECODE_MAX_CLUSTERS = 8
#: q-heads per kv-head at most (csrc/decode_attention.cu kMaxG: the 16 A
#: rows of one m16n8k16 product)
DECODE_MAX_G = 16
#: bytes of a q row at most when G > 8 (kWideRowBytes: hd 256 in bf16,
#: 128 in fp32), so that sixteen heads' state fits shared memory
DECODE_WIDE_ROW = 512


def decode_geometry(S: int, G: int, hd: int,
                    dtype: torch.dtype) -> tuple[int, int]:
    """Launch geometry of the decode-attention kernel for a cache of S
    allocated positions, G q-heads per kv-head and head width hd:
    (CTAs per (kv-head, lane), positions per CTA). A function of these
    static shapes alone -- never of the live lengths or the lane count --
    because the kernel's softmax sums follow it, and a lane's logits must
    not depend on what else shares the step. The slices are whole tiles of
    DECODE_TILE positions, cover S, and none is empty: S = 128 takes 4 CTAs
    of 32 positions, S = 512 takes 8 of 64. (G, hd and the dtype do not
    move the split today: every case the wrapper takes -- G up to 8 at hd
    256 in fp32, G up to 16 at rows of DECODE_WIDE_ROW bytes -- fits a
    CTA's shared memory with 32-position tiles.)"""
    least = -(-S // DECODE_MAX_CLUSTERS)      # positions per CTA, at least
    per = DECODE_TILE * max(1, -(-least // DECODE_TILE))
    return -(-S // per), per


def _check_decode(name: str, q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, lengths: torch.Tensor) -> None:
    """The shape, stride and size checks both decode wrappers make."""
    B, H, hd = q.shape
    Bc, S, K, hdc = k_cache.shape
    if (Bc, hdc) != (B, hd) or v_cache.shape != k_cache.shape \
            or lengths.shape != (B,) or K < 1 or H % K:
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, k "
            f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}, lengths "
            f"{tuple(lengths.shape)} do not fit (B,H,hd)/(B,S,K,hd)/(B,)")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError(f"{name}: lengths must be contiguous int32")
    if q.stride(2) != 1 or k_cache.stride(3) != 1 \
            or k_cache.stride() != v_cache.stride():
        raise ValueError(f"{name}: unit stride over hd and equal k/v "
                         f"strides required")
    G, row = H // K, hd * q.element_size()
    if G > DECODE_MAX_G or hd > 256 or (G > 8 and row > DECODE_WIDE_ROW):
        raise ValueError(
            f"{name}: G={G}, hd={hd} in {q.dtype} not supported by the "
            f"kernel (G <= {DECODE_MAX_G}, hd <= 256; a group of more than "
            f"8 heads takes q rows of at most {DECODE_WIDE_ROW} bytes)")
    if B > 65535:
        raise ValueError(f"{name}: B={B} exceeds the grid")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd); k/v cache of one layer (B, S, K, hd), read through
    its strides; lengths (B,) int32 valid prefix per lane -> (B, H, hd)
    in q's dtype."""
    _refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths)
    _check_cuda("decode_attention", q, k_cache, v_cache, lengths)
    _check_decode("decode_attention", q, k_cache, v_cache, lengths)
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype} (float32 or "
                         f"bfloat16, all equal)")
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return out.zero_()
    clusters, per = decode_geometry(S, H // K, hd, q.dtype)
    vec = all(_rows_aligned(t) for t in (q, k_cache, v_cache))
    rc = build.entry("decode_attention")(
        q.data_ptr(), q.stride(0), q.stride(1),
        k_cache.data_ptr(), v_cache.data_ptr(),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        lengths.data_ptr(), out.data_ptr(), B, H, K, S, hd,
        _DTYPES[q.dtype], 1.0 / math.sqrt(hd), clusters, per, int(vec),
        _stream(q))
    _raise_on("decode_attention", rc)
    LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_int8(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """``decode_attention`` over an int8 cache: k/v (B, S, K, hd) int8,
    each row with its fp16 scale in k_scale / v_scale (B, S, K), all read
    through their strides; q (B, H, hd) float32 or bfloat16, the dtype
    the rows are dequantized to (``ref.dequant_kv``) -> (B, H, hd) in q's
    dtype. The kernel reads the int8 rows and scales, never a dequantized
    copy. hd % 4 == 0, and the cache rows start on 4 bytes. Same geometry
    as ``decode_attention`` (``decode_geometry`` of q's dtype), so the
    two attend a cache of the same values alike."""
    name = "decode_attention_int8"
    _refuse_grad(name, q, k_scale, v_scale)
    if q.device.type == "cpu":
        return ref.decode_attention_int8(q, k_cache, v_cache, k_scale,
                                         v_scale, lengths)
    _check_cuda(name, q, k_cache, v_cache, k_scale, v_scale, lengths)
    _check_decode(name, q, k_cache, v_cache, lengths)
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _DTYPES or k_cache.dtype != torch.int8 \
            or v_cache.dtype != torch.int8 \
            or k_scale.dtype != torch.float16 \
            or v_scale.dtype != torch.float16:
        raise ValueError(f"{name}: dtypes q {q.dtype}, k/v {k_cache.dtype}"
                         f"/{v_cache.dtype}, scales {k_scale.dtype}/"
                         f"{v_scale.dtype} (q float32 or bfloat16, k/v "
                         f"int8, scales float16)")
    if k_scale.shape != (B, S, K) or v_scale.shape != (B, S, K) \
            or k_scale.stride() != v_scale.stride():
        raise ValueError(f"{name}: scales {tuple(k_scale.shape)}, "
                         f"{tuple(v_scale.shape)} must both be (B, S, K) "
                         f"= {(B, S, K)} with equal strides")
    if hd % 4 or any(t.data_ptr() % 4 or any(st % 4 for st in t.stride()[:3])
                     for t in (k_cache, v_cache)):
        raise ValueError(f"{name}: hd={hd} must be a multiple of 4 and the "
                         f"int8 rows must start on 4 bytes")
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return out.zero_()
    clusters, per = decode_geometry(S, H // K, hd, q.dtype)
    rc = build.entry(name)(
        q.data_ptr(), q.stride(0), q.stride(1),
        k_cache.data_ptr(), v_cache.data_ptr(),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        k_scale.data_ptr(), v_scale.data_ptr(), *k_scale.stride(),
        lengths.data_ptr(), out.data_ptr(), B, H, K, S, hd,
        _DTYPES[q.dtype], 1.0 / math.sqrt(hd), clusters, per,
        int(_rows_aligned(q)), _stream(q))
    _raise_on(name, rc)
    LAUNCHES[name] += 1
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


#: logits per CTA below which a row is not split further
TOPK_SLICE_MIN = 4096
#: CTAs per row at most (the portable thread-block cluster size)
TOPK_MAX_CLUSTERS = 8
#: largest slice, in bytes, that a CTA copies into shared memory; a
#: larger one is read from global memory on every pass
TOPK_STAGE_BYTES = 160 * 1024


def topk_cdf_geometry(V: int, dtype: torch.dtype) -> tuple[int, int, bool]:
    """Launch geometry of the top-k kernel for rows of V logits of
    ``dtype``: (CTAs per row, logits per CTA, whether a CTA stages its
    slice in shared memory). A function of V and the dtype alone -- never
    of the row count or the card -- because the kernel's float sums
    follow it, and compress and decompress must build the same integers
    whatever else shares the launch. The slices are multiples of 8, cover
    V, and none is empty."""
    clusters = max(1, min(TOPK_MAX_CLUSTERS, -(-V // TOPK_SLICE_MIN)))
    width = -(-V // clusters)
    width = -(-width // 8) * 8
    el = torch.empty((), dtype=dtype).element_size()
    return clusters, width, width * el <= TOPK_STAGE_BYTES


def topk_cdf(logits: torch.Tensor, k: int, precision: int):
    """logits (R, V), rows read through their stride -> (ids (R, k)
    int32, cdf (R, k+2) int32) with cdf[:, 0] == 0 and cdf[:, -1] ==
    2**precision."""
    _refuse_grad("topk_cdf", logits)
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
        clusters, width, staged = topk_cdf_geometry(V, logits.dtype)
        rc = build.entry("topk_cdf")(
            logits.data_ptr(), logits.stride(0), _DTYPES[logits.dtype], R,
            V, k, precision, clusters, width, int(staged), ids.data_ptr(),
            cdf.data_ptr(), _stream(logits))
        _raise_on("topk_cdf", rc)
        LAUNCHES["topk_cdf"] += 1
    return ids, cdf


#: logits per warp row of the full-vocabulary CDF kernel (32 lanes x 4)
CDF_ROW = 128
#: logits per CTA below which a row is not split further
CDF_SLICE_MIN = 4096
#: CTAs per row at most (the portable thread-block cluster size)
CDF_MAX_CLUSTERS = 8
#: a slice whose logits and fp32 running sums fit here is staged in
#: shared memory (csrc/cdf_points.cu kStageLimit); a larger one is read
#: from global memory on every pass
CDF_STAGE_BYTES = 192 * 1024


def cdf_points_geometry(V: int, dtype: torch.dtype) -> tuple[int, int]:
    """Launch geometry of the full-vocabulary CDF kernel for rows of V
    logits of ``dtype``: (CTAs per row, logits per CTA). A function of V
    and the dtype alone -- never of the row count or the card -- because
    the kernel's prefix sums follow it, and compress and decompress must
    build the same integers whatever else shares the launch. The slices
    are multiples of CDF_ROW, cover V, and none is empty. (The dtype does
    not move the split today; it decides, with the width, whether a slice
    is staged in shared memory: ``cdf_points_staged``.)"""
    clusters = max(1, min(CDF_MAX_CLUSTERS, -(-V // CDF_SLICE_MIN)))
    width = -(-V // clusters)
    width = -(-width // CDF_ROW) * CDF_ROW
    return -(-V // width), width


def cdf_points_staged(V: int, dtype: torch.dtype) -> bool:
    """Whether the CDF kernel stages a slice (its logits and their fp32
    running sums) in shared memory, as the C entry point decides it."""
    _, width = cdf_points_geometry(V, dtype)
    el = torch.empty((), dtype=dtype).element_size()
    return (el + 4) * width <= CDF_STAGE_BYTES


def cdf_points(logits: torch.Tensor, precision: int) -> torch.Tensor:
    """logits (R, V), rows read through their stride -> int32 CDF
    interior points (R, V): strictly increasing, last == 2**precision."""
    _refuse_grad("cdf_points", logits)
    if logits.device.type == "cpu":
        return ref.cdf_points(logits, precision)
    _check_logits("cdf_points", logits)
    R, V = logits.shape
    if not 1 <= precision <= 24 or (1 << precision) <= V:
        raise ValueError(f"cdf_points: precision {precision} cannot hold "
                         f"V={V} (and the kernel takes <= 24)")
    out = torch.empty((R, V), dtype=torch.int32, device=logits.device)
    if R:
        clusters, width = cdf_points_geometry(V, logits.dtype)
        rc = build.entry("cdf_points")(
            logits.data_ptr(), logits.stride(0), _DTYPES[logits.dtype], R,
            V, precision, clusters, width, out.data_ptr(), _stream(logits))
        _raise_on("cdf_points", rc)
        LAUNCHES["cdf_points"] += 1
    return out


def _rows_aligned(t: torch.Tensor) -> bool:
    """Every row of ``t`` (its last axis) starts on 16 bytes."""
    unit = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % unit == 0
                                          for s in t.stride()[:-1])


#: q rows (head, position) per warp and per CTA of the bf16 flash kernel
FLASH_WARP_ROWS = 16
FLASH_ROWS = 128


def flash_geometry(Sq: int, G: int, dtype: torch.dtype) -> tuple[int, int]:
    """(q-heads per CTA, positions per q tile) of the flash kernel for Sq
    queries and G q-heads per kv-head. bf16: the largest of 8, 4, 2, 1
    that divides G shares each K/V tile, and the tile is the tallest
    that fits FLASH_ROWS rows, but no taller than Sq rounded up to a
    warp's rows (the probe's S = 32 gets 32-position tiles and half the
    warps). fp32: one head, 32 positions. A function of the static
    shapes only: a lane's output never depends on the batch."""
    if dtype != torch.bfloat16:
        return 1, 32
    hg = next(d for d in (8, 4, 2, 1) if G % d == 0)
    w = FLASH_WARP_ROWS
    return hg, min(FLASH_ROWS // hg, -(-Sq // w) * w)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q (B, H, Sq, hd), k/v (B, K, Sk, hd), each read through its strides
    (unit stride over hd; the model passes transposed views of its
    (B, S, heads, hd) projections) -> (B, H, Sq, hd) in q's dtype. On the
    card the result is a (B, H, Sq, hd) view of a (B, Sq, H, hd) tensor,
    so the caller's transpose back to the model's layout is free. Any Sq
    and Sk; hd a multiple of 8 up to 128; H % K == 0; ``window`` None or
    >= 1."""
    _refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal, window)
    _check_cuda("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         f"(B,H,Sq,hd)/(B,K,Sk,hd)")
    B, H, Sq, hd = q.shape
    Bk, K, Sk, hdk = k.shape
    if (Bk, hdk) != (B, hd) or K < 1 or H % K:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (lanes, hd, or H % K)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype} (float32 or bfloat16, all equal)")
    if hd % 8 or not 8 <= hd <= 128:
        raise ValueError(f"flash_attention: hd={hd} (the kernel takes a "
                         f"multiple of 8 up to 128)")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: unit stride over hd required")
    if window is not None and int(window) < 1:
        raise ValueError(f"flash_attention: window {window} (None or >= 1)")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: B={B}, H={H} exceed the grid")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B == 0 or Sq == 0 or Sk == 0:
        return out.zero_()
    vec = all(_rows_aligned(t) for t in (q, k, v))
    hg, bq = flash_geometry(Sq, H // K, q.dtype)
    rc = build.entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], B, H, K, Sq, Sk, hd, int(bool(causal)),
        int(window or 0), _DTYPES[q.dtype], 1.0 / math.sqrt(hd), int(vec),
        hg, bq, _stream(q))
    _raise_on("flash_attention", rc)
    LAUNCHES["flash_attention"] += 1
    return out


#: rows of a y tile (and positions of a j tile) of the bf16 SSD kernel
SSD_ROWS = 64


def ssd_geometry(Q: int, H: int, P: int, N: int,
                 dtype: torch.dtype) -> tuple[int, int, int, int]:
    """Launch geometry of the SSD kernel: (rows per y tile, heads per CTA,
    y tiles per chunk, state CTAs per chunk and head group). The grid is
    (R, ceil(H / heads), y tiles + state CTAs): a CTA takes one chunk,
    one group of heads, and either a tile of y's rows for all the group's
    heads or the chunk-end state of two of them. bf16: 64-row tiles, 4
    heads from H = 4 up (2 below: a CTA's two warp halves take a head
    each at a step, and 2 above Q = 2048, where three (heads, Q) fp32
    arrays leave too little shared memory for 4), heads / 2 state CTAs.
    At mamba2-130m's scoring shape (Q = 128, H = 24) a chunk takes (2 +
    2) x 6 = 24 CTAs of 256 threads, so R = 16 chunks launch 384, two
    resident per SM: 1.45 waves of the 132 SMs, the heaviest CTAs first.
    fp32 (the fp32 twin's check): 32-row tiles, one head, one state CTA.
    A function of the static shapes only, never of R (P and N do not
    move it today). No sum depends on the head grouping, and each chunk's
    bits depend on that chunk alone."""
    if dtype != torch.bfloat16:
        return 32, 1, -(-Q // 32), 1
    heads = 4 if H >= 4 and Q <= 2048 else 2
    return SSD_ROWS, heads, -(-Q // SSD_ROWS), heads // 2


def ssd_intra(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor):
    """Mamba2 SSD over R independent chunks with a zero entering state:
    x (R, Q, H, P), dt (R, Q, H), A (H,) float32, Bm/Cm (R, Q, N), each
    read through its strides (unit stride over P and N; the model passes
    views of its conv output) -> (y (R, Q, H, P), chunk-end state (R, H,
    P, N)), both float32. Any Q up to 4096, P <= 64, N <= 128; x, dt, Bm
    and Cm share the dtype."""
    _refuse_grad("ssd_intra", x, dt, A, Bm, Cm)
    if x.device.type == "cpu":
        return ref.ssd_intra(x, dt, A, Bm, Cm)
    _check_cuda("ssd_intra", x, dt, A, Bm, Cm)
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 \
            or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_intra: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)} do not fit "
                         f"(R,Q,H,P)/(R,Q,H)/(H,)/(R,Q,N)")
    R, Q, H, P = x.shape
    N = Bm.shape[2]
    if dt.shape != (R, Q, H) or A.shape != (H,) or Bm.shape[:2] != (R, Q):
        raise ValueError(f"ssd_intra: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)} and B "
                         f"{tuple(Bm.shape)} disagree")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (dt, Bm, Cm)):
        raise ValueError(f"ssd_intra: dtypes {x.dtype}, {dt.dtype}, "
                         f"{Bm.dtype}, {Cm.dtype} (float32 or bfloat16, "
                         f"all equal)")
    if A.dtype != torch.float32 or not A.is_contiguous():
        raise ValueError("ssd_intra: A must be contiguous float32")
    if x.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError("ssd_intra: unit stride over P and N required")
    if not (1 <= P <= 64 and 1 <= N <= 128 and Q <= 4096):
        raise ValueError(f"ssd_intra: P={P}, N={N}, Q={Q} outside the "
                         f"kernel's range (P <= 64, N <= 128, Q <= 4096)")
    if R > 65535 or H > 65535:
        raise ValueError(f"ssd_intra: R={R}, H={H} exceed the grid")
    y = torch.empty((R, Q, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((R, H, P, N), dtype=torch.float32, device=x.device)
    if R == 0 or Q == 0 or H == 0:
        return y, state.zero_()
    vec = all(_rows_aligned(t) for t in (x, Bm, Cm))
    rc = build.entry("ssd_intra")(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(), *x.stride()[:3],
        *dt.stride(), *Bm.stride()[:2], *Cm.stride()[:2], R, Q, H, P, N,
        _DTYPES[x.dtype], int(vec), *ssd_geometry(Q, H, P, N, x.dtype),
        _stream(x))
    _raise_on("ssd_intra", rc)
    LAUNCHES["ssd_intra"] += 1
    return y, state
