"""Weight-only int8 products: the CUDA kernel, its plain version, its count.

The JAX package keeps a quantized model's matmul kernels resident as int8
codes with f32 scales and dequantizes them inside every program
(``engine/decode.py::_mp`` -> ``models/quant.py::dequantize_tree``); XLA
fuses the convert and the scale into the consuming matmul, so the int8
bytes stream from device memory straight into the product. There is no
``pallas_call`` behind it. Eager PyTorch has no such fusion: dequantizing
first would write and re-read a full-precision copy of every weight each
step (about 9 bytes moved a weight against bf16's 2). This module is the
port's counterpart of that fusion: ``csrc/int8_weight_matmul.cu`` reads
the codes and their scales and does the product in one pass.

It computes ``y[M, N] = x[M, K] . W[N, K]^T (+ bias)`` with ``W[n, k] =
wd(q[n, k]) * wd(scale[n % period])`` rounded to the weight dtype ``wd``
(the model dtype: ``QTensor.dequantize`` casts both factors to it and
multiplies there) and the sum kept in f32; the output is in the
activations' dtype. ``period`` is the scale's length: the flax kernel's
last axis (``head_dim`` for q/k/v, whose flax kernel is ``[D, N, H]``;
the output features elsewhere). Activations are bf16 (the projections
of a bf16 model: tensor cores) or f32 (the ``lm_head`` and router of a
bf16 model, whose weights are still rounded to bf16, and every product
of an f32 model: CUDA cores).

Four bodies, by the activations' dtype and rows (:data:`BODIES`), each
counted in :data:`launches_by_body` beside :data:`launches`:

- ``prefill`` (bf16 x, M > 16: prefill groups and chunks, verify windows,
  MoE experts at a fill): a warp-specialised ``wgmma`` body computing
  ``y^T = W . x^T``. A producer thread keeps TMA copies of codes and x in
  flight through a ring of shared-memory stages; two consumer warpgroups
  turn their rows' codes into bf16 A fragments in registers (the same
  rounding as :func:`dequantize_rows`) and multiply them into the x tile
  TMA landed, tokens as wgmma's N (64-256 a tile). The code bytes bound it
  up to M ~ 128, the bf16 tensor-core rate (and shared memory, through
  which every x tile passes) above.
- ``decode`` (bf16 x, M <= 16: a decode step's slots) and ``split3`` (f32
  x over bf16 weights: a bf16 model's ``lm_head`` and router): warps
  stream their columns' codes from device memory into ``mma.sync``
  fragments in registers. The code bytes bound them, one a weight.
- ``fma`` (f32 x over f32 weights: an f32 model): CUDA cores.

When the output tiles leave SMs idle (the narrow q/k/v/o products) the
bf16 bodies split K over a thread-block cluster and sum the partials
through distributed shared memory in rank order: no scratch, results
independent of block timing. The f32 bodies split K over a per-device
scratch (:func:`reserve`), the last block of each tile summing the
partials in split order.

CUDA tensors launch the kernel (or raise); CPU tensors, and CUDA tensors
inside :func:`plain_products` (card-side comparisons only), run
:func:`int8_linear_plain`. Launches are counted in :data:`launches`
(through ``graphs.count_launch``: a graph replay adds what its capture
recorded).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ray_dynamic_batching_tpu_torch.ops import graphs

#: Kernel launches since the last reset (plain-version calls do not count).
launches = 0

#: The kernel's bodies, in the order of the id its entry point reports.
BODIES = ("prefill", "decode", "split3", "fma")

#: Launches by body since the last reset (zeroed in place: graph replays
#: add to this dict).
launches_by_body = dict.fromkeys(BODIES, 0)

#: Split-K scratch per device for the f32-activation bodies: f32 partials
#: and per-tile arrival counters. Fixed sizes: the launch picks the
#: largest split that fits them, so a shape's split (and its numbers)
#: never depends on what ran before.
WS_FLOATS = 1 << 23          # 32 MB
WS_COUNTERS = 1 << 14

_DTYPES = (torch.float32, torch.bfloat16)

_PLAIN: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "plain_products", default=False)


@contextlib.contextmanager
def plain_products():
    """Inside this context CUDA tensors run the plain version too: for
    holding a model's kernel route against its plain route on the card.
    The serving path never enters it."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def dequantize_rows(codes: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype, axis: int = 0) -> torch.Tensor:
    """The one dequant rule: ``codes.to(dtype) * scale.to(dtype)`` with
    ``scale[i % period]`` (``period = scale.numel()``) along ``axis``."""
    n = codes.shape[axis]
    period = scale.numel()
    if n % period:
        raise ValueError(f"{n} rows are not a whole number of scale "
                         f"periods ({period})")
    shape = [1] * codes.dim()
    shape[axis] = n
    s = scale.reshape(-1).to(dtype).repeat(n // period).view(shape)
    return codes.to(dtype) * s


def int8_linear_plain(x: torch.Tensor, codes: torch.Tensor,
                      scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      *, weight_dtype: torch.dtype) -> torch.Tensor:
    """What the kernel computes, in PyTorch: the weight dequantized in
    ``weight_dtype``, then one ``F.linear`` in the activations' dtype."""
    w = dequantize_rows(codes, scale, weight_dtype)
    return F.linear(x, w.to(x.dtype), bias)


def _check(x, codes, scale, bias, weight_dtype) -> None:
    if codes.dtype != torch.int8 or codes.dim() != 2:
        raise TypeError(f"int8_linear: codes must be int8 [N, K], got "
                        f"{codes.dtype} {tuple(codes.shape)}")
    N, K = codes.shape
    if x.shape[-1] != K:
        raise ValueError(f"int8_linear: x {tuple(x.shape)} does not "
                         f"contract with codes {tuple(codes.shape)}")
    if scale.dtype != torch.float32 or scale.dim() != 1 or \
            scale.numel() == 0 or N % scale.numel():
        raise ValueError(f"int8_linear: scale must be f32 [period] with "
                         f"period dividing N = {N}, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if x.dtype not in _DTYPES or weight_dtype not in _DTYPES:
        raise TypeError(f"int8_linear: activations {x.dtype} / weights "
                        f"{weight_dtype} not in f32, bf16")
    if x.dtype == torch.bfloat16 and weight_dtype != torch.bfloat16:
        raise TypeError("int8_linear: bf16 activations take bf16 weights")
    if bias is not None and (tuple(bias.shape) != (N,)
                             or bias.dtype != x.dtype):
        raise ValueError(f"int8_linear: bias must be [{N}] in {x.dtype}, "
                         f"got {bias.dtype} {tuple(bias.shape)}")


_workspaces: dict = {}


def reset_counts() -> None:
    """Zero :data:`launches` and :data:`launches_by_body`."""
    global launches
    launches = 0
    for body in BODIES:
        launches_by_body[body] = 0


def _workspace(device: torch.device):
    """The device's split-K scratch (partials, counters), made once,
    counters zeroed then; each launch leaves them at 0. Launches on one
    device share it, so they run in stream order (the engine issues every
    kernel on the current stream). Under graph capture it must exist
    already (:func:`reserve`): a graph would bake in memory a later
    allocation could move."""
    key = device.index
    ws = _workspaces.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("int8_linear: reserve() the split-K scratch "
                               "before capturing a graph")
        ws = (torch.empty((WS_FLOATS,), dtype=torch.float32, device=device),
              torch.zeros((WS_COUNTERS,), dtype=torch.int32, device=device))
        _workspaces[key] = ws
    return ws


def reserve(device) -> tuple:
    """Make the device's split-K scratch (for f32 activations) before any
    graph captures a launch; returns it (the caller keeps it while its
    graphs live)."""
    from ray_dynamic_batching_tpu_torch.ops import _build

    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    with _build.launch_lock:
        return _workspace(device)


def _launch(x2, codes, scale, bias, weight_dtype) -> torch.Tensor:
    from ray_dynamic_batching_tpu_torch.ops import _build

    M, K = x2.shape
    N = codes.shape[0]
    for t in (codes, scale) + (() if bias is None else (bias,)):
        if t.device != x2.device:
            raise ValueError("int8_linear: inputs on more than one device")
    if K % 16:
        raise ValueError(f"int8_linear: K = {K} is not a multiple of 16 "
                         "(the kernel reads codes in 16-byte rows)")
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    codes = codes.contiguous()
    if codes.data_ptr() % 16:
        raise ValueError("int8_linear: codes must be 16-byte aligned")
    scale = scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    lib = _build.load("int8_weight_matmul")
    body = ctypes.c_int(-1)
    act_bf16 = x2.dtype == torch.bfloat16
    with _build.launch_lock:
        # The bf16 bodies reduce inside a cluster: no scratch.
        ws, cnt = (None, None) if act_bf16 else _workspace(x2.device)
        rc = lib.rdb_int8_weight_matmul(
            x2.data_ptr(), codes.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            M, N, K, scale.numel(), int(act_bf16),
            int(weight_dtype == torch.bfloat16),
            None if ws is None else ws.data_ptr(),
            0 if ws is None else ws.numel(),
            None if cnt is None else cnt.data_ptr(),
            0 if cnt is None else cnt.numel(),
            torch.cuda.current_stream(x2.device).cuda_stream,
            ctypes.byref(body))
    _build.check(lib, rc, "int8_weight_matmul")
    graphs.count_launch(globals(), "launches")
    graphs.count_launch(launches_by_body, BODIES[body.value])
    return out


def int8_linear(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                weight_dtype: torch.dtype) -> torch.Tensor:
    """``x [..., K]`` times the int8 weight ``codes [N, K]`` with f32
    ``scale [period]`` (``period`` dividing N), dequantized in
    ``weight_dtype``, plus ``bias [N]`` in x's dtype: ``[..., N]`` in x's
    dtype. CUDA tensors launch the kernel (K a multiple of 16; other
    shapes raise); CPU tensors run the plain version."""
    _check(x, codes, scale, bias, weight_dtype)
    if not x.is_cuda or _PLAIN.get():
        return int8_linear_plain(x, codes, scale, bias,
                                 weight_dtype=weight_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.shape[0] == 0:
        raise ValueError("int8_linear: no rows")
    return _launch(x2, codes, scale, bias, weight_dtype).view(
        *lead, codes.shape[0])
