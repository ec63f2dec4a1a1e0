"""The encoder block's elementwise passes as five row-wise kernels
(csrc/encoder_epilogue.cu).

They replace no TPU kernel: XLA fused these passes on the TPU.  Under
PyTorch each bias add, layernorm, GELU, residual add and cast is a kernel
of its own writing a float32 intermediate; these read the bf16 GEMM output
once and write only what the next GEMM or the residual stream needs.  Per
encoder layer (models/whisper.py `_qkv`, `_out_mlp`; a decoder layer takes
ln_cast once a step and bias_residual_ln after each of its three residual
GEMMs, `_decoder_layer`):

    ln_cast           bf16 LN(x)                      block entry
    bias_cast         q, v = bf16(f32(q|v) + b)       after the q/k/v GEMMs
    bias_residual_ln  x' = x + (f32(y) + b), bf16 LN(x')   after o
    bias_gelu_cast    h = bf16(gelu_tanh(f32(y) + b)) after mlp0
    bias_residual     x' = x + (f32(y) + b)           after mlp2

Each `*_ref` is the torch sequence the block runs without the kernels, in
any dtype: models/whisper.py `_ops` binds them to the compute dtype where
its rule (`_kernels`) says plain, and the card's tests compare the kernels
with them.  CUDA tensors go through the kernels, which take f32 rows x,
bf16 GEMM outputs y, f32 biases and layernorm weights, every tensor
contiguous and 16-byte aligned, a row width D that is a multiple of 8 (at
most 2048 for the layernorms); anything else raises.  `bias_cast` and
`bias_gelu_cast` write into y and return it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import library

EPS = 1e-5              # the encoder's layernorms (models/whisper.py)
MAX_LN_WIDTH = 2048     # the layernorm kernels keep a row in registers


def _bias_add(y, b, dtype):
    """f32(y) + f32(b), rounded once to dtype."""
    return torch.add(y, b.float(), out=torch.empty(y.shape, dtype=dtype,
                                                   device=y.device))


def _layernorm(x, w, b, eps):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def ln_cast_ref(x, w, b, dtype=torch.bfloat16, eps: float = EPS):
    """LN(x) in f32, rounded to dtype."""
    return _layernorm(x, w, b, eps).to(dtype)


def bias_cast_ref(*pairs, dtype=None):
    """For each (y, b): f32(y) + b rounded to dtype (y's when None) -> a
    tuple.  A K3 or all-reduced product comes in f32 and rounds to the
    compute dtype here."""
    return tuple(_bias_add(y, b, dtype or y.dtype) for y, b in pairs)


def bias_residual_ln_ref(x, y, bias, w, b, dtype=torch.bfloat16,
                         eps: float = EPS):
    """-> (x' = x + (f32(y) + bias) in f32, LN(x') rounded to dtype)."""
    x = x + _bias_add(y, bias, torch.float32)
    return x, _layernorm(x, w, b, eps).to(dtype)


def bias_gelu_cast_ref(y, bias, dtype=torch.bfloat16):
    """gelu_tanh(f32(y) + bias) in f32, rounded to dtype."""
    return F.gelu(_bias_add(y, bias, torch.float32),
                  approximate="tanh").to(dtype)


def bias_residual_ref(x, y, bias):
    """x + (f32(y) + bias), f32."""
    return x + _bias_add(y, bias, torch.float32)


def _stream(x: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _check(fn_name: str, D: int, tensors, max_width: int | None = None):
    """Each (name, tensor, dtype, shape) as given, on the first tensor's
    CUDA device, contiguous and 16-byte aligned; D a multiple of 8 (at most
    max_width).  -> the rows."""
    first = tensors[0][1]
    if not first.is_cuda:
        raise ValueError(f"{fn_name}: unsupported device {first.device}")
    dev = first.get_device()
    for name, x, dtype, shape in tensors:
        if x.shape != shape or x.dtype != dtype or x.get_device() != dev:
            raise ValueError(f"{fn_name}: {name} is {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}, expected "
                             f"{tuple(shape)} {dtype} on {first.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{fn_name}: {name} must be contiguous and "
                             "16-byte aligned")
    if D % 8 or D < 8 or (max_width is not None and D > max_width):
        raise ValueError(f"{fn_name}: row width {D} must be a multiple of 8"
                         + (f" up to {max_width}" if max_width else ""))
    rows = tensors[0][1].numel() // D
    if not 1 <= rows < 2 ** 31:
        raise ValueError(f"{fn_name}: {rows} rows")
    return rows


def ln_cast(x, w, b):
    """x (..., D) f32 -> bf16 LN(x) (w, b (D,) f32)."""
    if not x.is_cuda and x.device.type == "cpu":
        return ln_cast_ref(x, w, b)
    D = x.shape[-1]
    rows = _check("ln_cast", D, (("x", x, torch.float32, x.shape),
                                 ("w", w, torch.float32, (D,)),
                                 ("b", b, torch.float32, (D,))),
                  MAX_LN_WIDTH)
    out = torch.empty_like(x, dtype=torch.bfloat16)
    library().call("wtt_ln_cast", x.data_ptr(), w.data_ptr(), b.data_ptr(),
                   out.data_ptr(), rows, D, EPS, _stream(x))
    ln_cast.launches += 1
    return out


ln_cast.launches = 0


def bias_cast(*pairs):
    """One or two (y (..., D) bf16, b (D,) f32) pairs of one shape: y =
    bf16(f32(y) + b) in place, in one launch -> the y's."""
    if not 1 <= len(pairs) <= 2:
        raise ValueError(f"bias_cast: {len(pairs)} pairs, takes 1 or 2")
    y = pairs[0][0]
    if not y.is_cuda and y.device.type == "cpu":
        return bias_cast_ref(*pairs)
    D = y.shape[-1]
    rows = _check("bias_cast", D, [
        t for i, (yi, bi) in enumerate(pairs)
        for t in ((f"y{i}", yi, torch.bfloat16, y.shape),
                  (f"b{i}", bi, torch.float32, (D,)))])
    (y0, b0), (y1, b1) = pairs[0], pairs[-1]
    library().call("wtt_bias_cast", y0.data_ptr(), b0.data_ptr(),
                   y1.data_ptr(), b1.data_ptr(), len(pairs), rows, D,
                   _stream(y))
    bias_cast.launches += 1
    return tuple(yi for yi, _ in pairs)


bias_cast.launches = 0


def bias_residual_ln(x, y, bias, w, b):
    """x (..., D) f32, y bf16 of its shape, bias/w/b (D,) f32 -> (x' = x +
    (f32(y) + bias) f32, bf16 LN(x'))."""
    if not x.is_cuda and x.device.type == "cpu":
        return bias_residual_ln_ref(x, y, bias, w, b)
    D = x.shape[-1]
    rows = _check("bias_residual_ln", D, (
        ("x", x, torch.float32, x.shape), ("y", y, torch.bfloat16, x.shape),
        ("bias", bias, torch.float32, (D,)), ("w", w, torch.float32, (D,)),
        ("b", b, torch.float32, (D,))), MAX_LN_WIDTH)
    x_out = torch.empty_like(x)
    ln = torch.empty_like(x, dtype=torch.bfloat16)
    library().call("wtt_bias_residual_ln", x.data_ptr(), y.data_ptr(),
                   bias.data_ptr(), w.data_ptr(), b.data_ptr(),
                   x_out.data_ptr(), ln.data_ptr(), rows, D, EPS, _stream(x))
    bias_residual_ln.launches += 1
    return x_out, ln


bias_residual_ln.launches = 0


def bias_gelu_cast(y, bias):
    """y (..., D) bf16, bias (D,) f32: y = bf16(gelu_tanh(f32(y) + bias)) in
    place -> y."""
    if not y.is_cuda and y.device.type == "cpu":
        return bias_gelu_cast_ref(y, bias, y.dtype)
    D = y.shape[-1]
    rows = _check("bias_gelu_cast", D, (
        ("y", y, torch.bfloat16, y.shape),
        ("bias", bias, torch.float32, (D,))))
    library().call("wtt_bias_gelu_cast", y.data_ptr(), bias.data_ptr(), rows,
                   D, _stream(y))
    bias_gelu_cast.launches += 1
    return y


bias_gelu_cast.launches = 0


def bias_residual(x, y, bias):
    """x (..., D) f32, y bf16 of its shape, bias (D,) f32 -> x + (f32(y) +
    bias), f32."""
    if not x.is_cuda and x.device.type == "cpu":
        return bias_residual_ref(x, y, bias)
    D = x.shape[-1]
    rows = _check("bias_residual", D, (
        ("x", x, torch.float32, x.shape), ("y", y, torch.bfloat16, x.shape),
        ("bias", bias, torch.float32, (D,))))
    x_out = torch.empty_like(x)
    library().call("wtt_bias_residual", x.data_ptr(), y.data_ptr(),
                   bias.data_ptr(), x_out.data_ptr(), rows, D, _stream(x))
    bias_residual.launches += 1
    return x_out


bias_residual.launches = 0
