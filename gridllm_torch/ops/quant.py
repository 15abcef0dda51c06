"""Int8 weight-only quantization.

The counterpart of the JAX package's ``ops/quant.py``: per-out-channel
symmetric int8 weights with float32 scales, so llama3:70b's matmul
weights (~68.5 GB in int8 against ~137 GB in bf16) fit one 80 GB card with
room for the KV pool. Activations stay in the model dtype.

Scheme (bit-equal to the JAX package's: the same `q` and `scale` bits):
- scale[o] = max(max_i |W[i, o]| / 127, 1e-12) in float32;
- q = clip(round(W / scale), -127, 127) in int8, rounding half to even.
Because scale is constant along the contracted axis,
x @ W == (x @ q) * scale up to rounding, which is `qdot`.

`qdot` is the plain form: the layer's int8 slice is converted to the
activation dtype and multiplied with `torch.matmul`, then the scale is
applied on the output channel. The JAX package computes it outside any
Pallas kernel too (XLA fuses the convert into the dot's operand read);
here the converted slice is a real tensor, written and read once more.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch


class QuantizedTensor:
    """int8 weights + per-out-channel scale. q: [..., in, out] int8;
    scale: [..., out] float32 (broadcasts over the removed `in` axis).
    Indexing the leading axes (a stacked leaf's layer) gives that slice's
    pair."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    def __getitem__(self, index) -> "QuantizedTensor":
        return QuantizedTensor(self.q[index], self.scale[index])

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def device(self) -> torch.device:
        return self.q.device

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """q * scale in `dtype` (the weight the int8 pair stands for)."""
        return self.q.to(dtype) * self.scale.to(dtype).unsqueeze(-2)


def _float32(w) -> torch.Tensor:
    """`w` as a float32 tensor: a tensor on its device, an array copied."""
    if isinstance(w, torch.Tensor):
        return w.to(torch.float32)
    return torch.from_numpy(np.array(w, dtype=np.float32))


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """The float32 scale of channels whose largest magnitude is `amax`.
    The divisor is a tensor on amax's device: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which rounds differently
    from the JAX package's (and the CPU's) true division."""
    amax = amax.to(torch.float32)
    return torch.clamp(amax / amax.new_full((), 127.0), min=1e-12)


def to_int8(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(w / scale), half to even, clipped to ±127, as int8 (`scale`
    broadcast against w's float32 values)."""
    return torch.clamp(torch.round(w.to(torch.float32) / scale), -127, 127).to(torch.int8)


def quantize_array(w, contract_axis: int = -2) -> QuantizedTensor:
    """Per-out-channel symmetric int8 over the contracted axis (default:
    second-to-last, the [in, out] / [L, in, out] weight layout). `w`: a
    tensor (quantized on its device) or a numpy array (on the CPU)."""
    w = _float32(w)
    scale = scale_of(w.abs().amax(dim=contract_axis))
    return QuantizedTensor(to_int8(w, scale.unsqueeze(contract_axis)), scale)


def quantize_into(dst: QuantizedTensor, w: torch.Tensor, block: int = 8192) -> None:
    """Quantize the [in, out] weight `w` into `dst` (its q and scale
    tensors, on any device) block of `block` output channels by block: the
    scale is per channel, so the blocks give quantize_array's bits while
    the float32 temporaries stay one block (a llama3:70b head is 4.2 GB in
    float32)."""
    for c0 in range(0, w.shape[-1], block):
        part = quantize_array(w[..., c0:c0 + block].to(dst.q.device))
        dst.q[..., c0:c0 + block].copy_(part.q)
        dst.scale[..., c0:c0 + block].copy_(part.scale)


def qdot(x: torch.Tensor, w, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x @ w for a plain weight; for a QuantizedTensor (x @ q) * scale, the
    scale applied on the output channel in the product's dtype (x's, or
    `out_dtype`, as the JAX package's preferred_element_type)."""
    if isinstance(w, QuantizedTensor):
        y = x @ w.q.to(x.dtype)
        if out_dtype is not None:
            y = y.to(out_dtype)
        return y * w.scale.to(y.dtype)
    y = x @ w
    return y if out_dtype is None else y.to(out_dtype)


# the llama-skeleton matmul leaves that quantize; everything else (norms,
# biases, embed, which doubles as the tied head, rope, the MoE router and
# experts) stays in the load dtype
QUANT_LEAVES = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"}
)

# subtrees whose leaves never quantize although their names collide with
# QUANT_LEAVES (the JAX package's llava vision tower and projector)
NO_QUANT_SUBTREES = frozenset({"vision", "projector"})


def quantize_params(params: dict[str, Any]) -> dict[str, Any]:
    """Quantize the QUANT_LEAVES of a llama-family pytree of tensors;
    returns a new pytree, the other leaves passed through."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                out[name] = leaf if name in NO_QUANT_SUBTREES else walk(leaf)
            elif name in QUANT_LEAVES:
                out[name] = quantize_array(leaf)
            else:
                out[name] = leaf
        return out

    return walk(params)


def quantize_np_leaf(name: str, arr):
    """Host-side quantization of one assembled leaf (a numpy array or CPU
    tensor) before it reaches the device: a QuantizedTensor of CPU tensors,
    or the leaf unchanged when `name` is not a quantized matmul. A stacked
    [L, ...] leaf is quantized one layer slice at a time, so the float32
    temporaries stay ~1/L of the leaf (a whole llama3:70b w_down in float32
    would be ~75 GiB of host memory)."""
    if name not in QUANT_LEAVES:
        return arr
    shape = tuple(arr.shape)
    if len(shape) <= 2:
        return quantize_array(arr)
    q = torch.empty(shape, dtype=torch.int8)
    scale = torch.empty(shape[:-2] + shape[-1:], dtype=torch.float32)
    flat_w = arr.reshape((-1,) + shape[-2:])
    flat_q = q.view((-1,) + shape[-2:])
    flat_s = scale.view((-1, shape[-1]))
    for i in range(flat_w.shape[0]):   # a float32 copy of one slice at a time
        part = quantize_array(flat_w[i])
        flat_q[i], flat_s[i] = part.q, part.scale
    return QuantizedTensor(q, scale)


def params_nbytes(params: Any) -> int:
    """Total parameter bytes of a pytree (dicts of tensors and
    QuantizedTensors; int8 counts one byte). Meta tensors count their
    shapes, so the memory math of a model too large to build needs no
    allocation."""
    if isinstance(params, dict):
        return sum(params_nbytes(v) for v in params.values())
    if isinstance(params, QuantizedTensor):
        return params_nbytes(params.q) + params_nbytes(params.scale)
    if isinstance(params, torch.Tensor):
        return math.prod(params.shape) * params.element_size()
    return math.prod(np.shape(params)) * np.asarray(params).dtype.itemsize
