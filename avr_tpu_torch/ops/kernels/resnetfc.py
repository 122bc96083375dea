"""K2: fused FC-ResNet field decoder (forward) — CUDA kernel wrapper and
its plain version.

Replaces ``avr_tpu/ops/pallas/resnetfc.py:896 fused_resnetfc`` (forward,
``:726``).  The function: an optional in-kernel positional encoding of the
raw ``[xyz | viewdir]`` lanes (:class:`CodeSpec`); per source view,
``lin_in`` and the first ``n_lin_z`` blocks, each preceded by a latent
injection ``h += z @ Wz_k + bz_k``; the mean over views; the remaining
blocks; ``relu -> lin_out``; optionally ``sigmoid(rgb) / relu(sigma)``.  A
block is ``h + relu(relu(h) @ W0 + b0) @ W1 + b1``.  The residual trunk
``h`` is float32; matmul operands (weights, biases, activations, the
encoded input and the latent) are rounded to the compute dtype and
accumulate in float32.

What bounds it on Hopper: operations.  At the band shape (81,920 points,
d_hidden 512, 13 hidden products) it is ~5.6e11 FLOP, ~0.57 ms at the bf16
tensor-core peak, against ~94 MB of compulsory traffic (~28 us).  The
kernel keeps each 32-point tile's activations on chip (trunk in
registers, the operand tile in shared memory) so the (N, 512) activations
and the 42-wide encoding never reach device memory, and runs the bf16
products on the tensor cores with ``mma.sync`` m16n8k16.  The ~6.8 MB of
bf16 weights do not fit in shared memory (the TPU kernel holds them all in
VMEM); they stream from L2 for every tile.  float32 operands take a plain
FMA path with the same tiling.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from avr_tpu_torch.ops.kernels import _build

__all__ = ["CodeSpec", "DecoderWeights", "fused_resnetfc", "resnetfc_plain",
           "encode_tables"]

NAME = "fused_resnetfc"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class CodeSpec:
    """The in-decoder positional encoding (``avr_tpu`` ``CodeSpec``).

    Raw input ``[coded dims | passthrough dims]``; encoded layout: optional
    raw coded dims, then ``sin(f_k x + phase_k)`` as channel ``k*d_coded +
    d`` with ``f_k = freq_factor * 2**(k//2)`` and ``phase_k = (k%2)*pi/2``,
    then the passthrough dims.
    """

    num_freqs: int
    freq_factor: float
    include_input: bool
    d_coded: int
    d_pass: int = 0

    @property
    def d_raw(self) -> int:
        return self.d_coded + self.d_pass

    @property
    def d_enc(self) -> int:
        return (self.d_coded if self.include_input else 0) + \
            2 * self.num_freqs * self.d_coded + self.d_pass


class DecoderWeights(NamedTuple):
    """Decoder parameters in ``nn.Linear`` layout ``(out, in)``, stacked."""

    wi: torch.Tensor  # (dh, d_enc)
    bi: torch.Tensor  # (dh,)
    wz: torch.Tensor  # (n_lin_z, dh, d_latent)
    bz: torch.Tensor  # (n_lin_z, dh)
    w0: torch.Tensor  # (n_blocks, dh, dh)
    b0: torch.Tensor  # (n_blocks, dh)
    w1: torch.Tensor  # (n_blocks, dh, dh)
    b1: torch.Tensor  # (n_blocks, dh)
    wo: torch.Tensor  # (d_out, dh)
    bo: torch.Tensor  # (d_out,)


_RAW, _SIN, _ZERO = 0, 1, 2


def encode_tables(code: Optional[CodeSpec], d_in: int, width: int):
    """Per encoded column: (mode, source lane, frequency, phase), padded
    with zero columns to ``width``.  ``code=None`` is the identity on
    ``d_in`` already-encoded lanes."""
    mode = np.full(width, _ZERO, np.int32)
    src = np.zeros(width, np.int32)
    f = np.ones(width, np.float32)
    ph = np.zeros(width, np.float32)
    if code is None:
        mode[:d_in], src[:d_in] = _RAW, np.arange(d_in)
        return mode, src, f, ph
    dc, col = code.d_coded, 0
    if code.include_input:
        mode[:dc], src[:dc] = _RAW, np.arange(dc)
        col = dc
    for k in range(2 * code.num_freqs):
        cols = col + k * dc + np.arange(dc)
        mode[cols], src[cols] = _SIN, np.arange(dc)
        f[cols] = code.freq_factor * 2.0 ** (k // 2)
        ph[cols] = (k % 2) * (np.pi / 2.0)
    col += 2 * code.num_freqs * dc
    mode[col:col + code.d_pass] = _RAW
    src[col:col + code.d_pass] = dc + np.arange(code.d_pass)
    return mode, src, f, ph


def _encode(p: torch.Tensor, code: CodeSpec) -> torch.Tensor:
    """``(N, d_raw)`` float32 -> ``(N, d_enc)`` float32 (the decoder prologue)."""
    mode, src, f, ph = (torch.from_numpy(a).to(p.device)
                        for a in encode_tables(code, code.d_raw, code.d_enc))
    lanes = p[:, src.long()]
    return torch.where(mode == _SIN, torch.sin(lanes * f + ph), lanes)


def resnetfc_plain(x: torch.Tensor, z: torch.Tensor, w: DecoderWeights, *,
                   n_blocks: int, n_lin_z: int, compute_dtype: torch.dtype,
                   code: Optional[CodeSpec] = None,
                   activate_out: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``x (NS, N, d_in)``, ``z
    (NS, N, d_latent)`` -> ``(N, d_out)`` float32."""
    c = lambda t: t.to(compute_dtype).float()  # operand rounding, f32 math
    wi, bi, wz, bz, w0, b0, w1, b1, wo, bo = (c(t) for t in w)

    def block(h, k):
        a2 = c(torch.relu(c(torch.relu(h)) @ w0[k].T + b0[k]))
        return h + a2 @ w1[k].T + b1[k]

    ns = x.shape[0]
    h_sum = None
    for v in range(ns):
        p = x[v].float()
        if code is not None:
            p = _encode(p, code)
        zv = c(z[v])
        h = c(p) @ wi.T + bi
        for k in range(n_lin_z):
            h = h + zv @ wz[k].T + bz[k]
            h = block(h, k)
        h_sum = h if h_sum is None else h_sum + h
    h = h_sum if ns == 1 else h_sum * (1.0 / ns)
    for k in range(n_lin_z, n_blocks):
        h = block(h, k)
    out = c(torch.relu(h)) @ wo.T + bo
    if activate_out:
        out = torch.cat([torch.sigmoid(out[:, :3]), torch.relu(out[:, 3:])], dim=-1)
    return out


def fused_resnetfc(x: torch.Tensor, z: torch.Tensor, w: DecoderWeights, *,
                   n_blocks: int, n_lin_z: int, compute_dtype: torch.dtype,
                   code: Optional[CodeSpec] = None,
                   activate_out: bool = False) -> torch.Tensor:
    """Apply the decoder: ``x (NS, N, d_in)`` raw (``code``) or encoded
    point features, ``z (NS, N, d_latent)`` latents -> ``(N, d_out)`` float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if not 0 < n_lin_z <= n_blocks:
        raise ValueError(f"{NAME}: need 0 < n_lin_z <= n_blocks")
    if activate_out and w.wo.shape[0] != 4:
        raise ValueError(f"{NAME}: activate_out requires d_out == 4")
    if x.device.type == "cpu":
        return resnetfc_plain(x, z, w, n_blocks=n_blocks, n_lin_z=n_lin_z,
                              compute_dtype=compute_dtype, code=code,
                              activate_out=activate_out)
    if compute_dtype not in _DTYPES:
        raise TypeError(f"{NAME}: compute dtype {compute_dtype} not in {list(_DTYPES)}")
    ns, N, d_in = x.shape
    d_hidden, d_enc = w.wi.shape
    d_latent, d_out = z.shape[-1], w.wo.shape[0]
    if code is not None and code.d_raw != d_in:
        raise ValueError(f"{NAME}: x width {d_in} != code.d_raw {code.d_raw}")
    if d_hidden % 64 or not 64 <= d_hidden <= 512 or d_latent % 64:
        raise ValueError(f"{NAME}: kernel needs d_hidden in 64..512 and d_latent "
                         f"multiples of 64, got {d_hidden}, {d_latent}")
    if z.shape[:2] != (ns, N) or w.wz.shape != (n_lin_z, d_hidden, d_latent):
        raise ValueError(f"{NAME}: z {tuple(z.shape)} / wz {tuple(w.wz.shape)} mismatch")
    dev = x.device
    k_in = (d_enc + 63) // 64 * 64
    mode, src, f, ph = encode_tables(code, d_in, k_in)
    tables = torch.from_numpy(np.stack([mode, src]).astype(np.int32)).to(dev)
    fph = torch.from_numpy(np.stack([f, ph])).to(dev)
    cd = lambda t: t.to(compute_dtype).contiguous()
    wi = torch.zeros((d_hidden, k_in), dtype=compute_dtype, device=dev)
    wi[:, :d_enc] = w.wi
    biases = [t.to(compute_dtype).float().contiguous() for t in (w.bi, w.bz, w.b0, w.b1, w.bo)]
    args = dict(x=x.float().contiguous(), z=cd(z), wi=wi, wz=cd(w.wz), w0=cd(w.w0),
                w1=cd(w.w1), wo=cd(w.wo), bi=biases[0], bz=biases[1], b0=biases[2],
                b1=biases[3], bo=biases[4], tables=tables, fph=fph)
    _build.check_cuda_inputs(NAME, "the recompute / stash backward, resnetfc.py:823,853",
                             args, dev)
    out = torch.empty((N, d_out), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    fn = _build.kernel_fn("avr_resnetfc", [ctypes.c_void_p] * 15 + [ctypes.c_int] * 11
                          + [ctypes.c_void_p])
    a = args
    err = fn(_build.ptr(a["x"]), _build.ptr(a["z"]), _build.ptr(a["wi"]), _build.ptr(a["bi"]),
             _build.ptr(a["wz"]), _build.ptr(a["bz"]), _build.ptr(a["w0"]), _build.ptr(a["b0"]),
             _build.ptr(a["w1"]), _build.ptr(a["b1"]), _build.ptr(a["wo"]), _build.ptr(a["bo"]),
             _build.ptr(tables), _build.ptr(fph), _build.ptr(out),
             N, ns, d_in, k_in, d_latent, d_hidden, d_out, n_blocks, n_lin_z,
             int(activate_out), _DTYPES[compute_dtype],
             ctypes.c_void_p(_build.stream_ptr(dev)))
    _build.check(NAME, err)
    return out
