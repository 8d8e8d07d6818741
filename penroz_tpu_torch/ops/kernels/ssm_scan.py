"""Chunked gated linear attention (the SSD scan): the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces penroz_tpu/ops/pallas/ssm_scan.py ``gla_chunked``.  Per head the
recurrence ``S_t = g_t S_{t-1} + k_t ⊗ v_t, y_t = q_t · S_t`` is computed in
chunks of ``block_t`` tokens: with ``la`` the inclusive cumsum of
``log(max(g, 1e-6))`` over the chunk,

    y     = (q · e^{la}) S_0 + ((q kᵀ) ⊙ causal e^{la_t − la_j}) v
    S_end = e^{la_L} S_0 + (k · e^{la_L − la})ᵀ v

and the ragged tail is padded with g = 1 and q = k = v = 0.  Every
exponent is ≤ 0 (gates in (0, 1)), so each factor lies in (0, 1] and
``e^{la_t − la_j}`` is formed from the difference, never as a quotient.

:func:`gla_chunked` launches the kernel (csrc/ssm_scan.cu) for CUDA
tensors and raises on anything it cannot take; for CPU tensors it runs
:func:`gla_chunked_reference`, the same chunk algebra in PyTorch (the twin
of the JAX ``_chunk_body``/``gla_chunked_reference``).  Nothing falls back
from the card to the plain version.  The token-sequential oracle lives in
ops/ssm.py (``gla_full_reference``); the two agree only to rounding, and
not at all where a gate is below the 1e-6 log floor.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from penroz_tpu_torch.ops.kernels import build

DEFAULT_BLOCK_T = 128
_LOG_EPS = 1e-6  # floor before log: sigmoid underflow -> exactly-0 gate

_COUNT_LOCK = threading.Lock()
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, g, y; B, T, H, dk, dv, chunk; (batch, token, head) strides of
# q, k and v; dtype code; stream
_ARGTYPES = [_P] * 5 + [_I] * 6 + [_L] * 9 + [_I, _P]


def chunk_length(T: int, block_t: int = DEFAULT_BLOCK_T) -> int:
    """Tokens per chunk: ``block_t``, cut to the sequence (at least 8)."""
    return min(int(block_t), max(int(T), 8))


def _chunk_body(q, k, v, lg, s0):
    """One chunk in fp32 for N sequences at once: q, k (N, L, dk), v
    (N, L, dv), log-gates (N, L), carry (N, dk, dv) → (y, s_end)."""
    la = torch.cumsum(lg, dim=-1)  # inclusive
    y = (q * torch.exp(la)[..., None]) @ s0
    scores = q @ k.transpose(-1, -2)
    L = la.shape[-1]
    causal = torch.ones(L, L, dtype=torch.bool, device=la.device).tril()
    diff = la[:, :, None] - la[:, None, :]
    decay = torch.exp(torch.where(causal, diff, float("-inf")))
    y = y + (scores * decay) @ v
    kd = k * torch.exp(la[:, -1:] - la)[..., None]
    s_end = torch.exp(la[:, -1])[:, None, None] * s0 + kd.transpose(-1, -2) @ v
    return y, s_end


def gla_chunked_reference(q, k, v, g, block_t: int = DEFAULT_BLOCK_T):
    """Plain version: the kernel's chunk algebra in PyTorch.  q, k
    (B, T, H, dk), v (B, T, H, dv) of any float type, gates g (B, T, H) in
    (0, 1) → y (B, T, H, dv) fp32."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    L = chunk_length(T, block_t)
    pad = -T % L
    lg = torch.log(torch.clamp(g.float(), min=_LOG_EPS))
    q, k, v = (t.float() for t in (q, k, v))
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        lg = F.pad(lg, (0, 0, 0, pad))
    n = (T + pad) // L

    def chunks(t):  # (B, Tp, H, d) -> (B*H, n, L, d)
        return t.permute(0, 2, 1, 3).reshape(B * H, n, L, t.shape[-1])

    qf, kf, vf = chunks(q), chunks(k), chunks(v)
    lgf = lg.permute(0, 2, 1).reshape(B * H, n, L)
    s = torch.zeros(B * H, dk, dv, dtype=torch.float32, device=q.device)
    ys = []
    for c in range(n):
        y, s = _chunk_body(qf[:, c], kf[:, c], vf[:, c], lgf[:, c], s)
        ys.append(y)
    out = torch.stack(ys, dim=1).reshape(B, H, n * L, dv)
    return out.permute(0, 2, 1, 3)[:, :T]


def _check_inputs(q, k, v, g):
    if q.device.type != "cuda":
        raise ValueError(f"gla_chunked: unsupported device {q.device}")
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 \
            or v.shape[:3] != q.shape[:3] or g.shape != q.shape[:3]:
        raise ValueError(f"gla_chunked: q, k (B, T, H, dk), v (B, T, H, dv) "
                         f"and g (B, T, H) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(g.shape)}")
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"gla_chunked: q, k, v must share a dtype in "
                         f"{sorted(map(str, build.DTYPE_CODES))}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"gla_chunked: {name} is on {t.device}, not "
                             f"{q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"gla_chunked: {name}'s last dim must be "
                             f"contiguous")
    if g.dtype != torch.float32 or g.device != q.device \
            or not g.is_contiguous():
        raise ValueError("gla_chunked: g must be a contiguous fp32 tensor "
                         "on q's device")


def gla_chunked(q, k, v, g, block_t: int = DEFAULT_BLOCK_T):
    """Chunked GLA, y (B, T, H, dv) fp32.  CUDA tensors launch the kernel:
    q, k (B, T, H, dk) and v (B, T, H, dv) in one dtype, fp32 or bf16, any
    strides with a contiguous last dim; g (B, T, H) contiguous fp32.  CPU
    tensors run :func:`gla_chunked_reference`."""
    if q.device.type == "cpu":
        return gla_chunked_reference(q, k, v, g, block_t)
    _check_inputs(q, k, v, g)
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    L = chunk_length(T, block_t)
    lib = build.load("ssm_scan")
    smem = build.function(lib, "penroz_gla_smem_bytes", [_I] * 3)(L, dk, dv)
    limit = torch.cuda.get_device_properties(
        q.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"gla_chunked: a {L}-token chunk at dk {dk}, dv "
                         f"{dv} needs {smem} bytes of shared memory, more "
                         f"than the card's {limit}; use a smaller block_t")
    y = torch.empty(B, T, H, dv, dtype=torch.float32, device=q.device)
    fn = build.function(lib, "penroz_gla_chunked", _ARGTYPES)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             y.data_ptr(), B, T, H, dk, dv, L, *strides,
             build.DTYPE_CODES[q.dtype], build.stream(q))
    build.check(lib, err, "gla_chunked")
    with _COUNT_LOCK:
        gla_chunked.launches += 1
    return y


gla_chunked.launches = 0
