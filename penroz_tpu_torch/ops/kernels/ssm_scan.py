"""Chunked gated linear attention (the SSD scan): the CUDA kernel's wrapper,
its plain PyTorch version and a CPU twin of the kernel's decomposition.

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

The kernel does not walk the chunks in order.  The log floor is applied per
token, so the algebra is exact for any chunk length; the kernel cuts the
sequence into ``KERNEL_TILE``-token tiles, all computed in parallel: each
tile's local state ``(k · e^{la_L − la})ᵀ v``, a carry pass in which every
``carry_stride``-th tile publishes its inclusive state and the others sum
the last such state and the locals after it, and the outputs.  Its
products run on tensor cores in 3xTF32 (each fp32 operand split into a
TF32 head and a TF32 tail).  :func:`gla_chunked_parallel_reference` is
that decomposition on the CPU, with the products in fp32 or in emulated
(3x)TF32, for the tests.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from penroz_tpu_torch.ops.kernels import build

DEFAULT_BLOCK_T = 128
KERNEL_TILE = 64  # tokens a tile of the kernel (csrc/ssm_scan.cu kTile)
_LOG_EPS = 1e-6  # floor before log: sigmoid underflow -> exactly-0 gate

_COUNT_LOCK = threading.Lock()
_FLAGS: dict[int, tuple[torch.Tensor, int]] = {}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, g, y, states, flags; B, T, H, dk, dv, carry stride, epoch;
# (batch, token, head) strides of q, k and v; dtype code, vec; stream
_ARGTYPES = [_P] * 7 + [_I] * 7 + [_L] * 9 + [_I, _I, _P]


def chunk_length(T: int, block_t: int = DEFAULT_BLOCK_T) -> int:
    """Tokens per chunk: ``block_t``, cut to the sequence (at least 8)."""
    return min(int(block_t), max(int(T), 8))


def carry_stride(dk: int, dv: int) -> int:
    """Every how many tiles the kernel publishes an inclusive state: a tile
    sums at most this many (dk x dv) slots, and the carry's serial chain
    has one link a stride.  Wide states take the shorter stride."""
    return 8 if dk * dv <= 64 * 64 else 4


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


def _padded_chunks(q, k, v, g, L):
    """fp32 operands cut into chunks of L tokens, the tail padded with
    g = 1 and q = k = v = 0: q, k, v (B H, n, L, d), log-gates (B H, n, L)."""
    B, T, H, _ = q.shape
    pad = -T % L
    lg = torch.log(torch.clamp(g.float(), min=_LOG_EPS))
    q, k, v = (t.float() for t in (q, k, v))
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        lg = F.pad(lg, (0, 0, 0, pad))
    n = (T + pad) // L

    def chunks(t):  # (B, Tp, H, d) -> (B*H, n, L, d)
        return t.permute(0, 2, 1, 3).reshape(B * H, n, L, t.shape[-1])

    return chunks(q), chunks(k), chunks(v), \
        lg.permute(0, 2, 1).reshape(B * H, n, L)


def _unchunk(y, B, T, H):
    """(B H, n, L, dv) → (B, T, H, dv), the padded tail dropped."""
    n, L, dv = y.shape[1:]
    return y.reshape(B, H, n * L, dv).permute(0, 2, 1, 3)[:, :T]


def gla_chunked_reference(q, k, v, g, block_t: int = DEFAULT_BLOCK_T):
    """Plain version: the kernel's chunk algebra in PyTorch.  q, k
    (B, T, H, dk), v (B, T, H, dv) of any float type, gates g (B, T, H) in
    (0, 1) → y (B, T, H, dv) fp32."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf, lgf = _padded_chunks(q, k, v, g, chunk_length(T, block_t))
    s = torch.zeros(B * H, dk, dv, dtype=torch.float32, device=q.device)
    ys = []
    for c in range(qf.shape[1]):
        y, s = _chunk_body(qf[:, c], kf[:, c], vf[:, c], lgf[:, c], s)
        ys.append(y)
    return _unchunk(torch.stack(ys, dim=1), B, T, H)


def tf32_round(x):
    """fp32 → the nearest TF32 value (10 mantissa bits kept, ties away from
    zero: ``cvt.rna.tf32.f32``), still as fp32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul(a, b, products: str):
    """a @ b in fp32 ("fp32"), in one TF32 pass ("tf32"), or as the kernel
    does it ("3xtf32"): hi = tf32(x), lo = tf32(x − hi), and
    lo·hi' + hi·lo' + hi·hi', each pass exact products summed in fp32."""
    if products == "fp32":
        return a @ b
    ah, bh = tf32_round(a), tf32_round(b)
    if products == "tf32":
        return ah @ bh
    if products != "3xtf32":
        raise ValueError(f"products must be fp32, tf32 or 3xtf32, got "
                         f"{products!r}")
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def gla_chunked_parallel_reference(q, k, v, g, sub_chunk: int = KERNEL_TILE,
                                   stride: int = 8, products: str = "fp32"):
    """The kernel's decomposition on the CPU: chunks of ``sub_chunk`` tokens
    (the kernel's tiles), their local states, the carry pass (every
    ``stride``-th chunk's inclusive state, and for each chunk the last of
    those before it plus the locals after it, newest first, each times
    e^{sum of the later chunks' la_L}), then the outputs.  ``products``
    selects the arithmetic of every matrix product (see :func:`_matmul`).
    Same inputs and output as :func:`gla_chunked_reference`."""
    if stride < 2:
        raise ValueError(f"stride must be at least 2, got {stride}")
    B, T, H, _ = q.shape
    qf, kf, vf, lg = _padded_chunks(q, k, v, g, int(sub_chunk))
    n, L = lg.shape[1:]
    la = torch.cumsum(lg, dim=-1)
    last = la[..., -1]                                      # (B H, n)
    kd = kf * torch.exp(last[..., None] - la)[..., None]
    local = _matmul(kd.transpose(-1, -2), vf, products)     # (B H, n, dk, dv)
    carry = torch.zeros_like(local)                         # S_{c-1}
    inclusive = {}
    for c in range(1, n):
        cp = (c // stride) * stride - 1                     # -1: none yet
        acc = torch.zeros_like(local[:, 0])
        r = torch.zeros_like(last[:, 0])
        for j in range(c - 1, max(cp, 0) - 1, -1):
            x = inclusive[j] if j == cp else local[:, j]
            acc = acc + torch.exp(r)[:, None, None] * x
            if j > cp:
                r = r + last[:, j]
        carry[:, c] = acc
        if c % stride == stride - 1:
            inclusive[c] = torch.exp(last[:, c])[:, None, None] * acc \
                + local[:, c]
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    decay = torch.exp(torch.where(causal, la[..., :, None] - la[..., None, :],
                                  float("-inf")))
    scores = _matmul(qf, kf.transpose(-1, -2), products) * decay
    y = torch.exp(la)[..., None] * _matmul(qf, carry, products) \
        + _matmul(scores, vf, products)
    return _unchunk(y, B, T, H)


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


def _flags(device, n: int):
    """The per-device int64 buffer of the ticket ([0], left at zero by each
    launch) and at least ``n`` publish flags, and this launch's epoch: a
    flag is set when its low word equals the epoch (its high word carries
    the tile's log-gate sum), so launches need no reset.  A new buffer
    starts at zero, and the epoch at 1."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    with _COUNT_LOCK:
        buf, epoch = _FLAGS.get(index, (None, 0))
        epoch = epoch + 1 if epoch < 2 ** 31 - 1 else 1
        if buf is None or buf.numel() < n + 1 or epoch == 1:
            buf = torch.zeros(max(n + 1, 4096), dtype=torch.int64,
                              device=device)
        _FLAGS[index] = (buf, epoch)
        return buf, epoch


def _vectorizable(q, k, v) -> bool:
    """16-byte copies: every pointer, stride and width a multiple of 16
    bytes."""
    per = 16 // q.element_size()
    return all(t.data_ptr() % 16 == 0 and t.shape[-1] % per == 0
               and all(s % per == 0 for s in t.stride()[:3])
               for t in (q, k, v))


def gla_chunked(q, k, v, g, block_t: int = DEFAULT_BLOCK_T):
    """Chunked GLA, y (B, T, H, dv) fp32.  CUDA tensors launch the kernel:
    q, k (B, T, H, dk) and v (B, T, H, dv) in one dtype, fp32 or bf16, any
    strides with a contiguous last dim; g (B, T, H) contiguous fp32.  The
    kernel computes the same function in its own ``KERNEL_TILE``-token
    tiles, whatever ``block_t``.  CPU tensors run
    :func:`gla_chunked_reference` with ``block_t``."""
    if q.device.type == "cpu":
        return gla_chunked_reference(q, k, v, g, block_t)
    _check_inputs(q, k, v, g)
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    lib = build.load("ssm_scan")
    smem = build.function(lib, "penroz_gla_smem_bytes", [_I] * 2)(dk, dv)
    limit = torch.cuda.get_device_properties(
        q.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"gla_chunked: a {KERNEL_TILE}-token tile at dk "
                         f"{dk}, dv {dv} needs {smem} bytes of shared "
                         f"memory, more than the card's {limit}")
    y = torch.empty(B, T, H, dv, dtype=torch.float32, device=q.device)
    n = -(-T // KERNEL_TILE)
    slot = -(-dk // 16) * 16 * (-(-dv // 8) * 8)
    states = torch.empty(B * H * n * slot, dtype=torch.float32,
                         device=q.device)
    flags, epoch = _flags(q.device, B * H * n)
    fn = build.function(lib, "penroz_gla_chunked", _ARGTYPES)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             y.data_ptr(), states.data_ptr(), flags.data_ptr(), B, T, H, dk,
             dv, carry_stride(dk, dv), epoch,
             *strides, build.DTYPE_CODES[q.dtype],
             int(_vectorizable(q, k, v)), build.stream(q))
    build.check(lib, err, "gla_chunked")
    with _COUNT_LOCK:
        gla_chunked.launches += 1
    return y


gla_chunked.launches = 0
