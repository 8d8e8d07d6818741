"""Fixed-size recurrent sequence state: gated linear attention / the SSD
scan (counterpart of penroz_tpu/ops/ssm.py).

Where a KV cache grows with the sequence, the SSM state is a constant
``(H, dk, dv)`` tensor per row and layer.  Recurrence (per head and row,
fp32 throughout):

    S_t = g_t * S_{t-1} + k_t ⊗ v_t          g_t = σ(gate_t)
    y_t = q_t · S_t                           q pre-scaled by dk^-0.5

Two forms, as in the JAX package:

- ``SSMState.update_dense`` — cached prefill and decode: a token-sequential
  loop over T at the cache's position offset, so cached generation feeds
  the tokens in the JAX package's order and its greedy tokens match.
- :func:`gla_full` — the no-cache forward (``/output/``, ``/evaluate/``,
  training): the chunked CUDA kernel (ops/kernels/ssm_scan.py) for CUDA
  tensors at inference, the sequential oracle :func:`gla_full_reference`
  in training and on the CPU — the JAX dispatch, so the CPU port matches
  the CPU JAX package.

Checkpoint ring: every token write also stores the post-token state in a
ring of ``ckpt_slots`` slots keyed by the length after the token
(``ckpt_pos``; -1 = empty), the JAX layout that speculative-decoding
rollback reads.  The JAX states are functional pytrees; this one updates
its tensors IN PLACE, as the port's KV caches do.  ``update_packed``,
``rollback_row`` and the row import/export and hand-off methods belong to
the scheduler's SSM rows, which are not ported.
"""

from __future__ import annotations

import os

import torch

from penroz_tpu_torch.ops.kernels import ssm_scan


def ckpt_slots_default() -> int:
    """Ring size: enough for a spec-decode verify block plus slack."""
    slots = int(os.environ.get("PENROZ_SSM_CKPT", "8"))
    spec = int(os.environ.get("PENROZ_SPEC_DECODE", "0") or 0)
    return max(slots, spec + 2, 2)


def _outer(k_t, v_t):
    """k ⊗ v over trailing dims: (..., dk) x (..., dv) -> (..., dk, dv)."""
    return k_t[..., :, None] * v_t[..., None, :]


class SSMState:
    """Per-row recurrent state for every ``ssm`` block of a model: per-layer
    ``state`` (B, H, dk, dv) fp32, per-layer ``ckpt`` (B, C, H, dk, dv) fp32
    and one shared ``ckpt_pos`` (B, C) int32 (every layer checkpoints at
    the same positions)."""

    def __init__(self, state, ckpt, ckpt_pos, specs, ckpt_slots):
        self.state = list(state)
        self.ckpt = list(ckpt)
        self.ckpt_pos = ckpt_pos
        self.specs = tuple(tuple(int(x) for x in s) for s in specs)
        self.ckpt_slots = int(ckpt_slots)

    @classmethod
    def create(cls, specs, batch, ckpt_slots=None, device=None):
        """Zero state for ``specs = [(num_heads, head_dim, value_dim), ...]``."""
        C = int(ckpt_slots) if ckpt_slots else ckpt_slots_default()
        B = int(batch)
        state = [torch.zeros((B, h, dk, dv), dtype=torch.float32,
                             device=device) for (h, dk, dv) in specs]
        ckpt = [torch.zeros((B, C, h, dk, dv), dtype=torch.float32,
                            device=device) for (h, dk, dv) in specs]
        ckpt_pos = torch.full((B, C), -1, dtype=torch.int32, device=device)
        return cls(state, ckpt, ckpt_pos, specs, C)

    @property
    def batch(self) -> int:
        return int(self.ckpt_pos.shape[0])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.ckpt_pos, *self.state, *self.ckpt))

    def reset(self):
        """Zero every row (in place)."""
        for t in (*self.state, *self.ckpt):
            t.zero_()
        self.ckpt_pos.fill_(-1)
        return self

    def reset_row(self, row: int):
        """Zero row ``row`` (in place)."""
        for t in (*self.state, *self.ckpt):
            t[row].zero_()
        self.ckpt_pos[row].fill_(-1)
        return self

    def update_dense(self, layer_idx: int, q, k, v, g, start):
        """Token-sequential scan over T for B rows at position offset
        ``start`` (the cache length, shared by the rows; the JAX package's
        per-row offsets serve the scheduler's rows, not ported); updates
        this layer's state and checkpoints in place (the tensors keep
        their addresses, as a captured step needs) and returns y
        (B, T, H, dv) fp32.  ``start`` is a host int, or the (1, T) int64
        device positions of a captured step, which place the checkpoints
        at device indices."""
        B, T = q.shape[0], q.shape[1]
        C = self.ckpt_slots
        q, k, v, g = (t.float() for t in (q, k, v, g))
        state = self.state[layer_idx]
        ck = self.ckpt[layer_idx]
        if isinstance(start, torch.Tensor):  # the checkpoints' keys
            keys = start.reshape(-1) + 1
            slots = keys % C
            keys = keys.to(torch.int32)
        s = state
        ys = []
        for t in range(T):
            s = g[:, t, :, None, None] * s + _outer(k[:, t], v[:, t])
            ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t], s))
            if isinstance(start, torch.Tensor):
                slot = slots[t:t + 1]
                ck.index_copy_(1, slot, s[:, None])
                self.ckpt_pos.index_copy_(
                    1, slot, keys[t:t + 1].view(1, 1).expand(B, 1))
            else:
                length = int(start) + t + 1  # the checkpoint's key
                ck[:, length % C] = s
                self.ckpt_pos[:, length % C] = length
        state.copy_(s)
        return torch.stack(ys, dim=1)


# ---------------------------------------------------------------------------
# No-cache full-sequence form (training, /output/, /evaluate/)
# ---------------------------------------------------------------------------

def gla_full_reference(q, k, v, g):
    """Sequential-scan oracle: the exact recurrence, (B, T, H, ·) -> fp32,
    with a gradient."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    q, k, v, g = (t.float() for t in (q, k, v, g))
    s = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    ys = []
    for t in range(T):
        s = g[:, t, :, None, None] * s + _outer(k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t], s))
    return torch.stack(ys, dim=1)


def gla_full(q, k, v, g, training: bool = False):
    """Full causal gated linear attention without a cache.  Inference on
    the card runs the chunked CUDA kernel; training, any call that needs a
    gradient (the ``/stats/`` pass) and the CPU run the differentiable
    sequential oracle (the kernel has no backward)."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, g))
    if not training and not needs_grad and q.device.type == "cuda":
        return ssm_scan.gla_chunked(q, k, v, g)
    return gla_full_reference(q, k, v, g)
