"""Fixed-size recurrent sequence state: gated linear attention / the SSD
scan (counterpart of penroz_tpu/ops/ssm.py).

Where a KV cache grows with the sequence, the SSM state is a constant
``(H, dk, dv)`` tensor per row and layer.  Recurrence (per head and row,
fp32 throughout):

    S_t = g_t * S_{t-1} + k_t ⊗ v_t          g_t = σ(gate_t)
    y_t = q_t · S_t                           q pre-scaled by dk^-0.5

Three forms, as in the JAX package:

- ``SSMState.update_dense`` — cached prefill and decode: B rows of T
  tokens, each row at its own start (a scalar or a (B,) start), and
  optionally only its first ``count[b]`` tokens (a right-padded batch, a
  parked row of a shared step: the rest leave the row untouched).
- ``SSMState.update_packed`` — the unified ragged block: the packed slots
  of a ``build_descriptors`` layout ((NB, 4) ``(row, q_pos0, q_valid,
  kv_len)``), walked in order; a slot at ``t >= q_valid`` and every slot
  of a padding block (row -1) are dropped.
- :func:`gla_full` — the no-cache forward (``/output/``, ``/evaluate/``,
  training): the chunked CUDA kernel (ops/kernels/ssm_scan.py) for CUDA
  tensors at inference, the sequential oracle :func:`gla_full_reference`
  in training and on the CPU — the JAX dispatch, so the CPU port matches
  the CPU JAX package.

On the card both cached forms are one launch of the recurrent-update
kernel a layer (ops/kernels/ssm_update.py, csrc/ssm_update.cu), the port's
form of the JAX package's one-program ``lax.scan``: a (row, head, 8-column
tile) takes four warps, each thread a few rows of the state in registers,
fed slots that cp.async fetched stages ahead; on the CPU they run the
plain versions :func:`update_dense_reference` and
:func:`update_packed_reference`, loops over the tokens.  The same fp32
arithmetic a token in every form and on every chunking (the state rounded
as two products and a sum, bit for bit the plain version's), so a row's
state does not depend on how its prompt was cut.

Checkpoint ring: every token write also stores the post-token state in a
ring of ``ckpt_slots`` slots keyed by the length after the token
(``ckpt_pos``; -1 = empty), the JAX layout that ``rollback_row`` (the
speculative verify's rejection) reads.  The JAX states are functional
pytrees; this one updates its tensors IN PLACE, as the port's KV caches
do: a :meth:`SSMState.row_view` is a batch-1 slice that writes through.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from penroz_tpu_torch.ops.kernels import ssm_scan, ssm_update


def ckpt_slots_default() -> int:
    """Ring size: enough for a spec-decode verify block plus slack."""
    slots = int(os.environ.get("PENROZ_SSM_CKPT", "8"))
    spec = int(os.environ.get("PENROZ_SPEC_DECODE", "0") or 0)
    return max(slots, spec + 2, 2)


def _outer(k_t, v_t):
    """k ⊗ v over trailing dims: (..., dk) x (..., dv) -> (..., dk, dv)."""
    return k_t[..., :, None] * v_t[..., None, :]


def row_starts(start, B: int, device) -> torch.Tensor:
    """(B,) int64 start positions of ``update_dense``: a host int for every
    row, a (B,) per-row start, or the (B, T) per-token positions of a
    captured or batched step (each row's first)."""
    if isinstance(start, torch.Tensor):
        return start.reshape(B, -1)[:, 0].to(device, torch.int64)
    arr = np.broadcast_to(np.asarray(start, np.int64).reshape(-1), (B,))
    return torch.as_tensor(np.array(arr), device=device)


def update_dense_reference(state, ckpt, ckpt_pos, q, k, v, g, start,
                           count=None):
    """Plain version of the dense recurrent update (the JAX scan, one token
    at a time): ``state`` (B, H, dk, dv) fp32, ``ckpt`` (B, C, H, dk, dv)
    fp32 and ``ckpt_pos`` (B, C) int32 are updated in place; q, k (B, T,
    H, dk), v (B, T, H, dv), g (B, T, H); ``start`` (B,) int64; ``count``
    (B,) or None: row b takes its first ``count[b]`` tokens, the others
    leave it untouched and output 0.  Returns y (B, T, H, dv) fp32."""
    B, T = q.shape[0], q.shape[1]
    C = ckpt.shape[1]
    q, k, v, g = (t.float() for t in (q, k, v, g))
    rows = torch.arange(B, device=q.device)
    s = state.clone()
    ys = []
    for t in range(T):
        valid = (torch.ones(B, dtype=torch.bool, device=q.device)
                 if count is None else t < count)
        s_new = g[:, t, :, None, None] * s + _outer(k[:, t], v[:, t])
        s = torch.where(valid[:, None, None, None], s_new, s)
        y = torch.einsum("bhk,bhkv->bhv", q[:, t], s_new)
        ys.append(torch.where(valid[:, None, None], y, torch.zeros_like(y)))
        pa = start + t + 1
        slot = pa % C
        ckpt[rows, slot] = torch.where(valid[:, None, None, None], s,
                                       ckpt[rows, slot])
        ckpt_pos[rows, slot] = torch.where(valid, pa.to(torch.int32),
                                           ckpt_pos[rows, slot])
    state.copy_(s)
    return torch.stack(ys, dim=1)


def update_packed_reference(state, ckpt, ckpt_pos, q, k, v, g, descs,
                            block_q: int):
    """Plain version of the packed recurrent update (the JAX scan over the
    packed slots): q, k (1, Tp, H, dk), v (1, Tp, H, dv), g (1, Tp, H);
    ``descs`` (NB, 4) ``(row, q_pos0, q_valid, kv_len)``, Tp = NB x
    ``block_q``.  Slot ``p`` is token ``t = p % block_q`` of block ``p //
    block_q``; it updates its row when ``0 <= row < B`` and ``t <
    q_valid`` (the JAX scan's dropped writes), in slot order, and outputs
    0 otherwise.  Updates ``state``/``ckpt``/``ckpt_pos`` in place and
    returns y (1, Tp, H, dv) fp32."""
    B, C = ckpt_pos.shape
    Tp = q.shape[1]
    q, k, v, g = (t[0].float() for t in (q, k, v, g))
    y = torch.zeros((Tp, q.shape[1], v.shape[-1]), dtype=torch.float32,
                    device=q.device)
    for blk, (row, pos0, n, _) in enumerate(
            np.asarray(torch.as_tensor(descs).cpu(), np.int64).tolist()):
        if not 0 <= row < B:
            continue
        for t in range(min(int(n), int(block_q))):
            p = blk * int(block_q) + t
            s = g[p, :, None, None] * state[row] + _outer(k[p], v[p])
            y[p] = torch.einsum("hk,hkv->hv", q[p], s)
            state[row] = s
            pa = pos0 + t + 1
            ckpt[row, pa % C] = s
            ckpt_pos[row, pa % C] = pa
    return y[None]


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

    @property
    def device(self):
        return self.ckpt_pos.device

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.ckpt_pos, *self.state, *self.ckpt))

    def _tensors(self):
        return (*self.state, *self.ckpt, self.ckpt_pos)

    def reset(self):
        """Zero every row (in place)."""
        for t in (*self.state, *self.ckpt):
            t.zero_()
        self.ckpt_pos.fill_(-1)
        return self

    def reset_row(self, row: int):
        """Zero row ``row`` and empty its ring (in place)."""
        for t in (*self.state, *self.ckpt):
            t[row].zero_()
        self.ckpt_pos[row].fill_(-1)
        return self

    # -- the row contract (the scheduler's rows) ---------------------------

    def insert_row(self, row: int, src: "SSMState"):
        """Copy a batch-1 ``SSMState`` (a newcomer's own prefill) into row
        ``row``, ring included."""
        if src.specs != self.specs:
            raise ValueError(f"insert_row source specs {src.specs} != "
                             f"destination specs {self.specs}")
        return self.merge_row(row, src)

    def import_row(self, row: int, blob: dict):
        """Install the per-layer states of one row (a hand-off or resume
        import): ``blob["state"]``, a list of (H, dk, dv) arrays (host or
        device).  The row's ring starts empty: the next tokens fill it
        before any rollback can need it."""
        self.reset_row(row)
        for s, b in zip(self.state, blob["state"]):
            if not isinstance(b, torch.Tensor):
                b = torch.from_numpy(np.array(b))
            s[row].copy_(b.to(s.device, torch.float32))
        return self

    def rollback_row(self, row: int, new_length: int):
        """Exact rewind of row ``row`` to ``new_length`` through the ring:
        length 0 restores zeros; otherwise the checkpoint keyed
        ``new_length`` is restored, and the state is kept when no slot
        holds it.  Every checkpoint past ``new_length`` (all of them at 0)
        is dropped.  Host op on the row's (C,) keys."""
        L = int(new_length)
        keys = self.ckpt_pos[row].tolist()
        hit = [c for c, key in enumerate(keys) if key == L]
        for s, ck in zip(self.state, self.ckpt):
            if L == 0:
                s[row].zero_()
            elif hit:
                s[row].copy_(ck[row, hit[0]])
        drop = [c for c, key in enumerate(keys) if key > L or L == 0]
        if drop:
            self.ckpt_pos[row, drop] = -1
        return self

    def row_view(self, row: int, length=None) -> "SSMState":
        """Batch-1 view of row ``row``: slices of this state's tensors, so
        updates through it write the row in place.  ``length`` is taken for
        the KV contract's sake and ignored (the state has no extent)."""
        r = int(row)
        return SSMState([s[r:r + 1] for s in self.state],
                        [c[r:r + 1] for c in self.ckpt],
                        self.ckpt_pos[r:r + 1], self.specs, self.ckpt_slots)

    def merge_row(self, row: int, view: "SSMState"):
        """Write a batch-1 ``view`` into row ``row``: nothing to do for a
        :meth:`row_view`, which wrote in place; a copy is copied."""
        r = int(row)
        for mine, theirs in zip(self._tensors(), view._tensors()):
            dst = mine[r:r + 1]
            if dst.data_ptr() != theirs.data_ptr():
                dst.copy_(theirs.to(dst.device, dst.dtype))
        return self

    def export_row(self, row: int, device: bool = False) -> dict:
        """Constant-size blob of one row's live states (hand-off and
        hibernation): ``{"state": [(H, dk, dv)], "specs"}``; ``device``
        keeps the planes on the card, else they are CPU copies."""
        planes = [s[int(row)].clone() for s in self.state]
        if not device:
            planes = [p.cpu() for p in planes]
        return {"state": planes, "specs": [list(s) for s in self.specs]}

    def export_row_pages(self, row, length, device: bool = False) -> dict:
        """The KV hand-off contract's name for :meth:`export_row`: a
        recurrent row's "pages" are its state, whatever its length."""
        return self.export_row(int(row), device=device)

    def import_row_pages(self, row, blob: dict):
        """The KV hand-off contract's name for :meth:`import_row`."""
        return self.import_row(int(row), blob)

    def export_all(self, device: bool = False) -> dict:
        """Every row's live states (whole-cache hibernation)."""
        planes = [s.clone() for s in self.state]
        if not device:
            planes = [p.cpu() for p in planes]
        return {"state": planes, "specs": [list(s) for s in self.specs]}

    def import_all(self, blob: dict):
        """Install every row's states from :meth:`export_all`; every ring
        starts empty."""
        self.reset()
        for s, b in zip(self.state, blob["state"]):
            if not isinstance(b, torch.Tensor):
                b = torch.from_numpy(np.array(b))
            s.copy_(b.to(s.device, torch.float32))
        return self

    # -- cached updates (in place) ------------------------------------------

    def update_dense(self, layer_idx: int, q, k, v, g, start, count=None):
        """Dense recurrent update of B rows of T tokens at ``start`` (a
        host int, a (B,) start, or (B, T) device positions: see
        :func:`row_starts`), row b taking its first ``count[b]`` tokens
        ((B,) tensor, or None for all T).  Updates this layer's state and
        ring in place (the tensors keep their addresses, as a captured
        step needs) and returns y (B, T, H, dv) fp32, 0 at a dropped
        token.  CUDA tensors launch the kernel, CPU tensors run
        :func:`update_dense_reference`."""
        B = q.shape[0]
        starts = row_starts(start, B, q.device)
        if count is not None:
            count = torch.as_tensor(count, device=q.device)
        state, ck = self.state[layer_idx], self.ckpt[layer_idx]
        if q.device.type == "cuda":
            return ssm_update.ssm_update(state, ck, self.ckpt_pos, q, k, v,
                                         g, starts=starts, counts=count)
        return update_dense_reference(state, ck, self.ckpt_pos, q, k, v, g,
                                      starts, count)

    def update_packed(self, layer_idx: int, q, k, v, g, descs,
                      block_q: int):
        """Packed recurrent update over the unified block's slots (see
        :func:`update_packed_reference`): q, k, v, g (1, Tp, ...), descs
        (NB, 4) int32.  Returns y (1, Tp, H, dv) fp32.  CUDA tensors launch
        the kernel, CPU tensors run the plain version."""
        state, ck = self.state[layer_idx], self.ckpt[layer_idx]
        if q.device.type == "cuda":
            return ssm_update.ssm_update(state, ck, self.ckpt_pos, q, k, v,
                                         g, descs=descs, block_q=block_q)
        return update_packed_reference(state, ck, self.ckpt_pos, q, k, v, g,
                                       descs, block_q)


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
