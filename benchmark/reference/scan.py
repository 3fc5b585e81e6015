"""Selective scan of the Mamba mixer, plain PyTorch, in chunks.

    h[t] = exp(delta[t] A) * h[t-1] + (delta[t] u[t]) B[t],   h[-1] = 0
    y[t] = sum_n C[t, n] h[t][:, n] + D u[t]

u, delta (B, L, Din); A (Din, N); B, C (B, L, N); D (Din,); `reverse` walks
from t = L-1 down to 0. Within a chunk the affine maps h -> a h + b are
composed by doubling; chunks follow one another. `scan` is differentiable:
its forward keeps the inputs and each chunk's entry state, its backward
recomputes one chunk at a time under autograd, from the last chunk back,
so no (L, Din, N) tensor is ever kept whole.
"""

from __future__ import annotations

import torch

# Elements of one chunk's (B, c, Din, N) tensors: 2^26 floats, 256 MiB.
CHUNK_ELEMENTS = 1 << 26


def _compose_prefix(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix over dim 1 of the maps h -> a h + b by doubling:
    after the pass with offset s, position t holds the composition of the
    maps t-2s+1 .. t."""
    s = 1
    while s < a.shape[1]:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a, b


def _chunk(u, delta, A, Bp, Cp, h0):
    """y (without D u) and the last state of one chunk from its entry state."""
    a = torch.exp(delta[..., None] * A)
    b = (delta * u)[..., None] * Bp[:, :, None, :]
    pa, pb = _compose_prefix(a, b)
    h = pa * h0[:, None] + pb
    y = torch.einsum("bcdn,bcn->bcd", h, Cp)
    return y, h[:, -1]


def chunk_len(batch: int, d_in: int, n: int) -> int:
    c = max(1, CHUNK_ELEMENTS // max(1, batch * d_in * n))
    return 1 << (c.bit_length() - 1)


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, delta, A, Bp, Cp, D, chunk):
        batch, seq_len, d_in = u.shape
        h = u.new_zeros(batch, d_in, A.shape[1])
        ys, entries = [], []
        for s in range(0, seq_len, chunk):
            e = min(s + chunk, seq_len)
            entries.append(h)
            y, h = _chunk(u[:, s:e], delta[:, s:e], A, Bp[:, s:e], Cp[:, s:e], h)
            ys.append(y)
        ctx.chunk = chunk
        ctx.save_for_backward(u, delta, A, Bp, Cp, D, torch.stack(entries, 1))
        return torch.cat(ys, 1) + D * u

    @staticmethod
    def backward(ctx, dy):
        u, delta, A, Bp, Cp, D, entries = ctx.saved_tensors
        chunk, seq_len = ctx.chunk, u.shape[1]
        du, dd, dB, dC = (torch.zeros_like(t) for t in (u, delta, Bp, Cp))
        dA = torch.zeros_like(A)
        gh = None
        starts = list(range(0, seq_len, chunk))
        for k in reversed(range(len(starts))):
            s = starts[k]
            e = min(s + chunk, seq_len)
            with torch.enable_grad():
                ins = [t[:, s:e].detach().requires_grad_() for t in (u, delta, Bp, Cp)]
                a_leaf = A.detach().requires_grad_()
                h0 = entries[:, k].detach().requires_grad_()
                y, h_last = _chunk(ins[0], ins[1], a_leaf, ins[2], ins[3], h0)
                outs, grads = [y], [dy[:, s:e]]
                if gh is not None:
                    outs.append(h_last)
                    grads.append(gh)
                got = torch.autograd.grad(outs, [*ins, a_leaf, h0], grads)
            for acc, g in zip((du, dd, dB, dC), got[:4]):
                acc[:, s:e] += g
            dA += got[4]
            gh = got[5]
        du += dy * D
        dD = (dy * u).sum(dim=(0, 1))
        return du, dd, dA, dB, dC, dD, None


def scan(u, delta, A, Bp, Cp, D, reverse: bool = False) -> torch.Tensor:
    """y (B, L, Din) float32 of the selective scan (module docstring)."""
    if reverse:
        u, delta, Bp, Cp = (torch.flip(t, (1,)) for t in (u, delta, Bp, Cp))
    chunk = chunk_len(u.shape[0], u.shape[2], A.shape[1])
    y = _Scan.apply(u, delta, A, Bp, Cp, D, chunk)
    return torch.flip(y, (1,)) if reverse else y
