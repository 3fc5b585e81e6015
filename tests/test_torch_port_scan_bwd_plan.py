"""A model of how `csrc/scan_bwd.cu`'s `scan_bwd_kernel` walks and sums the
selective scan's backward, held to the JAX package's Pallas backward and to
float64 autograd of the literal recurrence on the CPU.

The kernel runs only on the card, so its order of arithmetic is checked here
in its own terms. Per block (one batch row, DT = 256 / N channels) the
tiles of 32 steps are taken against the scan's walk, each from its
checkpointed entry state:
- pass 1, the steps in walk order: a = exp2(dt A log2 e), q = a h, h = dt u
  Bp + q; q is stored, a and dt q are kept;
- pass 2, the steps backwards: g = Cp dy + g, g is stored, dA += g (dt q),
  g = a g;
- the sums over states of each (step, channel), states in order: du =
  dt sum(g Bp) + D dy, ddelta = u sum(g Bp) + sum(A g q); g and q are then
  replaced by g dt u and h dy (h = dt u Bp + q again), and dD's term dy u
  is added into the (step mod N) class of the channel;
- the sums over channels of each (step, state), channels in order: the tile's
  dBp and dCp partials;
then the partials over channel tiles and the dA, dD sums over batch rows,
each in order. The model takes `scan_ckpt_reference`'s checkpoints, as the
kernel takes `scan_ckpt`'s. The cotangent of a·h_prev comes from the stored
q, not from h - dt u Bp, so no subtraction can cancel: a case where a is
near 0 (h ~ dt u Bp) checks that anyway. The buffers' XOR swizzle is checked
to be a bijection that gives each warp of the walk and of both sums 32
distinct banks.

Tolerances: the float32 model within 1e-5 of max|ref| of JAX's
`selective_scan_pallas_bwd` in interpret mode and of float64 autograd, 1e-4
for dA and dD (sums over B * L terms), as the port's other scan tests.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_scan import _inputs

from deepchopper_tpu.ops.pallas_scan import selective_scan_pallas_bwd
from deepchopper_tpu_torch.ops import scan

CHUNK = scan.CKPT_CHUNK
THREADS = 256
LOG2E = np.float32(1.4426950408889634)
NAMES = ("du", "ddelta", "dA", "dBp", "dCp", "dD")
TOLS = (1e-5, 1e-5, 1e-4, 1e-5, 1e-5, 1e-4)


def swz(n_states: int, s: int, dl: int, n: int) -> int:
    """Position of (channel dl, state n) among step s's 256 floats of the g
    and q buffers (`swz` in csrc/scan_bwd.cu)."""
    if n_states == 16:
        return ((dl ^ (s & 1)) << 4) | (n ^ (dl & 15))
    return ((dl ^ (((dl >> 3) ^ s) & 3)) << 3) | (n ^ (dl & 7))


def tile_steps(seq_len: int, c: int, reverse: bool) -> list[int]:
    """The steps of tile c in the order the forward took them (slot j)."""
    lo = c * CHUNK
    steps = list(range(lo, min(seq_len, lo + CHUNK)))
    return steps[::-1] if reverse else steps


def scan_bwd_model(u, delta, A, Bp, Cp, D, dy, reverse: bool):
    """(du, ddelta, dA, dBp, dCp, dD) float32 in the kernel's order."""
    batch, seq_len, d_in = u.shape
    n = A.shape[1]
    dt_ch = THREADS // n  # channels a block (DT)
    tiles = d_in // dt_ch
    nl = -(-seq_len // CHUNK)
    a2 = A * LOG2E
    ckpt = scan.scan_ckpt_reference(u, delta, A, Bp, reverse)  # (B, nl, N, Din)
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    part_db = torch.empty(tiles, batch, seq_len, n)
    part_dc = torch.empty_like(part_db)
    g = torch.zeros(batch, d_in, n)  # the carry, one register a thread
    da_sum = torch.zeros(batch, d_in, n)
    dd_sum = torch.zeros(batch, n, d_in)  # one partial a (step class, channel) thread
    for k in range(nl):
        c = k if reverse else nl - 1 - k  # against the forward walk
        steps = tile_steps(seq_len, c, reverse)
        # Pass 1.
        h = ckpt[:, c].transpose(1, 2)
        qs, a_s, w_s = [], [], []
        for t in steps:
            dt = delta[:, t, :, None]
            a = torch.exp2(dt * a2)
            q = a * h
            h = (dt * u[:, t, :, None]) * Bp[:, t, None, :] + q
            qs.append(q)
            a_s.append(a)
            w_s.append(dt * q)
        # Pass 2.
        gs = [None] * len(steps)
        da = torch.zeros(batch, d_in, n)
        for j in reversed(range(len(steps))):
            t = steps[j]
            g = Cp[:, t, None, :] * dy[:, t, :, None] + g
            gs[j] = g
            da = g * w_s[j] + da
            g = a_s[j] * g
        da_sum = da_sum + da
        # Sums over states, (step, channel) each; dD's classes of steps.
        dd_tile = torch.zeros(batch, n, d_in)
        for s, t in enumerate(steps):
            dt, ut, dyt = delta[:, t], u[:, t], dy[:, t]
            bu = dt * ut
            vb, va = torch.zeros(batch, d_in), torch.zeros(batch, d_in)
            for nn in range(n):
                gv, qv, bp = gs[s][..., nn], qs[s][..., nn], Bp[:, t, None, nn]
                vb = gv * bp + vb
                va = A[:, nn] * (gv * qv) + va
            du[:, t] = vb * dt + D * dyt
            ddelta[:, t] = vb * ut + va
            gs[s] = gs[s] * bu[..., None]
            qs[s] = (bu[..., None] * Bp[:, t, None, :] + qs[s]) * dyt[..., None]
            # Thread kk % 256 of kk = s DT + channel is class s mod N.
            dd_tile[:, s % n] = dyt * ut + dd_tile[:, s % n]
        dd_sum = dd_sum + dd_tile
        # Sums over channels, (step, state) each, channels in order.
        for tile in range(tiles):
            for s, t in enumerate(steps):
                sb, sc = torch.zeros(batch, n), torch.zeros(batch, n)
                for dd in range(tile * dt_ch, (tile + 1) * dt_ch):
                    sb = sb + gs[s][:, dd]
                    sc = sc + qs[s][:, dd]
                part_db[tile, :, t], part_dc[tile, :, t] = sb, sc
    # scan_bwd_reduce: each sum in order.
    dbp, dcp = torch.zeros(batch, seq_len, n), torch.zeros(batch, seq_len, n)
    for tile in range(tiles):
        dbp, dcp = dbp + part_db[tile], dcp + part_dc[tile]
    dd_row = torch.zeros(batch, d_in)
    for r in range(n):
        dd_row = dd_row + dd_sum[:, r]
    d_a, d_d = torch.zeros(d_in, n), torch.zeros(d_in)
    for b in range(batch):
        d_a, d_d = d_a + da_sum[b], d_d + dd_row[b]
    return du, ddelta, d_a, dbp, dcp, d_d


def float64_grads(u, delta, A, Bp, Cp, D, dy, reverse: bool):
    """Autograd of the literal recurrence in float64."""
    leaves = [torch.from_numpy(x).double().requires_grad_(True) for x in (u, delta, A, Bp, Cp, D)]
    uu, dd, aa, bb, cc, ds = leaves
    batch, seq_len, d_in = u.shape
    h = torch.zeros(batch, d_in, A.shape[1], dtype=torch.float64)
    ys = [None] * seq_len
    for t in range(seq_len - 1, -1, -1) if reverse else range(seq_len):
        h = torch.exp(dd[:, t, :, None] * aa) * h + (dd[:, t] * uu[:, t])[..., None] * bb[:, t, None, :]
        ys[t] = (h * cc[:, t, None, :]).sum(-1) + ds * uu[:, t]
    grads = torch.autograd.grad(torch.stack(ys, 1), leaves, torch.from_numpy(dy).double())
    du, ddelta, d_a, dbp, dcp, d_d = (x.numpy() for x in grads)
    return du, ddelta, d_a, dbp, dcp, d_d


def _rel(got, want) -> float:
    """Max-abs error of max|want| (dA of a one-step scan is all zero, and
    then asks for an exact zero)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _check(args, reverse: bool) -> None:
    got = scan_bwd_model(*(torch.from_numpy(x) for x in args), reverse)
    pallas = selective_scan_pallas_bwd(*(jnp.asarray(x) for x in args), chunk=64, reverse=reverse, interpret=True)
    exact = float64_grads(*args, reverse)
    for name, tol, g, p, e in zip(NAMES, TOLS, got, pallas, exact):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(e.shape), name
        assert _rel(g, p) <= tol, (name, "pallas", _rel(g, p))
        assert _rel(g, e) <= tol, (name, "float64", _rel(g, e))


# (B, Din, N): N = 16 with two channel tiles of 16; N = 8 with one of 32.
# L = 1, 33 and 200 are ragged against the 32-step tiles.
@pytest.mark.parametrize("n", scan.KERNEL_STATES)
@pytest.mark.parametrize("seq_len", [1, 33, 200])
@pytest.mark.parametrize("reverse", [False, True])
def test_model_of_the_kernel_matches_pallas_interpret_and_float64(n, seq_len, reverse):
    _check(_inputs(2, seq_len, 32, n, seed=seq_len + n), reverse)


@pytest.mark.parametrize("n", scan.KERNEL_STATES)
@pytest.mark.parametrize("reverse", [False, True])
def test_model_holds_where_the_state_is_its_input_term(n, reverse):
    """delta A from -8 to -48: a = exp(delta A) is 3e-4 down to 1e-21, so
    h ~ dt u Bp and a h_prev ~ 0, where h - dt u Bp would cancel."""
    u, delta, A, Bp, Cp, D, dy = _inputs(2, 100, 32, n, seed=n)
    rng = np.random.default_rng(n + 1)
    delta = rng.uniform(2.0, 6.0, delta.shape).astype(np.float32)
    A = -rng.uniform(4.0, 8.0, A.shape).astype(np.float32)
    _check((u, delta, A, Bp, Cp, D, dy), reverse)


def _banks(addresses) -> int:
    return len({a % 32 for a in addresses})


@pytest.mark.parametrize("n", scan.KERNEL_STATES)
def test_buffer_swizzle_is_a_bijection_with_no_bank_conflicts(n):
    dt_ch = THREADS // n
    for s in range(CHUNK):
        assert sorted(swz(n, s, dl, k) for dl in range(dt_ch) for k in range(n)) == list(range(THREADS))
    for w in range(THREADS // 32):
        lanes = range(32 * w, 32 * w + 32)
        # The walk: one step, thread = channel * N + state.
        for s in range(CHUNK):
            assert _banks(s * THREADS + swz(n, s, t // n, t % n) for t in lanes) == 32
        for r in range(CHUNK * dt_ch // THREADS):
            ks = [r * THREADS + t for t in lanes]
            # Sums over states: (step, channel) = divmod(k, DT), one state at a time.
            for k in range(n):
                assert _banks((x // dt_ch) * THREADS + swz(n, x // dt_ch, x % dt_ch, k) for x in ks) == 32
        for r in range(CHUNK * n // THREADS):
            ks = [r * THREADS + t for t in lanes]
            # Sums over channels: (step, state) = divmod(k, N), one channel at a time.
            for dl in range(dt_ch):
                assert _banks((x // n) * THREADS + swz(n, x // n, dl, x % n) for x in ks) == 32
