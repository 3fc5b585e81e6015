"""A numpy model of how `csrc/mixer_bwd.cu` schedules the mixer backward,
held to float64, to the plain version and to the JAX op on the CPU.

The kernel runs only on the card, so its plan is checked here at small widths
in its own terms, each function named after the device function it mirrors:
`plan_for` (layout by N, rows a block G, threads, shared memory, row groups),
the rows kernel (G rows of a channel at a time, four halves a row), the
two-CTA cluster (CTA r holds half r of both signals) and its park at N = 65536
(w's half parked in global scratch, z's output and adjoint before dw's), the
joint pair pass over (k, M - k), the output pass that leaves the gate
cotangents in the slots it read, the short-conv adjoint at chunk, thread and
row edges, and the fixed order of the batch sums (dkhat slots folded in order,
the 12 short-conv sums per thread, a warp butterfly, warps in order, then
blocks in order). The transforms are `fft_radix.cuh`'s plan as
tests/test_torch_port_fft_plan.py models it.

Tolerance: the float32 model within 1e-5 of max|ref| of each output against
a float64 evaluation of the same math, against `mixer_bwd_reference` and
against the JAX op `mixer_bwd_pallas` in interpret mode at float32 DFT
precision (FFT rounding and summation order only).
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_fft_plan import fft_half, pad, quarter_table, values_per_thread

from deepchopper_tpu.ops.pallas_fft import mixer_bwd_pallas
from deepchopper_tpu_torch.data.bucketing import default_buckets
from deepchopper_tpu_torch.ops import mixer

REL_TOL = 1e-5
SMEM_LIMIT = 232448  # bytes a block may use on sm_90
PAIR_LOG2H, PARK_LOG2H = 12, 14  # N = 16384 and 65536
MIN_THREADS = 256
KSUMS = 12
SMS, SMEM_PER_SM, WAVES = 132, 233472, 2
F32 = np.float32
NAMES = ("dproj", "dk_short", "db_short", "dk_long", "dbias")


def padded(H: int) -> int:
    return H + H // 16


def quarter(H: int) -> int:
    return max(1, H // 4)


def plan_for(B: int, D: int, log2n: int) -> dict:
    """`plan_for`: the layout, V, rows a block at once (G), threads, CTAs a
    block, shared bytes a CTA and row groups (blocks a channel)."""
    log2h = log2n - 2
    H = 1 << log2h
    if log2h >= PAIR_LOG2H:
        kind = "park" if log2h >= PARK_LOG2H else "pair"
        V, G, ctas = 32, 1, 2
        threads = (2 if kind == "pair" else 1) * H // V  # the CTA's transforms, H / V threads each
        slots = 2 * (H // 2 + 1) if kind == "pair" else 0
        smem = ((2 if kind == "pair" else 1) * padded(H) + quarter(H) + slots) * 8
    else:
        kind, V, ctas = "rows", values_per_thread(H), 1
        nt = H // V
        G = 1 if 4 * nt >= MIN_THREADS else MIN_THREADS // (4 * nt)
        threads = G * 4 * nt
        S = max(H, threads)
        smem = (G * 4 * padded(H) + quarter(H) + 2 * S + S // H) * 8
    smem += threads // 32 * KSUMS * 4
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024), 2048 // threads))
    sets = -(-B // G)
    want = -(-(SMS * per_sm * WAVES) // (D * ctas))
    return {"kind": kind, "V": V, "G": G, "threads": threads, "ctas": ctas, "smem": smem,
            "groups": max(1, min(want, sets))}  # fmt: skip


class Gate:
    """Taps (k0, k1, k2) and bias of one gate channel, float32."""

    def __init__(self, taps: np.ndarray, bsh: np.ndarray, ch: int):
        self.k0, self.k1, self.k2 = (F32(taps[t, ch]) for t in range(3))
        self.b = F32(bsh[ch])

    def at(self, x: np.ndarray) -> np.ndarray:
        """`gate_at` over raw_chunk's x (n, P + 2) -> (n, P)."""
        return self.k0 * x[:, :-2] + self.k1 * x[:, 1:-1] + self.k2 * x[:, 2:] + self.b


def raw_chunk(row: np.ndarray, n0: np.ndarray, L: int, P: int) -> np.ndarray:
    """`raw_chunk`: x[c, i] = row[n0[c] - 2 + i], i < P + 2, zero outside
    [0, L) (the two values before a chunk are the lane before's; see
    test_lane_before_holds_the_chunk_before)."""
    idx = n0[:, None] - 2 + np.arange(P + 2)[None, :]
    return np.where((idx >= 0) & (idx < L), row[np.clip(idx, 0, L - 1)], F32(0)).astype(F32)


def load_chunk(row, n0, L, P):
    return raw_chunk(row, n0, L, P)[:, 2:]


def chunk_m(n0: np.ndarray, P: int, extra: int = 0) -> np.ndarray:
    return n0[:, None] // 2 + np.arange(P // 2 + extra)[None, :]


class Row:
    """`Rows`: the gate rows of batch row b, channel c, and its dproj rows."""

    def __init__(self, m: dict, b: int, c: int):
        D = m["D"]
        self.x2, self.x1, self.v = (m["proj"][b, j * D + c] for j in range(3))
        self.dy = m["dy"][b, c]
        self.out = [(b, j * D + c) for j in range(3)]


def fill_chunk(r: Row, n0, L, P, gs, tw, H, w0, w1, d0, d1) -> None:
    """`fill_chunk`: z[m] = s[2m] + i s[2m+1] of w = v x1 and dz = dy x2 into
    half 0 (z) and half 1 (z W_M^m) of each signal; None skips."""
    pos = n0[:, None] + np.arange(P)[None, :]
    m = chunk_m(n0, P)
    keep = m < H
    for h0, h1, sig in ((w0, w1, "w"), (d0, d1, "d")):
        if h0 is None and h1 is None:
            continue
        if sig == "w":
            s = gs[2].at(raw_chunk(r.v, n0, L, P)) * gs[1].at(raw_chunk(r.x1, n0, L, P))
        else:
            s = load_chunk(r.dy, n0, L, P) * gs[0].at(raw_chunk(r.x2, n0, L, P))
        s = np.where(pos < L, s, F32(0))
        z = (s[:, 0::2] + 1j * s[:, 1::2]).astype(np.complex64)
        if h0 is not None:
            h0[pad(m[keep])] = z[keep]
        if h1 is not None:
            h1[pad(m[keep])] = z[keep] * tw[2 * m[keep]]


def rfft_split(A, B, k, tw):
    W = tw[k]
    fe = 0.5 * (A + np.conj(B))
    wfo = W * (-0.5j * (A - np.conj(B)))
    return fe + wfo, np.conj(fe - wfo)


def rfft_merge(yk, ymk, k, tw):
    W = tw[k]
    P_, Q = yk + np.conj(ymk), yk - np.conj(ymk)
    return P_ + 1j * (np.conj(W) * Q), np.conj(P_) + 1j * (W * np.conj(Q))


def pair_bwd(wa, wb, da, db, k, M, kh, tw):
    """`pair_bwd`: the packed spectra of z (khat X_w) and dw (conj(khat)
    X_dz) at bins k, (M - k) mod M, and the dkhat terms of bins k and M - k."""
    xk, xmk = rfft_split(wa, wb, k, tw)
    dk, dmk = rfft_split(da, db, k, tw)
    hk, hmk = kh[k], kh[M - k]
    za, zb = rfft_merge(xk * hk, xmk * hmk, k, tw)
    ea, eb = rfft_merge(dk * np.conj(hk), dmk * np.conj(hmk), k, tw)
    return za, zb, ea, eb, np.conj(xk) * dk, np.conj(xmk) * dmk


def out_chunk(r: Row, n0, L, P, gs, tw, H, ez, oz, ed, od, dst2, dst1, dstv):
    """`out_chunk`: dx2 = dy z, dx1 = dw v, dv = dw x1 from the inverse halves
    (E + conj(W_M^m) O), left in the slots (dst2, dst1, dstv); returns each
    gate's (cotangent, raw) per chunk for the sums, None where skipped."""
    m = chunk_m(n0, P)
    inL = 2 * m < L
    mc = np.clip(m, 0, H - 1)
    twc = np.where(m < H, np.conj(tw[2 * mc]), 0).astype(np.complex64)
    pos = n0[:, None] + np.arange(P)[None, :]

    def inverse(e, o):
        s = np.where(inL, e[pad(mc)] + o[pad(mc)] * twc, 0).astype(np.complex64)
        return np.where(pos < L, np.stack([s.real, s.imag], -1).reshape(len(n0), P), F32(0)).astype(F32)

    def put_pairs(dst, dg):
        keep = m < H
        dst[pad(m[keep])] = (dg[:, 0::2] + 1j * dg[:, 1::2]).astype(np.complex64)[keep]

    got = [None, None, None]
    if ez is not None:
        x = raw_chunk(r.x2, n0, L, P)
        dx2 = load_chunk(r.dy, n0, L, P) * inverse(ez, oz)
        put_pairs(dst2, dx2)
        got[0] = (dx2, x)
    if ed is not None:
        a, b = raw_chunk(r.x1, n0, L, P), raw_chunk(r.v, n0, L, P)
        dw = inverse(ed, od)
        dx1, dv = dw * gs[2].at(b), dw * gs[1].at(a)
        put_pairs(dst1, dx1)
        put_pairs(dstv, dv)
        got[1], got[2] = (dx1, a), (dv, b)
    return got


def adjoint_chunk(slots, n0, L, P, g: Gate) -> np.ndarray:
    """`adjoint_chunk`: y[i] = k2 dg[n0+i] + k1 dg[n0+i+1] + k0 dg[n0+i+2],
    dg from the chunk's P/2 slots and the one after, zero at n >= L."""
    m = chunk_m(n0, P, 1)
    v = np.where(2 * m < L, slots[pad(np.clip(m, 0, (L - 1) // 2))], 0)
    d = np.stack([v.real, np.where(2 * m + 1 < L, v.imag, 0)], -1).reshape(len(n0), P + 2).astype(F32)
    return g.k2 * d[:, :P] + g.k1 * d[:, 1 : P + 1] + g.k0 * d[:, 2:]


def store_chunks(m: dict, r: Row, j: int, n0, L, P, y) -> None:
    pos = n0[:, None] + np.arange(P)[None, :]
    keep = pos < L
    m["dproj"][r.out[j]][pos[keep]] = y[keep]


def add_sums(sums: np.ndarray, threads: np.ndarray, got) -> None:
    """`add_sums`, item by item as each owning thread adds: sums[t, 4 j + u]."""
    for j, pair in enumerate(got):
        if pair is None:
            continue
        dg, x = pair
        for i in range(dg.shape[1]):
            for u in range(3):
                sums[threads, 4 * j + u] += dg[:, i] * x[:, i + u]
            sums[threads, 4 * j + 3] += dg[:, i]


def block_sums(sums: np.ndarray) -> np.ndarray:
    """`block_sums`: a warp butterfly (lane ^ 16, 8, 4, 2, 1), then lane 0 of
    each warp added in warp order."""
    v = sums.reshape(-1, 32, KSUMS).astype(F32)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    out = np.zeros(KSUMS, F32)
    for w in range(v.shape[0]):
        out = out + v[w, 0]
    return out


def rows_items(G: int, log2q: int, threads: int):
    """The rows kernel's chunk loop: per round, items i = i0 + t for each
    thread t (row i >> log2q, chunk i mod 2^log2q)."""
    items = G << log2q
    for i0 in range(0, items, threads):
        i = i0 + np.arange(min(threads, items - i0))
        yield i, i >> log2q, i & ((1 << log2q) - 1), i - i0


def mixer_bwd_rows(m: dict, grp: int, c: int) -> tuple[np.ndarray, np.ndarray]:
    """Block (grp, c) of the rows kernel: its dkhat partial row and its 12 sums."""
    p, H, M, L, P = m["plan"], m["H"], m["M"], m["L"], m["P"]
    G, T = p["G"], p["threads"]
    S = max(H, T)
    log2h = H.bit_length() - 1
    log2q = max(0, log2h + 1 - (P.bit_length() - 1))
    acc_a, acc_b = np.zeros(S, np.complex64), np.zeros(S, np.complex64)
    acc_h = np.zeros(S // H, np.complex64)
    sums = np.zeros((T, KSUMS), F32)
    gs, tw, kh = m["gates"][c], m["tw"], m["khat"][c]
    B = m["B"]
    for s in range(grp, -(-B // G), p["groups"]):
        b0 = s * G
        buf = np.zeros((G, 4, padded(H)), np.complex64)  # [w 0 | w 1 | dz 0 | dz 1] a row
        for _i, g, q, _t in rows_items(G, log2q, T):
            for gg in np.unique(g[b0 + g < B]):
                sel = g == gg
                fill_chunk(Row(m, b0 + gg, c), q[sel] * P, L, P, gs, tw, H, *buf[gg])
        active = [g for g in range(G) if b0 + g < B]
        for g in active:
            for h in range(4):
                buf[g, h] = fft_half(buf[g, h], H, False, m["table"])
        # Pair pass: item i = g H + k (k < H; k = 0 also bin H) into slot i mod S.
        k = np.arange(H)
        k2 = (M - k) & (M - 1)
        for g in active:
            w, d = buf[g, 0:2], buf[g, 2:4]
            ia, ib = (k & 1, pad(k >> 1)), (k2 & 1, pad(k2 >> 1))
            wa, wb, da, db = w[ia], w[ib], d[ia], d[ib]
            za, zb, ea, eb, ta, tb = pair_bwd(wa, wb, da, db, k, M, kh, tw)
            two = (k != 0) & (k2 != k)
            w[ia], d[ia] = za, ea
            w[k2[two] & 1, pad(k2[two] >> 1)], d[k2[two] & 1, pad(k2[two] >> 1)] = zb[two], eb[two]
            hb = np.array([H])
            a_h, _, e_h, _, t_h, _ = pair_bwd(w[0, pad(hb >> 1)], w[0, pad(hb >> 1)], d[0, pad(hb >> 1)],
                                              d[0, pad(hb >> 1)], hb, M, kh, tw)  # fmt: skip
            w[0, pad(H >> 1)], d[0, pad(H >> 1)] = a_h[0], e_h[0]
            slot = (g * H + k) & (S - 1)
            acc_a[slot] += ta
            acc_b[slot[k != M - k]] += tb[k != M - k]
            acc_h[slot[0] >> log2h] += t_h[0]
        for g in active:
            for h in range(4):
                buf[g, h] = fft_half(buf[g, h], H, True, m["table"])
        for _i, g, q, t in rows_items(G, log2q, T):
            for gg in np.unique(g[b0 + g < B]):
                sel = g == gg
                row = buf[gg]
                got = out_chunk(Row(m, b0 + gg, c), q[sel] * P, L, P, gs, tw, H, *row, row[0], row[1], row[2])
                add_sums(sums, t[sel], got)
        for g in active:
            r = Row(m, b0 + g, c)
            n0 = np.arange(0, L, P)
            for j in range(3):
                store_chunks(m, r, j, n0, L, P, adjoint_chunk(buf[g, j], n0, L, P, gs[j]))
    part = np.zeros(M + 1, np.complex64)
    for kk in range(M + 1):
        v = np.complex64(0)
        if kk == H:
            for j in range(S // H):
                v = v + acc_h[j]
        elif kk < H:
            for j in range(kk, S, H):
                v = v + acc_a[j]
        else:
            for j in range(0 if kk == M else M - kk, S, H):
                v = v + acc_b[j]
        part[kk] = v
    return part, block_sums(sums)


def mixer_bwd_pair(m: dict, grp: int, c: int, park: bool, threads: int) -> tuple[np.ndarray, np.ndarray]:
    """Cluster (grp, c): CTA r holds half r; pair keeps both signals' halves in
    shared memory, park parks w's. Returns its partial row and (2, 12) sums."""
    H, M, L, P = m["H"], m["M"], m["L"], m["P"]
    gs, tw, kh = m["gates"][c], m["tw"], m["khat"][c]
    part = np.zeros(M + 1, np.complex64)
    items = [np.arange(H // 2 + 1 - r) for r in (0, 1)]
    acc = [[np.zeros(len(j), np.complex64) for _ in range(2)] for j in items]
    sums = np.zeros((2, threads, KSUMS), F32)
    Q, Qo = -(-2 * H // P), -(-L // P)
    Qh = (Qo + 1) // 2
    for b in range(grp, m["B"], m["plan"]["groups"]):
        r_ = Row(m, b, c)
        sw = np.zeros((2, padded(H)), np.complex64)  # CTA r's w half (park: its one half)
        sd = np.zeros((2, padded(H)), np.complex64)
        parked = np.zeros((2, H), np.complex64)
        n0 = np.arange(Q) * P
        for r in (0, 1):
            h = (None, sw[r]) if r else (sw[r], None)
            if park:
                fill_chunk(r_, n0, L, P, gs, tw, H, *h, None, None)
                parked[r] = fft_half(sw[r], H, False, m["table"])[pad(np.arange(H))]
                fill_chunk(r_, n0, L, P, gs, tw, H, None, None, *((None, sd[r]) if r else (sd[r], None)))
                sd[r] = fft_half(sd[r], H, False, m["table"])
            else:
                fill_chunk(r_, n0, L, P, gs, tw, H, *h, *((None, sd[r]) if r else (sd[r], None)))
                sw[r], sd[r] = fft_half(sw[r], H, False, m["table"]), fft_half(sd[r], H, False, m["table"])
        for r in (0, 1):
            k = 2 * items[r] + r
            k2 = (M - k) & (M - 1)
            ia, ib = k >> 1, k2 >> 1
            wsrc = parked[r] if park else sw[r]
            wi = (ia, ib) if park else (pad(ia), pad(ib))
            za, zb, ea, eb, ta, tb = pair_bwd(wsrc[wi[0]], wsrc[wi[1]], sd[r][pad(ia)], sd[r][pad(ib)], k, M, kh, tw)
            two = (k != 0) & (k2 != k)
            zdst, edst = (sd[r], parked[r]) if park else (sw[r], sd[r])  # park: z into shared memory, dw into the park
            zi = (pad(ia), pad(ib)) if park else wi
            ei = (ia, ib) if park else (pad(ia), pad(ib))
            zdst[zi[0]], edst[ei[0]] = za, ea
            zdst[zi[1][two]], edst[ei[1][two]] = zb[two], eb[two]
            if park:
                first = b == grp
                part[k] = ta if first else part[k] + ta
                mk = k != M - k
                part[M - k[mk]] = tb[mk] if first else part[M - k[mk]] + tb[mk]
            else:
                acc[r][0] += ta
                acc[r][1][k != M - k] += tb[k != M - k]
        phases = (("z",), ("w",)) if park else (("z", "w"),)
        for phase in phases:
            if park:
                src = sd if phase == ("z",) else np.stack([np.zeros(padded(H), np.complex64)] * 2)
                if phase == ("w",):
                    src[:, pad(np.arange(H))] = parked
                cur = np.stack([fft_half(src[r], H, True, m["table"]) for r in (0, 1)])
                ez, oz, ed, od = (cur[0], cur[1], None, None) if phase == ("z",) else (None, None, cur[0], cur[1])
                dst = (cur[0], None, None) if phase == ("z",) else (None, cur[0], cur[1])
            else:
                zs = np.stack([fft_half(sw[r], H, True, m["table"]) for r in (0, 1)])
                ds = np.stack([fft_half(sd[r], H, True, m["table"]) for r in (0, 1)])
                ez, oz, ed, od = zs[0], zs[1], ds[0], ds[1]
                dst = (zs[0], zs[1], ds[0])
            for r in (0, 1):  # CTA r: output chunks [r Qh, min(Qo, (r + 1) Qh))
                q = np.arange(r * Qh, min(Qo, (r + 1) * Qh))
                t = (q - r * Qh) % threads
                for t0 in range(0, len(q), threads):
                    sel = slice(t0, t0 + threads)
                    got = out_chunk(r_, q[sel] * P, L, P, gs, tw, H, ez, oz, ed, od, *dst)
                    add_sums(sums[r], t[sel], got)
            n0 = np.arange(Qo) * P
            for j in range(3):
                if dst[j] is not None:
                    store_chunks(m, r_, j, n0, L, P, adjoint_chunk(dst[j], n0, L, P, gs[j]))
    if not park:
        for r in (0, 1):
            k = 2 * items[r] + r
            part[k] = acc[r][0]
            mk = k != M - k
            part[M - k[mk]] = acc[r][1][mk]
    return part, np.stack([block_sums(sums[r]) for r in (0, 1)])


def mixer_bwd_reduce(part: np.ndarray, sums: np.ndarray, ctas: int) -> tuple[np.ndarray, np.ndarray]:
    """`mixer_bwd_reduce`: partials over the blocks in order; dsh[t, gi D + c]
    over the blocks, then their CTAs, in order."""
    groups, D = part.shape[:2]
    dkhat = np.zeros(part.shape[1:], np.complex64)
    dsh = np.zeros((4, 3 * D), F32)
    for g in range(groups):
        dkhat = dkhat + part[g]
        for r in range(ctas):
            for gi in range(3):
                dsh[:, gi * D : (gi + 1) * D] += sums[g, :, r, 4 * gi : 4 * gi + 4].T
    return dkhat, dsh


def model_bwd(proj, dy, k_short, b_short, k_long, bias, layout: str | None = None, threads: int = 64):
    """The kernel's schedule in float32: (dproj, dk_short, db_short, dk_long,
    dbias, dkhat). `layout` forces the cluster layouts at a small N (with
    `threads` a CTA); by default the layout is `plan_for`'s."""
    B, W3, L = proj.shape
    D = W3 // 3
    n = mixer.fft_size(L)
    H = n // 4
    plan = plan_for(B, D, n.bit_length() - 1)
    if layout is not None and layout != plan["kind"]:
        plan = {**plan, "kind": layout, "G": 1, "threads": threads, "ctas": 2, "groups": min(plan["groups"], B)}
    P = 8 if proj.dtype == torch.bfloat16 else 4
    taps = k_short.float().reshape(3, W3).numpy()
    bsh = b_short.float().numpy()
    tw = mixer._twiddles(n, torch.device("cpu")).numpy()
    m = {"plan": plan, "B": B, "D": D, "L": L, "H": H, "M": 2 * H, "P": P, "tw": tw,
         "table": quarter_table(tw, H), "proj": proj.float().numpy(), "dy": dy.float().numpy(),
         "khat": mixer.filter_spectrum(k_long, bias, n).numpy(), "dproj": np.zeros((B, W3, L), F32),
         "gates": [[Gate(taps, bsh, j * D + c) for j in range(3)] for c in range(D)]}  # fmt: skip
    ctas = plan["ctas"]
    part = np.zeros((plan["groups"], D, 2 * H + 1), np.complex64)
    sums = np.zeros((plan["groups"], D, 2, KSUMS), F32)
    for c in range(D):
        for grp in range(plan["groups"]):
            if plan["kind"] == "rows":
                part[grp, c], sums[grp, c, 0] = mixer_bwd_rows(m, grp, c)
            else:
                part[grp, c], sums[grp, c] = mixer_bwd_pair(m, grp, c, plan["kind"] == "park", plan["threads"])
    dkhat, dsh = mixer_bwd_reduce(part, sums, ctas)
    dk_long, dbias = mixer._filter_vjp(torch.from_numpy(dkhat.copy()), k_long, bias, n)
    return (torch.from_numpy(m["dproj"]), torch.from_numpy(dsh[:3].reshape(3, 1, W3)), torch.from_numpy(dsh[3]),
            dk_long, dbias, dkhat)  # fmt: skip


def float64_bwd(proj, dy, k_short, b_short, k_long, bias):
    """The same math in float64 at the kernel's N: (dproj, dk_short, db_short, dkhat)."""
    B, W3, L = proj.shape
    D = W3 // 3
    n = mixer.fft_size(L)
    p = proj.double().numpy()
    ks = k_short.double().numpy()[:, 0, :]
    xp = np.pad(p, ((0, 0), (0, 0), (2, 0)))
    g = ks[0][:, None] * xp[..., :L] + ks[1][:, None] * xp[..., 1 : L + 1] + ks[2][:, None] * xp[..., 2:] + \
        b_short.double().numpy()[:, None]  # fmt: skip
    x2, x1, v = g[:, :D], g[:, D : 2 * D], g[:, 2 * D :]
    kt = k_long.double().numpy().T.copy()
    kt[:, 0] += bias.double().numpy()
    khat = np.fft.rfft(kt, n=n, axis=-1) / n
    d = dy.double().numpy()
    wf = np.fft.rfft(v * x1, n=n, axis=-1)
    zf = np.fft.rfft(d * x2, n=n, axis=-1)
    z = np.fft.irfft(wf * khat, n=n, axis=-1)[..., :L] * n
    dw = np.fft.irfft(zf * np.conj(khat), n=n, axis=-1)[..., :L] * n
    dg = np.concatenate([d * z, dw * v, dw * x1], axis=1)
    dp = np.pad(dg, ((0, 0), (0, 0), (0, 2)))
    dproj = ks[2][:, None] * dp[..., :L] + ks[1][:, None] * dp[..., 1 : L + 1] + ks[0][:, None] * dp[..., 2:]
    dks = np.stack([(dg * xp[..., t : t + L]).sum(axis=(0, 2)) for t in range(3)])[:, None, :]
    return dproj, dks, dg.sum(axis=(0, 2)), (np.conj(wf) * zf).sum(axis=0)


def _inputs(batch: int, d_model: int, seq_len: int, seed: int):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    decay = np.exp(-np.arange(seq_len) / 40.0)[:, None]
    return (f32(rng.standard_normal((batch, 3 * d_model, seq_len))),
            f32(rng.standard_normal((batch, d_model, seq_len))),
            f32(rng.standard_normal((3, 1, 3 * d_model))), f32(rng.standard_normal(3 * d_model)),
            f32(rng.standard_normal((seq_len, d_model)) * decay), f32(rng.standard_normal(d_model)))  # fmt: skip


def _assert_close(got, want, name: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    got = got.astype(np.complex128 if np.iscomplexobj(got) else np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= REL_TOL * scale, f"{name}: err {err:.3e} > {REL_TOL} * {scale:.3e}"


# (layout, B, D, L): the rows kernel with G = 16 (L = 7: N = 16), 8, 2 and 1
# rows a block, B = 13 leaving the last set part empty, L odd and not whole
# chunks; the two cluster layouts at a small N (32 threads a CTA, so chunk
# ranges span several rounds and warps).
CASES = [
    ("rows", 3, 2, 7), ("rows", 13, 2, 100), ("rows", 3, 4, 256), ("rows", 2, 2, 1000), ("rows", 1, 2, 1280),
    ("pair", 3, 2, 100), ("pair", 2, 2, 256), ("pair", 1, 2, 301),
    ("park", 3, 2, 100), ("park", 2, 2, 256), ("park", 1, 2, 301),
]  # fmt: skip


@pytest.mark.parametrize("layout,batch,d_model,seq_len", CASES)
def test_model_matches_float64_and_the_plain_version(layout, batch, d_model, seq_len):
    args = _inputs(batch, d_model, seq_len, seed=seq_len + batch)
    got = model_bwd(*args, layout=layout, threads=32)
    want64 = float64_bwd(*args)
    for name, g, w in zip(("dproj", "dk_short", "db_short", "dkhat"), (*got[:3], got[5]), want64):
        _assert_close(g, w, f"{name} vs float64")
    for name, g, r in zip(NAMES, got[:5], mixer.mixer_bwd_reference(*args)):
        assert g.shape == r.shape, name
        _assert_close(g.numpy(), r.numpy(), f"{name} vs plain")


@pytest.mark.parametrize("layout,batch,d_model,seq_len", [CASES[2], CASES[6], CASES[9]])
def test_model_matches_jax_pallas_interpret(layout, batch, d_model, seq_len):
    args = _inputs(batch, d_model, seq_len, seed=seq_len + 3)
    ref = mixer_bwd_pallas(*(jnp.asarray(a.numpy()) for a in args), precision="float32", interpret=True)
    got = model_bwd(*args, layout=layout, threads=32)
    for name, g, r in zip(NAMES, got[:5], ref):
        _assert_close(g.numpy(), np.asarray(r), f"{name} vs JAX")


@pytest.mark.parametrize("seq_len", [*default_buckets(32768), 1000, 1001])
def test_plan_fits_the_card_at_the_ladder_widths(seq_len):
    """Layout by N as the kernel's header states; at least 256 and at most
    512 threads; shared memory within a block's limit; every block has rows."""
    n = mixer.fft_size(seq_len)
    for batch, d_model in ((min(512, (1 << 17) // seq_len), 256), (1, 8), (3, 8)):
        p = plan_for(batch, d_model, n.bit_length() - 1)
        assert p["kind"] == ("rows" if n <= 8192 else "pair" if n <= 32768 else "park")
        assert MIN_THREADS <= p["threads"] <= 512 and p["threads"] % 32 == 0
        assert p["smem"] <= SMEM_LIMIT, p
        assert 1 <= p["groups"] <= -(-batch // p["G"])
        if p["kind"] == "rows":
            H = n // 4
            assert p["threads"] == p["G"] * 4 * H // p["V"]
            assert p["G"] == 1 or 4 * H // p["V"] < MIN_THREADS
        else:
            assert n // 4 // 32 * (2 if p["kind"] == "pair" else 1) == p["threads"]  # V = 32 transforms


@pytest.mark.parametrize("log2h", range(1, 13))
def test_dkhat_slots_have_one_owner_and_cover_each_bin(log2h):
    """Rows kernel: pair item i (row i >> log2h, bin i mod H) runs on thread
    i mod T and adds into slot i mod S, S = max(H, T): each slot is one
    thread's, and bin k's slots are k, k + H, ... (k = 0 also bin H)."""
    H = 1 << log2h
    p = plan_for(1, 8, log2h + 2)
    G, T = p["G"], p["threads"]
    S = max(H, T)
    i = np.arange(G * H)
    owner = {}
    for slot, thread in zip(i & (S - 1), i % T):
        assert owner.setdefault(slot, thread) == thread
    assert sorted(set((i & (S - 1)) % H)) == list(range(H))
    # Cluster: item j (bin 2j + r) on thread j mod 512; every bin 0..M once.
    M = 2 * H
    bins = []
    for r in (0, 1):
        k = 2 * np.arange(H // 2 + 1 - r) + r
        bins += list(k) + list(M - k[k != M - k])
    assert sorted(bins) == list(range(M + 1))


@pytest.mark.parametrize("log2h", [1, 2, 5, 8, 10, 12])
@pytest.mark.parametrize("P", [4, 8])
def test_lane_before_holds_the_chunk_before(log2h, P):
    """`raw_chunk` takes the two positions before a chunk from the lane
    before: in the rows kernel's loop and in each CTA's range of the cluster,
    the lane before a lane that is not a warp's first and whose chunk is not
    its row's first holds the chunk before, of the same row."""
    H = 1 << log2h
    p = plan_for(1, 8, log2h + 2)
    log2q = max(0, log2h + 1 - (P.bit_length() - 1))
    for i, g, q, t in rows_items(p["G"], log2q, p["threads"]):
        inner = (t % 32 != 0) & (q != 0)
        assert np.all(g[inner] == g[np.flatnonzero(inner) - 1]) and np.all(q[inner] - 1 == q[np.flatnonzero(inner) - 1])
    Qo = -(-2 * H // P)
    Qh = (Qo + 1) // 2
    for r, threads in itertools.product((0, 1), (256, 512)):
        q = np.arange(r * Qh, min(Qo, (r + 1) * Qh))
        t = (q - r * Qh) % threads
        inner = t % 32 != 0
        assert np.all(q[inner] - 1 == q[np.flatnonzero(inner) - 1])


@pytest.mark.parametrize("seq_len", [1, 2, 7, 8, 9, 63, 64, 100])
@pytest.mark.parametrize("P", [4, 8])
def test_adjoint_at_chunk_and_row_edges(seq_len, P):
    """`adjoint_chunk` over a row's slots, chunk by chunk (each reads the slot
    after its own: across chunk, thread and warp edges), is the short-conv
    adjoint with dg zero at s >= L."""
    rng = np.random.default_rng(seq_len)
    H = max(2, mixer.fft_size(seq_len) // 4)
    dg = rng.standard_normal(2 * H).astype(F32)
    dg[seq_len:] = rng.standard_normal(2 * H - seq_len)  # slots beyond L hold stale values
    slots = np.zeros(padded(H), np.complex64)
    slots[pad(np.arange(H))] = dg[0::2] + 1j * dg[1::2]
    g = Gate(rng.standard_normal((3, 1)).astype(F32), rng.standard_normal(1).astype(F32), 0)
    n0 = np.arange(0, seq_len, P)
    y = adjoint_chunk(slots, n0, seq_len, P, g).reshape(-1)[:seq_len]
    d = np.concatenate([dg[:seq_len], np.zeros(2, F32)]).astype(np.float64)
    want = g.k2 * d[:seq_len] + g.k1 * d[1 : seq_len + 1] + g.k0 * d[2:]
    assert np.abs(y - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


def test_batch_sums_are_the_blocks_in_order():
    """The dkhat partials and the short-conv sums of several blocks of a
    channel, reduced in block order, are what the reduce kernel writes, and
    the model is bitwise the same on a second run (no order depends on
    timing)."""
    assert plan_for(13, 2, 9)["G"] == 8 and plan_for(13, 2, 9)["groups"] == 2  # two blocks a channel
    args = _inputs(13, 2, 256, seed=5)
    a = model_bwd(*args)
    b = model_bwd(*args)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("seq_len", [1, 7, 300, 1024])
def test_filter_vjp_in_closed_form_is_autograd_of_the_spectrum(seq_len):
    """`_filter_vjp`, irfft of dkhat, against autograd of `filter_spectrum`
    with the doubled half-spectrum cotangent (`_grads_from_cotangents`)."""
    rng = np.random.default_rng(seq_len)
    n = mixer.fft_size(seq_len)
    k_long = torch.from_numpy(rng.standard_normal((seq_len, 3)).astype(F32))
    bias = torch.from_numpy(rng.standard_normal(3).astype(F32))
    dkhat = torch.from_numpy((rng.standard_normal((3, n // 2 + 1)) + 1j * rng.standard_normal((3, n // 2 + 1)))
                             .astype(np.complex64))  # fmt: skip
    g = dkhat.clone()
    g[:, 1 : n // 2] *= 2
    with torch.enable_grad():
        kl, b = k_long.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        want = torch.autograd.grad(mixer.filter_spectrum(kl, b, n), (kl, b), g)
    for got, w in zip(mixer._filter_vjp(dkhat, k_long, bias, n), want):
        assert got.shape == w.shape and got.dtype == w.dtype
        _assert_close(got.numpy(), w.numpy(), "filter vjp")
