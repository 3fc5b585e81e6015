"""A numpy model of how `csrc/mixer_inproj_fwd.cu` schedules the in_proj-fused
mixer, held to the plain version and to the JAX op on the CPU.

The kernel runs only on the card, so its plan is checked here at small widths
in its own terms. Phase 1: channel groups of CG (16, or 8 from N = 32768 on),
K = D padded with zeros to 16, position tiles of TP (64 in bfloat16, 32 in
float32) whose product is the tensor cores' (bf16 products summed in float32;
float32 operands split into three bf16 terms, six products kept, the five
small ones in their own sum), a (3CG x (2 + TP)) window whose first two
columns, the tile before's last two positions from one of two carry arrays,
run the short conv across tile edges, and z (w pairs) and the x2 gate stored
to scratch rows; from N = 32768 on the two-CTA schedule (each CTA half of the
tiles, the second from one tile early). Phase 2 hands each scratch row to
`fft_radix.cuh`'s plan, modelled in tests/test_torch_port_fft_plan.py: two
halves, the pair pass, the inverse halves and the last stage times the x2
gate. The ldmatrix addresses of the bf16 path are checked to give the mma
fragments. Each function mirrors the device function of the same name.

Tolerance: the float32 model within 1e-5 of max|ref| of `inproj_reference`
and of the JAX op `mixer_fft_conv_inproj` in interpret mode at float32 DFT
precision (GEMM and FFT rounding only); the bfloat16 schedule within 1e-5 of
the plain mixer of the float32 projection of the bf16-rounded x and w.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_fft_plan import fft_half, pad, pair_pass, quarter_table, values_per_thread

from deepchopper_tpu.ops.pallas_fft import mixer_fft_conv_inproj as jax_inproj
from deepchopper_tpu_torch.data.bucketing import default_buckets
from deepchopper_tpu_torch.ops import inproj, mixer

REL_TOL = 1e-5
SMEM_LIMIT = 232448  # bytes a block may use on sm_90
PAIR_LOG2N = 15  # N from which a cluster of two CTAs takes a group


def group_size(log2n: int) -> int:
    return 8 if log2n >= 15 else 16


def tile_positions(bf16: bool) -> int:
    return 64 if bf16 else 32


def round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def tile_bytes(bf16: bool, cg: int, kp: int) -> int:
    """`Tile::bytes`: two x tiles and the weight rows (rows padded by 16
    bytes), the window, b_in, the gates and two carries."""
    size = 2 if bf16 else 4
    tp = tile_positions(bf16)
    e = 16 // size
    r = 3 * cg
    return size * (2 * kp * (tp + e) + r * (kp + e)) + 4 * (r * (tp + 4) + 9 * r)


def fft_bytes(log2n: int, cg: int) -> tuple[int, int]:
    """(phase 2's shared bytes, threads) of `launch_rows` / `launch_pair`."""
    H = 1 << (log2n - 2)
    padded, quarter = H + H // 16, max(1, H // 4)
    if log2n >= PAIR_LOG2N:
        return (padded + quarter) * 8, H // 32
    nt = H // values_per_thread(H)
    G = min(cg, 256 // (2 * nt))
    return (G * 2 * padded + quarter) * 8, 256


def to_bf16(a: np.ndarray) -> np.ndarray:
    """Round float32 to bfloat16 (nearest, ties to even), kept in float32."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def split_pair(v: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """v = hi + mid + lo in bf16 terms (each difference exact in float32)."""
    hi = to_bf16(v)
    r = (v - hi).astype(np.float32)
    mid = to_bf16(r)
    return hi, mid, to_bf16((r - mid).astype(np.float32))


def tile_product(xt: np.ndarray, wg: np.ndarray, bf16: bool) -> np.ndarray:
    """(TP, R) product of the x tile (kp, TP) and the weight rows (R, kp), as
    the tensor cores form it: bf16 products summed in float32."""
    a, b = xt.T.astype(np.float32), wg.T.astype(np.float32)
    if bf16:
        return a @ b
    ah, am, al = split_pair(a)
    bh, bm, bl = split_pair(b)
    small = al @ bh + am @ bm + ah @ bl + am @ bh + ah @ bm
    return ah @ bh + small


def project(x, w, b_in, taps, bsh, b, c0, cg, t_write, t_end, scratch, bf16):
    """Phase 1 for batch row b, channels c0 .. c0 + cg - 1 (numpy, float32):
    tiles [t_write, t_end), from one tile early when t_write > 0 for the
    carry. scratch[j] = (z pairs as L floats, the x2 gate)."""
    _, D, L = x.shape
    kp = round_up(D, 16)
    tp = tile_positions(bf16)
    R = 3 * cg
    rows = [(r // cg) * D + c0 + r % cg for r in range(R)]
    on = np.array([c0 + r % cg < D for r in range(R)])
    wg = np.zeros((R, kp), np.float32)
    wg[on, :D] = w[[ch for ch, o in zip(rows, on) if o]]
    ch = np.where(on, rows, 0)
    bin_, k0, k1, k2, kb = (np.where(on, v[ch], 0).astype(np.float32) for v in (b_in, taps[0], taps[1], taps[2], bsh))
    carry = np.zeros((2, R, 2), np.float32)  # the two positions before tile t, at t & 1; p[-2] = p[-1] = 0
    win = np.zeros((R, 2 + tp), np.float32)
    for t in range(t_write - 1 if t_write > 0 else 0, t_end):
        p0 = t * tp
        xt = np.zeros((kp, tp), np.float32)
        xt[:D, : min(tp, L - p0)] = x[b, :, p0 : p0 + tp]
        win[:, :2] = carry[t & 1]
        win[:, 2:] = (tile_product(xt, wg, bf16) + bin_).T
        carry[(t + 1) & 1] = win[:, tp:]
        if t >= t_write:
            gates = (k0[:, None] * win[:, :tp] + k1[:, None] * win[:, 1 : tp + 1] + k2[:, None] * win[:, 2:]
                     + kb[:, None])  # fmt: skip
            n = p0 + np.arange(tp)
            keep = n < L
            for j in range(min(cg, D - c0)):
                x2g, x1g, vg = gates[j], gates[cg + j], gates[2 * cg + j]
                scratch[j, 0, n[keep]] = (vg * x1g)[keep]
                scratch[j, 1, n[keep]] = x2g[keep]


def long_conv(zrow, g2row, kh, tw, L: int, log2n: int) -> np.ndarray:
    """Phase 2 for one channel: the scratch row's z into `fft_radix.cuh`'s
    two halves, the pair pass, the inverse halves, the last stage times the
    x2 gate. The two-CTA schedule runs the same arithmetic, one half a CTA."""
    H = 1 << (log2n - 2)
    M = 2 * H
    table = quarter_table(tw, H)
    w = np.zeros(2 * H, np.float32)
    w[:L] = zrow
    z = (w[0::2] + 1j * w[1::2]).astype(np.complex64)
    halves = []
    for h in (0, 1):
        x = np.zeros(pad(H - 1) + 1, np.complex64)
        x[pad(np.arange(H))] = z * tw[2 * np.arange(H)] if h else z
        halves.append(fft_half(x, H, False, table))
    k = np.arange(M // 2 + 1)
    k2 = (M - k) & (M - 1)
    spec = np.stack(halves)
    A, B = spec[k & 1, pad(k >> 1)], spec[k2 & 1, pad(k2 >> 1)]
    za, zb = pair_pass(A, B, k, M, kh, tw)
    spec[k & 1, pad(k >> 1)] = za
    own = (k != 0) & (k2 != k)
    spec[k2[own] & 1, pad(k2[own] >> 1)] = zb[own]
    e, o = (fft_half(spec[h], H, True, table) for h in (0, 1))
    m = np.arange((L + 1) // 2)
    zz = e[pad(m)] + o[pad(m)] * np.conj(tw[2 * m])
    return np.stack([zz.real, zz.imag], axis=1).reshape(-1)[:L] * g2row


def model_inproj(x, w, b_in, k_short, b_short, k_long, bias, bf16=False, pair=None) -> np.ndarray:
    """The kernel's schedule over the whole call, float32 out. `pair` forces
    (True) or forbids (False) the two-CTA schedule; by default it is the
    kernel's (from N = 32768 on)."""
    batch, D, L = x.shape
    n = mixer.fft_size(L)
    log2n = n.bit_length() - 1
    cg = group_size(log2n)
    tp = tile_positions(bf16)
    tiles = -(-L // tp)
    pair = log2n >= PAIR_LOG2N if pair is None else pair
    x, w = x.numpy(), w.numpy()
    if bf16:
        x, w = to_bf16(x), to_bf16(w)
    taps = k_short[:, 0, :].numpy()
    khat = mixer.filter_spectrum(k_long, bias, n).numpy()
    tw = mixer._twiddles(n, torch.device("cpu")).numpy()
    out = np.zeros((batch, D, L), np.float32)
    for b in range(batch):
        for c0 in range(0, D, cg):
            scratch = np.full((cg, 2, L), np.nan, np.float32)
            args = (x, w, b_in.numpy(), taps, b_short.numpy(), b, c0, cg)
            if pair:
                half = (tiles + 1) // 2
                for rank in (0, 1):
                    project(*args, half if rank else 0, tiles if rank else half, scratch, bf16)
            else:
                project(*args, 0, tiles, scratch, bf16)
            for j in range(min(cg, D - c0)):
                out[b, c0 + j] = long_conv(scratch[j, 0], scratch[j, 1], khat[c0 + j], tw, L, log2n)
    return out


def _inputs(batch: int, d_model: int, seq_len: int, seed: int):
    """x, w (nn.Linear layout (3D, D)), b_in, k_short, b_short, k_long, bias."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (
        f32(rng.standard_normal((batch, d_model, seq_len))),
        f32(rng.standard_normal((3 * d_model, d_model)) / np.sqrt(d_model)),
        f32(rng.standard_normal(3 * d_model) * 0.1),
        f32(rng.standard_normal((3, 1, 3 * d_model))),
        f32(rng.standard_normal(3 * d_model)),
        f32(rng.standard_normal((seq_len, d_model)) * np.exp(-np.arange(seq_len) / 40.0)[:, None]),
        f32(rng.standard_normal(d_model)),
    )


def _close(got: np.ndarray, ref: np.ndarray, what: str = "") -> None:
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), f"{what} err {err:.3e}, max|ref| {np.abs(ref).max():.3e}"


# D = 8, 24, 40: K not a multiple of 16 and D not a multiple of the group;
# L = 1000: a ragged last tile (and odd half-lengths).
D_MODELS = [8, 24, 40]
WIDTHS = [256, 768, 1280, 1000]


@pytest.mark.parametrize("seq_len", WIDTHS)
@pytest.mark.parametrize("d_model", D_MODELS)
def test_model_of_the_kernel_matches_the_plain_version(d_model, seq_len):
    args = _inputs(2, d_model, seq_len, seed=d_model * 7 + seq_len)
    _close(model_inproj(*args), inproj.inproj_reference(*args).numpy())


@pytest.mark.parametrize("seq_len", WIDTHS[:3])
@pytest.mark.parametrize("d_model", D_MODELS)
def test_model_of_the_kernel_matches_jax_pallas_interpret(d_model, seq_len):
    args = _inputs(1, d_model, seq_len, seed=d_model + seq_len)
    x, w, *rest = (jnp.asarray(a.numpy()) for a in args)
    ref = np.asarray(jax_inproj(x, w.T, *rest, interpret=True, precision="float32"))
    _close(model_inproj(*args), ref)


@pytest.mark.parametrize("seq_len", [256, 1000])
@pytest.mark.parametrize("d_model", [8, 40])
def test_bf16_schedule_keeps_the_projection_in_float32(d_model, seq_len):
    """bfloat16 tiles of 64: the mixer of the float32 projection of the
    bf16-rounded x and w (exact products, float32 sums)."""
    x, w, b_in, *mix = _inputs(2, d_model, seq_len, seed=seq_len + 3)
    proj = inproj.projection_f32(x.bfloat16(), w, b_in)
    _close(model_inproj(x, w, b_in, *mix, bf16=True), mixer.mixer_reference(proj, *mix).numpy())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("seq_len", [300, 1000, 1280])
def test_two_cta_schedule_writes_the_rows_of_one_block(bf16, seq_len):
    """Each CTA of a cluster projects half of the tiles, the second from one
    tile early for the carry: their scratch rows are bitwise those of one
    block that walks every tile, and every position is written once."""
    x, w, b_in, k_short, b_short, *_ = _inputs(1, 24, seq_len, seed=seq_len)
    tp = tile_positions(bf16)
    tiles = -(-seq_len // tp)
    half = (tiles + 1) // 2
    args = (x.numpy(), w.numpy(), b_in.numpy(), k_short[:, 0, :].numpy(), b_short.numpy(), 0, 16, 8)
    whole = np.full((8, 2, seq_len), np.nan, np.float32)
    project(*args, 0, tiles, whole, bf16)
    split = np.full_like(whole, np.nan)
    project(*args, 0, half, split, bf16)
    assert np.isnan(split[:, :, half * tp :]).all() and not np.isnan(split[:, :, : half * tp]).any()
    project(*args, half, tiles, split, bf16)
    assert np.array_equal(split, whole) and not np.isnan(whole).any()
    full = model_inproj(*_inputs(1, 24, seq_len, seed=seq_len), bf16=bf16, pair=True)
    _close(full, model_inproj(*_inputs(1, 24, seq_len, seed=seq_len), bf16=bf16, pair=False))


def test_split_keeps_24_bits():
    v = np.random.default_rng(0).standard_normal(10000).astype(np.float32) * np.float32(1e3)
    hi, mid, lo = split_pair(v)
    for t in (hi, mid, lo):
        assert np.array_equal(t, to_bf16(t))
    assert np.abs((hi.astype(np.float64) + mid + lo) - v).max() <= 2.0**-24 * np.abs(v).max()


def ldmatrix(smem: np.ndarray, addrs: list[tuple[int, int]], trans: bool) -> np.ndarray:
    """regs[lane, matrix, 2] of `ldmatrix.m8n8.x4` (rows of 8 b16 at the
    addresses lanes 8i .. 8i + 7 give for matrix i), `.trans` or not."""
    regs = np.zeros((32, len(addrs) // 8, 2), smem.dtype)
    for mat in range(len(addrs) // 8):
        tile = np.stack([smem[r, c : c + 8] for r, c in addrs[8 * mat : 8 * mat + 8]])
        if trans:
            tile = tile.T
        for lane in range(32):
            regs[lane, mat] = tile[lane // 4, 2 * (lane % 4) : 2 * (lane % 4) + 2]
    return regs


@pytest.mark.parametrize("k0,m0,n0", [(0, 0, 0), (16, 48, 8), (32, 16, 40)])
def test_ldmatrix_addresses_give_the_mma_fragments(k0, m0, n0):
    """The bf16 path's lane addresses into the [d][pos] x tile (x4.trans) and
    the [row][d] weight rows (x2) give m16n8k16's A (rows = positions, cols =
    d) and B (rows = d, cols = projected rows) fragments."""
    xs = np.arange(64 * 72).reshape(64, 72)  # kp = 64 rows of XS = 72
    ws = np.arange(48 * 72).reshape(48, 72) + 10**6
    a_addr = [(k0 + (lane & 7) + ((lane >> 4) << 3), m0 + (((lane >> 3) & 1) << 3)) for lane in range(32)]
    b_addr = [(n0 + (lane & 7), k0 + (((lane >> 3) & 1) << 3)) for lane in range(16)]
    a, b = ldmatrix(xs, a_addr, True), ldmatrix(ws, b_addr, False)
    A = xs[k0 : k0 + 16, m0 : m0 + 16].T  # A[m][k] = x[k0 + k][m0 + m]
    B = ws[n0 : n0 + 8, k0 : k0 + 16].T  # B[k][n] = w[n0 + n][k0 + k]
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for r in range(4):  # a[r]: rows g (+8 for odd r), k 2t, 2t + 1 (+8 for r >= 2)
            m, k = g + 8 * (r & 1), 2 * t + 8 * (r >> 1)
            assert list(a[lane, r]) == [A[m, k], A[m, k + 1]]
        for r in range(2):
            assert list(b[lane, r]) == [B[2 * t + 8 * r, g], B[2 * t + 8 * r + 1, g]]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("seq_len", default_buckets(32768))
def test_plan_fits_the_card_at_the_ladder_widths(bf16, seq_len):
    """At D = 256 every width's block fits shared memory, bf16 blocks up to N
    = 32768 fit two an SM, and CG, tiles and threads divide as the kernel
    assumes (warps cover the m-tiles, at most three n8 tiles a warp)."""
    n = mixer.fft_size(seq_len)
    log2n = n.bit_length() - 1
    cg = group_size(log2n)
    p2, threads = fft_bytes(log2n, cg)
    smem = max(tile_bytes(bf16, cg, 256), p2)
    assert smem <= SMEM_LIMIT
    if bf16 and log2n <= 15:
        assert 2 * (smem + 1024) <= 233472 and threads == 256
    warps = threads // 32
    mt = tile_positions(bf16) // 16
    nstep = warps // mt
    assert warps % mt == 0 and -(-3 * cg // 8 // nstep) <= 3
    assert (log2n >= PAIR_LOG2N) == (seq_len > 8192)
