"""A numpy model of how `csrc/mixer_fwd.cu` (on `csrc/fft_radix.cuh`) lays
out and walks its FFT, held to the plain mixer on the CPU.

The kernel runs only on the card, so its plan is checked here at small
widths in its own terms: the radix sequence of a length-H transform, each
thread's V values and their groups, the Stockham passes (natural order in and
out) with the register DFTs done as radix-2 decimation in frequency plus a
bit reversal, the padded shared-memory index p + p // 16, twiddles from a
quarter table W_H^b (b < H/4) turned by (-i)^q, the two halves of the packed
real transform, the pair pass and the last stage that forms only outputs
m < L/2. Each function mirrors the device function of the same name.
Tolerance: float32 model vs the plain mixer within 1e-5 of max|ref| (FFT
rounding only), as the port's other mixer tests.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deepchopper_tpu_torch.ops import mixer

REL_TOL = 1e-5


def radices(h: int) -> list[int]:
    """Radix of each pass of a length-2^h transform: the remainder first
    (its pass, at Ns = 1, needs no twiddles), then radix 16."""
    if h <= 4:
        return [1 << h]
    return ([1 << (h % 4)] if h % 4 else []) + [16] * (h // 4)


def values_per_thread(H: int) -> int:
    return H if H < 16 else (32 if H >= 4096 else 16)


def rows_per_block(H: int) -> int:
    """Batch rows of one channel a block takes: at least 256 threads."""
    return max(1, 256 // (2 * H // values_per_thread(H)))


def pad(p):
    return p + (p >> 4)


def quarter_table(tw: np.ndarray, H: int) -> np.ndarray:
    """W_H^b for b < H/4, from the host's float64-built W_N table (N = 4H)."""
    return tw[4 * np.arange(max(1, H // 4))]


def twiddle(table, H: int, idx, inverse: bool):
    q, b = np.divmod(idx, H // 4)
    w = table[b] * ((-1j) ** q).astype(np.complex64)
    return np.conj(w) if inverse else w


def rotate(a, n: int, den: int, inverse: bool):
    """a * exp(-+2 pi i n / den), den <= 16, exact at multiples of 1/4."""
    s = (n * (16 // den)) & 15
    if s == 0:
        return a
    w = np.complex64(np.exp((1 if inverse else -1) * 2j * np.pi * s / 16))
    return a * w


def dft(v: np.ndarray, inverse: bool) -> np.ndarray:
    """Length-R DFT of each row of v (R = v.shape[1]): radix-2 DIF in
    registers, then the bit-reversal permutation."""
    v = v.copy()
    R = v.shape[1]
    span = R // 2
    while span >= 1:
        for i in range(R):
            if i & span == 0:
                a, b = v[:, i].copy(), v[:, i + span].copy()
                v[:, i] = a + b
                v[:, i + span] = rotate(a - b, i & (span - 1), 2 * span, inverse)
        span //= 2
    bits = R.bit_length() - 1
    rev = [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(R)]
    return v[:, rev]


def fft_half(x: np.ndarray, H: int, inverse: bool, table: np.ndarray) -> np.ndarray:
    """Stockham passes over one padded half (length pad(H)), out of place
    here; the kernel reads all of a pass into registers, then writes."""
    V = values_per_thread(H)
    T = H // V
    ns = 1
    for R in radices(H.bit_length() - 1):
        j = np.array([t + g * T for t in range(T) for g in range(V // R)])
        assert sorted(j.tolist()) == list(range(H // R))  # each group once
        r = np.arange(R)
        v = x[pad(j[:, None] + r[None, :] * (H // R))]
        if ns > 1:
            v = v * twiddle(table, H, r[None, :] * (j[:, None] % ns) * (H // (ns * R)), inverse)
        v = dft(v.astype(np.complex64), inverse)
        out = x.copy()
        out[pad((j[:, None] // ns) * ns * R + j[:, None] % ns + r[None, :] * ns)] = v
        x = out
        ns *= R
    return x


def model_mixer(proj, k_short, b_short, k_long, bias) -> np.ndarray:
    """The kernel's arithmetic, row by row, in complex64."""
    batch, width, L = proj.shape
    D = width // 3
    n = mixer.fft_size(L)
    M, H = n // 2, n // 4
    gates = mixer._short_conv_gates(proj, k_short, b_short).numpy()
    x2, x1, v = gates[:, :D], gates[:, D : 2 * D], gates[:, 2 * D :]
    khat = mixer.filter_spectrum(k_long, bias, n).numpy()
    tw = mixer._twiddles(n, torch.device("cpu")).numpy()
    table = quarter_table(tw, H)
    out = np.zeros((batch, D, L), np.float32)
    for b in range(batch):
        for c in range(D):
            w = np.zeros(2 * M, np.float32)
            w[:L] = v[b, c] * x1[b, c]
            z = (w[0 : 2 * H : 2] + 1j * w[1 : 2 * H : 2]).astype(np.complex64)
            halves = []
            for h in (0, 1):
                x = np.zeros(pad(H - 1) + 1, np.complex64)
                x[pad(np.arange(H))] = z * tw[2 * np.arange(H)] if h else z
                halves.append(fft_half(x, H, False, table))

            def at(k):
                return halves[k & 1], pad(k >> 1)

            kh = khat[c]
            for k in range(M // 2 + 1):
                k2 = (M - k) & (M - 1)
                (ha, pa), (hb, pb) = at(k), at(k2)
                za, zb = pair_pass(ha[pa], hb[pb], k, M, kh, tw)
                ha[pa] = za
                if k != 0 and k2 != k:
                    hb[pb] = zb
            e, o = (fft_half(x, H, True, table) for x in halves)
            m = np.arange((L + 1) // 2)
            zz = e[pad(m)] + o[pad(m)] * np.conj(tw[2 * m])
            y = np.stack([zz.real, zz.imag], axis=1).reshape(-1)[:L]
            out[b, c] = y * x2[b, c]
    return out


def pair_pass(A, B, k: int, M: int, kh, tw):
    """`mixer_common.cuh:pair_pass`: real-FFT split, filter product, merge."""
    W = tw[k]
    fe = 0.5 * (A + np.conj(B))
    fo = -0.5j * (A - np.conj(B))
    xk, xmk = fe + W * fo, np.conj(fe - W * fo)
    yk, ymk = xk * kh[k], xmk * kh[M - k]
    P, Q = yk + np.conj(ymk), yk - np.conj(ymk)
    return P + 1j * np.conj(W) * Q, np.conj(P) + 1j * W * np.conj(Q)


@pytest.mark.parametrize("h", range(1, 15))
def test_plan_has_at_most_four_passes_and_fits_its_threads(h):
    H = 1 << h
    V = values_per_thread(H)
    assert np.prod(radices(h)) == H and len(radices(h)) <= 4
    assert all(V % R == 0 for R in radices(h))
    threads = rows_per_block(H) * 2 * H // V if H <= 8192 else H // V  # N = 65536: one half a CTA
    assert 32 <= threads <= 512 or H < 16


@pytest.mark.parametrize("seq_len", [1, 7, 8, 33, 256, 300, 1000, 2048, 3072])
def test_kernel_plan_computes_the_mixer(seq_len):
    rng = np.random.default_rng(seq_len)
    D = 2
    proj = torch.from_numpy(rng.standard_normal((2, 3 * D, seq_len)).astype(np.float32))
    k_short = torch.from_numpy(rng.standard_normal((3, 1, 3 * D)).astype(np.float32))
    b_short = torch.from_numpy(rng.standard_normal(3 * D).astype(np.float32))
    k_long = torch.from_numpy((rng.standard_normal((seq_len, D)) * np.exp(-np.arange(seq_len) / 40.0)[:, None])
                              .astype(np.float32))  # fmt: skip
    bias = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    ref = mixer.mixer_reference(proj, k_short, b_short, k_long, bias).numpy()
    got = model_mixer(proj, k_short, b_short, k_long, bias)
    assert np.abs(got - ref).max() <= REL_TOL * np.abs(ref).max()
