"""A numpy model of how `csrc/conv_fwd.cu` tiles the causal conv over the
channel-last (B, L, D) layout, on the plan of `ops/conv.conv_fwd_plan`, held
to the card's limits, to the plain version's addresses, to float64, to the
plain version and to the JAX op on the CPU.

The kernel runs only on the card, so its plan is checked here in its own
terms: the grid (rows kernel: batch row b, channel group c0, group fastest;
pair kernel: one (b, c) a cluster of two CTAs), the fill's items (two
positions of CW = min(G, 4) channels a thread, channel vector fastest) and
the addresses they load, the 16-byte alignment and the whole sectors of a
warp's loads, the shared bytes and threads the C entry accepts, and the
arithmetic: two `fft_radix.cuh` transforms a channel (as
tests/test_torch_port_fft_plan.py models them), the pair pass, the inverses
and the last stage, for the rows kernel and for the cluster (each CTA filling
both halves from half of the positions).

Tolerance: the float32 model within 1e-5 of max|ref| against a float64
evaluation of the same conv, against `conv_reference` and against the JAX op
`fft_causal_conv_pallas` in interpret mode at float32 DFT precision (FFT
rounding only, as tests/test_torch_port_conv.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_fft_plan import fft_half, pad, pair_pass, quarter_table

from deepchopper_tpu.ops.pallas_fft import fft_causal_conv_pallas
from deepchopper_tpu_torch.data.bucketing import default_buckets
from deepchopper_tpu_torch.ops import conv, mixer

REL_TOL = 1e-5
LADDER = default_buckets(32768)
D_MODELS = (8, 12, 20, 256)
SECTOR = 32  # bytes


def test_ladder_is_the_seventeen_bucket_widths():
    assert len(LADDER) == 17 and LADDER[0] == 256 and LADDER[-1] == 32768


def blocks(plan: dict, batch: int, d_model: int):
    """(CTA, rank, b, c0): the work each CTA of the grid takes."""
    if plan["layout"] == "pair":
        for cta in range(plan["grid"]):
            bc = cta >> 1
            yield cta, cta & 1, bc // d_model, bc % d_model
        return
    ng = -(-d_model // plan["G"])
    for cta in range(plan["grid"]):
        yield cta, 0, cta // ng, (cta % ng) * plan["G"]


@pytest.mark.parametrize("d_model", D_MODELS)
@pytest.mark.parametrize("seq_len", LADDER)
def test_plan_covers_every_row_once(seq_len, d_model):
    batch = 3
    plan = conv.conv_fwd_plan(batch, d_model, seq_len)
    seen = np.zeros((batch, d_model), int)
    for _cta, rank, b, c0 in blocks(plan, batch, d_model):
        if plan["layout"] == "pair":
            seen[b, c0] += rank == 0
            continue
        for c in range(c0, min(c0 + plan["G"], d_model)):  # channels >= D idle
            seen[b, c] += 1
    assert (seen == 1).all()
    n = mixer.fft_size(seq_len)
    assert plan["layout"] == ("pair" if n == 65536 else "rows")
    want_g = {512: 8, 1024: 8, 2048: 4, 4096: 2, 8192: 2, 16384: 2, 32768: 1, 65536: 1}[n]
    assert plan["G"] == min(want_g, 1 << (d_model - 1).bit_length())


@pytest.mark.parametrize("seq_len", [1, 7, 8, 33, 300, 1000, 2049, *LADDER])
def test_plan_fits_the_card_and_the_entry_checks(seq_len):
    """Shared bytes within 227 KB; the threads the C entry launches: the 2G
    transforms at once, H / V threads each, at most 512 (exactly 512 in the
    cluster); 256 where G is neither capped nor floored."""
    for d_model in (1, 3, *D_MODELS):
        plan = conv.conv_fwd_plan(2, d_model, seq_len)
        h = mixer.fft_size(seq_len) // 4
        assert plan["smem"] <= conv.SMEM_LIMIT
        if plan["layout"] == "pair":
            assert plan["smem"] == (conv.padded(h) + conv.quarter(h)) * 8
            assert plan["threads"] == h // 32 == conv.PAIR_THREADS and plan["G"] == 1
            continue
        assert plan["smem"] == (plan["G"] * 2 * conv.padded(h) + conv.quarter(h)) * 8
        nt = h // plan["V"]
        assert plan["G"] in (1, 2, 4, 8) and plan["CW"] == min(plan["G"], 4)
        assert plan["threads"] == 2 * plan["G"] * nt <= 512
        if 2 < plan["G"] < 8 and plan["G"] < d_model:
            assert plan["threads"] == conv.ROWS_THREADS


def fill_items(plan: dict, seq_len: int, d_model: int, b: int, c0: int, rank: int = 0):
    """The fill's loads in the kernel's item order (item, position, channel
    in the vector): arrays of position n, channel c, element offset into v
    as the kernel forms it (row base b L D + c0, then n D + g + j) and the
    vector's first offset (-1 for a scalar load), for the CTA that takes
    (b, c0) (rank: which half of the positions a cluster CTA reads)."""
    h = mixer.fft_size(seq_len) // 4
    if plan["layout"] == "pair":
        cw = 1
        m = np.arange(rank * h // 2, (rank + 1) * h // 2)
        g = np.zeros_like(m)
    else:
        cw = plan["CW"]
        nq = plan["G"] // cw
        items = np.arange(h * nq)
        m, g = items // nq, (items % nq) * cw
    vec = plan["layout"] == "rows" and d_model % cw == 0
    n = np.stack([2 * m, 2 * m + 1], axis=1)  # (item, position)
    j = np.arange(cw)
    nn = np.broadcast_to(n[:, :, None], (*n.shape, cw))
    cc = np.broadcast_to((c0 + g)[:, None, None] + j, nn.shape)
    off = b * seq_len * d_model + c0 + nn * d_model + (cc - c0)
    whole = vec & (n < seq_len) & (c0 + g + cw <= d_model)[:, None]
    start = np.broadcast_to(np.where(whole, off[:, :, 0], -1)[:, :, None], nn.shape)
    live = (nn < seq_len) & (cc < d_model)
    return nn[live], cc[live], off[live], start[live]


@pytest.mark.parametrize("d_model", [6, 8, 12, 20])
@pytest.mark.parametrize("seq_len", [7, 300, 2049, 4096, 8192, 16384, 24576])
def test_fill_reads_the_plain_versions_addresses_once(seq_len, d_model):
    """Every element of v the plain version reads, v[b, n, c] at offset
    (b L + n) D + c, is loaded exactly once over the grid, by the CTA of its
    channel; nothing past L or D is loaded."""
    batch = 2
    plan = conv.conv_fwd_plan(batch, d_model, seq_len)
    hits = np.zeros(batch * seq_len * d_model, np.int32)
    for _cta, rank, b, c0 in blocks(plan, batch, d_model):
        n, c, off, _start = fill_items(plan, seq_len, d_model, b, c0, rank)
        assert (off == np.ravel_multi_index((np.full_like(n, b), n, c), (batch, seq_len, d_model))).all()
        assert ((c0 <= c) & (c < c0 + plan["G"])).all()
        np.add.at(hits, off, 1)
    assert (hits == 1).all()


@pytest.mark.parametrize("seq_len", [300, 1000, 2048, 2049, 4096, 8192, 16384])
@pytest.mark.parametrize("d_model", [8, 12, 20, 256])
def test_vector_loads_are_aligned_and_fill_whole_sectors(seq_len, d_model):
    """With G >= 4 and D % 4 == 0 each fill load is one 16-byte vector at a
    16-byte offset; at G = 8 and D % 8 == 0 the first load of a warp (32
    items: positions 0, 2, ..., 30, two channel vectors each) uses every byte
    of each 32-byte sector it touches."""
    plan = conv.conv_fwd_plan(1, d_model, seq_len)
    last = (-(-d_model // plan["G"]) - 1) * plan["G"]
    for c0 in (0, last):
        n, _c, off, start = fill_items(plan, seq_len, d_model, 0, c0)
        if plan["G"] < 4:
            assert plan["CW"] == plan["G"]
            continue
        assert (start >= 0).all() and (start % 4 == 0).all()
        if plan["G"] == 8 and d_model % 8 == 0:
            first = off[(n % 2 == 0) & (n < 32)]
            sectors, used = np.unique(first * 4 // SECTOR, return_counts=True)
            assert len(sectors) == 16 and (used * 4 == SECTOR).all()


def model_conv(v: np.ndarray, k: torch.Tensor, bias: torch.Tensor) -> np.ndarray:
    """The kernel's arithmetic in complex64, CTA by CTA as the plan lays it
    out: shared rows [G][2][padded(H)] (rows) or one half a CTA (pair), each
    filled from the loads of `fill_items`."""
    batch, seq_len, d_model = v.shape
    n = mixer.fft_size(seq_len)
    M, H = n // 2, n // 4
    hp = conv.padded(H)
    khat = mixer.filter_spectrum(k, bias, n).numpy()
    tw = mixer._twiddles(n, torch.device("cpu")).numpy()
    table = quarter_table(tw, H)
    plan = conv.conv_fwd_plan(batch, d_model, seq_len)
    G = plan["G"]
    y = np.full((batch, seq_len, d_model), np.nan, np.float32)
    flat = v.reshape(-1)
    half = (seq_len + 1) // 2
    for _cta, rank, b, c0 in blocks(plan, batch, d_model):
        if rank:
            continue  # the pair's two CTAs are modelled together
        s = np.zeros((G, 2, hp), np.complex64)
        for r in (0, 1) if plan["layout"] == "pair" else (0,):
            pos, ch, off, _start = fill_items(plan, seq_len, d_model, b, c0, r)
            w = np.zeros((G, 2 * H), np.float32)
            w[ch - c0, pos] = flat[off]
            m = np.arange(r * H // 2, (r + 1) * H // 2) if plan["layout"] == "pair" else np.arange(H)
            z = (w[:, 2 * m] + 1j * w[:, 2 * m + 1]).astype(np.complex64)
            s[:, 0, pad(m)] = z
            s[:, 1, pad(m)] = z * tw[2 * m]
        for g in range(G):
            c = c0 + g
            if c >= d_model:
                continue
            halves = [fft_half(s[g, h], H, False, table) for h in (0, 1)]
            for kk in range(M // 2 + 1):
                k2 = (M - kk) & (M - 1)
                ha, pa, hb, pb = halves[kk & 1], pad(kk >> 1), halves[k2 & 1], pad(k2 >> 1)
                za, zb = pair_pass(ha[pa], hb[pb], kk, M, khat[c], tw)
                ha[pa] = za
                if kk != 0 and k2 != kk:
                    hb[pb] = zb
            e, o = (fft_half(x, H, True, table) for x in halves)
            if plan["layout"] == "pair":
                per = (half + 1) // 2
                m = np.concatenate([np.arange(r * per, min(half, (r + 1) * per)) for r in (0, 1)])
            else:
                m = np.arange(half)
            assert sorted(m.tolist()) == list(range(half))
            zz = e[pad(m)] + o[pad(m)] * np.conj(tw[2 * m])
            y[b, 2 * m, c] = zz.real
            odd = 2 * m + 1 < seq_len
            y[b, 2 * m[odd] + 1, c] = zz.imag[odd]
    return y


def _inputs(batch: int, seq_len: int, d_model: int, seed: int):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((batch, seq_len, d_model)).astype(np.float32)
    k = (rng.standard_normal((seq_len, d_model)) * np.exp(-np.arange(seq_len) / 40.0)[:, None]).astype(np.float32)
    bias = rng.standard_normal(d_model).astype(np.float32)
    return v, k, bias


def float64_conv(v: np.ndarray, k: np.ndarray, bias: np.ndarray) -> np.ndarray:
    seq_len = v.shape[1]
    n = 2 * seq_len
    vf = np.fft.rfft(v.astype(np.float64), n=n, axis=1)
    kf = np.fft.rfft(k.astype(np.float64), n=n, axis=0)
    return np.fft.irfft(vf * kf, n=n, axis=1)[:, :seq_len] + v * bias


def _assert_close(got, ref, what):
    err = np.abs(got - ref).max()
    assert err <= REL_TOL * np.abs(ref).max(), f"{what}: max-abs err {err:.3e} vs max|ref| {np.abs(ref).max():.3e}"


# 1 and 7: the smallest transforms; 300 and 2049: odd half-lengths and ragged
# tails; D = 3, 6 and 12: no whole channel vectors, a group part idle. The
# JAX op takes 2L % 512 == 0 only (256, 768).
@pytest.mark.parametrize("seq_len,d_model", [(1, 3), (7, 6), (256, 8), (300, 12), (768, 12), (2049, 4)])
def test_kernel_model_computes_the_conv_on_rows(seq_len, d_model):
    v, k, bias = _inputs(2, seq_len, d_model, seed=seq_len + d_model)
    got = model_conv(v, torch.from_numpy(k), torch.from_numpy(bias))
    assert not np.isnan(got).any()
    _assert_close(got, float64_conv(v, k, bias), "float64")
    ref = conv.conv_reference(*(torch.from_numpy(a) for a in (v, k, bias))).numpy()
    _assert_close(got, ref, "conv_reference")
    if 2 * seq_len % 512 == 0:
        jax_ref = np.asarray(fft_causal_conv_pallas(jnp.asarray(v), jnp.asarray(k), jnp.asarray(bias), interpret=True,
                                                    precision="float32"))  # fmt: skip
        _assert_close(got, jax_ref, "JAX fft_causal_conv_pallas")


def test_kernel_model_computes_the_conv_on_the_cluster():
    """N = 65536: each CTA of the pair fills both halves from half of the
    positions and writes half of the outputs."""
    seq_len = 24576 + 3
    v, k, bias = _inputs(1, seq_len, 1, seed=11)
    plan = conv.conv_fwd_plan(1, 1, seq_len)
    assert plan["layout"] == "pair" and plan["grid"] == 2
    got = model_conv(v, torch.from_numpy(k), torch.from_numpy(bias))
    assert not np.isnan(got).any()
    _assert_close(got, float64_conv(v, k, bias), "float64")
    # The plain version's own float32 FFT at N = 2L = 49158 (a factor 2731:
    # Bluestein) is off float64 by 2.9e-5 of max|ref|: held at chip_smoke.py's
    # 1e-4, the limit of f32 FFT rounding at this width.
    ref = conv.conv_reference(*(torch.from_numpy(a) for a in (v, k, bias))).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
