"""Card-only tests of the port's CUDA kernels (skip without a CUDA device).

This file imports no JAX, so it also runs where only PyTorch is installed:
    python -m pytest --noconftest tests/test_torch_port_cuda.py
Each kernel is held to its plain PyTorch version on the same inputs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deepchopper_tpu_torch.ops import mixer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(batch, d_model, seq_len, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    proj = torch.from_numpy(rng.standard_normal((batch, 3 * d_model, seq_len)).astype(np.float32))
    k_short = torch.from_numpy(rng.standard_normal((3, 1, 3 * d_model)).astype(np.float32))
    b_short = torch.from_numpy(rng.standard_normal(3 * d_model).astype(np.float32))
    decay = np.exp(-np.arange(seq_len) / 40.0)[:, None]
    k_long = torch.from_numpy((rng.standard_normal((seq_len, d_model)) * decay).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(d_model).astype(np.float32))
    return proj.to(device, dtype), k_short.to(device), b_short.to(device), k_long.to(device), bias.to(device)


# Up to 16384 the rows kernel (several batch rows a block up to L = 1024),
# 24576 and 32768 the two-CTA cluster kernel. 1, 7 and 8 take the smallest
# transform (N = 8, one radix-2 pass); 7, 33, 300 and 1000 are not whole 16-byte
# chunks (the scalar loads); B = 3 and 5 leave a block's rows part empty.
@pytest.mark.parametrize("seq_len", [1, 7, 8, 33, 256, 300, 1000, 1280, 2048, 3072, 6144, 12288, 16384, 24576, 32768])
@pytest.mark.parametrize("batch", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_mixer_kernel_matches_plain(cuda, seq_len, batch, dtype, tol):
    args = _inputs(batch, 8, seq_len, dtype, cuda, seed=seq_len)
    mixer.reset_launch_counts()
    got = mixer.mixer_fft_conv_bm(*args)
    torch.cuda.synchronize()
    assert mixer.launch_counts["mixer_fwd"] == 1
    ref = mixer.mixer_reference(*args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.parametrize("seq_len", [256, 1000, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixer_rows_are_independent_of_their_batch(cuda, seq_len, dtype):
    """Each row of a B = 5 call is bitwise the row run alone, whichever rows
    share its block: the fused path's byte identity rests on it."""
    args = _inputs(5, 8, seq_len, dtype, cuda, seed=seq_len + 3)
    whole = mixer.mixer_fwd_cuda(*args)
    for b in range(5):
        assert torch.equal(whole[b : b + 1], mixer.mixer_fwd_cuda(args[0][b : b + 1], *args[1:]))


def test_mixer_kernel_rejects_bad_shapes(cuda):
    proj, ks, bs, kl, bias = _inputs(1, 8, 256, torch.float32, cuda)
    with pytest.raises(ValueError):
        mixer.mixer_fft_conv_bm(proj[:, :20], ks, bs, kl, bias)
    with pytest.raises(ValueError):
        mixer.mixer_fft_conv_bm(proj.half(), ks, bs, kl, bias)


def _bwd_inputs(batch, d_model, seq_len, dtype, device, seed=0):
    proj, k_short, b_short, k_long, bias = _inputs(batch, d_model, seq_len, dtype, device, seed)
    dy = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((batch, d_model, seq_len)).astype(np.float32))
    return proj, dy.to(device, dtype), k_short, b_short, k_long, bias


# Same widths as the forward, and one at each transform length of the
# kernel's layouts (rows kernel up to N = 8192: 4096 there; the two-CTA cluster
# at N = 16384 (8192) and 32768 (16384), with the park at 65536 (24576,
# 32768)); B = 3 is odd, so the batch groups are uneven; 300 (bf16) and 1001
# are not whole 16-byte chunks.
@pytest.mark.parametrize("seq_len", [256, 300, 1000, 1280, 16384, 24576, 32768, 4096, 8192, 1001])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_mixer_bwd_kernel_matches_plain(cuda, seq_len, dtype, tol):
    args = _bwd_inputs(3, 8, seq_len, dtype, cuda, seed=seq_len)
    mixer.reset_launch_counts()
    got = mixer.mixer_bwd_cuda(*args)
    again = mixer.mixer_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert mixer.launch_counts["mixer_bwd"] == 2
    ref = mixer.mixer_bwd_reference(*args)
    for g, a, r in zip(got, again, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, a)  # no atomics: bitwise repeatable
        assert (g.float() - r.float()).abs().max().item() <= tol * r.float().abs().max().item()


def _check_bwd(args, tol):
    """Kernel vs plain, each gradient within tol of its max|ref|; two calls
    bitwise equal."""
    mixer.reset_launch_counts()
    got = mixer.mixer_bwd_cuda(*args)
    again = mixer.mixer_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert mixer.launch_counts["mixer_bwd"] == 2
    ref = mixer.mixer_bwd_reference(*args)
    for g, a, r in zip(got, again, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, a)
        assert (g.float() - r.float()).abs().max().item() <= tol * r.float().abs().max().item()


# One width in each layout (rows with G = 8 rows a block at 256 and one row a
# block at 4096, pair at 8192 and 16384, park at 32768); B = 1, and B = 13
# (the rows kernel's last set of 8 part empty); D = 256 with B = 5 makes one
# block (a cluster from 8192 on) walk all five rows of its channel.
@pytest.mark.parametrize("seq_len", [256, 4096, 8192, 16384, 32768])
@pytest.mark.parametrize("batch,d_model", [(1, 8), (13, 8), (5, 256)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_mixer_bwd_layouts_and_batches(cuda, seq_len, batch, d_model, dtype, tol):
    layout = mixer.mixer_bwd_plan(batch, d_model, seq_len)["layout"]
    assert layout == {256: "rows", 4096: "rows", 8192: "pair", 16384: "pair", 32768: "park"}[seq_len]
    _check_bwd(_bwd_inputs(batch, d_model, seq_len, dtype, cuda, seed=seq_len + batch), tol)


def _off_alignment(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    shift = 4 // t.element_size()
    out = flat[shift : shift + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("seq_len", [1000, 16384])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_mixer_bwd_takes_rows_off_16_byte_alignment(cuda, seq_len, dtype, tol):
    """L = 1000 is a whole number of chunks; rows off 16-byte alignment take
    the scalar loads and stores."""
    proj, dy, *params = _bwd_inputs(3, 8, seq_len, dtype, cuda, seed=seq_len + 11)
    proj, dy = _off_alignment(proj), _off_alignment(dy)
    assert proj.data_ptr() % 16 and dy.data_ptr() % 16
    _check_bwd((proj, dy, *params), tol)


def test_mixer_bwd_extra_memory_is_below_one_float32_gate_tensor(cuda):
    """At the flagship's training shape (B = 128, D = 256, L = 1024, bf16) a
    call allocates dproj, the partials and the small outputs: less than one
    (B, 3D, L) float32 tensor beyond its inputs (the first design wrote the
    gate cotangents as one)."""
    args = _bwd_inputs(128, 256, 1024, torch.bfloat16, cuda, seed=9)
    mixer.mixer_bwd_cuda(*args)  # first-use allocations (twiddle table)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = mixer.mixer_bwd_cuda(*args)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra < 128 * 3 * 256 * 1024 * 4, extra
    ref = mixer.mixer_bwd_reference(*args)
    for g, r in zip(got, ref):
        assert (g.float() - r.float()).abs().max().item() <= 1e-2 * r.float().abs().max().item()


def test_gradient_through_mixer_fn_on_the_card(cuda):
    proj, dy, *params = _bwd_inputs(2, 16, 1024, torch.float32, cuda, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (proj, *params)]
    mixer.reset_launch_counts()
    out = mixer.mixer_fft_conv_bm(*leaves)
    assert out.grad_fn is not None
    out.backward(dy)
    torch.cuda.synchronize()
    assert mixer.launch_counts == {"mixer_fwd": 1, "mixer_bwd": 1}
    plain = [t.clone().requires_grad_(True) for t in (proj, *params)]
    mixer.mixer_reference(*plain).backward(dy)
    for leaf, want in zip(leaves, plain):
        assert (leaf.grad - want.grad).abs().max().item() <= 1e-4 * want.grad.abs().max().item()


# -- selective scan (Caduceus) ------------------------------------------------------


def _scan_inputs(batch, seq_len, d_in, n, device, seed=0):
    """u, delta, A, Bp, Cp, D, dy; Bp and Cp sliced from one projection, as
    the mixer makes them."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    proj = f32(rng.standard_normal((batch, seq_len, 4 + 2 * n)))
    return (f32(rng.standard_normal((batch, seq_len, d_in))), f32(rng.uniform(0.01, 1.0, (batch, seq_len, d_in))),
            f32(-rng.uniform(0.1, 4.0, (d_in, n))), proj[..., 4 : 4 + n], proj[..., 4 + n :],
            f32(rng.standard_normal(d_in)), f32(rng.standard_normal((batch, seq_len, d_in))))  # fmt: skip


def _rel(got, want):
    """Max-abs error of max|want| (an all-zero want, as the checkpoints of a
    one-tile scan are, asks for an exact zero)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


# (B, L, Din, N): N = 16 at the flagship's Din; N = 8 (the tiny configs);
# L = 1, 31, 33 and 1000 are ragged against the 32-step tiles. scan_fwd splits
# L into segments (ops/scan.scan_fwd_plan) at 4096, 20000 (a ragged last
# segment) and 32768 (the widest bucket). (64, 1024) is the Caduceus train
# step's batch at 2^16 tokens: 2048 blocks of scan_bwd.
SCAN_SHAPES = [(2, 1000, 512, 16), (3, 33, 64, 8), (1, 31, 128, 8), (2, 1, 64, 16), (4, 4096, 512, 16),
               (1, 20000, 512, 16), (4, 32768, 512, 16), (64, 1024, 512, 16)]  # fmt: skip
SCAN_GRADS = (("du", 1e-5), ("ddelta", 1e-5), ("dA", 1e-4), ("dBp", 1e-5), ("dCp", 1e-5), ("dD", 1e-4))


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_kernels_match_plain(cuda, shape, reverse):
    from deepchopper_tpu_torch.ops import scan

    u, delta, A, Bp, Cp, D, dy = _scan_inputs(*shape, cuda, seed=shape[1])
    scan.reset_launch_counts()
    y = scan.scan_fwd_cuda(u, delta, A, Bp, Cp, D, reverse)
    ckpt = scan.scan_ckpt_cuda(u, delta, A, Bp, reverse)
    grads = scan.scan_bwd_cuda(u, delta, A, Bp, Cp, D, dy, ckpt, reverse)
    again = scan.scan_bwd_cuda(u, delta, A, Bp, Cp, D, dy, ckpt, reverse)
    torch.cuda.synchronize()
    assert scan.launch_counts == {"scan_fwd": 1, "scan_ckpt": 1, "scan_bwd": 2}
    assert _rel(y, scan.selective_scan_reference(u, delta, A, Bp, Cp, D, reverse)) <= 1e-5
    assert _rel(ckpt, scan.scan_ckpt_reference(u, delta, A, Bp, reverse)) <= 1e-5
    want = scan.scan_bwd_reference(u, delta, A, Bp, Cp, D, dy, reverse)
    for (name, tol), g, a, w in zip(SCAN_GRADS, grads, again, want):
        assert torch.equal(g, a), name  # no atomics: bitwise repeatable
        assert _rel(g, w) <= tol, name


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_fwd_is_bitwise_repeatable(cuda, shape, reverse):
    from deepchopper_tpu_torch.ops import scan

    u, delta, A, Bp, Cp, D, _dy = _scan_inputs(*shape, cuda, seed=shape[1] + 1)
    first = scan.scan_fwd_cuda(u, delta, A, Bp, Cp, D, reverse)
    second = scan.scan_fwd_cuda(u, delta, A, Bp, Cp, D, reverse)
    torch.cuda.synchronize()
    assert torch.equal(first, second)  # no atomics; segment end states folded in a fixed order


# The checkpoint walk (scan_fwd.cu's scan_ckpt) on the plan of
# ops/scan.scan_ckpt_plan: segmented at (4, 32768) (69 segments of 480 steps)
# and at 20000 (a ragged last segment); one segment at L = 1000 (a ragged
# last chunk and tile, walked first in reverse); N = 8 at 1000 and 33.
CKPT_SHAPES = [(4, 32768, 512, 16), (1, 20000, 512, 16), (2, 1000, 512, 16), (3, 1000, 64, 8), (3, 33, 64, 8)]


@pytest.mark.parametrize("shape", CKPT_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_ckpt_matches_plain_and_repeats(cuda, shape, reverse):
    """Within 1e-5 of max|ref| of the plain checkpoints, two calls bitwise
    equal (one tally each, segmented or not), the walk's first chunk zero,
    and scan_bwd from them within SCAN_GRADS's limits."""
    from deepchopper_tpu_torch.ops import scan

    u, delta, A, Bp, Cp, D, dy = _scan_inputs(*shape, cuda, seed=shape[1] + 2)
    scan.reset_launch_counts()
    first = scan.scan_ckpt_cuda(u, delta, A, Bp, reverse)
    second = scan.scan_ckpt_cuda(u, delta, A, Bp, reverse)
    torch.cuda.synchronize()
    assert scan.launch_counts["scan_ckpt"] == 2
    assert torch.equal(first, second)  # no atomics; segment end states folded in a fixed order
    assert not first[:, -1 if reverse else 0].any()
    assert _rel(first, scan.scan_ckpt_reference(u, delta, A, Bp, reverse)) <= 1e-5
    grads = scan.scan_bwd_cuda(u, delta, A, Bp, Cp, D, dy, first, reverse)
    for (name, tol), g, w in zip(SCAN_GRADS, grads, scan.scan_bwd_reference(u, delta, A, Bp, Cp, D, dy, reverse)):
        assert _rel(g, w) <= tol, name


@pytest.mark.parametrize("reverse", [False, True])
def test_gradient_through_scan_fn_on_the_card(cuda, reverse):
    from deepchopper_tpu_torch.ops import scan

    *args, dy = _scan_inputs(2, 300, 64, 16, cuda, seed=5)
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    scan.reset_launch_counts()
    y = scan.selective_scan(*leaves, reverse=reverse)
    assert y.grad_fn is not None
    y.backward(dy)
    torch.cuda.synchronize()
    assert scan.launch_counts == {"scan_fwd": 1, "scan_ckpt": 1, "scan_bwd": 1}
    for leaf, want in zip(leaves, scan.scan_bwd_reference(*args, dy, reverse)):
        assert _rel(leaf.grad, want) <= 1e-4


def _off_alignment(t):
    """A contiguous copy of t that starts 4 bytes past a 16-byte alignment."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_fwd_takes_rows_off_16_byte_alignment(cuda, reverse):
    """Contiguous u and delta that start 4 bytes past an alignment: the
    kernel stages them in 4-byte copies in place of 16-byte ones."""
    from deepchopper_tpu_torch.ops import scan

    u, delta, A, Bp, Cp, D, _dy = _scan_inputs(2, 300, 64, 16, cuda, seed=9)
    y = scan.scan_fwd_cuda(_off_alignment(u), _off_alignment(delta), A, Bp, Cp, D, reverse)
    torch.cuda.synchronize()
    assert _rel(y, scan.selective_scan_reference(u, delta, A, Bp, Cp, D, reverse)) <= 1e-5


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_ckpt_takes_rows_off_16_byte_alignment(cuda, reverse):
    """Contiguous u and delta that start 4 bytes past an alignment: the
    checkpoint walk stages them in 4-byte copies (a segmented plan here)."""
    from deepchopper_tpu_torch.ops import scan

    u, delta, A, Bp, _Cp, _D, _dy = _scan_inputs(2, 300, 64, 16, cuda, seed=11)
    assert scan.scan_ckpt_plan(2, 300, 64, 16).segments > 1
    ckpt = scan.scan_ckpt_cuda(_off_alignment(u), _off_alignment(delta), A, Bp, reverse)
    torch.cuda.synchronize()
    assert _rel(ckpt, scan.scan_ckpt_reference(u, delta, A, Bp, reverse)) <= 1e-5


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_bwd_takes_rows_off_16_byte_alignment(cuda, reverse):
    """Contiguous u, delta and dy that start 4 bytes past an alignment:
    scan_bwd stages them in 4-byte copies in place of 16-byte ones."""
    from deepchopper_tpu_torch.ops import scan

    u, delta, A, Bp, Cp, D, dy = _scan_inputs(2, 300, 64, 16, cuda, seed=10)
    ckpt = scan.scan_ckpt_cuda(u, delta, A, Bp, reverse)
    grads = scan.scan_bwd_cuda(_off_alignment(u), _off_alignment(delta), A, Bp, Cp, D, _off_alignment(dy), ckpt,
                               reverse)  # fmt: skip
    torch.cuda.synchronize()
    for (name, tol), g, w in zip(SCAN_GRADS, grads, scan.scan_bwd_reference(u, delta, A, Bp, Cp, D, dy, reverse)):
        assert _rel(g, w) <= tol, name


def test_scan_kernels_refuse_what_they_do_not_take(cuda):
    from deepchopper_tpu_torch.ops import scan

    u, delta, A, Bp, Cp, D, _dy = _scan_inputs(1, 64, 64, 16, cuda)
    bad = {
        "d_state 4": (u, delta, A[:, :4], Bp[..., :4], Cp[..., :4], D),
        "Din not a multiple of 16": (u[..., :40], delta[..., :40], A[:40], Bp, Cp, D[:40]),
        "float64": (u.double(), delta, A, Bp, Cp, D),
        "non-contiguous u": (u[:, ::2], delta[:, ::2], A, Bp[:, ::2], Cp[:, ::2], D),
        "strided N": (u, delta, A, Bp.transpose(1, 2).contiguous().transpose(1, 2), Cp, D),
        "D on the CPU": (u, delta, A, Bp, Cp, D.cpu()),
    }
    for why, args in bad.items():
        with pytest.raises(ValueError):
            scan.scan_fwd_cuda(*args)
            pytest.fail(why)


# -- gated conv, causal conv, in_proj-fused mixer (Hyena's other routes) -----------


def _gated_inputs(batch, d_model, seq_len, dtype, device, seed=0):
    proj, k_short, b_short, k_long, bias = _inputs(batch, d_model, seq_len, torch.float32, device, seed)
    from deepchopper_tpu_torch.models.hyena import short_depthwise_conv_cf

    return short_depthwise_conv_cf(proj, k_short, b_short).to(dtype), k_long, bias


def _inproj_inputs(batch, d_model, seq_len, dtype, device, seed=0):
    rng = np.random.default_rng(seed + 11)
    x = torch.from_numpy(rng.standard_normal((batch, d_model, seq_len)).astype(np.float32)).to(device, dtype)
    w_in = torch.from_numpy((rng.standard_normal((3 * d_model, d_model)) / np.sqrt(d_model)).astype(np.float32))
    b_in = torch.from_numpy((rng.standard_normal(3 * d_model) * 0.1).astype(np.float32))
    _proj, k_short, b_short, k_long, bias = _inputs(1, d_model, seq_len, torch.float32, device, seed)
    return x, w_in.to(device), b_in.to(device), k_short, b_short, k_long, bias


def _within(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


# gated_fwd (mixer_fwd.cu's kernels without the short conv): 256..16384 the
# rows kernel (several batch rows a block up to L = 2048), 24576 and 32768 the
# two-CTA cluster; conv_fwd (ops/conv.conv_fwd_plan): rows blocks of G = 8
# channels up to L = 512, 4 at 513..1024, 2 at 1025..8192, 1 at
# 8193..16384, the two-CTA cluster at 24576 and 32768; mixer_inproj_fwd:
# 256..16384 one block a channel group, 24576 and 32768 a cluster of two CTAs.
# 300, 1000, 513, 1025, 2049 and 8193 are off-ladder widths (odd
# half-lengths; in bfloat16 not whole 16-byte chunks: the scalar loads).
ROUTE_WIDTHS = [256, 300, 1000, 1280, 16384, 24576, 32768]
BOUNDARY_WIDTHS = [512, 513, 1024, 1025, 2048, 2049, 4096, 8192, 8193]
# (batch, D): D % 8 != 0 is the unfused route's real trigger; for the conv,
# D = 12 and 20 leave a channel group part idle at G = 8, and D = 6 takes no
# whole channel vectors; odd batches leave a gated block's rows part empty.
GATED_SHAPES = [(2, 8), (3, 12), (1, 20)]
CONV_SHAPES = [(2, 8), (3, 12), (1, 20), (3, 6)]


@pytest.mark.parametrize("seq_len", ROUTE_WIDTHS + BOUNDARY_WIDTHS)
@pytest.mark.parametrize("batch,d_model", GATED_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_gated_kernel_matches_plain(cuda, seq_len, batch, d_model, dtype, tol):
    from deepchopper_tpu_torch.ops import gated

    args = _gated_inputs(batch, d_model, seq_len, dtype, cuda, seed=seq_len + d_model)
    gated.reset_launch_counts()
    got = gated.gated_fwd_cuda(*args)
    torch.cuda.synchronize()
    assert gated.launch_counts["gated_fwd"] == 1
    _within(got, gated.gated_reference(*args), tol)


@pytest.mark.parametrize("seq_len", [256, 1000, 2049, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_rows_are_independent_of_their_batch(cuda, seq_len, dtype):
    """Each row of a B = 5 call is bitwise the row run alone, whichever rows
    share its block (the rows layout's promise), and two calls are equal."""
    from deepchopper_tpu_torch.ops import gated

    uc, k_long, bias = _gated_inputs(5, 12, seq_len, dtype, cuda, seed=seq_len + 3)
    whole = gated.gated_fwd_cuda(uc, k_long, bias)
    assert torch.equal(whole, gated.gated_fwd_cuda(uc, k_long, bias))
    for b in range(5):
        assert torch.equal(whole[b : b + 1], gated.gated_fwd_cuda(uc[b : b + 1].contiguous(), k_long, bias))


@pytest.mark.parametrize("seq_len", ROUTE_WIDTHS + BOUNDARY_WIDTHS)
@pytest.mark.parametrize("batch,d_model", CONV_SHAPES)
def test_conv_kernel_matches_plain(cuda, seq_len, batch, d_model):
    from deepchopper_tpu_torch.ops import conv

    _proj, _ks, _bs, k_long, bias = _inputs(1, d_model, seq_len, torch.float32, cuda, seed=seq_len)
    rng = np.random.default_rng(seq_len + d_model)
    v = torch.from_numpy(rng.standard_normal((batch, seq_len, d_model)).astype(np.float32)).to(cuda)
    conv.reset_launch_counts()
    got = conv.conv_fwd_cuda(v, k_long, bias)
    torch.cuda.synchronize()
    assert conv.launch_counts["conv_fwd"] == 1
    _within(got, conv.conv_reference(v, k_long, bias), 1e-4)


def test_conv_kernel_takes_rows_off_vector_alignment(cuda):
    """v starting one float past a 16-byte boundary takes the scalar loads."""
    from deepchopper_tpu_torch.ops import conv

    _proj, _ks, _bs, k_long, bias = _inputs(1, 8, 1000, torch.float32, cuda, seed=4)
    v = torch.randn(2 * 1000 * 8 + 1, device=cuda)[1:].view(2, 1000, 8)
    _within(conv.conv_fwd_cuda(v, k_long, bias), conv.conv_reference(v, k_long, bias), 1e-4)


@pytest.mark.parametrize("seq_len", [1000, 32768])
def test_route_wrappers_allocate_no_scratch(cuda, seq_len):
    """Past the first call (filter spectrum kept, twiddles cached), a call of
    either wrapper allocates its output and nothing more: no global scratch
    at any width (the first design parked a B D N/4 float2 row at N = 65536,
    as large as the output)."""
    from deepchopper_tpu_torch.ops import conv, gated

    uc, k_long, bias = _gated_inputs(16, 8, seq_len, torch.float32, cuda, seed=1)
    k_long, bias = mixer.fixed_filter(k_long, bias)
    v = torch.randn(16, seq_len, 8, device=cuda)
    for call in (lambda: gated.gated_fwd_cuda(uc, k_long, bias), lambda: conv.conv_fwd_cuda(v, k_long, bias)):
        call()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = call()
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base <= out.numel() * out.element_size() + 4096
        del out


@pytest.mark.parametrize("seq_len", ROUTE_WIDTHS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_inproj_kernel_matches_plain(cuda, seq_len, dtype, tol):
    from deepchopper_tpu_torch.ops import inproj

    args = _inproj_inputs(2, 16, seq_len, dtype, cuda, seed=seq_len)
    inproj.reset_launch_counts()
    got = inproj.mixer_inproj_fwd_cuda(*args)
    torch.cuda.synchronize()
    assert inproj.launch_counts["mixer_inproj_fwd"] == 1
    _within(got, inproj.inproj_reference(*args), tol)


# D = 8, 12 and 24: K padded to 16 and a group part empty (12 in bfloat16:
# weight rows off 16-byte alignment, staged one element at a time); 256 the
# flagship's. L = 1000: a ragged last tile; 32768: the two-CTA cluster.
@pytest.mark.parametrize("d_model", [8, 12, 24, 256])
@pytest.mark.parametrize("seq_len", [1000, 32768])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_inproj_kernel_matches_plain_across_groups(cuda, d_model, seq_len, dtype, tol):
    from deepchopper_tpu_torch.ops import inproj

    args = _inproj_inputs(2, d_model, seq_len, dtype, cuda, seed=d_model + seq_len)
    inproj.reset_launch_counts()
    got = inproj.mixer_inproj_fwd_cuda(*args)
    torch.cuda.synchronize()
    assert inproj.launch_counts["mixer_inproj_fwd"] == 1
    _within(got, inproj.inproj_reference(*args), tol)


@pytest.mark.parametrize("seq_len", [1000, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inproj_rows_are_independent_of_their_batch_and_repeatable(cuda, seq_len, dtype):
    """Row 0 of a B = 4 call is bitwise the row run alone (B = 1), and two
    calls are bitwise equal: no atomics, no dependence on the grid."""
    from deepchopper_tpu_torch.ops import inproj

    x, *params = _inproj_inputs(4, 24, seq_len, dtype, cuda, seed=seq_len + 7)
    whole = inproj.mixer_inproj_fwd_cuda(x, *params)
    assert torch.equal(whole, inproj.mixer_inproj_fwd_cuda(x, *params))
    assert torch.equal(whole[:1], inproj.mixer_inproj_fwd_cuda(x[:1].contiguous(), *params))


def _grads(fn, args, dy):
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    out = fn(*leaves)
    out.backward(dy)
    return out, [t.grad for t in leaves]


def test_gradients_through_the_route_functions_on_the_card(cuda):
    from deepchopper_tpu_torch.ops import conv, gated, inproj

    cases = {
        "gated": (gated, gated.gated_fft_conv_bm, gated.gated_reference, _gated_inputs(2, 16, 1000, torch.float32, cuda, 5),
                  {"gated_fwd": 1}),
        "conv": (conv, conv.fft_causal_conv, conv.conv_reference,
                 (torch.randn(2, 1000, 16, device=cuda), *_inputs(1, 16, 1000, torch.float32, cuda, 5)[3:]),
                 {"conv_fwd": 1}),
        "inproj": (inproj, inproj.mixer_fft_conv_inproj, inproj.inproj_reference,
                   _inproj_inputs(2, 16, 1000, torch.float32, cuda, 5), {"mixer_inproj_fwd": 1}),
    }  # fmt: skip
    for name, (module, fn, plain, args, launches) in cases.items():
        module.reset_launch_counts()
        mixer.reset_launch_counts()
        dy = torch.randn_like(plain(*args))
        out, got = _grads(fn, args, dy)
        torch.cuda.synchronize()
        assert out.grad_fn is not None, name
        assert module.launch_counts == launches, name
        # The in_proj route's backward runs the mixer backward kernel.
        assert mixer.launch_counts == {"mixer_fwd": 0, "mixer_bwd": int(name == "inproj")}, name
        _, want = _grads(plain, args, dy)
        for i, (g, w) in enumerate(zip(got, want)):
            assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item(), (name, i)


def test_route_kernels_refuse_what_they_do_not_take(cuda):
    from deepchopper_tpu_torch.ops import conv, gated, inproj

    uc, k_long, bias = _gated_inputs(1, 8, 256, torch.float32, cuda)
    x, w_in, b_in, ks, bs, kl, b = _inproj_inputs(1, 8, 256, torch.float32, cuda)
    v = torch.randn(1, 256, 8, device=cuda)
    bad = {
        "gated: width not 3D": lambda: gated.gated_fwd_cuda(uc[:, :20], k_long, bias),
        "gated: float16": lambda: gated.gated_fwd_cuda(uc.half(), k_long, bias),
        "gated: k_long on the CPU": lambda: gated.gated_fwd_cuda(uc, k_long.cpu(), bias),
        "gated: L beyond 32768": lambda: gated.gated_fwd_cuda(
            torch.zeros(1, 3, 40000, device=cuda), torch.zeros(40000, 1, device=cuda), torch.zeros(1, device=cuda)),
        "conv: bfloat16": lambda: conv.conv_fwd_cuda(v.bfloat16(), k_long, bias),
        "conv: k of another width": lambda: conv.conv_fwd_cuda(v, k_long[:100], bias),
        "inproj: flax-layout weight": lambda: inproj.mixer_inproj_fwd_cuda(x, w_in.T.contiguous(), b_in, ks, bs, kl,
                                                                          b),
        "inproj: 4 taps": lambda: inproj.mixer_inproj_fwd_cuda(x, w_in, b_in, torch.cat([ks, ks[:1]]), bs, kl, b),
        "inproj: float16": lambda: inproj.mixer_inproj_fwd_cuda(x.half(), w_in, b_in, ks, bs, kl, b),
    }  # fmt: skip
    for why, call in bad.items():
        with pytest.raises(ValueError):
            call()
            pytest.fail(why)


def test_setup_kernel_matches_plain(cuda):
    from deepchopper_tpu_torch.ops import setup

    for shape in (setup.SHAPE, (3, 1024)):
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32)).to(cuda)
        setup.reset_launch_counts()
        got = setup.setup_tile(x)
        torch.cuda.synchronize()
        assert setup.launch_counts["setup"] == 1
        assert got.dtype == torch.float32 and torch.equal(got, setup.setup_reference(x))
    for bad in (torch.zeros(setup.SHAPE, device=cuda, dtype=torch.bfloat16), torch.zeros(2, 2048, device=cuda)):
        with pytest.raises(ValueError):
            setup.setup_tile(bad)


def test_runtime_setup_launches_the_setup_kernel_once_per_engine(cuda):
    from deepchopper_tpu_torch.infer.engine import PredictEngine
    from deepchopper_tpu_torch.models.registry import build_model
    from deepchopper_tpu_torch.ops import _build, setup

    setup.reset_launch_counts()
    engine = PredictEngine(build_model("hyenadna-tiny-1k-seqlen"), max_length=1024, device=cuda)
    seconds = engine.runtime_setup()
    assert seconds > 0 and engine.stats.setup_s == seconds and 0 <= engine.stats.build_s <= seconds
    assert engine.stats.elapsed_s == 0.0
    assert setup.launch_counts["setup"] == 1
    assert set(_build.SOURCES) <= set(_build._loaded)
    assert engine.runtime_setup() == 0.0 and setup.launch_counts["setup"] == 1


# -- the engine's CUDA graphs and the scan shapes the kernels do not take ------------


def _engine(name: str, dtype: str, device, return_labels: bool = False):
    """A PredictEngine on a registry model (random init, seed 0) at compute
    dtype `dtype`."""
    import dataclasses

    from deepchopper_tpu_torch.infer.engine import PredictEngine
    from deepchopper_tpu_torch.models.registry import DeepChopper

    base = DeepChopper.new(name, seed=0, device=device)
    model = type(base)(
        dataclasses.replace(base.backbone_config, compute_dtype=dtype),
        dataclasses.replace(base.head_config, compute_dtype=dtype),
    ).to(device)
    model.load_state_dict(base.state_dict())
    return PredictEngine(model, max_length=1024, return_labels=return_labels, device=device)


def _reads(rows: int, width: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    ids = rng.integers(7, 12, (rows, width)).astype(np.int8)
    quals = rng.integers(0, 41, (rows, width)).astype(np.uint8)
    ids[-1, width // 3 :], quals[-1, width // 3 :] = 4, 0  # a padded read, as in a bucket
    return ids, quals


@pytest.mark.parametrize("name", ["hyenadna-tiny-1k-seqlen", "caduceus-tiny"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_graph_replay_equals_step(cuda, name, dtype):
    """A replay runs the captured kernels on the copied-in batch: bitwise the
    eager step's logits, at two shapes. Control: a replay without the
    copy-in of a new batch must fail that rule."""
    engine = _engine(name, dtype, cuda)
    for shape in ((8, 256), (2, 1024)):
        ids, quals = _reads(*shape, seed=shape[1])
        graph = engine._get_step(shape)
        got = graph(ids, quals).clone()
        want = engine.step(torch.from_numpy(ids).to(cuda), torch.from_numpy(quals).to(cuda))
        assert got.dtype == torch.float32 and got.shape == (*shape, 2)
        assert torch.equal(got, want), (shape, (got - want).abs().max().item())
        ids2, quals2 = _reads(*shape, seed=shape[1] + 1)
        graph.replay()  # the static inputs still hold the first batch
        fresh = engine.step(torch.from_numpy(ids2).to(cuda), torch.from_numpy(quals2).to(cuda))
        assert not torch.equal(graph.out, fresh)
    assert engine.stats.captures == 2


def test_graph_key_holds_the_hyena_route(cuda, monkeypatch):
    """A graph captured on the unfused route (DEEPCHOPPER_FUSE_SHORT=0) is
    not replayed once the variable is cleared: the fused route captures its
    own, and each replays its own kernels."""
    from deepchopper_tpu_torch.ops import gated

    engine = _engine("hyenadna-tiny-1k-seqlen", "bfloat16", cuda)
    n_layer = engine.model.backbone_config.n_layer
    ids, quals = _reads(2, 1024, seed=5)
    runs = {}
    for env, kernel in (({"DEEPCHOPPER_FUSE_SHORT": "0"}, "gated_fwd"), ({}, "mixer_fwd")):
        monkeypatch.delenv("DEEPCHOPPER_FUSE_SHORT", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        graph = engine._get_step((2, 1024))
        mixer.reset_launch_counts()
        gated.reset_launch_counts()
        graph(ids, quals)
        torch.cuda.synchronize()
        assert {**mixer.launch_counts, **gated.launch_counts} == {
            "mixer_fwd": n_layer * (kernel == "mixer_fwd"), "mixer_bwd": 0, "gated_fwd": n_layer * (kernel == "gated_fwd")}
        runs[kernel] = graph
    assert runs["gated_fwd"] is not runs["mixer_fwd"] and engine.stats.captures == 2


def test_failed_capture_raises(cuda, monkeypatch):
    """A step that cannot be captured (it copies to the host) raises at
    capture and caches nothing, first on a fresh engine, then beside a graph
    captured before; the engine then captures again, and the earlier graph
    still replays right."""
    engine = _engine("hyenadna-tiny-1k-seqlen", "bfloat16", cuda)
    step = engine.step

    def eager(shape, seed):
        ids, quals = _reads(*shape, seed=seed)
        return ids, quals, step(torch.from_numpy(ids).to(cuda), torch.from_numpy(quals).to(cuda))

    for failing, good in (((2, 256), (2, 256)), ((4, 256), (8, 256))):
        monkeypatch.setattr(engine, "step", lambda ids, quals: ids.float().sum().cpu())
        with pytest.raises(RuntimeError):
            engine._get_step(failing)
        assert failing not in {k[:2] for k in engine._graphs}
        monkeypatch.undo()
        ids, quals, want = eager(good, seed=good[0])
        assert torch.equal(engine._get_step(good)(ids, quals), want)
    ids, quals, want = eager((2, 256), seed=9)
    assert torch.equal(engine._get_step((2, 256))(ids, quals), want) and engine.stats.captures == 2


def test_planned_predict_counts_launches_over_replays(cuda):
    """Through `predict_batches`, the mixer's launches are n_layer per
    dispatch: replays count, and a capture's eager run is its first
    dispatch's own."""
    from deepchopper_tpu_torch.data.bucketing import Batch

    engine = _engine("hyenadna-tiny-1k-seqlen", "bfloat16", cuda, return_labels=True)
    n_layer = engine.model.backbone_config.n_layer
    batches = []
    for i, rows in enumerate((512, 200, 512, 5)):  # full at W 256, a tail of 128 + 32 + 32 + 8 (padded to 32), ...
        ids, quals = _reads(rows, 256, seed=40 + i)
        batches.append(Batch(input_ids=ids.astype(np.int32), labels=ids, quals=quals.astype(np.float32),
                             ids=np.zeros((rows, 256), np.int32), lengths=np.full(rows, 256, np.int32),
                             read_ids=[str(r) for r in range(rows)], quals_raw=quals))  # fmt: skip
    mixer.reset_launch_counts()
    outs = [labels for _batch, labels in engine.predict_batches(iter(batches))]
    torch.cuda.synchronize()
    stats = engine.stats
    assert [o.shape for o in outs] == [(512, 256), (200, 256), (512, 256), (5, 256)]
    assert engine._plan_dispatches(200, 256) == [(0, 128, 128), (128, 32, 32), (160, 32, 32), (192, 8, 32)]
    assert stats.dispatches == 1 + 4 + 1 + 1 and stats.captures == 3  # (512, 256), (128, 256), (32, 256)
    assert stats.warm_runs == 0 and mixer.launch_counts["mixer_fwd"] == n_layer * stats.dispatches


@pytest.mark.parametrize("d_in,n", [(128, 32), (72, 16), (40, 4)])
@pytest.mark.parametrize("reverse", [False, True])
def test_selective_scan_computes_shapes_the_kernels_do_not_take(cuda, d_in, n, reverse):
    """N = 32, Din = 72 and N = 4 run on the kernels, brought to shapes they
    take by the wrapper (`scan_kernel_groups`: one launch of each kernel per
    state group): y within 1e-5 of max|ref| of the plain version on the CPU,
    the gradients within SCAN_GRADS's limits (dA and dD sum B·L terms)."""
    from deepchopper_tpu_torch.ops import scan

    args = _scan_inputs(2, 300, d_in, n, "cpu", seed=d_in + n)
    scan.reset_launch_counts()
    leaves = [t.to(cuda).requires_grad_(True) for t in args[:6]]
    y = scan.selective_scan(*leaves, reverse=reverse)
    y.backward(args[6].to(cuda))
    torch.cuda.synchronize()
    groups = scan.scan_kernel_groups(n, d_in)[1]
    assert scan.launch_counts == {"scan_fwd": groups, "scan_ckpt": groups, "scan_bwd": groups}
    assert _rel(y.detach().cpu(), scan.selective_scan_reference(*args[:6], reverse)) <= 1e-5
    want = scan.scan_bwd_reference(*args, reverse)
    for (name, tol), leaf, w in zip(SCAN_GRADS, leaves, want):
        assert _rel(leaf.grad.cpu(), w) <= tol, name


def test_recomputed_blocks_give_the_same_gradients_on_the_card(cuda):
    """The Caduceus flagship at float32 on a (2, 4096) batch, one forward and
    backward with every block recomputed against none (run twice): the
    loss bitwise equal, every gradient bitwise equal wherever the two runs
    with none recomputed are (the same kernels on the same inputs) and
    within 1e-5 of its max|g| where they are not (the embedding table: its
    CUDA backward sums in an order that varies from run to run, chip_smoke.py's
    RECOMPUTE_GRAD_TOL); the recompute's scan_fwd launches counted (2 a
    recomputed block)."""
    import dataclasses

    from deepchopper_tpu_torch.models.registry import DeepChopper
    from deepchopper_tpu_torch.ops import scan
    from deepchopper_tpu_torch.train.loss import continuous_interval_loss

    base = DeepChopper.new("caduceus-ph_seqlen-131k_d_model-256_n_layer-16", seed=0, device=cuda)
    model = type(base)(dataclasses.replace(base.backbone_config, compute_dtype="float32"),
                       dataclasses.replace(base.head_config, compute_dtype="float32")).to(cuda)  # fmt: skip
    model.load_state_dict(base.state_dict())
    model.train()
    n_layer = model.backbone_config.n_layer
    ids, quals = _reads(2, 4096, seed=5)
    ids = torch.from_numpy(ids.astype(np.int64)).to(cuda)
    norm = torch.from_numpy(quals.astype(np.float32)).to(cuda)
    norm = norm / norm.norm(dim=-1, keepdim=True)
    labels = (ids % 2).long()
    runs = []
    for k in (0, 0, n_layer):
        model.backbone._recompute = k
        model.zero_grad(set_to_none=True)
        scan.reset_launch_counts()
        loss = continuous_interval_loss(model(ids, norm), labels)
        loss.backward()
        torch.cuda.synchronize()
        assert scan.launch_counts == {"scan_fwd": 2 * n_layer + 2 * k, "scan_ckpt": 2 * n_layer, "scan_bwd": 2 * n_layer}
        runs.append((loss.detach(), {name: p.grad.clone() for name, p in model.named_parameters()}))
    (loss0, ref), (_loss_again, again), (loss_k, got) = runs
    assert torch.equal(loss0, loss_k)
    for name, g in got.items():
        assert (g - ref[name]).abs().max() <= 1e-5 * ref[name].abs().max(), name
        if torch.equal(again[name], ref[name]):
            assert torch.equal(g, ref[name]), name
