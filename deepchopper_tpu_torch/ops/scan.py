"""Selective scan of the Mamba mixer (Caduceus backbone).

Port of `deepchopper_tpu/ops/pallas_scan.py`. The public function keeps the
JAX layout and contract:

    selective_scan(u (B, L, Din) f32, delta (B, L, Din) f32, A (Din, N),
                   Bp (B, L, N), Cp (B, L, N), D (Din,), reverse) -> y (B, L, Din) f32

    h[t] = exp(delta[t] ⊗ A) ⊙ h[t-1] + (delta[t] ⊙ u[t]) ⊗ Bp[t]
    y[t] = Σ_n Cp[t, n] h[t][:, n] + D ⊙ u[t]

with h = 0 before the first step; `reverse=True` walks from t = L-1 down to
0, which is flip(scan(flip(inputs))) without the flips.

It is differentiable through `ScanFn`, the counterpart of the JAX package's
`custom_vjp`: the forward saves only its inputs. On CUDA tensors the forward
launches `scan_fwd` of `csrc/scan_fwd.cu` (the port of `_scan_kernel`) on the
plan of `scan_fwd_plan`, and the backward launches `scan_ckpt` of the same
file on the plan of `scan_ckpt_plan`, then `scan_bwd` of `csrc/scan_bwd.cu`
(the ports of `_scan_ckpt_kernel` and `_scan_bwd_kernel`): the first walks
the forward's recurrence and stores the state at the entry of every
`CKPT_CHUNK`-step chunk, the second walks the chunks against the scan's
direction, recomputes the states of a chunk from its checkpoint and runs the
cotangent recurrence. The kernels take N in
KERNEL_STATES and Din a multiple of 256 / N (`scan_kernel_shape`); a CUDA
scan of any other shape is brought to one in the wrapper
(`scan_kernel_groups`), as the TPU kernel pads L and the batch to take every
shape: Din padded with idle channels (u = delta = 0), N padded to 8 or 16
with idle states (Bp = Cp = 0, A = -1), and N above 16 split into groups of
16 states, each a scan of its own whose y (and du, ddelta) add up. CPU tensors
run `selective_scan_reference` and `scan_bwd_reference`, the plain PyTorch
versions. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build

# Launches of each CUDA kernel since the last reset: one per wrapper call
# that reached the card. Read by chip_smoke.py to show the main path ran
# through the kernels.
launch_counts: dict[str, int] = _build.counters("scan_fwd", "scan_ckpt", "scan_bwd")

# Steps per checkpoint chunk: fixed by the kernels (`kChunk` in
# csrc/scan_common.cuh). Chunk c covers t in [c * CKPT_CHUNK, (c + 1) * CKPT_CHUNK).
# The checkpoint walk's segments are whole chunks (`scan_ckpt_plan`).
CKPT_CHUNK = 32
# States the kernels take (the flagship's 16, the tiny configs' 8). The
# backward kernels run one thread per (channel, state), 256 a block, so Din
# must be a multiple of 256 / N.
KERNEL_STATES = (8, 16)
_THREADS = 256
# Tokens (batch rows x steps) per chunk of the plain scan: bounds its
# (B, chunk, Din, N) float32 intermediates (4096 tokens x 512 x 16 x 4 B =
# 128 MiB each at the flagship's widths).
PLAIN_CHUNK_TOKENS = 4096


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# -- plain versions -------------------------------------------------------------


def _affine_prefix(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan over dim 1 of the affine maps h -> a h + b, composed
    (a2, b2) o (a1, b1) = (a2 a1, a2 b1 + b2), by Hillis-Steele doubling."""
    step = 1
    while step < a.shape[1]:
        a_head, b_head = a[:, :step], b[:, :step]
        b = torch.cat([b_head, a[:, step:] * b[:, :-step] + b[:, step:]], dim=1)
        a = torch.cat([a_head, a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    return a, b


def _chunk_states(u, delta, A, Bp, h0) -> torch.Tensor:
    """States h (B, c, Din, N) of the steps of one chunk, in order, from the
    entry state h0 (B, Din, N)."""
    a = torch.exp(delta[..., None] * A)
    b = (delta * u)[..., None] * Bp[:, :, None, :]
    ca, cb = _affine_prefix(a, b)
    return ca * h0[:, None] + cb


# -- the plans of scan_fwd.cu's walks ---------------------------------------------

# The card's SMs (an H100 SXM). The plan depends on the shape alone, never on
# the device it runs on.
PLAN_SMS = 132
FWD_MAX_CHANNELS = 128  # channels (threads) a block: `kFwdMaxChannels` in csrc/scan_fwd.cu
FWD_TILE = 16  # steps a staged tile
# Warps of one walk at or above which L is not split, and the warps a split
# walk aims for: about 1.6 waves of the 5 blocks of 4 warps an SM holds, so
# that blocks whose folds differ in length even out. From a sweep of plans
# on an H100 (scripts/torch_scan_ab.py --sweep, PERF.md §6): at 512
# warps (W 4096) one segment beat any split, at 400 (W 5120) splits won.
FWD_FILL_WARPS = 512
FWD_SEG_WARPS = 32 * PLAN_SMS


class ScanFwdPlan(NamedTuple):
    """How `csrc/scan_fwd.cu` cuts a (B, L, Din, N) walk: blocks of
    `channels` channels of one batch row, tiles of `tile` steps, and L split
    into `segments` runs of `seg_len` steps (a whole number of tiles, and of
    CKPT_CHUNK-step chunks for the checkpoint walk; the last run may be
    shorter). `block_target` is the grid the plan aims for."""

    channels: int
    tile: int
    segments: int
    seg_len: int
    block_target: int

    def blocks(self, batch: int, d_in: int) -> int:
        """Blocks of the launch that writes y (or the checkpoints)."""
        return batch * (d_in // self.channels) * self.segments

    def scratch_floats(self, batch: int, d_in: int, n: int) -> int:
        """Floats of the segment scratch: each segment's end states and sums of dt."""
        return batch * self.segments * d_in * (n + 1) if self.segments > 1 else 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _segment_plan(seq_len: int, channels: int, tile: int, segments: int, block_target: int,
                  unit: int | None = None) -> ScanFwdPlan:  # fmt: skip
    """L in at most `segments` runs of equal whole units of steps (tiles by
    default; the last run shorter)."""
    unit = unit or tile
    seg_len = _cdiv(_cdiv(seq_len, segments), unit) * unit
    return ScanFwdPlan(channels, tile, _cdiv(seq_len, seg_len), seg_len, block_target)


def _walk_plan(batch: int, seq_len: int, d_in: int, n: int, unit: int, what: str) -> ScanFwdPlan:
    if not scan_kernel_shape(n, d_in) or batch < 1 or seq_len < 1:
        raise ValueError(f"{what}: no plan for (B={batch}, L={seq_len}, Din={d_in}, N={n})")
    channels = next(c for c in (FWD_MAX_CHANNELS, 64, 32, 16) if d_in % c == 0)
    warps = _cdiv(channels, 32)
    row_blocks = batch * (d_in // channels)
    if row_blocks * warps >= FWD_FILL_WARPS:
        return _segment_plan(seq_len, channels, FWD_TILE, 1, _cdiv(FWD_FILL_WARPS, warps), unit)
    target = _cdiv(FWD_SEG_WARPS, warps)
    most = max(1, math.isqrt(seq_len))
    for segments in range(min(_cdiv(target, row_blocks), most), most + 1):
        plan = _segment_plan(seq_len, channels, FWD_TILE, segments, target, unit)
        if row_blocks * plan.segments >= target:
            break
    return plan


@functools.lru_cache(maxsize=4096)
def scan_fwd_plan(batch: int, seq_len: int, d_in: int, n: int) -> ScanFwdPlan:
    """The forward kernel's plan for a (B, L, Din, N) scan, from the shape
    alone. Blocks take the most channels up to FWD_MAX_CHANNELS that divide
    Din. Where the blocks of whole rows hold FWD_FILL_WARPS warps, L is one
    segment. Below that, L is split into the fewest segments of whole tiles
    that bring the grid to FWD_SEG_WARPS warps, but into no more than
    isqrt(L): a block folds up to one end state per segment before its walk,
    so a segment is kept at least about as long as the count."""
    return _walk_plan(batch, seq_len, d_in, n, FWD_TILE, "scan_fwd_plan")


@functools.lru_cache(maxsize=4096)
def scan_ckpt_plan(batch: int, seq_len: int, d_in: int, n: int) -> ScanFwdPlan:
    """The checkpoint walk's plan: `scan_fwd_plan`'s, with segments of whole
    CKPT_CHUNK-step chunks, so that each segment starts on a chunk boundary
    and the walk enters every chunk inside one segment. FWD_TILE divides the
    chunk, so no tile lies in two chunks."""
    return _walk_plan(batch, seq_len, d_in, n, CKPT_CHUNK, "scan_ckpt_plan")


def _plain_chunk(batch: int, chunk: int | None) -> int:
    return chunk or max(1, PLAIN_CHUNK_TOKENS // batch)


def _flip_time(*ts: torch.Tensor) -> list[torch.Tensor]:
    return [t.flip(1) for t in ts]


def selective_scan_reference(u, delta, A, Bp, Cp, D, reverse: bool = False, chunk: int | None = None):
    """Plain PyTorch scan in float32: a chunked associative scan (the math of
    `models/caduceus.py:selective_scan`), carrying the (B, Din, N) end state
    from chunk to chunk. `reverse` flips around it, as `_scan_reference_xla`
    does. `chunk` steps per chunk (default: PLAIN_CHUNK_TOKENS // B)."""
    u, delta, A, Bp, Cp, D = (t.float() for t in (u, delta, A, Bp, Cp, D))
    if reverse:
        u, delta, Bp, Cp = _flip_time(u, delta, Bp, Cp)
    batch, seq_len, d_in = u.shape
    chunk = _plain_chunk(batch, chunk)
    h = u.new_zeros(batch, d_in, A.shape[1])
    ys = []
    for lo in range(0, seq_len, chunk):
        sl = slice(lo, min(seq_len, lo + chunk))
        hs = _chunk_states(u[:, sl], delta[:, sl], A, Bp[:, sl], h)
        ys.append(torch.einsum("bldn,bln->bld", hs, Cp[:, sl]))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) + u * D
    return y.flip(1) if reverse else y


def scan_ckpt_reference(u, delta, A, Bp, reverse: bool = False, chunk: int = CKPT_CHUNK) -> torch.Tensor:
    """Plain chunk-entry states (B, nl, N, Din) float32, nl = ceil(L / chunk):
    entry c is the state on entering chunk c (t in [c chunk, (c+1) chunk)) in
    the scan's direction of walk, so entry 0 of a forward scan and entry
    nl-1 of a reverse scan are zero."""
    u, delta, A, Bp = (t.float() for t in (u, delta, A, Bp))
    batch, seq_len, d_in = u.shape
    nl = -(-seq_len // chunk)
    out = u.new_empty(batch, nl, A.shape[1], d_in)
    h = u.new_zeros(batch, d_in, A.shape[1])
    for c in reversed(range(nl)) if reverse else range(nl):
        out[:, c] = h.transpose(1, 2)
        sl = slice(c * chunk, min(seq_len, (c + 1) * chunk))
        seg = [u[:, sl], delta[:, sl], Bp[:, sl]]
        if reverse:
            seg = _flip_time(*seg)
        h = _chunk_states(seg[0], seg[1], A, seg[2], h)[:, -1]
    return out


def scan_bwd_reference(u, delta, A, Bp, Cp, D, dy, reverse: bool = False, chunk: int | None = None):
    """Autograd of the plain forward: (du, ddelta, dA, dBp, dCp, dD) float32.

    Run one chunk at a time, from the last chunk of the walk to the first:
    each chunk's forward is recomputed from its entry state, and autograd
    takes dy and the cotangent of the state leaving the chunk to the
    cotangents of the chunk's inputs and of its entry state. This is autograd
    of `selective_scan_reference` with the graph of one chunk alive at a time."""
    u, delta, A, Bp, Cp, D, dy = (t.float() for t in (u, delta, A, Bp, Cp, D, dy))
    if reverse:
        u, delta, Bp, Cp, dy = _flip_time(u, delta, Bp, Cp, dy)
    batch, seq_len, d_in = u.shape
    chunk = _plain_chunk(batch, chunk)
    bounds = [(lo, min(seq_len, lo + chunk)) for lo in range(0, seq_len, chunk)]
    entries = []
    with torch.no_grad():
        h = u.new_zeros(batch, d_in, A.shape[1])
        for lo, hi in bounds:
            entries.append(h)
            h = _chunk_states(u[:, lo:hi], delta[:, lo:hi], A, Bp[:, lo:hi], h)[:, -1]
    du, ddelta, dbp, dcp = (torch.empty_like(t) for t in (u, delta, Bp, Cp))
    d_a, d_d = torch.zeros_like(A), torch.zeros_like(D)
    g_out = torch.zeros_like(h)
    for (lo, hi), h0 in zip(reversed(bounds), reversed(entries)):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (u[:, lo:hi], delta[:, lo:hi], A, Bp[:, lo:hi],
                                                               Cp[:, lo:hi], D, h0)]  # fmt: skip
            uc, dc, ac, bc, cc, dsk, h_in = leaves
            hs = _chunk_states(uc, dc, ac, bc, h_in)
            y = torch.einsum("bldn,bln->bld", hs, cc) + uc * dsk
            grads = torch.autograd.grad((y, hs[:, -1]), leaves, (dy[:, lo:hi], g_out))
        du[:, lo:hi], ddelta[:, lo:hi], dbp[:, lo:hi], dcp[:, lo:hi] = grads[0], grads[1], grads[3], grads[4]
        d_a += grads[2]
        d_d += grads[5]
        g_out = grads[6]
    if reverse:
        du, ddelta, dbp, dcp = _flip_time(du, ddelta, dbp, dcp)
    return du, ddelta, d_a, dbp, dcp, d_d


# -- CUDA kernels -----------------------------------------------------------------


def bind_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of scan_fwd.cu's `scan_fwd` on a loaded build of it."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.scan_fwd.argtypes = [ptr] * 8 + [i32] * 4 + [i64] * 4 + [i32] * 5 + [ptr]
    lib.scan_fwd.restype = i32
    return lib


def bind_ckpt(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of scan_fwd.cu's `scan_ckpt` on a loaded build of it."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.scan_ckpt.argtypes = [ptr] * 6 + [i32] * 4 + [i64] * 2 + [i32] * 5 + [ptr]
    lib.scan_ckpt.restype = i32
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of scan_bwd.cu's C entries on a loaded build of it."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.scan_bwd.argtypes = [ptr] * 15 + [i32] * 4 + [i64] * 4 + [i32, ptr]
    lib.scan_bwd.restype = i32
    lib.scan_bwd_scratch_floats.argtypes = [i32] * 4
    lib.scan_bwd_scratch_floats.restype = i64
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_lib() -> ctypes.CDLL:
    return bind_ckpt(bind_fwd(_build.load("scan_fwd.cu")))


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    return bind_bwd(_build.load("scan_bwd.cu"))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"selective_scan: {msg}")


def scan_kernel_shape(n: int, d_in: int) -> bool:
    """Whether the CUDA kernels take a scan of N states and Din channels as
    it is: N in KERNEL_STATES and Din a multiple of the backward block's
    256 / N channels (the shape half of `_check_kernel_args`)."""
    return n in KERNEL_STATES and d_in % (_THREADS // n) == 0


def scan_kernel_groups(n: int, d_in: int) -> tuple[int, int, int]:
    """How the kernels take a scan of N states and Din channels: (states a
    launch, launches, Din padded). A launch takes 8 states for N <= 8, else
    16; N above 16 is split into groups of 16; Din is padded up to a multiple
    of 256 / states. A shape the kernels take is (N, 1, Din)."""
    states = KERNEL_STATES[0] if n <= KERNEL_STATES[0] else KERNEL_STATES[1]
    per_block = _THREADS // states
    return states, -(-n // states), -(-d_in // per_block) * per_block


def _pad(t: torch.Tensor, dim: int, size: int, value: float = 0.0) -> torch.Tensor:
    """t padded with `value` at the end of dimension `dim` (>= 0) to `size`;
    t itself when it has that size."""
    extra = size - t.shape[dim]
    if extra == 0:
        return t
    return torch.nn.functional.pad(t, [0, 0] * (t.dim() - 1 - dim) + [0, extra], value=value)


def _kernel_shaped(u, delta, A, Bp, Cp, D, dy=None):
    """The scan's tensors brought to launches the kernels take
    (`scan_kernel_groups`): (u, delta, dy, [(A, Bp, Cp, D) of each state
    group]). Idle channels have u = delta = dy = 0 and D = 0, so their state
    stays 0; idle states have Bp = Cp = 0 and A = -1, so theirs stays 0 too
    and adds nothing to any output or gradient. D rides on the first group
    only (the rest get zeros): y = sum over groups. A shape the kernels take
    passes through as it is."""
    n, d_in = A.shape[1], u.shape[2]
    states, groups, d_pad = scan_kernel_groups(n, d_in)
    n_pad = states * groups
    u, delta = _pad(u, 2, d_pad), _pad(delta, 2, d_pad)
    dy = None if dy is None else _pad(dy, 2, d_pad)
    A = _pad(_pad(A, 0, d_pad, -1.0), 1, n_pad, -1.0)
    Bp, Cp, D = _pad(Bp, 2, n_pad), _pad(Cp, 2, n_pad), _pad(D, 0, d_pad)
    parts = [(A[:, s : s + states], Bp[..., s : s + states], Cp[..., s : s + states],
              D if s == 0 else torch.zeros_like(D)) for s in range(0, n_pad, states)]  # fmt: skip
    return u, delta, dy, parts


def _join(parts: list[torch.Tensor], dim: int) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _check_kernel_args(u, delta, A, Bp, Cp=None, D=None, dy=None) -> None:
    """Raise on what the CUDA kernels do not take: CUDA float32 tensors on
    one device; u, delta (and dy) contiguous (B, L, Din); Bp, Cp (B, L, N)
    with unit stride along N (slices of x_proj's output are taken as they
    are); A (Din, N); D (Din,); N in KERNEL_STATES and Din a multiple of the
    block's 256 / N channels."""
    _check(u.is_cuda, "u must be a CUDA tensor")
    _check(u.dim() == 3, f"u must be (B, L, Din), got {tuple(u.shape)}")
    batch, seq_len, d_in = u.shape
    _check(batch > 0 and seq_len > 0, f"empty input {tuple(u.shape)}")
    _check(A.dim() == 2 and A.shape[0] == d_in, f"A must be (Din={d_in}, N), got {tuple(A.shape)}")
    n = A.shape[1]
    _check(scan_kernel_shape(n, d_in), f"the kernels take d_state in {KERNEL_STATES} and Din a multiple of 256 / N, "
                                       f"got N = {n}, Din = {d_in}")  # fmt: skip
    named = [("u", u, (batch, seq_len, d_in)), ("delta", delta, (batch, seq_len, d_in)), ("A", A, (d_in, n)),
             ("Bp", Bp, (batch, seq_len, n))]  # fmt: skip
    if Cp is not None:
        named += [("Cp", Cp, (batch, seq_len, n)), ("D", D, (d_in,))]
    if dy is not None:
        named.append(("dy", dy, (batch, seq_len, d_in)))
    for name, t, shape in named:
        _check(t.device == u.device, f"{name} is on {t.device}, u on {u.device}")
        _check(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
        _check(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
    for name, t in (("u", u), ("delta", delta), ("dy", dy)):
        _check(t is None or t.is_contiguous(), f"{name} must be contiguous")
    for name, t in (("Bp", Bp), ("Cp", Cp)):
        if t is not None:
            _check(t.stride(2) == 1, f"{name} needs unit stride along N, got strides {t.stride()}")


def _nl(seq_len: int) -> int:
    return -(-seq_len // CKPT_CHUNK)


def scan_fwd_cuda(u, delta, A, Bp, Cp, D, reverse: bool = False) -> torch.Tensor:
    """Launch `csrc/scan_fwd.cu` on the current stream (no synchronise), on
    the plan of `scan_fwd_plan`. A split plan makes two launches (the
    segments' end states, then y); the call counts as one launch."""
    _check_kernel_args(u, delta, A, Bp, Cp, D)
    batch, seq_len, d_in = u.shape
    y = torch.empty_like(u)
    _scan_fwd_launch(u, delta, A, Bp, Cp, D, y, reverse, scan_fwd_plan(batch, seq_len, d_in, A.shape[1]))
    launch_counts["scan_fwd"] += 1
    return y


def _scan_fwd_launch(u, delta, A, Bp, Cp, D, y, reverse: bool, plan: ScanFwdPlan) -> None:
    """The kernel on checked arguments and a given plan (the wrapper's, or
    another in a timing script)."""
    batch, seq_len, d_in = u.shape
    a, dsk = A.contiguous(), D.contiguous()
    n = a.shape[1]
    floats = plan.scratch_floats(batch, d_in, n)
    scratch = torch.empty(floats, dtype=torch.float32, device=u.device) if floats else None
    _build.launch(
        _fwd_lib().scan_fwd, u,
        u.data_ptr(), delta.data_ptr(), a.data_ptr(), Bp.data_ptr(), Cp.data_ptr(), dsk.data_ptr(), y.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        batch, seq_len, d_in, n, Bp.stride(0), Bp.stride(1), Cp.stride(0), Cp.stride(1), int(reverse),
        plan.channels, plan.tile, plan.segments, plan.seg_len,
        what=f"scan_fwd at (B={batch}, L={seq_len}, Din={d_in})",
    )  # fmt: skip


def scan_ckpt_cuda(u, delta, A, Bp, reverse: bool = False) -> torch.Tensor:
    """Launch `scan_ckpt` of `csrc/scan_fwd.cu` on the plan of
    `scan_ckpt_plan`: the chunk-entry states (B, nl, N, Din), as
    `scan_ckpt_reference` at chunk CKPT_CHUNK. A split plan makes two
    launches (the segments' end states, then the checkpoints); the call
    counts as one launch."""
    _check_kernel_args(u, delta, A, Bp)
    batch, seq_len, d_in = u.shape
    a = A.contiguous()
    n = a.shape[1]
    plan = scan_ckpt_plan(batch, seq_len, d_in, n)
    ckpt = torch.empty((batch, _nl(seq_len), n, d_in), dtype=torch.float32, device=u.device)
    floats = plan.scratch_floats(batch, d_in, n)
    scratch = torch.empty(floats, dtype=torch.float32, device=u.device) if floats else None
    _build.launch(
        _fwd_lib().scan_ckpt, u,
        u.data_ptr(), delta.data_ptr(), a.data_ptr(), Bp.data_ptr(), ckpt.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        batch, seq_len, d_in, n, Bp.stride(0), Bp.stride(1), int(reverse),
        plan.channels, plan.tile, plan.segments, plan.seg_len,
        what=f"scan_ckpt at (B={batch}, L={seq_len}, Din={d_in})",
    )  # fmt: skip
    launch_counts["scan_ckpt"] += 1
    return ckpt


def scan_bwd_cuda(u, delta, A, Bp, Cp, D, dy, ckpt, reverse: bool = False):
    """Launch `scan_bwd` of `csrc/scan_bwd.cu` from the checkpoints of
    `scan_ckpt_cuda`: (du, ddelta, dA, dBp, dCp, dD) float32."""
    _check_kernel_args(u, delta, A, Bp, Cp, D, dy)
    batch, seq_len, d_in = u.shape
    n = A.shape[1]
    _check(ckpt.is_contiguous() and tuple(ckpt.shape) == (batch, _nl(seq_len), n, d_in),
           f"ckpt must be contiguous {(batch, _nl(seq_len), n, d_in)}, got {tuple(ckpt.shape)}")  # fmt: skip
    _check(ckpt.device == u.device and ckpt.dtype == torch.float32, "ckpt must be float32 on u's device")
    a, dsk = A.contiguous(), D.contiguous()
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    dbp = torch.empty((batch, seq_len, n), dtype=torch.float32, device=u.device)
    dcp = torch.empty_like(dbp)
    d_a, d_d = torch.empty_like(a), torch.empty_like(dsk)
    lib = _bwd_lib()
    scratch = torch.empty(lib.scan_bwd_scratch_floats(batch, seq_len, d_in, n), dtype=torch.float32, device=u.device)
    _build.launch(
        lib.scan_bwd, u,
        u.data_ptr(), delta.data_ptr(), a.data_ptr(), Bp.data_ptr(), Cp.data_ptr(), dsk.data_ptr(),
        dy.data_ptr(), ckpt.data_ptr(), scratch.data_ptr(),
        du.data_ptr(), ddelta.data_ptr(), dbp.data_ptr(), dcp.data_ptr(), d_a.data_ptr(), d_d.data_ptr(),
        batch, seq_len, d_in, n, Bp.stride(0), Bp.stride(1), Cp.stride(0), Cp.stride(1), int(reverse),
        what=f"scan_bwd at (B={batch}, L={seq_len}, Din={d_in})",
    )  # fmt: skip
    launch_counts["scan_bwd"] += 1
    return du, ddelta, d_a, dbp, dcp, d_d


def scan_fwd_kernels(u, delta, A, Bp, Cp, D, reverse: bool = False) -> torch.Tensor:
    """y of a CUDA scan of any N and Din on `scan_fwd_cuda`: one launch per
    state group of `_kernel_shaped`, y summed over them, idle channels
    dropped."""
    d_in = u.shape[2]
    u_k, delta_k, _dy, parts = _kernel_shaped(u, delta, A, Bp, Cp, D)
    y = None
    for a, bp, cp, dsk in parts:
        part = scan_fwd_cuda(u_k, delta_k, a, bp, cp, dsk, reverse)
        y = part if y is None else y.add_(part)
    return y if u_k is u else y[..., :d_in].contiguous()


def scan_bwd_kernels(u, delta, A, Bp, Cp, D, dy, reverse: bool = False):
    """(du, ddelta, dA, dBp, dCp, dD) of a CUDA scan of any N and Din on
    `scan_ckpt_cuda` and `scan_bwd_cuda`: per state group of
    `_kernel_shaped`, du and ddelta summed, dA, dBp and dCp joined along N,
    dD from the group that holds D; idle channels and states dropped."""
    n, d_in = A.shape[1], u.shape[2]
    u_k, delta_k, dy_k, parts = _kernel_shaped(u, delta, A, Bp, Cp, D, dy.contiguous())
    du = ddelta = d_d = None
    d_a, dbp, dcp = [], [], []
    for a, bp, cp, dsk in parts:
        ckpt = scan_ckpt_cuda(u_k, delta_k, a, bp, reverse)
        g_du, g_ddelta, g_da, g_dbp, g_dcp, g_dd = scan_bwd_cuda(u_k, delta_k, a, bp, cp, dsk, dy_k, ckpt, reverse)
        if du is None:
            du, ddelta, d_d = g_du, g_ddelta, g_dd
        else:
            du.add_(g_du)
            ddelta.add_(g_ddelta)
        d_a.append(g_da)
        dbp.append(g_dbp)
        dcp.append(g_dcp)
    return (du[..., :d_in], ddelta[..., :d_in], _join(d_a, 1)[:d_in, :n], _join(dbp, 2)[..., :n],
            _join(dcp, 2)[..., :n], d_d[:d_in])  # fmt: skip


class ScanFn(torch.autograd.Function):
    """The selective scan with its hand-written backward. Saves only its
    inputs: the backward recomputes the states from chunk checkpoints, as
    the JAX backward kernels do."""

    @staticmethod
    def forward(ctx, u, delta, A, Bp, Cp, D, reverse):
        ctx.save_for_backward(u, delta, A, Bp, Cp, D)
        ctx.reverse = reverse
        if u.device.type == "cuda":
            return scan_fwd_kernels(u, delta, A, Bp, Cp, D, reverse)
        return selective_scan_reference(u, delta, A, Bp, Cp, D, reverse)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        u, delta, A, Bp, Cp, D = ctx.saved_tensors
        if u.device.type == "cuda":
            grads = scan_bwd_kernels(u, delta, A, Bp, Cp, D, dy, ctx.reverse)
        else:
            grads = scan_bwd_reference(u, delta, A, Bp, Cp, D, dy, ctx.reverse)
        return (*grads, None)


def selective_scan(u, delta, A, Bp, Cp, D, reverse: bool = False) -> torch.Tensor:
    """The selective scan: y (B, L, Din) float32, differentiable.

    CPU tensors take the plain versions; CUDA tensors of any N and Din launch
    the kernels (`scan_kernel_groups`); any other device raises."""
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"selective_scan: no implementation for device {u.device}")
    return ScanFn.apply(u, delta, A, Bp, Cp, D, reverse)
