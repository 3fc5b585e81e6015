"""A model of how `csrc/scan_fwd.cu` cuts and walks the selective scan, held
to the JAX package's Pallas scan and to the float64 recurrence on the CPU.

The kernel runs only on the card, so its plan (`ops/scan.scan_fwd_plan`, as
the wrapper calls it) and its order of arithmetic are checked here in its
own terms: segments of whole tiles walked in order in either direction, the
tiles of a segment and the steps of a tile walked from the end in reverse,
each step's exp2(dt A log2 e) and the states summed into y in order, every
segment but the last of the walk first walked from zero to its end state and
sum of dt, those folded in the kernel's fixed order into each segment's entry
state, then the segment walked again from there to y. Each function mirrors
the device function of the same name. Tolerances: the float32 model within
1e-5 of max|ref| of JAX's `selective_scan_pallas` in interpret mode and of
the float64 literal recurrence (f32 sums in another order over a contracting
recurrence), as the port's other scan tests.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_scan import _inputs, _rel, _sequential

from deepchopper_tpu.ops.pallas_scan import selective_scan_pallas
from deepchopper_tpu_torch.data.bucketing import default_buckets
from deepchopper_tpu_torch.ops import scan

TOL = 1e-5
LOG2E = np.float32(1.4426950408889634)


def segment_bounds(plan, seq_len: int, s: int) -> tuple[int, int]:
    """Steps [lo, hi) of segment s (by position)."""
    lo = s * plan.seg_len
    return lo, min(seq_len, lo + plan.seg_len)


def walk_order(plan, reverse: bool) -> list[int]:
    """The segments in the order the scan walks them."""
    order = list(range(plan.segments))
    return order[::-1] if reverse else order


def tile_lo(plan, lo: int, hi: int, k: int, reverse: bool) -> tuple[int, int]:
    """The k-th tile of segment [lo, hi) in walk order: (first step, steps)."""
    nt = -(-(hi - lo) // plan.tile)
    t_lo = lo + ((nt - 1 - k) if reverse else k) * plan.tile
    return t_lo, min(plan.tile, hi - t_lo)


def walked_steps(plan, lo: int, hi: int, reverse: bool) -> list[int]:
    """Every step of segment [lo, hi) in walk order, tile by tile."""
    out = []
    for k in range(-(-(hi - lo) // plan.tile)):
        t_lo, n = tile_lo(plan, lo, hi, k, reverse)
        out += [t_lo + (n - 1 - j if reverse else j) for j in range(n)]
    return out


def walk_step(h, a2, dt, bu, b_row, c_row, end: bool):
    """One step of every (row, channel)'s N states, float32: h <- exp2(dt a2)
    h + (dt u) Bp, and for the y walk the sum over states in order."""
    h = torch.exp2(dt[..., None] * a2) * h + bu[..., None] * b_row[:, None, :]
    acc = torch.zeros_like(dt)
    if not end:
        for n in range(h.shape[-1]):
            acc = acc + c_row[:, None, n] * h[..., n]
    return h, acc


def fold_entry(h, a2, h_end, dt_sum, plan, s: int, reverse: bool):
    """The entry state of segment s from the end states of the segments
    walked before it, first walked first."""
    for k in walk_order(plan, reverse):
        if k == s:
            break
        h = torch.exp2(a2 * dt_sum[:, k, :, None]) * h + h_end[:, k].transpose(1, 2)
    return h


def scan_fwd_kernel(args, a2, plan, s: int, reverse: bool, end: bool, scratch=None, y=None):
    """One segment of the walk for every (row, channel): with `end`, from
    zero into the scratch's end state and sum of dt; else from the folded
    entry state into y."""
    u, delta, _A, Bp, Cp, D = args
    batch, seq_len, d_in = u.shape
    lo, hi = segment_bounds(plan, seq_len, s)
    h = torch.zeros(batch, d_in, a2.shape[1])
    if not end:
        h = fold_entry(h, a2, *scratch, plan, s, reverse)
    dsum = torch.zeros(batch, d_in)
    for t in walked_steps(plan, lo, hi, reverse):
        dt, ut = delta[:, t], u[:, t]
        h, acc = walk_step(h, a2, dt, dt * ut, Bp[:, t], Cp[:, t], end)
        if end:
            dsum = dsum + dt
        else:
            y[:, t] = D * ut + acc
    if end:
        h_end, dt_sum = scratch
        h_end[:, s] = h.transpose(1, 2)
        dt_sum[:, s] = dsum


def scan_fwd(args, plan, reverse: bool) -> torch.Tensor:
    """The wrapper's launches: a split plan first walks every segment but the
    last of the walk into the (B, S, N, Din) and (B, S, Din) scratch, then
    every segment to y."""
    u, _delta, A, *_ = args
    batch, seq_len, d_in = u.shape
    n = A.shape[1]
    a2 = A * LOG2E
    h_end, dt_sum = torch.zeros(batch, plan.segments, n, d_in), torch.zeros(batch, plan.segments, d_in)
    assert h_end.numel() + dt_sum.numel() == plan.scratch_floats(batch, d_in, n) or plan.segments == 1
    if plan.segments > 1:
        for s in walk_order(plan, reverse)[:-1]:
            scan_fwd_kernel(args, a2, plan, s, reverse, True, (h_end, dt_sum))
    y = torch.empty_like(u)
    for s in range(plan.segments):
        scan_fwd_kernel(args, a2, plan, s, reverse, False, (h_end, dt_sum), y)
    return y


def _plan_of(shape):
    batch, seq_len, d_in, n = shape
    return scan.scan_fwd_plan(batch, seq_len, d_in, n)


# (B, L, Din, N) with the plan the wrapper takes for each:
# - (2, 300, 32, 8): 10 segments of 32 steps, the last 12 (ragged segment and tile);
# - (1, 1000, 16, 16): 21 segments of 3 tiles, the last 40 steps (2.5 tiles);
# - (3, 77, 16, 16): 5 segments of one tile, the last 13 steps;
# - (2, 13, 32, 8): one segment, one ragged tile.
MODEL_SHAPES = [(2, 300, 32, 8), (1, 1000, 16, 16), (3, 77, 16, 16), (2, 13, 32, 8)]


@pytest.mark.parametrize("shape", MODEL_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_model_of_the_kernel_matches_pallas_interpret_and_float64(shape, reverse):
    plan = _plan_of(shape)
    u, delta, A, Bp, Cp, D, _dy = _inputs(*shape, seed=shape[1])
    args = [torch.from_numpy(x) for x in (u, delta, A, Bp, Cp, D)]
    got = scan_fwd(args, plan, reverse).numpy()
    want = np.asarray(selective_scan_pallas(*(jnp.asarray(x) for x in (u, delta, A, Bp, Cp, D)), chunk=32,
                                            reverse=reverse, interpret=True))  # fmt: skip
    exact, _states = _sequential(u, delta, A, Bp, Cp, D, reverse)
    assert _rel(got, want) <= TOL, _rel(got, want)
    assert _rel(got, exact) <= TOL, _rel(got, exact)


def test_model_shapes_cover_the_plan_cases():
    plans = {shape: _plan_of(shape) for shape in MODEL_SHAPES}
    last = {shape: shape[1] - (p.segments - 1) * p.seg_len for shape, p in plans.items()}
    assert plans[(2, 13, 32, 8)].segments == 1
    assert all(p.segments > 1 for shape, p in plans.items() if shape[1] > 16)
    assert all(last[s] < plans[s].seg_len for s in MODEL_SHAPES if s[1] > 16)  # ragged last segment
    assert any(last[s] % plans[s].tile for s in MODEL_SHAPES)  # ragged last tile
    assert any(p.seg_len > p.tile for p in plans.values())  # segments of several tiles


@pytest.mark.parametrize("reverse", [False, True])
def test_every_plan_of_one_shape_computes_the_same_scan(reverse):
    """One segment, the wrapper's split, and another split of the same
    inputs agree: segments change the order of arithmetic only."""
    shape = (2, 300, 32, 8)
    u, delta, A, Bp, Cp, D, _dy = _inputs(*shape, seed=3)
    args = [torch.from_numpy(x) for x in (u, delta, A, Bp, Cp, D)]
    plan = _plan_of(shape)
    exact, _states = _sequential(u, delta, A, Bp, Cp, D, reverse)
    for alt in (plan, scan._segment_plan(300, plan.channels, plan.tile, 1, 0),
                scan._segment_plan(300, plan.channels, plan.tile, 3, 0)):  # fmt: skip
        assert _rel(scan_fwd(args, alt, reverse).numpy(), exact) <= TOL, alt


TOKENS = 1 << 17  # a batch of the engine's ladder: B = 2^17 // W
LADDER = [(TOKENS // w, w) for w in default_buckets(32768)] + [(TOKENS // 1000, 1000)]


@pytest.mark.parametrize("n", scan.KERNEL_STATES)
@pytest.mark.parametrize("batch,seq_len", LADDER)
def test_plan_at_the_ladder_widths(batch, seq_len, n):
    d_in = 512
    plan = scan.scan_fwd_plan(batch, seq_len, d_in, n)
    # A function of (B, L, Din, N) alone: the same plan when made anew.
    assert scan.scan_fwd_plan.__wrapped__(batch, seq_len, d_in, n) == plan
    assert d_in % plan.channels == 0 and plan.channels <= scan.FWD_MAX_CHANNELS and plan.channels % 16 == 0
    # Segments of whole tiles; the last one (by position) may be shorter.
    assert plan.seg_len % plan.tile == 0
    assert 0 < seq_len - (plan.segments - 1) * plan.seg_len <= plan.seg_len
    # They tile [0, L) exactly, in walk order in both directions.
    for reverse in (False, True):
        steps = []
        for s in walk_order(plan, reverse):
            steps += walked_steps(plan, *segment_bounds(plan, seq_len, s), reverse)
        assert steps == (list(range(seq_len))[::-1] if reverse else list(range(seq_len)))
    # The grid reaches the plan's target, within the fold's limit.
    assert plan.blocks(batch, d_in) >= plan.block_target
    assert plan.segments <= max(1, math.isqrt(seq_len))
    # Shared memory of two staged tiles within a block's 227 KB.
    assert 2 * 4 * plan.tile * (2 * plan.channels + 2 * n) <= 227 * 1024


def test_plan_splits_only_where_rows_cannot_fill_the_card():
    one = [w for b, w in LADDER[:-1] if scan.scan_fwd_plan(b, w, 512, 16).segments == 1]
    split = [w for b, w in LADDER[:-1] if scan.scan_fwd_plan(b, w, 512, 16).segments > 1]
    assert one and split and max(one) < min(split)  # the wide buckets split
    assert scan.scan_fwd_plan(TOKENS // 1000, 1000, 512, 16).segments == 1
    assert scan.scan_fwd_plan(1, 131072, 512, 16).segments > 1
    with pytest.raises(ValueError):
        scan.scan_fwd_plan(1, 100, 40, 16)  # Din not a multiple of 16
