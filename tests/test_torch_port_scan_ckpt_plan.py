"""A model of how `csrc/scan_fwd.cu`'s checkpoint walk (`scan_ckpt`,
`Walk::kCkpt`) cuts and walks the scan, held to the JAX package's
`_scan_ckpt_kernel` and to the float64 recurrence on the CPU.

The kernel runs only on the card, so its plan (`ops/scan.scan_ckpt_plan`, as
the wrapper calls it) and its order of arithmetic are checked here in the
terms of `test_torch_port_scan_plan.py`, whose model of the forward's walk
this one reuses: segments of whole 32-step chunks walked in order in either
direction, the tiles of a segment and the steps of a tile walked from the
end in reverse, each step's exp2(dt A log2 e), every segment but the last of
the walk first walked from zero to its end state and sum of dt, those folded
in the kernel's fixed order into each segment's entry state (`fold_entry`),
then the segment walked again from there, the state written where the walk
enters a chunk. Tolerance: the float32 model within 1e-5 of max|ref| of
`_scan_ckpt_kernel` in interpret mode at chunk 32 and of the float64 literal
recurrence (f32 products in another order over a contracting recurrence), as
the port's other scan tests.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from test_torch_port_scan import _inputs, _rel, _sequential
from test_torch_port_scan_plan import (
    LADDER,
    LOG2E,
    fold_entry,
    scan_fwd_kernel,
    segment_bounds,
    tile_lo,
    walk_order,
    walk_step,
)

from deepchopper_tpu.ops.pallas_scan import _scan_ckpt_kernel
from deepchopper_tpu_torch.ops import scan

TOL = 1e-5
CHUNK = scan.CKPT_CHUNK


def chunks_entered(plan, lo: int, hi: int, reverse: bool) -> list[tuple[int, int]]:
    """(tile k, chunk) for each tile of segment [lo, hi) with which the walk
    enters a chunk, in walk order."""
    out, chunk = [], None
    for k in range(-(-(hi - lo) // plan.tile)):
        t_lo, _n = tile_lo(plan, lo, hi, k, reverse)
        if t_lo // CHUNK != chunk:
            chunk = t_lo // CHUNK
            out.append((k, chunk))
    return out


def scan_ckpt_kernel(args, a2, plan, s: int, reverse: bool, scratch, ckpt) -> list[int]:
    """The checkpoint walk of segment s for every (row, channel): from the
    folded entry state, tile by tile in walk order, the state written to
    ckpt[:, c] before the first tile of each chunk c it enters. Returns the
    chunks in the order written."""
    u, delta, _A, Bp = args[:4]
    batch, seq_len, d_in = u.shape
    lo, hi = segment_bounds(plan, seq_len, s)
    h = fold_entry(torch.zeros(batch, d_in, a2.shape[1]), a2, *scratch, plan, s, reverse)
    entries = dict(chunks_entered(plan, lo, hi, reverse))
    for k in range(-(-(hi - lo) // plan.tile)):
        t_lo, n = tile_lo(plan, lo, hi, k, reverse)
        if k in entries:
            ckpt[:, entries[k]] = h.transpose(1, 2)
        for j in range(n):
            t = t_lo + (n - 1 - j if reverse else j)
            dt, ut = delta[:, t], u[:, t]
            h, _acc = walk_step(h, a2, dt, dt * ut, Bp[:, t], None, True)
    return list(entries.values())


def scan_ckpt(args, plan, reverse: bool) -> tuple[torch.Tensor, list[int]]:
    """The wrapper's launches: a split plan first walks every segment but the
    last of the walk to its end state (the forward's Walk::kEnd), then every
    segment to the checkpoints. Returns them and the chunks written, segments
    in walk order."""
    u, _delta, A = args[:3]
    batch, seq_len, d_in = u.shape
    n = A.shape[1]
    a2 = A * LOG2E
    h_end, dt_sum = torch.zeros(batch, plan.segments, n, d_in), torch.zeros(batch, plan.segments, d_in)
    if plan.segments > 1:
        for s in walk_order(plan, reverse)[:-1]:
            scan_fwd_kernel(args, a2, plan, s, reverse, True, (h_end, dt_sum))
    ckpt = torch.full((batch, -(-seq_len // CHUNK), n, d_in), float("nan"))
    written = {s: scan_ckpt_kernel(args, a2, plan, s, reverse, (h_end, dt_sum), ckpt) for s in range(plan.segments)}
    return ckpt, [c for s in walk_order(plan, reverse) for c in written[s]]


def pallas_ckpt(u, delta, A, Bp, reverse: bool) -> np.ndarray:
    """`_scan_ckpt_kernel` at chunk 32 in interpret mode, the call built as
    `selective_scan_pallas_bwd` builds it: L padded to whole chunks, bt rows
    a block, the grid walking the chunks in the scan's direction."""
    batch, seq_len, d_in = u.shape
    n = A.shape[1]
    pad = (-seq_len) % CHUNK
    nl = (seq_len + pad) // CHUNK
    per_bt = (2 * 4 * CHUNK * d_in + 2 * 2 * CHUNK * n) * 4 + 2 * CHUNK * n * d_in * 4 + 2 * n * d_in * 4
    bt = max(1, min(batch, (14 << 20) // per_bt))
    bt = 1 << (bt.bit_length() - 1)
    bpad = (-batch) % bt
    u, delta, Bp = (jnp.pad(jnp.asarray(x), ((0, bpad), (0, pad), (0, 0))) for x in (u, delta, Bp))
    fwd_l = (lambda b, l: (b, nl - 1 - l, 0)) if reverse else (lambda b, l: (b, l, 0))
    ck_l = (lambda b, l: (b, nl - 1 - l, 0, 0)) if reverse else (lambda b, l: (b, l, 0, 0))
    d_blk = pl.BlockSpec((bt, CHUNK, d_in), fwd_l, memory_space=pltpu.VMEM)
    n_blk = pl.BlockSpec((bt, CHUNK, n), fwd_l, memory_space=pltpu.VMEM)
    at_blk = pl.BlockSpec((n, d_in), lambda b, l: (0, 0), memory_space=pltpu.VMEM)
    ckpt = pl.pallas_call(
        functools.partial(_scan_ckpt_kernel, chunk=CHUNK, reverse=reverse),
        grid=((batch + bpad) // bt, nl),
        in_specs=[d_blk, d_blk, n_blk, at_blk],
        out_specs=pl.BlockSpec((bt, 1, n, d_in), ck_l, memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((batch + bpad, nl, n, d_in), jnp.float32),
        scratch_shapes=[pltpu.VMEM((bt, n, d_in), jnp.float32)],
        interpret=True,
    )(u, delta, Bp, jnp.asarray(A.T))
    return np.asarray(ckpt)[:batch]


def float64_ckpt(u, delta, A, Bp, Cp, D, reverse: bool) -> np.ndarray:
    """The entry states of the literal float64 recurrence: entering chunk c
    forward, the state after step 32c - 1; in reverse, after 32(c + 1)."""
    batch, seq_len, d_in = u.shape
    _y, states = _sequential(u, delta, A, Bp, Cp, D, reverse)
    nl = -(-seq_len // CHUNK)
    out = np.zeros((batch, nl, A.shape[1], d_in))
    for c in range(nl):
        t = (c + 1) * CHUNK if reverse else c * CHUNK - 1
        if 0 <= t < seq_len:
            out[:, c] = states[:, t].transpose(0, 2, 1)
    return out


def _wrapper_plan(shape):
    batch, seq_len, d_in, n = shape
    return scan.scan_ckpt_plan(batch, seq_len, d_in, n)


def _segments(shape, segments: int):
    """The wrapper's channels and tile with L in `segments` runs of whole chunks."""
    plan = _wrapper_plan(shape)
    return scan._segment_plan(shape[1], plan.channels, plan.tile, segments, 0, CHUNK)


# (B, L, Din, N) and the plan: the wrapper's at L = 75 (3 segments of one
# chunk, the last 11 steps) and L = 200 (7 segments, the last 8 steps); one
# segment at both; 3 segments of 3 chunks at L = 200 (the last one 8 steps).
MODEL_CASES = [
    ((2, 75, 32, 8), _wrapper_plan),
    ((1, 200, 16, 16), _wrapper_plan),
    ((2, 75, 32, 8), functools.partial(_segments, segments=1)),
    ((3, 200, 16, 16), functools.partial(_segments, segments=1)),
    ((1, 200, 16, 16), functools.partial(_segments, segments=3)),
]


@pytest.mark.parametrize("case", range(len(MODEL_CASES)))
@pytest.mark.parametrize("reverse", [False, True])
def test_model_of_the_ckpt_walk_matches_pallas_interpret_and_float64(case, reverse):
    shape, make_plan = MODEL_CASES[case]
    plan = make_plan(shape)
    u, delta, A, Bp, Cp, D, _dy = _inputs(*shape, seed=shape[1] + case)
    args = [torch.from_numpy(x) for x in (u, delta, A, Bp, Cp, D)]
    got, written = scan_ckpt(args, plan, reverse)
    nl = -(-shape[1] // CHUNK)
    # Every chunk written once, in the walk's order.
    assert written == (list(range(nl))[::-1] if reverse else list(range(nl)))
    got = got.numpy()
    # The first chunk of the walk enters from zero.
    assert not got[:, nl - 1 if reverse else 0].any()
    want = pallas_ckpt(u, delta, A, Bp, reverse)
    exact = float64_ckpt(u, delta, A, Bp, Cp, D, reverse)
    assert got.shape == want.shape == exact.shape
    assert _rel(got, want) <= TOL, _rel(got, want)
    assert _rel(got, exact) <= TOL, _rel(got, exact)


def test_model_cases_cover_the_plan_cases():
    plans = [make(shape) for shape, make in MODEL_CASES]
    assert [p.segments for p in plans] == [3, 7, 1, 1, 3]
    assert all(p.seg_len % CHUNK == 0 for p in plans)
    assert any(p.seg_len > CHUNK for p in plans if p.segments > 1)  # segments of several chunks
    # Ragged last chunk and last tile (walked first in reverse).
    assert all(shape[1] % CHUNK and shape[1] % p.tile for (shape, _m), p in zip(MODEL_CASES, plans))


# The split at N = 16, Din = 512 where the rows cannot fill the card:
# segments of the checkpoint walk at each wide width (B = 2^17 // W; B = 1 at
# 131072). The narrower widths and L = 1000 are one segment.
CKPT_SEGMENTS = {5120: 11, 6144: 13, 8192: 18, 12288: 28, 16384: 35, 24576: 55, 32768: 69, 131072: 274}


@pytest.mark.parametrize("n", scan.KERNEL_STATES)
@pytest.mark.parametrize("batch,seq_len", [*LADDER, (1, 131072)])
def test_ckpt_plan_at_the_ladder_widths(batch, seq_len, n):
    d_in = 512
    plan = scan.scan_ckpt_plan(batch, seq_len, d_in, n)
    fwd = scan.scan_fwd_plan(batch, seq_len, d_in, n)
    assert scan.scan_ckpt_plan.__wrapped__(batch, seq_len, d_in, n) == plan
    # The forward's blocks and tiles; segments start on chunk boundaries and
    # no tile lies in two chunks.
    assert (plan.channels, plan.tile, plan.block_target) == (fwd.channels, fwd.tile, fwd.block_target)
    assert plan.seg_len % CHUNK == 0 and CHUNK % plan.tile == 0
    assert plan.segments == -(-seq_len // plan.seg_len)
    assert 0 < seq_len - (plan.segments - 1) * plan.seg_len <= plan.seg_len
    # Split exactly where the forward splits, into the forward's count or a
    # few more (shorter whole-chunk runs), reaching the same block target.
    assert (plan.segments == 1) == (fwd.segments == 1)
    assert fwd.segments <= plan.segments <= max(1, math.isqrt(seq_len))
    assert plan.blocks(batch, d_in) >= plan.block_target
    assert plan.segments == CKPT_SEGMENTS.get(seq_len, 1)
    assert plan.blocks(batch, d_in) == batch * (d_in // plan.channels) * CKPT_SEGMENTS.get(seq_len, 1)
    # Every chunk entered once, in walk order, in both directions.
    nl = -(-seq_len // CHUNK)
    for reverse in (False, True):
        entered = []
        for s in walk_order(plan, reverse):
            entered += [c for _k, c in chunks_entered(plan, *segment_bounds(plan, seq_len, s), reverse)]
        assert entered == (list(range(nl))[::-1] if reverse else list(range(nl)))


def test_ckpt_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="scan_ckpt_plan"):
        scan.scan_ckpt_plan(1, 100, 40, 16)  # Din not a multiple of 16
    with pytest.raises(ValueError, match="scan_ckpt_plan"):
        scan.scan_ckpt_plan(1, 100, 64, 4)  # N not in KERNEL_STATES
