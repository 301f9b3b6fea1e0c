"""Dropout on a shard (ops/dropout.Window), on the CPU: the plain version
that csrc/dropout.cu is held to on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 21(d)).

A shard's mask is the slice of the unsharded tensor's mask, for windows of
rows (sequence parallelism's encoder rows), of columns (tensor
parallelism's fc1 output), of both, and at column offsets that are not a
multiple of 4 (two Philox calls cover a group); the default window draws
the bits the port drew before windows existed (pinned from the parent
tree's plain version, whose Philox code this file does not touch).
"""

import pytest
import torch

from tethys_tpu_torch.ops import dropout

SEED, RATE = 1234, 0.3
WHOLE = (3, 10, 12)


@pytest.mark.parametrize("rows,cols", [
    ((0, 10), (0, 12)),      # the whole tensor, spelled out
    ((2, 5), (0, 12)),       # rows
    ((6, 4), (0, 12)),
    ((0, 10), (4, 4)),       # columns
    ((0, 10), (8, 4)),
    ((3, 4), (4, 8)),        # both
    ((0, 10), (1, 11)),      # an offset that is not a multiple of 4
    ((1, 9), (5, 3)),
])
def test_shard_mask_is_the_slice_of_the_whole(rows, cols):
    (r0, nr), (c0, nc) = rows, cols
    whole = dropout.keep_mask(SEED, WHOLE, RATE)
    window = dropout.Window(row0=r0, rows=WHOLE[1], col0=c0, cols=WHOLE[2])
    shard = dropout.keep_mask(SEED, (WHOLE[0], nr, nc), RATE, window=window)
    assert torch.equal(shard, whole[:, r0:r0 + nr, c0:c0 + nc])
    x = torch.randn(WHOLE, generator=torch.Generator().manual_seed(0))
    got = dropout.plain_dropout(x[:, r0:r0 + nr, c0:c0 + nc].contiguous(),
                                RATE, SEED, window)
    want = dropout.plain_dropout(x, RATE, SEED)[:, r0:r0 + nr, c0:c0 + nc]
    assert torch.equal(got, want)


def test_default_window_keeps_the_bits():
    """Window() and no window draw one mask, the parent tree's (pinned)."""
    mask = dropout.keep_mask(7, (2, 24, 40), 0.1)
    assert int(mask.sum()) == 1706
    assert int((mask.flatten() * torch.arange(mask.numel())).sum()) == 1640233
    assert dropout.philox_bits(12345, 8).tolist() == [
        3522838145, 796912209, 3536492049, 3811097568, 11954473, 619747172,
        3835353109, 2774477367]
    explicit = dropout.keep_mask(7, (2, 24, 40), 0.1, window=dropout.Window(
        0, 24, 0, 40))
    assert torch.equal(mask, explicit)
    assert dropout.window_segments((2, 24, 40), dropout.Window()) == (
        2 * 24 * 40, 1, 0, 0, 0)


def test_window_segments_and_refusals():
    """The kernel's segment form: rows fold into one segment per outer
    index, columns give one segment per row; a shard outside its window
    raises."""
    assert dropout.window_segments((3, 5, 12), dropout.Window(2, 10)) == (
        60, 1, 120, 0, 24)
    assert dropout.window_segments((3, 10, 4),
                                   dropout.Window(col0=4, cols=12)) == (
        4, 10, 120, 12, 4)
    assert dropout.window_segments((3, 4, 8), dropout.Window(3, 10, 4, 12)) \
        == (8, 4, 120, 12, 40)
    with pytest.raises(ValueError, match="does not fit"):
        dropout.window_segments((3, 5, 12), dropout.Window(6, 10))
    with pytest.raises(ValueError, match="does not fit"):
        dropout.window_segments((3, 10, 8), dropout.Window(col0=8, cols=12))


def test_windowed_backward_is_the_same_mask():
    window = dropout.Window(row0=4, rows=10, col0=0, cols=12)
    x = torch.randn(3, 6, 12, requires_grad=True)
    y = dropout.fused_dropout(x, RATE, SEED, window)
    y.backward(torch.ones_like(y))
    keep = dropout.keep_mask(SEED, x.shape, RATE, window=window)
    assert torch.equal(x.grad != 0, keep)
    assert torch.equal(y != 0, keep & (x != 0))


@pytest.mark.parametrize("head0,row0,shape", [
    (0, 0, (2, 4, 7, 9)),       # the whole tensor
    (2, 0, (2, 2, 7, 9)),       # heads 2-3 of 4 (tensor parallelism)
    (1, 0, (2, 1, 7, 9)),
    (0, 4, (2, 4, 3, 9)),       # query rows 4-6 of 7 (sequence parallelism)
    (0, 0, (2, 4, 4, 9)),
])
def test_probs_window_is_the_slice_of_the_whole(head0, row0, shape):
    """Attention probabilities [B, H, Tq, Tk] at an ops/attention.
    ProbsWindow (a shard of heads or of query rows) drop the slice of the
    whole tensor's mask; a shard of both is refused."""
    from tethys_tpu_torch.ops.attention import ProbsWindow, probs_dropout

    whole_shape = (2, 4, 7, 9)
    probs = torch.rand(whole_shape, generator=torch.Generator().manual_seed(3))
    want = probs_dropout(probs, RATE, SEED)
    b, h, tq, _ = shape
    window = ProbsWindow(head0=head0, heads=4, row0=row0, rows=7)
    got = probs_dropout(
        probs[:, head0:head0 + h, row0:row0 + tq].contiguous(), RATE, SEED,
        window)
    assert torch.equal(got, want[:, head0:head0 + h, row0:row0 + tq])
    with pytest.raises(ValueError, match="both heads"):
        probs_dropout(probs[:, :2, :3].contiguous(), RATE, SEED,
                      ProbsWindow(0, 4, 0, 7))
