"""The trace's reading (trace.py) on a made-up profile: the window is the
benchmark's host span, busy time is the union of the device's operations
within it (overlaps counted once, the device's copies of host spans left
out), device time goes to its group by the kernel's name or the operation
that launched it, and each idle gap to the host operation running at its
middle."""

from types import SimpleNamespace as NS

import pytest

from tethys_bench import trace


def _event(name, start, end, device="CPU", kernels=(), parent=None,
           annotation=False):
    return NS(name=name, device_type=NS(name=device),
              time_range=NS(start=start, end=end), kernels=list(kernels),
              cpu_parent=parent, is_user_annotation=annotation)


def _profile():
    window = _event(trace.WINDOW, 100.0, 200.0)
    step = _event("Optimizer.step#KerasAdam.step", 150.0, 170.0)
    foreach = _event("aten::_foreach_add_", 151.0, 152.0, parent=step,
                     kernels=[NS(name="multi_tensor_apply_kernel",
                                 duration=10.0)])
    mm = _event("aten::mm", 101.0, 102.0,
                kernels=[NS(name="nvjet_tst_256x128", duration=20.0)])
    flash = _event("tethys::flash_fwd", 103.0, 104.0,
                   kernels=[NS(name="flash_fwd_wgmma_kernel", duration=15.0)])
    copy = _event("aten::copy_", 130.0, 145.0,
                  kernels=[NS(name="Memcpy HtoD (Pageable -> Device)",
                              duration=5.0)])
    return NS(events=lambda: [
        window, step, foreach, mm, flash, copy,
        # device side: two overlapping kernels, one copy, and the device
        # copies of two host spans, which are no operation
        _event("nvjet_tst_256x128", 105.0, 125.0, device="CUDA"),
        _event("flash_fwd_wgmma_kernel", 120.0, 135.0, device="CUDA"),
        _event("Memcpy HtoD (Pageable -> Device)", 140.0, 145.0,
               device="CUDA"),
        _event("multi_tensor_apply_kernel", 160.0, 170.0, device="CUDA"),
        _event(trace.WINDOW, 100.0, 200.0, device="CUDA", annotation=True),
        _event("Optimizer.step#KerasAdam.step", 150.0, 170.0,
               device="CUDA"),
    ])


def test_reading():
    r = trace.read(_profile())
    assert r.window_s == pytest.approx(100e-6)
    # [105, 135] + [140, 145] + [160, 170] = 45 us
    assert r.busy_s == pytest.approx(45e-6)
    assert r.by_group_s["products"] == pytest.approx(20e-6)
    assert r.by_group_s["flash"] == pytest.approx(15e-6)
    assert r.by_group_s["input_copy"] == pytest.approx(5e-6)
    assert r.by_group_s["optimizer"] == pytest.approx(10e-6)
    gaps = dict(r.idle_gaps)
    # [100, 105]: mm (101-102) has ended by 102.5; [170, 200]: nothing
    assert gaps["no_host_operation"] == pytest.approx((5 + 30) * 1e-6)
    assert gaps["aten::copy_"] == pytest.approx(5e-6)         # [135, 140]
    assert gaps["Optimizer.step#KerasAdam.step"] == pytest.approx(15e-6)


def test_reading_needs_one_window():
    prof = NS(events=lambda: [_event("aten::mm", 0.0, 1.0)])
    with pytest.raises(RuntimeError):
        trace.read(prof)
