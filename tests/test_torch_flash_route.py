"""The flash kernels' routes, on the CPU.

``flash_route`` is a pure function of dtype, head dim and alignment: every
head dim of the main path (whisper-base, whisper-large-v3, wav2vec2-base,
all 64) takes TMA + wgmma in bf16, misaligned bases and head dims that are
not multiples of 16 take mma.sync, f32 takes FFMA, and what no route takes
raises.  CPU tensors reach the plain versions and launch nothing: no
count, total or per route, moves.  The kernels themselves run only on the
card (tests/test_torch_cuda.py, ``-k flash``).
"""

import numpy as np
import pytest
import torch

from tethys_tpu_torch.configs import Wav2Vec2Config, WhisperConfig
from tethys_tpu_torch.ops import flash_attention
from tethys_tpu_torch.utils import kernel_lib

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32


def _head_dim(config) -> int:
    if isinstance(config, WhisperConfig):
        return config.d_model // config.encoder_attention_heads
    return config.hidden_size // config.num_attention_heads


@pytest.mark.parametrize("config", [
    WhisperConfig.from_size("base"), WhisperConfig.from_size("large-v3"),
    WhisperConfig.from_size("small"), Wav2Vec2Config.from_size("base")],
    ids=["whisper-base", "whisper-large-v3", "whisper-small",
         "wav2vec2-base"])
def test_main_path_shapes_take_wgmma(config):
    d = _head_dim(config)
    assert d == 64
    assert flash_attention.flash_route(BF16, d, True) == "wgmma"
    assert flash_attention.flash_route(F32, d, True) == "ffma"


@pytest.mark.parametrize("d,aligned,route", [
    (64, False, "mma"), (16, False, "mma"), (128, False, "mma"),
    (8, True, "mma"), (40, True, "mma"), (72, True, "mma"), (33, True, "mma"),
    (1, True, "mma"), (16, True, "wgmma"), (80, True, "wgmma"),
    (128, True, "wgmma")])
def test_bf16_routes_by_alignment_and_head_dim(d, aligned, route):
    """TMA needs 16-byte aligned bases, wgmma 16-deep steps over d."""
    assert flash_attention.flash_route(BF16, d, aligned) == route


@pytest.mark.parametrize("d", [1, 33, 64, 128])
@pytest.mark.parametrize("aligned", [True, False])
def test_f32_takes_ffma(d, aligned):
    assert flash_attention.flash_route(F32, d, aligned) == "ffma"


@pytest.mark.parametrize("dtype,d", [(BF16, 0), (BF16, 160), (F32, 129),
                                     (torch.float16, 64), (torch.int8, 64)])
def test_what_no_route_takes_raises(dtype, d):
    with pytest.raises(ValueError, match="no route"):
        flash_attention.flash_route(dtype, d, True)


def test_routes_match_the_kernels_route_codes():
    """The wrappers pass ROUTES.index(route) as the C Route code (ffma 0,
    mma 1, wgmma 2 in csrc/flash_fwd.cu and csrc/flash_bwd.cu), and each
    flash kernel counts every route."""
    assert flash_attention.ROUTES == ("ffma", "mma", "wgmma")
    counts = kernel_lib.launch_counts()
    for name in ("flash_fwd", "flash_fwd_dropout", "flash_bwd"):
        for route in flash_attention.ROUTES:
            assert f"{name}.{route}" in counts
    assert flash_attention.route_launches().keys() == {
        "flash_fwd", "flash_fwd_dropout", "flash_bwd"}


def test_forced_route_is_read_at_each_call(monkeypatch):
    q = torch.zeros(2, 8, 64, dtype=BF16)
    monkeypatch.delenv("TETHYS_FLASH_ROUTE", raising=False)
    assert flash_attention._route(BF16, 64, q) == "wgmma"
    monkeypatch.setenv("TETHYS_FLASH_ROUTE", "mma")
    assert flash_attention._route(BF16, 64, q) == "mma"
    monkeypatch.setenv("TETHYS_FLASH_ROUTE", "tma")
    with pytest.raises(ValueError, match="TETHYS_FLASH_ROUTE"):
        flash_attention._route(BF16, 64, q)


def test_a_routed_kernel_refuses_a_launch_without_its_route():
    """The route is checked before the library is touched, so this runs
    without a card or nvcc; nothing is counted."""
    kernel_lib.reset_launch_counts()
    with pytest.raises(ValueError, match="route"):
        kernel_lib.FLASH_FWD()
    with pytest.raises(ValueError, match="route"):
        kernel_lib.DROPOUT(route="wgmma")
    assert all(n == 0 for n in kernel_lib.launch_counts().values())


def test_set_launch_counts_round_trips():
    kernel_lib.reset_launch_counts()
    counts = kernel_lib.launch_counts()
    counts.update({"flash_bwd": 3, "flash_bwd.wgmma": 2, "flash_bwd.mma": 1,
                   "log_mel": 5})
    kernel_lib.set_launch_counts(counts)
    assert kernel_lib.launch_counts() == counts
    assert kernel_lib.FLASH_BWD.routes == {"ffma": 0, "mma": 1, "wgmma": 2}
    kernel_lib.reset_launch_counts()
    assert all(n == 0 for n in kernel_lib.launch_counts().values())


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cpu_tensors_take_the_plain_versions(dtype, rate):
    """CPU tensors never reach a route: the plain versions run, and no
    count moves."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 77, 64)).astype(
        np.float32)).to(dtype) for _ in range(4))
    kernel_lib.reset_launch_counts()
    o, lse = flash_attention.flash_attention_fwd(q, k, v, 70, rate, 9)
    want_o, want_lse = flash_attention.plain_flash_fwd(q, k, v, 70, rate, 9)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    grads = flash_attention.flash_attention_bwd(q, k, v, o, lse, do, 70,
                                                rate, 9)
    want = flash_attention.plain_flash_bwd(q, k, v, o, lse, do, 70, rate, 9)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    assert all(n == 0 for n in kernel_lib.launch_counts().values())
